#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`bds3_tpu_torch`).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from `bds3_tpu_torch/csrc`, holds each
kernel against its plain PyTorch version on the card, and drives the
port's main path through its public entry points:

  1. build   nvcc build of the kernels; the card's name and power limit;
             K1's blocks per channel at the preset, B1C narrowband and
             B2a 12 channels, with the blocks the card holds at once: the
             preset and B2a must run S > 1.
  2. kernel  fused_track_block against track_block_reference on the card:
             (a) 10 Msps, 2 satellites, 30 epochs; (b) 99.375 Msps,
             12 channels, 20 epochs.  blksize and cursors must be equal,
             correlators and discriminators within 1e-3 of |a|.mean()+1.
             (c) K1's float32 and complex64 instances, one 20-epoch block
             of B2a 12 channels and of the B1C preset at 99.375 Msps
             (complex on an IQ8 capture rendered on the card); K1 on
             capture.float() and on capture + 0j must equal K1 on the int8
             capture bit for bit; B2a block times of the three instances.
             Every K1 check here and below runs K1 at 1 and 2 blocks per
             channel and at the chosen count against one plain
             block (K1_CLUSTERS).
  3. receiver  run_receiver on the synthesized 20 Msps, 11.5 s,
             5-satellite scenario (seeds 3 and 1): 5 channels, the kernel
             launched, >= 3 fixes, median 3D error < 1 m; the float32
             cast of the capture must track exactly as the int8 one; then
             the kernel against its plain version on one block at these
             shapes.  The same scenario rendered on the card as IQ8 and
             handed over as int8 pairs (receiver_iq8_e2e): 5 channels, K1's
             complex instance launched, >= 3 fixes, median < 1 m.
  4. full-rate  99.375 Msps, 2.2 s, 4 satellites: acquisition over PRNs
             1-63 must detect exactly those 4; 12 channels tracked for
             2000 epochs must all lock; kernel times at one block per
             channel and at the chosen count in turns (S1, S, S,
             S1), the plain version's time, K1's bound.
             Then the same 2000 epochs through the prefix-sum path
             (track(correlator="bucket_pallas"), the mix+prefix kernel):
             12/12 locked, real-time factor beside the tracking kernel's.
             Then the same satellites as an IQ8 capture rendered on the
             card (track_iq8_99msps_12ch): 12/12 locked through K1's
             complex instance, real-time factor beside the int8 run's.
  5. prefix  (run last) mix_prefix (csrc/mix_prefix.cu) against
             mix_prefix_reference
             and a float64 numpy oracle at B1C (10 channels) and B2a
             (12 channels) 99.375 Msps epoch widths and at the B1C
             receiver's (6 Msps, 5 channels), with windows past the
             capture's end and blk < n, and at edge windows (n < 4096,
             n = 1, blk <= 0, cursors below 0 and past the end): within
             5e-4 of max|P_i| + 1; every call repeated bit for bit; one
             scratch reused by every shape and cursor, bit for bit.
             Times with output and scratch made once and made per call,
             the device's own time (torch.profiler), the plain version's
             and a scan-only torch.cumsum (less work than K2).  K2's
             float32 instance at every shape and edge window: on
             capture.float() equal to the int8 instance bit for bit, on
             samples with fractions within 5e-4 of its plain version and
             the oracle; its times and its byte bound (4 bytes a sample).
  6. bucket  one 20-epoch bucket_pallas block from the same state, B2a
             (12 channels) and B1C narrowband (10 channels) at 99.375 Msps:
             blksize and cursors equal, correlators within 1e-3 of
             |a|.mean()+1 of the same path through the kernel's plain
             version, and within 2e-2 of the plain bucket path (another
             rounding of the carrier phase); on capture.float() (K2's
             float32 instance) rows and state equal to the int8 block's.
  7. B1C kernel  fused_track_block against track_block_reference at the
             B1C preset's rate (99.375 Msps), 10 channels over the 4
             satellites, one 20-epoch block: narrowband, and wideband in
             each code blend (composite, nb, split, dotprod).  blksize and
             cursors equal, correlators (with the BOC(6,1) and composite
             pilot) within 1e-3 of |a|.mean()+1; kernel block times at
             one block per channel and at the chosen count in
             turns, the plain version's, and the kernel's bound.
  8. B1C acquisition  b1c_settings() (resampled) over PRNs 1-63 on the
             2.2 s 99.375 Msps capture: exactly the 4 satellites; the
             card's resampler within 5e-3 of the host scipy filter in
             the interior.
  9. B1C tracking  the preset (wideband, composite), 10 channels,
             200 epochs through track() "auto": K1 launched, 10/10
             locked, real-time factor.  Narrowband through "auto" (K1),
             "bucket_pallas" (the mix+prefix kernel), "bucket_pallas" on
             capture.float() (its float32 instance: every output equal to
             the int8 run's) and plain "bucket": 10/10 locked in each.
 10. B1C receivers  run_receiver on the 6 Msps, 26 s, 5-satellite
             narrowband scenario (seeds 5 and 2), then on the bench's
             wideband one (33.125 Msps, IF fs/4, 26 s, "split" blend,
             resampled acquisition; the capture rendered on the card):
             5 channels, K1 launched, >= 4 ephemerides with the true m_0,
             >= 10 fixes with a median 3D error < 2 m; then one 20-epoch
             block at their shapes, K1 against its plain version, and for
             narrowband also bucket_pallas against the same path with
             the mix+prefix kernel's plain version (as in 6).
 11. stream  the 2.2 s B2a capture of 4 written to a .bin and tracked
             from a StreamingCapture, 12 channels, 2000 epochs in blocks
             of 500 with sync_each_block, through K1 block by block:
             transport "none" must equal the resident run of the same
             blocks (blksize and absolute_sample exactly, correlators
             within 1e-3 of mean|a|+1; K1 reads the cursor only as an
             index, so 0 is expected); "int4" and "int2" must lock 12/12;
             download=False must realize to the download=True outputs.
             Real-time factor of each transport beside the resident one.
 12. mxu_micro  K3 (csrc/mxu_micro.cu) against mxu_micro_reference on
             seeded normal inputs, every shape of benchmarks/mxu_micro.py:
             80-89 in every variant at 8 iterations, within 1e-5 of
             iters * sum|a||b|; then the port's bench stage
             (bench.bench_mxu_micro, 2000 iterations, its launches
             counted); then each shape at 2000 iterations in turns: K3,
             its plain version and one torch.mm over the concatenated
             operands (cuBLAS, TF32 off; mxu_one_call), K3 and the one
             call over 10 back-to-back calls, the plain version once;
             K3 and the one call held to the plain result, with K3's
             grid.
 13. parallel  (before prefix) the parallel/ paths with their ranks side
             by side on this card (parallel.worker through
             parallel.launch.launch_local, gloo, cuda:0), over the cached
             captures, each against the parent's one-process run:
             parallel_channel_b2a_12ch (2 ranks x 6 channels, 2000 epochs
             through sharded_track_block: rows equal track()'s bit for
             bit), parallel_nccl_world1 (the same on one rank over NCCL),
             parallel_time_b2a_12ch (time_sharded_track, 2 ranks, 2
             groups, against track() at 1000 epochs a block),
             parallel_time2d_b1c_wb (the preset on a (2, 2) time x
             channel mesh, 200 epochs, BOC(6,1) included) within
             rtol 3e-5, atol 3e-4 and blksize exactly; every tracking
             rank launches K1 and holds a 20-epoch block of it to its
             plain version within 1e-3.  parallel_acq_b2a: PRN- and
             Doppler-sharded search over 2 ranks (63 PRNs) with winners
             equal to one search's and peaks within 1e-5, and the
             time-sharded non-coherent search (4 rounds a rank, a
             63 x 25 x 99,375 cube) within 1e-5 of one rank's, the 4
             satellites at their bins.

 14. drivers  (before parallel) the port's drivers of the JAX paths, each
             through its main on the card at its default length: the
             examples' b2a_pipeline_demo (6.5 s at 99.375 Msps) and
             b1c_pipeline_demo (1 s, wideband), the tools'
             validate_b1c_chain (40 s at 6 Msps), streaming_demo (at 5 s
             here, two 2000-epoch blocks; 49 s by default) and
             profile_trace (0.2 s, in a process of its own);
             debug_pvt's run on receiver_e2e's
             cached capture.  Each must print its PASS line (profile_trace
             its "traced" line, with a trace file) and launch K1; each
             one's wall time and launches.

With `--profile` it runs only the build and then torch.profiler over
short runs of the tracking cells (see phase_profile), one JSON line each,
and prints no kernel table.

Each phase prints one JSON line.  Then come the kernel table
({"kernels": [...]}, each kernel's launches counted from 0 over its
path's run), the card's `nvidia-smi` name and power limit, and last
{"ok": true, "device": {...}}.  Any failure exits non-zero without that
last line; so does a machine without a usable CUDA device.  Captures are
synthesized in background processes while the card works, and cached
under bds3_tpu_torch/_build/captures; the 33.125 Msps wideband one is
rendered on the card.  Nothing here imports JAX or the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import multiprocessing as mp
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CAPTURES = os.path.join(REPO, "bds3_tpu_torch", "_build", "captures")

RX_TRUTH = np.array([-1288398.0, -4721697.0, 4078625.0])  # Boulder, ECEF [m]
# the 99.375 Msps bench satellites: (PRN, Doppler [Hz], code phase [chips])
FULL_SATS = [(5, 1650.0, 4100.0), (12, -2480.0, 8123.0),
             (19, 700.0, 55.0), (30, -310.0, 9000.0)]
FULL_MS = 2200.0
TOL = 1e-3   # kernel vs plain version, in units of |a|.mean() + 1
PREFIX_TOL = 5e-4   # mix_prefix vs plain / oracle, units of max|P_i| + 1
BUCKET_TOL = 2e-2   # bucket_pallas vs bucket, units of |a|.mean() + 1
CAPTURE_KINDS = ("e2e", "full", "b1c_full", "b1c_e2e")


def e2e_settings():
    from bds3_tpu_torch.config import b2a_settings

    return b2a_settings(
        sampling_freq=20e6, intermediate_freq=5e6, ms_to_process=11_500,
        use_tropo_corr=False, acq_satellite_list=tuple(range(1, 7)),
        num_channels=6)


def full_settings():
    from bds3_tpu_torch.config import b2a_settings

    return b2a_settings()


def b1c_full_settings():
    from bds3_tpu_torch.config import TrackMode, b1c_settings

    return b1c_settings(track_mode=TrackMode.NARROWBAND, resampling=False)


def b1c_e2e_settings():
    """tests/test_e2e_b1c.py:21-33."""
    from bds3_tpu_torch.config import TrackMode, b1c_settings

    return b1c_settings(
        sampling_freq=6e6, intermediate_freq=1.5e6, ms_to_process=26_000,
        use_tropo_corr=False, acq_satellite_list=tuple(range(1, 7)),
        num_channels=6, acq_coh_ms=3, acq_step=1000 / 3 / 2,
        acq_search_band=3000.0, track_mode=TrackMode.NARROWBAND)


def b1c_scenario():
    from bds3_tpu_torch.io.scenario import make_scenario

    return make_scenario(b1c_e2e_settings(), RX_TRUTH, n_sats=5,
                         sow_base=3600.0 * 3, seed=5)


def b1c_preset_settings(**overrides):
    """The B1C preset: 99.375 Msps, 10 channels, WIDEBAND, composite code
    blend, resampled acquisition (bds3_tpu_torch/config.py:153-184)."""
    from bds3_tpu_torch.config import b1c_settings

    return b1c_settings(**overrides)


def b1c_wb_e2e_settings():
    """bench.py:383-431: 33.125 Msps, IF fs/4, 26 s, 5 channels, wideband
    with the "split" code blend, resampled acquisition (the preset's)."""
    fs = 99.375e6 / 3
    return b1c_preset_settings(
        sampling_freq=fs, intermediate_freq=fs / 4, ms_to_process=26_000,
        use_tropo_corr=False, acq_satellite_list=tuple(range(1, 7)),
        num_channels=5, wb_code_blend="split")


def b1c_wb_scenario():
    from bds3_tpu_torch.io.scenario import make_scenario

    return make_scenario(b1c_wb_e2e_settings(), RX_TRUTH, n_sats=5,
                         sow_base=3600.0 * 3, seed=5)


def sat_params(sats, amplitude=0.65):
    from bds3_tpu_torch.io import SatParams

    return [SatParams(prn=p, doppler_hz=fd, code_phase_chips=cp,
                      amplitude=amplitude) for p, fd, cp in sats]


def make_inits(s, sats, n_channels):
    """Channels from the synthesized truth, fanned out over the satellites."""
    from bds3_tpu_torch.track.state import ChannelInit

    inits = []
    for i in range(n_channels):
        prn, fd, cp = sats[i % len(sats)]
        code_rate = s.code_freq_basis * (1 + fd / s.carr_freq_basis)
        start = ((s.code_length - cp % s.code_length) % s.code_length) \
            / code_rate
        inits.append(ChannelInit(
            prn=prn, acquired_freq=s.intermediate_freq + fd,
            code_phase=int(round(start * s.sampling_freq)), peak_metric=2.0))
    return inits


def _synth_job(kind: str, path: str) -> None:
    """Background process: synthesize one capture into `path` (.npy)."""
    sys.path.insert(0, REPO)
    from bds3_tpu_torch.io import synthesize_if
    from bds3_tpu_torch.io.scenario import make_scenario, synthesize_scenario

    if kind == "e2e":
        sc = make_scenario(e2e_settings(), RX_TRUTH, n_sats=5, seed=3)
        sig = synthesize_scenario(sc, noise_std=2.0, amplitude=0.7, seed=1)
    elif kind == "b1c_e2e":
        sig = synthesize_scenario(b1c_scenario(), noise_std=2.0,
                                  amplitude=1.3, seed=2)
    else:
        s = full_settings() if kind == "full" else b1c_full_settings()
        sig = synthesize_if(s, sat_params(FULL_SATS), n_ms=FULL_MS,
                            noise_std=2.0, seed=11)
    tmp = f"{path}.{os.getpid()}.tmp.npy"
    np.save(tmp, sig)
    os.replace(tmp, path)


class Captures:
    """The large captures, made in spawned processes while the card works;
    `get` waits for one.  `stop` ends any process still running."""

    def __init__(self):
        os.makedirs(CAPTURES, exist_ok=True)
        ctx = mp.get_context("spawn")
        self.procs = {}
        self.paths = {k: os.path.join(CAPTURES, f"{k}_v1.npy")
                      for k in CAPTURE_KINDS}
        for kind, path in self.paths.items():
            if not os.path.exists(path):
                p = ctx.Process(target=_synth_job, args=(kind, path))
                p.start()
                self.procs[kind] = p

    def get(self, kind: str) -> np.ndarray:
        t0 = time.perf_counter()
        p = self.procs.pop(kind, None)
        if p is not None:
            p.join()
            if p.exitcode != 0:
                raise RuntimeError(f"synthesis of the {kind} capture failed "
                                   f"(exit code {p.exitcode})")
        sig = np.load(self.paths[kind])
        emit({"phase": f"capture_{kind}", "samples": int(sig.shape[0]),
              "waited_s": time.perf_counter() - t0})
        return sig

    def stop(self):
        for p in self.procs.values():
            p.terminate()
        for p in self.procs.values():
            p.join()
        self.procs.clear()


CARD = {}


def emit(rec: dict) -> None:
    print(json.dumps({**rec, **CARD}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# K1's blocks per channel held to its plain version: one, two, and the
# count the wrapper chooses (None)
K1_BLOCKS = (1, 2, None)


def k1_blocks(setup, dtype=None) -> int:
    """The blocks per channel K1 runs `setup` with on a `dtype` capture
    (int8 where None; fused.blocks_per_channel)."""
    import torch

    from bds3_tpu_torch.track.fused import blocks_per_channel

    return blocks_per_channel(setup.cfg, int(setup.state.cursor.shape[0]),
                              torch.cuda.current_device(),
                              dtype or torch.int8)


def _agreement(cfg, label, st_k, rows_k, st_r, rows_r, tol) -> dict:
    """Asserts a kernel's block against its plain version's within `tol`."""
    import torch

    from bds3_tpu_torch.track.scan import unpack_rows

    k = {n: v.cpu().numpy() for n, v in unpack_rows(cfg, rows_k).items()}
    r = {n: v.cpu().numpy() for n, v in unpack_rows(cfg, rows_r).items()}
    if not np.array_equal(k["blksize"], r["blksize"]):
        raise AssertionError(f"{label}: blksize differs")
    if not torch.equal(st_k.cursor, st_r.cursor):
        raise AssertionError(f"{label}: cursors differ")
    # same sums in another order: correlators and discriminators agree
    # within tol of |a|.mean() + 1 (test_pallas_fused.py:71's scale)
    checked = [n for n in r if n.startswith(("d_", "p11_", "p61_", "p_"))] \
        + ["carr_err", "code_err"]
    abs_err = {n: float(np.abs(k[n] - r[n]).max()) for n in checked}
    scaled = {n: abs_err[n] / (float(np.abs(r[n]).mean()) + 1.0)
              for n in checked}
    bad = {n: e for n, e in scaled.items() if not e <= tol}
    if bad:
        raise AssertionError(f"{label}: kernel vs plain version beyond "
                             f"{tol} scaled: {bad}")
    return {"max_scaled_err": max(scaled.values()),
            "max_abs_err": max(abs_err.values()),
            "tolerance_scaled": tol,
            "epochs": int(k["blksize"].shape[0]),
            "channels": int(k["blksize"].shape[1])}


def compare_block(cfg, capture, setup, label: str, kernel: str = "fused",
                  plain=None, tol: float = TOL) -> dict:
    """One block through a kernel path (a driver.BLOCK_FNS name) and
    through `plain` (a block function; by default the path's plain
    version, track_block_reference), from the same state, on the card;
    asserts agreement within `tol`.  K1 ("fused") runs at each of
    K1_BLOCKS against the one plain block; the result is the worst of
    them, with each count's scaled error under "by_blocks"."""
    import functools

    import torch

    from bds3_tpu_torch.track.driver import BLOCK_FNS
    from bds3_tpu_torch.track.scan import track_block_reference

    plain = plain or track_block_reference
    args = (cfg, capture, setup.tables, setup.consts, setup.state)
    st_r, rows_r = plain(*args)
    fns = {"": BLOCK_FNS[kernel]}
    if kernel == "fused":
        fns = {str(S or f"auto_{k1_blocks(setup, capture.dtype)}"):
               functools.partial(BLOCK_FNS[kernel], _blocks=S)
               for S in K1_BLOCKS}
    res = {}
    for name, fn in fns.items():
        st_k, rows_k = fn(*args)
        torch.cuda.synchronize()
        res[name] = _agreement(cfg, f"{label} {name}".strip(), st_k, rows_k,
                               st_r, rows_r, tol)
    out = max(res.values(), key=lambda r: r["max_scaled_err"])
    out = {**out, "max_abs_err": max(r["max_abs_err"] for r in res.values())}
    if kernel == "fused":
        out["by_blocks"] = {n: r["max_scaled_err"] for n, r in res.items()}
    return out


def time_call(fn, reps: int) -> float:
    """Mean ms per call of fn(), CUDA events, after one warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    for _ in range(reps):
        fn()
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1) / reps


def time_block(fn, setup, capture, reps: int) -> float:
    """Mean ms per call of one block function, CUDA events."""
    return time_call(lambda: fn(setup.cfg, capture, setup.tables,
                                setup.consts, setup.state), reps)


def time_k1_blocks(setup, capture, reps: int) -> dict:
    """K1's block at one block per channel and at the chosen count, in
    turns (S1, S, S, S1), each a time_block of `reps` calls: the mean ms
    of each, the chosen blocks per channel, and the speed-up."""
    import functools

    from bds3_tpu_torch.track.fused import fused_track_block

    S = k1_blocks(setup, capture.dtype)
    fns = {1: functools.partial(fused_track_block, _blocks=1),
           S: functools.partial(fused_track_block, _blocks=S)}
    turns = {1: [], S: []}
    for size in (1, S, S, 1):
        turns[size].append(time_block(fns[size], setup, capture, reps))
    ms = {size: float(np.mean(t)) for size, t in turns.items()}
    return {"blocks_per_channel": S, "kernel_block_ms": ms[S],
            "kernel_block_ms_blocks1": ms[1],
            "kernel_block_ms_turns": {str(k): v for k, v in turns.items()},
            "blocks_speedup": ms[1] / ms[S]}


# H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit): FP32 outside
# the tensor cores, and HBM3 bandwidth
FP32_PEAK = 67e12     # operations per second
HBM_PEAK = 3.35e12    # bytes per second


def roofline_ms(ops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take for `ops` float32 operations
    moving `nbytes` bytes: the larger of the two bounds, and which."""
    t_ops, t_bytes = ops / FP32_PEAK, nbytes / HBM_PEAK
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def track_fused_bound(cfg, blksize: np.ndarray, span: int,
                      sample_bytes: int = 1) -> dict:
    """K1's bound for one launch whose epochs had these lengths
    (blksize (W, C)) and whose channels read `span` capture samples of
    `sample_bytes` each (1 int8, 4 float32, 8 complex64).
    Operations per sample: the carrier (2 multiplies and 3 adds for the
    phase, its mod, the angle multiply, one sine and one cosine, the two
    mixed products: 10; a complex sample's mix takes 4 products and 2
    adds: 4 more); per bank of taps that share a chip grid (one, or two
    for B1C wideband) two multiplies for the sample's ramp terms and, for
    each of E/P/L, 3 adds and a ceil for the chip index (14); per tap six
    multiply-adds (12).  Bytes: the capture span, the chip tables, the
    rows written."""
    taps = 2 if cfg.use_pilot else 1
    banks = 2 if cfg.wideband else 1
    per_sample = 10 + 14 * banks + 12 * (taps + (1 if cfg.wideband else 0)) \
        + (4 if cfg.complex_input else 0)
    samples = float(blksize.sum())
    n_ch = blksize.shape[1]
    tables = n_ch * (taps * (cfg.code_length * cfg.m_data + 32)
                     + (cfg.code_length * cfg.m_p61 + 32 if cfg.wideband
                        else 0))
    from bds3_tpu_torch.track.scan import slot_names

    rows = blksize.size * 4 * len(slot_names(cfg))
    ms, by = roofline_ms(samples * per_sample,
                         span * sample_bytes + tables + rows)
    return {"bound_ms": ms, "bound_by": by, "ops_per_sample": per_sample,
            "samples": samples}


def k1_bound(setup, capture) -> dict:
    """K1's bound (track_fused_bound) for one block of `setup` on
    `capture`, from this run's epoch lengths and span (one extra launch,
    outside any counted run)."""
    from bds3_tpu_torch.track.fused import fused_track_block
    from bds3_tpu_torch.track.scan import unpack_rows

    _, rows = fused_track_block(setup.cfg, capture, setup.tables,
                                setup.consts, setup.state)
    blk = unpack_rows(setup.cfg, rows)["blksize"].cpu().numpy()
    cur = setup.state.cursor.cpu().numpy()
    return track_fused_bound(setup.cfg, blk,
                             int((cur + blk.sum(axis=0)).max() - cur.min()),
                             capture.element_size())


def phase_build() -> float:
    from bds3_tpu_torch import _build

    t0 = time.perf_counter()
    _build.library()
    dt = time.perf_counter() - t0
    log = _build.library_path().with_suffix(".log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln] if log.exists() else []
    emit({"phase": "build", "seconds": dt, "ptxas": ptxas,
          "torch": __import__("torch").__version__,
          "k1_blocks": k1_blocks_choice()})
    return dt


def k1_blocks_choice() -> dict:
    """K1's blocks per channel at the main shapes (20-epoch blocks): the
    blocks the card holds at once and the count chosen; fails unless the
    preset and B2a at 12 channels run more than one block a channel."""
    import torch

    from bds3_tpu_torch.track import fused
    from bds3_tpu_torch.track.state import make_track_config

    dev = torch.cuda.current_device()
    out = {}
    for label, s, n_ch in (("b1c_wb_preset_10ch", b1c_preset_settings(), 10),
                           ("b1c_nb_10ch", b1c_full_settings(), 10),
                           ("b2a_12ch", full_settings(), 12)):
        cfg = make_track_config(s, epochs_per_block=20)
        out[label] = {"channels": n_ch,
                      "resident_blocks": fused.occupancy(cfg, n_ch, dev),
                      "blocks_per_channel": fused.blocks_per_channel(
                          cfg, n_ch, dev),
                      "smem_bytes": fused._smem_bytes(cfg)}
    for label in ("b1c_wb_preset_10ch", "b2a_12ch"):
        if out[label]["blocks_per_channel"] <= 1:
            raise AssertionError(f"K1 chose one block a channel at {label}: "
                                 f"{out}")
    return out


def phase_kernel_small() -> dict:
    import torch

    from bds3_tpu_torch.config import b2a_settings
    from bds3_tpu_torch.io import synthesize_if
    from bds3_tpu_torch.track.driver import as_capture, setup_tracking

    t0 = time.perf_counter()
    s = b2a_settings(sampling_freq=10e6, intermediate_freq=2.5e6)
    sats = [(19, 777.0, 123.0), (20, -1200.0, 5000.0)]
    sig = synthesize_if(s, [*sat_params(sats[:1], 0.9),
                            *sat_params(sats[1:], 0.7)],
                        n_ms=60.0, noise_std=1.0, seed=6)
    capture = as_capture(sig, torch.device("cuda"))
    setup = setup_tracking(capture, s, make_inits(s, sats, 2), 30, 30)
    res = compare_block(setup.cfg, capture, setup, "10 Msps")
    emit({"phase": "kernel_vs_plain_10msps", **res,
          "seconds": time.perf_counter() - t0})
    return res


def phase_kernel_full() -> dict:
    import torch

    from bds3_tpu_torch.io import synthesize_if
    from bds3_tpu_torch.track.driver import as_capture, setup_tracking

    t0 = time.perf_counter()
    s = full_settings()
    sig = synthesize_if(s, sat_params(FULL_SATS), n_ms=30.0, noise_std=2.0,
                        seed=11)
    capture = as_capture(sig, torch.device("cuda"))
    setup = setup_tracking(capture, s, make_inits(s, FULL_SATS, 12), 20, 20)
    res = compare_block(setup.cfg, capture, setup, "99.375 Msps")
    emit({"phase": "kernel_vs_plain_99msps", **res,
          "seconds": time.perf_counter() - t0})
    return res


B1C_BLENDS = ("composite", "nb", "split", "dotprod")


def phase_kernel_b1c(caps: Captures) -> dict:
    """K1 against track_block_reference at the B1C preset's rate
    (99.375 Msps), 10 channels over the 4 satellites, one 20-epoch block
    from the same state: narrowband, and wideband in each code blend.
    Then one block's time through the kernel and through the plain
    version, narrowband and the preset's wideband composite, with K1's
    bound for that block."""
    import torch

    from bds3_tpu_torch.track.driver import as_capture, setup_tracking
    from bds3_tpu_torch.track.scan import track_block_reference

    capture = as_capture(caps.get("b1c_full"), torch.device("cuda"))
    out = {"phase": "kernel_vs_plain_b1c_99msps"}
    cases = [("nb", b1c_full_settings())] + [
        (f"wb_{b}", b1c_preset_settings(wb_code_blend=b)) for b in B1C_BLENDS]
    for label, s in cases:
        t0 = time.perf_counter()
        setup = setup_tracking(capture, s, make_inits(s, FULL_SATS, 10),
                               20, 20)
        res = compare_block(setup.cfg, capture, setup, f"B1C {label}")
        if label in ("nb", "wb_composite"):
            res.update(
                **time_k1_blocks(setup, capture, reps=5),
                plain_block_ms=time_block(track_block_reference, setup,
                                          capture, reps=2),
                **k1_bound(setup, capture))
            res["bound_share"] = res["bound_ms"] / res["kernel_block_ms"]
        out[label] = {**res, "seconds": time.perf_counter() - t0}
    emit(out)
    return out


def iq8(s):
    """`s` for an IQ8 capture (interleaved int8 I/Q, tracked as complex)."""
    from bds3_tpu_torch.config import FileType

    return dataclasses.replace(s, file_type=FileType.IQ8)


# K1's instances, by the capture dtype each reads
K1_KINDS = ("int8", "float32", "complex64")


def _bits_equal(a, b) -> bool:
    import torch

    return a.dtype == b.dtype and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def phase_kernel_iq() -> dict:
    """K1's float32 and complex64 instances against the plain version on
    the card: one 20-epoch block from the same state, B2a 12 channels and
    the B1C preset (wideband composite, 10 channels) at 99.375 Msps, at
    each of K1_CLUSTERS (blksize and cursors exact, correlators within
    TOL): complex64 on an IQ8 capture of FULL_SATS rendered on the card
    and widened there, float32 on a real capture's cast.  Then the
    identities, bit for bit: K1 on capture.float() and on capture + 0j
    equals K1 on the int8 capture.  At B2a, one block's time through each
    instance at its chosen blocks per channel in turns (int8, float32,
    complex64, complex64, float32, int8), the plain version's, and each
    bound."""
    import torch

    from bds3_tpu_torch.io.render import render_if
    from bds3_tpu_torch.io.transport import widen_iq8
    from bds3_tpu_torch.track.driver import setup_tracking
    from bds3_tpu_torch.track.fused import fused_track_block
    from bds3_tpu_torch.track.scan import track_block_reference

    dev = torch.device("cuda")
    out = {"phase": "kernel_vs_plain_iq"}
    for label, s, n_ch in (("b2a_12ch", full_settings(), 12),
                           ("b1c_wb_preset_10ch", b1c_preset_settings(), 10)):
        t0 = time.perf_counter()
        n_ms = 25 * s.int_time * 1e3
        sats = sat_params(FULL_SATS)
        real = render_if(s, sats, n_ms, dev, noise_std=2.0, seed=11)
        caps = {"int8": real, "float32": real.float(),
                "complex64": widen_iq8(render_if(iq8(s), sats, n_ms, dev,
                                                 noise_std=2.0, seed=11))}
        inits = make_inits(s, FULL_SATS, n_ch)
        setups = {k: setup_tracking(c, s, inits, 20, 20)
                  for k, c in caps.items()}
        res = {k: compare_block(setups[k].cfg, caps[k], setups[k],
                                f"{label} {k}") for k in K1_KINDS[1:]}
        st8, rows8 = fused_track_block(setups["int8"].cfg, real,
                                       setups["int8"].tables,
                                       setups["int8"].consts,
                                       setups["int8"].state)
        for k, same in (("float32", caps["float32"]),
                        ("complex64", real.to(torch.complex64))):
            setup = setup_tracking(same, s, inits, 20, 20)
            st, rows = fused_track_block(setup.cfg, same, setup.tables,
                                         setup.consts, setup.state)
            torch.cuda.synchronize()
            if not (_bits_equal(rows, rows8) and _bits_equal(st.statef,
                                                             st8.statef)
                    and torch.equal(st.cursor, st8.cursor)):
                raise AssertionError(f"{label}: K1 {k} on the int8 "
                                     "capture's values differs from K1 int8")
            res[k]["equals_int8_bit_for_bit"] = True
        if label == "b2a_12ch":
            turns = {k: [] for k in K1_KINDS}
            for k in K1_KINDS + K1_KINDS[::-1]:
                turns[k].append(time_block(fused_track_block, setups[k],
                                           caps[k], reps=10))
            for k in K1_KINDS:
                res.setdefault(k, {}).update(
                    ms=float(np.mean(turns[k])), ms_turns=turns[k],
                    blocks_per_channel=k1_blocks(setups[k], caps[k].dtype),
                    plain_ms=time_block(track_block_reference, setups[k],
                                        caps[k], reps=2),
                    **k1_bound(setups[k], caps[k]))
                res[k]["bound_share"] = res[k]["bound_ms"] / res[k]["ms"]
        out[label] = {**res, "seconds": time.perf_counter() - t0}
        del caps, setups, real
    emit(out)
    return out


def phase_track_iq8(int8_run: dict) -> dict:
    """The 2.2 s B2a capture of FULL_SATS at 99.375 Msps as IQ8, rendered
    on the card as int8 pairs and widened there to complex64, 12 channels,
    2000 epochs through track() "auto" (K1's complex instance), cold then
    warm with the launch counts set to 0 just before the warm run: 12/12
    locked; the real-time factor beside the int8 capture's
    (track_99msps_12ch), and the bytes the card holds."""
    import torch

    from bds3_tpu_torch.io.render import render_if
    from bds3_tpu_torch.io.transport import widen_iq8
    from bds3_tpu_torch.track import fused

    s = iq8(full_settings())
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    pairs = render_if(s, sat_params(FULL_SATS), FULL_MS, dev, noise_std=2.0,
                      seed=11)
    capture = widen_iq8(pairs)
    pairs_bytes = pairs.numel() * pairs.element_size()
    del pairs
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    n_ep = 2000
    trk, cold, warm, launches = _timed_track(
        capture, s, make_inits(s, FULL_SATS, 12), n_ep)
    if trk.correlator != fused.KERNEL_NAME or launches["track_fused"] <= 0 \
            or capture.dtype != torch.complex64:
        raise AssertionError(f"IQ8 track ran {trk.correlator!r} on a "
                             f"{capture.dtype} capture, launches {launches}")
    locked = lock_count(trk, 500)
    if locked != 12:
        raise AssertionError(f"IQ8: {locked}/12 channels locked")
    out = {"phase": "track_iq8_99msps_12ch", "epochs": n_ep, "channels": 12,
           "locked": locked, "launches": launches, "cold_s": cold,
           "warm_s": warm, "ms_per_epoch": warm / n_ep * 1e3,
           "realtime_factor": n_ep * s.int_time / warm,
           "int8_realtime_factor": int8_run["realtime_factor"],
           "render_on_card_s": render_s, "samples": int(capture.shape[0]),
           "capture_bytes": capture.numel() * capture.element_size(),
           "pairs_bytes": pairs_bytes,
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(dev)}
    del capture
    emit(out)
    return out


def phase_receiver_iq8() -> dict:
    """run_receiver on the receiver_e2e scenario (20 Msps, 11.5 s, 5
    satellites, seeds 3 and 1) rendered on the card as IQ8 (int8 pairs,
    render_scenario with synth.py's IQ convention), handed over as the
    pairs tensor, which the receiver widens there: 5 channels, K1 launched
    on the complex capture, >= 3 fixes, median 3D error < 1 m."""
    import torch

    from bds3_tpu_torch.io.render import render_scenario
    from bds3_tpu_torch.io.scenario import make_scenario

    s = iq8(e2e_settings())
    t0 = time.perf_counter()
    pairs = render_scenario(make_scenario(s, RX_TRUTH, n_sats=5, seed=3),
                            torch.device("cuda"), noise_std=2.0,
                            amplitude=0.7, seed=1)
    torch.cuda.synchronize()
    synth_s = time.perf_counter() - t0
    _, out = drive_receiver("receiver_iq8_e2e", pairs, s, 250, 3, 1.0,
                            synth_on_card_s=synth_s,
                            samples=int(pairs.shape[0]))
    del pairs
    return out


def _check_fixes(nav, min_fixes: int, max_median_m: float) -> tuple:
    if nav is None:
        raise AssertionError("no navigation solution")
    ok = np.isfinite(nav.x)
    err = np.sqrt((nav.x[ok] - RX_TRUTH[0]) ** 2
                  + (nav.y[ok] - RX_TRUTH[1]) ** 2
                  + (nav.z[ok] - RX_TRUTH[2]) ** 2)
    med = float(np.median(err)) if ok.any() else float("inf")
    if ok.sum() < min_fixes or not med < max_median_m:
        raise AssertionError(f"{int(ok.sum())} fixes, median 3D error "
                             f"{med:.3f} m (need >= {min_fixes} and < "
                             f"{max_median_m} m)")
    return int(ok.sum()), med


def _check_ephemerides(nav, truth: dict) -> int:
    ephs = nav.ephemerides
    wrong = [p for p, e in ephs.items() if abs(e.m_0 - truth[p].m_0) > 1e-9]
    if len(ephs) < 4 or wrong:
        raise AssertionError(f"{len(ephs)} ephemerides decoded, m_0 wrong "
                             f"for PRNs {wrong} (need >= 4, all true)")
    return len(ephs)


def drive_receiver(phase: str, sig, s, epochs_per_block: int,
                   min_fixes: int, max_median_m: float, truth=None,
                   **extra):
    """run_receiver on the card, with the launch counts set to 0 just
    before it and read just after: 5 channels, tracking through K1, the
    fixes and, given the true ephemerides, the decoded ones checked.
    Emits the phase's line (with `extra`); returns (results, that line)."""
    import torch

    from bds3_tpu_torch.receiver import run_receiver
    from bds3_tpu_torch.track import fused

    t0 = time.perf_counter()
    _reset_launch_counts()
    res = run_receiver(sig, s, epochs_per_block=epochs_per_block,
                       verbose=False, device="cuda")
    torch.cuda.synchronize()
    launches = _launch_counts()
    wall = time.perf_counter() - t0
    if len(res.channels) != 5:
        raise AssertionError(f"{phase}: {len(res.channels)} channels, "
                             f"expected 5: {[c.prn for c in res.channels]}")
    if launches["track_fused"] <= 0 \
            or res.track.correlator != fused.KERNEL_NAME:
        raise AssertionError(f"{phase}: tracking did not run the tracking "
                             f"kernel (launches={launches}, "
                             f"correlator={res.track.correlator!r})")
    out = {"phase": phase, "channels": len(res.channels),
           "kernel_launches": launches, "correlator": res.track.correlator,
           "epochs": int(res.track.n_epochs)}
    if truth is not None:
        out["ephemerides"] = _check_ephemerides(res.nav, truth)
    out["fixes"], out["median_3d_err_m"] = _check_fixes(
        res.nav, min_fixes, max_median_m)
    out.update(wall_s=wall,
               lock_ok=[bool(h["lock_ok"]) for h in res.health],
               **{k: float(v) for k, v in res.timings.items()}, **extra)
    emit(out)
    return res, out


def phase_receiver(caps: Captures) -> dict:
    import torch

    from bds3_tpu_torch.track.driver import as_capture, setup_tracking

    from bds3_tpu_torch.receiver import run_receiver

    s = e2e_settings()
    sig = caps.get("e2e")
    res, out = drive_receiver("receiver_e2e", sig, s, 250, 3, 1.0)

    # the float32 cast of the same capture: K1's float32 instance reads the
    # same values, so tracking is exactly the int8 run's
    _reset_launch_counts()
    res32 = run_receiver(sig.astype(np.float32), s, epochs_per_block=250,
                         verbose=False, device="cuda")
    torch.cuda.synchronize()
    launches = _launch_counts()
    t8, t32 = res.track, res32.track
    same = sorted(t32.outputs) == sorted(t8.outputs) and all(
        np.array_equal(t32.outputs[k], t8.outputs[k]) for k in t8.outputs) \
        and np.array_equal(t32.absolute_sample, t8.absolute_sample)
    if not same or launches["track_fused"] <= 0:
        raise AssertionError(f"float32 receiver: tracking equal {same}, "
                             f"launches {launches}")
    out["float32"] = {"tracking_equal": same, "kernel_launches": launches,
                      "fixes": 0 if res32.nav is None
                      else int(np.isfinite(res32.nav.x).sum()),
                      **{k: float(v) for k, v in res32.timings.items()}}
    emit({"phase": "receiver_e2e_float32", **out["float32"]})

    # the kernel against its plain version at this path's shapes
    capture = as_capture(sig, torch.device("cuda"))
    setup = setup_tracking(capture, s, res.channels, 250, 250)
    cmp = compare_block(setup.cfg, capture, setup, "receiver shapes")
    emit({"phase": "kernel_vs_plain_receiver_shapes", **cmp})
    return {**out, "cmp": cmp}


def phase_full_rate(caps: Captures) -> dict:
    import torch

    from bds3_tpu_torch.acquire.pcps import acquire
    from bds3_tpu_torch.receiver import acquisition_signal_length
    from bds3_tpu_torch.track import prefix
    from bds3_tpu_torch.track.driver import (
        as_capture, assemble_results, run_blocks, setup_tracking, track)
    from bds3_tpu_torch.track.scan import track_block_reference

    s = full_settings()
    sig = caps.get("full")
    dev = torch.device("cuda")
    capture = as_capture(sig, dev)
    torch.cuda.synchronize()

    acq_s = []
    for _ in range(2):          # cold (tables, FFT plans), then warm
        t0 = time.perf_counter()
        acq = acquire(capture[: acquisition_signal_length(s)], s,
                      device=dev)
        acq_s.append(time.perf_counter() - t0)
    found = sorted(int(p) for p in acq.detected_prns())
    want = sorted(p for p, _, _ in FULL_SATS)
    if found != want:
        raise AssertionError(f"acquisition detected {found}, expected {want}")
    emit({"phase": "acquire_99msps", "prns_searched": len(acq.prns),
          "detected": found, "cold_s": acq_s[0], "warm_s": acq_s[1]})

    inits = make_inits(s, FULL_SATS, 12)
    n_ep = 2000
    trk_s = []
    for _ in range(2):          # cold, then warm
        t0 = time.perf_counter()
        trk = track(capture, s, inits, n_epochs=n_ep, epochs_per_block=n_ep,
                    device=dev)
        trk_s.append(time.perf_counter() - t0)
    if trk.n_epochs != n_ep:
        raise AssertionError(f"tracked {trk.n_epochs} epochs, expected {n_ep}")
    locked = lock_count(trk, 500)
    if locked != 12:
        raise AssertionError(f"{locked}/12 channels locked")

    # the same tracking through the plain version, on the card
    setup = setup_tracking(capture, s, inits, n_ep, n_ep)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = run_blocks(setup, capture, track_block_reference)
    plain = assemble_results(setup, rows, s, n_ep, "reference")
    plain_s = time.perf_counter() - t0

    k1 = time_k1_blocks(setup, capture, reps=2)
    bound = k1_bound(setup, capture)
    plain_ms = time_block(track_block_reference, setup, capture, reps=1)
    seconds_tracked = n_ep * s.int_time
    out = {"phase": "track_99msps_12ch", "epochs": n_ep, "channels": 12,
           "locked": locked, "cold_s": trk_s[0], "warm_s": trk_s[1],
           "ms_per_epoch": trk_s[1] / n_ep * 1e3,
           "realtime_factor": seconds_tracked / trk_s[1],
           "plain_track_s": plain_s,
           "plain_realtime_factor": seconds_tracked / plain_s,
           "plain_locked": lock_count(plain, 500),
           **k1, "plain_block_ms": plain_ms, **bound,
           "bound_share": bound["bound_ms"] / k1["kernel_block_ms"]}
    emit(out)

    # the same 2000 epochs through the prefix-sum path and its kernel
    bk_s = []
    for _ in range(2):          # cold, then warm
        t0 = time.perf_counter()
        trk_b = track(capture, s, inits, n_epochs=n_ep, epochs_per_block=n_ep,
                      device=dev, correlator="bucket_pallas")
        bk_s.append(time.perf_counter() - t0)
    if trk_b.correlator != prefix.KERNEL_NAME or trk_b.n_epochs != n_ep:
        raise AssertionError(f"bucket_pallas ran {trk_b.correlator!r} for "
                             f"{trk_b.n_epochs} epochs")
    locked_b = lock_count(trk_b, 500)
    if locked_b != 12:
        raise AssertionError(f"bucket_pallas: {locked_b}/12 channels locked")
    emit({"phase": "track_b2a_99msps_12ch_bucket", "epochs": n_ep,
          "channels": 12, "locked": locked_b, "cold_s": bk_s[0],
          "warm_s": bk_s[1], "ms_per_epoch": bk_s[1] / n_ep * 1e3,
          "realtime_factor": seconds_tracked / bk_s[1],
          "kernel_track_fused_realtime_factor": out["realtime_factor"]})
    return out


def lock_count(trk, last: int) -> int:
    """Channels whose mean |I_P| exceeds 4 mean |Q_P| over the last epochs."""
    ip = np.abs(trk.outputs["d_ip"][:, -last:]).mean(axis=1)
    qp = np.abs(trk.outputs["d_qp"][:, -last:]).mean(axis=1)
    return int((ip > 4 * qp).sum())


def prefix_shapes():
    """(label, settings, channels) of every path here that runs the
    mix+prefix kernel: B1C and B2a at 99.375 Msps, and the B1C receiver
    scenario (6 Msps, 5 channels)."""
    return (("b1c_10ch", b1c_full_settings(), 10),
            ("b2a_12ch", full_settings(), 12),
            ("b1c_e2e_5ch", b1c_e2e_settings(), 5))


def plain_pallas_block():
    """The bucket_pallas block function with the kernel's plain version in
    place of the kernel: what the kernel path is held to, block for
    block."""
    import functools

    from bds3_tpu_torch.track.prefix import mix_prefix_reference
    from bds3_tpu_torch.track.scan import pallas_prefix, track_block_bucket

    return functools.partial(
        track_block_bucket,
        prefix_fn=functools.partial(pallas_prefix, mix=mix_prefix_reference))


def prefix_inputs(n_ch: int, n: int) -> tuple[np.ndarray, ...]:
    """K2's inputs at one shape: random samples and phases
    (tests/test_pallas_prefix.py's) in a capture of 3n samples, cursors
    spread over it with two windows past its end, a third of the windows
    with blk < n: (capture, cursor, blk, base, slope)."""
    from bds3_tpu_torch.track import prefix

    total = 3 * n
    capture, base, slope = prefix.random_inputs(7, n_ch, n, total)
    cursor = np.linspace(0, 2 * n, n_ch).astype(np.int64)
    cursor[-2:] = (total - n // 2, total - 1000)
    blk = np.full(n_ch, n - 2, np.int64)
    blk[::3] = n - 5000
    return capture, cursor, blk, base, slope


def prefix_bound(capture, cursor, blk, base, n: int) -> tuple[float, str]:
    """K2's bound: each valid sample read once (1 byte in int8, 4 in
    float32), the two float32 prefix rows (n + 1 each) written once, the
    phase tables read; 12 operations a sample (the carrier as in
    track_fused_bound's 10, and one add for each prefix)."""
    valid = np.clip(np.minimum(blk, n), 0, len(capture) - cursor).sum()
    return roofline_ms(12.0 * valid,
                       valid * capture.itemsize + 2 * len(cursor) * (n + 1) * 4
                       + base.nbytes)


def with_fractions(capture: np.ndarray, seed: int = 8) -> np.ndarray:
    """K2's float32 input: the int8 samples plus a uniform fraction in
    [-0.5, 0.5), the capture of a front end that does not quantize."""
    frac = np.random.default_rng(seed).random(len(capture)) - 0.5
    return (capture + frac).astype(np.float32)


def _prefix_float32(label: str, host, n: int, chk: dict) -> dict:
    """K2's float32 instance at one shape: on the int8 capture's values as
    float32 it must give the int8 instance's result (chk, _prefix_check's)
    bit for bit; on with_fractions samples _prefix_check holds it to its
    plain version and the oracle.  Returns that check."""
    from bds3_tpu_torch.track import prefix

    args = chk["args"]
    same = prefix.mix_prefix(args[0].float(), *args[1:])
    if not all(np.array_equal(t.cpu().numpy(), want)
               for t, want in zip(same, chk["result"])):
        raise AssertionError(f"mix_prefix {label}: the float32 instance on "
                             "capture.float() differs from the int8 one")
    return _prefix_check(f"{label} float32",
                         (with_fractions(host[0]),) + tuple(host[1:]), n)


def device_time(fn, reps: int = 20) -> tuple[float | None, float]:
    """The device's time per call of fn() (ms) under torch.profiler over
    `reps` calls after a warm one, and its kernel launches per call; (None,
    0) where the profiler saw no device activity.  Each kernel counts its
    mean duration times its launches per call, so an event the profiler
    drops does not shorten the time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = per_name.get(e.name, (0, 0.0))
            per_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    if not per_name:
        return None, 0.0
    calls = {k: max(1, round(n / reps)) for k, (n, _) in per_name.items()}
    ms = sum(us / n * calls[k] for k, (n, us) in per_name.items()) * 1e-3
    kernels = sum(calls[k] for k in calls
                  if not k.startswith(("Memcpy", "Memset")))
    return ms, float(kernels)


def _prefix_check(label: str, host, n: int) -> dict:
    """K2 against its plain version and the float64 oracle within
    PREFIX_TOL, and against a second call bit for bit, each on fresh
    buffers: its errors, the kernel's result and the device arguments."""
    import torch

    from bds3_tpu_torch.track import prefix

    dev = torch.device("cuda")
    args = tuple(torch.from_numpy(a).to(dev) for a in host) + (n,)
    k = prefix.mix_prefix(*args)
    again = prefix.mix_prefix(*args)
    r = prefix.mix_prefix_reference(*args)
    torch.cuda.synchronize()
    o = prefix.mix_prefix_float64(*host, n)
    scale = np.abs(o[0]).max(axis=1, keepdims=True) + 1.0
    kn = tuple(t.cpu().numpy() for t in k)
    rn = tuple(t.cpu().numpy() for t in r)

    def worst(a, b):                  # scaled, over P_i and P_q
        return float(max((np.abs(a[0] - b[0]) / scale).max(),
                         (np.abs(a[1] - b[1]) / scale).max()))

    err = {"kernel_vs_oracle_scaled": worst(kn, o),
           "plain_vs_oracle_scaled": worst(rn, o),
           "kernel_vs_plain_scaled": worst(kn, rn)}
    bad = {key: v for key, v in err.items() if not v <= PREFIX_TOL}
    if bad:
        raise AssertionError(f"mix_prefix {label}: beyond {PREFIX_TOL} "
                             f"of max|P_i|+1: {bad}")
    if not (torch.equal(k[0], again[0]) and torch.equal(k[1], again[1])):
        raise AssertionError(f"mix_prefix {label}: two calls on the same "
                             "inputs differ")
    err["max_abs_err"] = float(max(np.abs(kn[0] - rn[0]).max(),
                                   np.abs(kn[1] - rn[1]).max()))
    err["max_abs_P"] = float(scale.max())
    return {"err": err, "result": kn, "args": args}


def prefix_edge_cases():
    """(label, n, cursor, blk) of the edge windows, in a 50,000-sample
    capture: a window shorter than one tile, n = 1, blk <= 0, cursors
    below 0 and past the capture's end."""
    total = 50_000
    return (("n_lt_tile", 3000, [0, 1234, total - 100], [3000, 2000, 3000]),
            ("n_1", 1, [0, 5, total - 1], [1, 1, 0]),
            ("blk_le_0", 3 * 4096 + 5, [0, 100, 200], [0, -7, 3 * 4096 + 5]),
            ("cursor_below_0", 2 * 4096 + 17, [-5000, -1, -20_000],
             [10**6] * 3),
            ("cursor_past_end", 2 * 4096 + 17, [total, total + 5, total - 3],
             [2 * 4096 + 17] * 3))


def phase_prefix() -> dict:
    """mix_prefix against its plain version and the float64 oracle at the
    epoch widths of prefix_shapes (prefix_inputs) and at the edge windows
    of prefix_edge_cases, within PREFIX_TOL.  Every call is repeated on
    fresh buffers and must give the same bits.  One scratch, made for the
    largest shape, serves the shapes' windows at two sets of cursors and
    every edge window, and must give what fresh buffers give, bit for bit;
    edge windows that read no sample must be all zeros.  Times at each
    shape: back-to-back calls with output and scratch made once (ms),
    made anew each call (ms_alloc), the plain version, and one
    torch.cumsum over a pre-mixed (2C, n) float32 tensor: a scan that does
    less work than K2 (no mix and no carry; it reads 4 bytes a sample and
    component), not a call that computes the same function; then, after
    all of them, the device's own time under the profiler.  main() runs
    this phase last.

    K2's float32 instance goes through the same at every shape and edge
    window (_prefix_float32: bit for bit the int8 instance on
    capture.float(), within PREFIX_TOL on samples with fractions), with
    its times and its byte bound (4 bytes a sample read) at each shape
    under "float32"."""
    import functools

    import torch

    from bds3_tpu_torch.track import prefix
    from bds3_tpu_torch.track.state import make_track_config

    dev = torch.device("cuda")
    out = {"phase": "prefix_vs_plain", "tolerance_scaled": PREFIX_TOL,
           "scan_only": "one torch.cumsum over pre-mixed (2C, n) float32: "
                        "less work than K2 (no mix, no carry), not the "
                        "same function"}
    shapes = [(label, n_ch, make_track_config(s).n_max)
              for label, s, n_ch in prefix_shapes()]
    runs = {}                         # each shape's call, buffers made once
    runs32 = {}                       # the same, float32 instance
    shared = torch.zeros(max([prefix.scratch_words(c, n)
                              for _, c, n in shapes]
                             + [prefix.scratch_words(len(cursor), n)
                                for _, n, cursor, _ in prefix_edge_cases()]),
                         dtype=torch.int64, device=dev)
    for label, n_ch, n in shapes:
        t0 = time.perf_counter()
        host = prefix_inputs(n_ch, n)
        chk = _prefix_check(label, host, n)
        args = chk["args"]
        for shift in (0, 12_345):             # the shared scratch
            moved = (args[0], args[1] + shift) + args[2:]
            want = prefix.mix_prefix(*moved)
            got = prefix.mix_prefix(*moved, scratch=shared)
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise AssertionError(f"mix_prefix {label}: the shared "
                                     f"scratch changed the result (+{shift})")
        bufs, scratch = prefix.buffers(n_ch, n, dev)
        runs[label] = functools.partial(prefix.mix_prefix, *args, out=bufs,
                                        scratch=scratch)
        kernel_ms = time_call(runs[label], reps=20)
        alloc_ms = time_call(lambda: prefix.mix_prefix(*args), reps=20)
        plain_ms = time_call(lambda: prefix.mix_prefix_reference(*args),
                             reps=5)
        mixed = torch.randn(2 * n_ch, n, device=dev)
        scanned = torch.empty_like(mixed)
        scan_ms = time_call(lambda: torch.cumsum(mixed, 1, out=scanned),
                            reps=20)
        bound_ms, bound_by = prefix_bound(*host[:4], n)
        chk32 = _prefix_float32(label, host, n, chk)
        args32 = chk32["args"]
        bufs32, scratch32 = prefix.buffers(n_ch, n, dev)
        runs32[label] = functools.partial(prefix.mix_prefix, *args32,
                                          out=bufs32, scratch=scratch32)
        bound32_ms, bound32_by = prefix_bound(with_fractions(host[0]),
                                              *host[1:4], n)
        f32 = {**chk32["err"], "bound_ms": bound32_ms,
               "bound_by": bound32_by,
               "kernel_ms": time_call(runs32[label], reps=20),
               "plain_ms": time_call(
                   lambda: prefix.mix_prefix_reference(*args32), reps=5)}
        out[label] = {"channels": n_ch, "n": n, **chk["err"],
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "kernel_ms": kernel_ms, "kernel_ms_alloc": alloc_ms,
                      "plain_ms": plain_ms, "scan_only_ms": scan_ms,
                      "float32": f32,
                      "seconds": time.perf_counter() - t0}
        del mixed, scanned
    edges = {}
    for label, n, cursor, blk in prefix_edge_cases():
        capture, base, slope = prefix.random_inputs(9, len(cursor), n,
                                                    50_000)
        host = (capture, np.array(cursor, np.int64), np.array(blk, np.int64),
                base, slope)
        chk = _prefix_check(label, host, n)
        got = prefix.mix_prefix(*chk["args"], scratch=shared)
        got = tuple(t.cpu().numpy() for t in got)
        if not all(np.array_equal(g, w) for g, w in zip(got, chk["result"])):
            raise AssertionError(f"mix_prefix {label}: the shared scratch "
                                 "changed the result")
        reads = ((np.minimum(host[2], n) > 0) & (host[1] < 50_000)
                 & (host[1] + n > 0))
        if np.stack(got)[:, ~reads].any():
            raise AssertionError(f"mix_prefix {label}: a window that reads "
                                 "no sample is not all zeros")
        edges[label] = {"n": n, **chk["err"],
                        "float32": _prefix_float32(label, host, n,
                                                   chk)["err"]}
    out["edges"] = edges
    # the device's own time, after every CUDA-event time of the phase
    for row, run in [(out[label], r) for label, r in runs.items()] \
            + [(out[label]["float32"], r) for label, r in runs32.items()]:
        device_ms, kernels = device_time(run)
        busy = device_ms if device_ms is not None else row["kernel_ms"]
        row.update(
            device_ms=device_ms, kernels_per_call=kernels,
            device_ms_source=("profiler" if device_ms is not None
                              else "cuda_events"),
            bounded_by=("host" if row["kernel_ms"] > 1.2 * busy
                        else "device"),
            share_of_bound=row["bound_ms"] / busy)
    emit(out)
    return out


def phase_bucket_compare(caps: Captures) -> dict:
    """One 20-epoch block through bucket_pallas (the mix+prefix kernel),
    from the same state, at 99.375 Msps: against the same path with the
    kernel's plain version (TOL), and against the plain bucket block, whose
    per-sample carrier phase rounds differently from the per-tile phase
    (BUCKET_TOL, the tolerance between the reference's own bucket and
    bucket_pallas paths, tests/test_correlator_equiv.py:52).  The same
    block on capture.float() (K2's float32 instance) must give the int8
    block's rows and state bit for bit."""
    import torch

    from bds3_tpu_torch.track import prefix
    from bds3_tpu_torch.track.driver import (
        BLOCK_FNS, as_capture, setup_tracking)

    plain_pallas = plain_pallas_block()
    out = {"phase": "bucket_vs_plain_99msps"}
    for label, s, kind, n_ch in (
            ("b2a_12ch", full_settings(), "full", 12),
            ("b1c_nb_10ch", b1c_full_settings(), "b1c_full", 10)):
        capture = as_capture(caps.get(kind), torch.device("cuda"))
        setup = setup_tracking(capture, s, make_inits(s, FULL_SATS, n_ch),
                               20, 20)
        out[label] = compare_block(setup.cfg, capture, setup, label,
                                   "bucket_pallas", plain_pallas)
        out[f"{label}_vs_bucket"] = compare_block(
            setup.cfg, capture, setup, f"{label} vs bucket",
            "bucket_pallas", BLOCK_FNS["bucket"], tol=BUCKET_TOL)
        before = prefix.mix_prefix.launches
        runs = [BLOCK_FNS["bucket_pallas"](setup.cfg, cap, setup.tables,
                                           setup.consts, setup.state)
                for cap in (capture, capture.float())]
        torch.cuda.synchronize()
        (st_i, rows_i), (st_f, rows_f) = runs
        if not (torch.equal(rows_f, rows_i)
                and all(torch.equal(a, b) for a, b in zip(st_f, st_i))):
            raise AssertionError(f"bucket_pallas {label}: the float32 "
                                 "capture's block differs from the int8 one")
        out[f"{label}_float32"] = {
            "equal_to_int8": True,
            "k2_launches": prefix.mix_prefix.launches - before}
        del capture, runs
    emit(out)
    return out


def phase_acquire_b1c_preset(caps: Captures) -> dict:
    """The preset's resampled acquisition over PRNs 1-63 on the 99.375 Msps
    capture with 4 satellites: exactly those 4 must be found.  Then the
    card's resampler (torch.fft) against the host scipy filter on the
    acquisition window, in the interior."""
    import torch

    from bds3_tpu_torch.acquire import resample
    from bds3_tpu_torch.acquire.pcps import acquire
    from bds3_tpu_torch.receiver import acquisition_signal_length
    from bds3_tpu_torch.track.driver import as_capture

    s = b1c_preset_settings()       # its PRN list is 1-63
    sig = caps.get("b1c_full")
    dev = torch.device("cuda")
    capture = as_capture(sig, dev)
    n = acquisition_signal_length(s)
    acq_s = []
    for _ in range(2):          # cold (tables, FFT plans), then warm
        t0 = time.perf_counter()
        acq = acquire(capture[:n], s, device=dev)
        acq_s.append(time.perf_counter() - t0)
    found = sorted(int(p) for p in acq.detected_prns())
    want = sorted(p for p, _, _ in FULL_SATS)
    if found != want:
        raise AssertionError(f"B1C preset acquisition detected {found}, "
                             f"expected {want}")
    plan = resample.plan_resample(s)
    t0 = time.perf_counter()
    card = resample.resample_signal_device(capture[:n], s, plan)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = resample.resample_signal(sig[:n], s, plan)
    host_s = time.perf_counter() - t0
    guard = int(3 * 701 * plan.new_fs / plan.old_fs) + 4
    card, host = card.cpu().numpy()[guard:-guard], host[guard:-guard]
    scale = float(np.abs(host).mean())
    err = float(np.abs(card - host).max()) / scale
    if not err <= 5e-3:
        raise AssertionError(f"resampler on the card vs host: {err} of "
                             "mean|host| (limit 5e-3)")
    out = {"phase": "acquire_b1c_preset_99msps", "prns_searched":
           len(acq.prns), "detected": found, "cold_s": acq_s[0],
           "warm_s": acq_s[1], "resampled_fs": plan.new_fs,
           "window_samples": n, "resample_card_s": card_s,
           "resample_host_s": host_s, "resample_scaled_err": err}
    emit(out)
    return out


def _launch_counts():
    from bds3_tpu_torch.benchmarks.mxu_micro import mxu_micro
    from bds3_tpu_torch.track import prefix
    from bds3_tpu_torch.track.fused import fused_track_block

    return {"track_fused": fused_track_block.launches,
            "mix_prefix": prefix.mix_prefix.launches,
            "mxu_micro": mxu_micro.launches}


def _reset_launch_counts():
    from bds3_tpu_torch.benchmarks.mxu_micro import mxu_micro
    from bds3_tpu_torch.track import prefix
    from bds3_tpu_torch.track.fused import fused_track_block

    fused_track_block.launches = 0
    prefix.mix_prefix.launches = 0
    mxu_micro.launches = 0


def _timed_track(capture, s, inits, n_ep, correlator="auto",
                 per_block=None):
    """track() cold, then warm with the launch counts set to 0 just before
    it, in one block or in blocks of `per_block` epochs: (results, cold s,
    warm s, the warm run's launches)."""
    import torch

    from bds3_tpu_torch.track.driver import track

    walls = []
    for _ in range(2):
        _reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trk = track(capture, s, inits, n_epochs=n_ep,
                    epochs_per_block=per_block or n_ep,
                    device=capture.device, correlator=correlator)
        walls.append(time.perf_counter() - t0)
    if trk.n_epochs != n_ep:
        raise AssertionError(f"tracked {trk.n_epochs} epochs, expected {n_ep}")
    return trk, walls[0], walls[1], _launch_counts()


def phase_b1c_track(caps: Captures) -> dict:
    """The B1C preset (wideband, composite blend) at 99.375 Msps, 10
    channels over the 4 satellites, 200 epochs (2 s) through track() with
    "auto" (K1); then narrowband through "auto" (K1), through
    "bucket_pallas" (the prefix-sum path with K2), through "bucket_pallas"
    on capture.float() (K2's float32 instance: every output and epoch
    end must equal the int8 run's) and through the plain "bucket" path.
    Every run must lock 10/10."""
    import torch

    from bds3_tpu_torch.track import fused, prefix
    from bds3_tpu_torch.track.driver import as_capture

    dev = torch.device("cuda")
    capture = as_capture(caps.get("b1c_full"), dev)
    n_ep = 200
    seconds_tracked = n_ep * 0.01
    outs = {}
    for phase, s, runs in (
            ("track_b1c_wb_99msps_10ch", b1c_preset_settings(),
             (("auto", "auto", fused.KERNEL_NAME, "track_fused"),)),
            ("track_b1c_nb_99msps_10ch", b1c_full_settings(),
             (("auto", "auto", fused.KERNEL_NAME, "track_fused"),
              ("bucket_pallas", "bucket_pallas", prefix.KERNEL_NAME,
               "mix_prefix"),
              ("bucket_pallas_float32", "bucket_pallas", prefix.KERNEL_NAME,
               "mix_prefix"),
              ("bucket", "bucket", "bucket", None)))):
        inits = make_inits(s, FULL_SATS, 10)
        out = {"phase": phase, "epochs": n_ep, "channels": 10}
        results = {}
        for label, correlator, ran, kernel in runs:
            cap = capture.float() if label.endswith("float32") else capture
            trk, cold, warm, launches = _timed_track(cap, s, inits, n_ep,
                                                     correlator)
            del cap
            if trk.correlator != ran or (kernel and launches[kernel] <= 0):
                raise AssertionError(
                    f"{phase} {label}: ran {trk.correlator!r}, "
                    f"launches {launches}")
            locked = lock_count(trk, 100)
            if locked != 10:
                raise AssertionError(f"{phase} {label}: {locked}/10 "
                                     "channels locked")
            results[label] = trk
            out[label] = {
                "correlator": trk.correlator, "locked": locked,
                "launches": launches, "cold_s": cold, "warm_s": warm,
                "ms_per_epoch": warm / n_ep * 1e3,
                "realtime_factor": seconds_tracked / warm}
        if "bucket_pallas_float32" in results:
            f32, i8 = results["bucket_pallas_float32"], results["bucket_pallas"]
            if not (np.array_equal(f32.absolute_sample, i8.absolute_sample)
                    and all(np.array_equal(f32.outputs[k], v)
                            for k, v in i8.outputs.items())):
                raise AssertionError(f"{phase}: bucket_pallas on the float32 "
                                     "capture differs from the int8 run")
            out["bucket_pallas_float32"]["equal_to_int8"] = True
        emit(out)
        outs[phase] = out
    return outs


def phase_receiver_b1c(caps: Captures) -> dict:
    """run_receiver on the tests/test_e2e_b1c.py scenario (narrowband), on
    the card: tracking through K1 ("auto")."""
    import torch

    from bds3_tpu_torch.track.driver import as_capture, setup_tracking

    s = b1c_e2e_settings()
    sig = caps.get("b1c_e2e")
    truth = {e.prn: e for e in b1c_scenario().ephemerides}
    res, out = drive_receiver("receiver_b1c_e2e", sig, s, 250, 10, 2.0,
                              truth)

    # K1 against its plain version, and the bucket_pallas path (K2)
    # against the same path with K2's plain version, one block at this
    # path's shapes.  20 epochs for the bucket path: over a longer closed
    # loop one float32 loop state rounds the other way sooner or later,
    # whatever the two summation orders, and shifts the carrier phase by
    # ~1e-4 cycles, which moves Q by I times that (3e-2 of mean|Q| over
    # 250 epochs)
    capture = as_capture(sig, torch.device("cuda"))
    setup = setup_tracking(capture, s, res.channels, 20, 20)
    cmp = compare_block(setup.cfg, capture, setup, "B1C receiver shapes")
    emit({"phase": "kernel_vs_plain_b1c_receiver_shapes", **cmp})
    cmp_b = compare_block(setup.cfg, capture, setup, "B1C receiver shapes",
                          "bucket_pallas", plain_pallas_block())
    emit({"phase": "bucket_vs_plain_b1c_receiver_shapes", **cmp_b})
    return {**out, "cmp": cmp, "cmp_bucket": cmp_b}


def phase_receiver_b1c_wb(caps: Captures) -> dict:
    """run_receiver on the bench.py:383-431 scenario: B1C wideband ("split"
    blend), 33.125 Msps, IF fs/4, 26 s, 5 satellites (seeds 5 and 2), with
    the preset's resampled acquisition; the capture is rendered on the
    card (io.render.render_scenario).  Tracking through K1."""
    import torch

    from bds3_tpu_torch.io.render import render_scenario
    from bds3_tpu_torch.track.driver import setup_tracking

    s = b1c_wb_e2e_settings()
    sc = b1c_wb_scenario()
    t0 = time.perf_counter()
    capture = render_scenario(sc, torch.device("cuda"), noise_std=2.0,
                              amplitude=1.3, seed=2)
    torch.cuda.synchronize()
    synth_s = time.perf_counter() - t0
    res, out = drive_receiver(
        "receiver_b1c_wb_e2e", capture, s, 500, 10, 2.0,
        {e.prn: e for e in sc.ephemerides}, synth_on_card_s=synth_s,
        samples=int(capture.shape[0]))
    setup = setup_tracking(capture, s, res.channels, 20, 20)
    cmp = compare_block(setup.cfg, capture, setup, "B1C wideband receiver")
    emit({"phase": "kernel_vs_plain_b1c_wb_receiver_shapes", **cmp})
    del capture
    return {**out, "cmp": cmp}


# --- the drivers of the JAX paths -------------------------------------------

DRIVER_STREAM_S = 5   # streaming_demo's seconds: 2 blocks (49 s by default)


def _drive(fn) -> tuple[float, dict, list[str]]:
    """fn() (a driver's main or run) with its standard output captured and
    echoed to standard error, the launch counts set to 0 just before it:
    (wall s, its launches, its output lines)."""
    import contextlib
    import io

    import torch

    buf = io.StringIO()
    _reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            fn()
        torch.cuda.synchronize()
    finally:
        sys.stderr.write(buf.getvalue())
    return time.perf_counter() - t0, _launch_counts(), \
        buf.getvalue().splitlines()


def _drive_in_child(module: str, argv: list[str]) -> tuple[float, dict,
                                                          list[str]]:
    """A driver's main(argv) in a process of its own (profile_trace: a
    torch.profiler run slows later launches of its process, and
    prefix_vs_plain times them later in this one): (wall s, its launches,
    its output lines)."""
    code = (
        "import json, sys\n"
        f"from {module} import main\n"
        "from bds3_tpu_torch.track import prefix\n"
        "from bds3_tpu_torch.track.fused import fused_track_block\n"
        f"rc = main({argv!r})\n"
        "print(json.dumps({'track_fused': fused_track_block.launches, "
        "'mix_prefix': prefix.mix_prefix.launches}))\n"
        "sys.exit(rc)\n")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO))
    wall = time.perf_counter() - t0
    sys.stderr.write(out.stdout + out.stderr[-3000:])
    if out.returncode != 0:
        raise AssertionError(f"{module} exited with {out.returncode}")
    lines = out.stdout.splitlines()
    return wall, json.loads(lines[-1]), lines[:-1]


def phase_drivers(caps: Captures) -> dict:
    """The port's drivers of the JAX paths on the card, each through its
    main at its default length (streaming_demo at DRIVER_STREAM_S), but
    debug_pvt, whose scenario is receiver_e2e's: its run() gets that
    cached capture.  Each must print its PASS line (profile_trace its
    "traced" line and a trace file) and launch K1; each one's wall time
    (its capture's rendering included), length and launches, by name."""
    import torch

    from bds3_tpu_torch.examples import b1c_pipeline_demo, b2a_pipeline_demo
    from bds3_tpu_torch.tools import debug_pvt, streaming_demo
    from bds3_tpu_torch.tools import validate_b1c_chain

    dev = torch.device("cuda")
    trace_dir = os.path.join(REPO, "bds3_tpu_torch", "_build", "trace")
    e2e = caps.get("e2e")
    drivers = (
        ("b2a_pipeline_demo", "6.5 s at 99.375 Msps, 2 satellites",
         lambda: _drive(lambda: b2a_pipeline_demo.main([])), "DEMO PASS"),
        ("b1c_pipeline_demo", "1 s at 99.375 Msps, wideband, 2 satellites",
         lambda: _drive(lambda: b1c_pipeline_demo.main([])), "DEMO PASS"),
        ("debug_pvt", "11.5 s at 20 Msps, 5 satellites (receiver_e2e's "
         "capture)",
         lambda: _drive(lambda: debug_pvt.run(debug_pvt.settings(), e2e,
                                              dev)), "PVT DEBUG PASS"),
        ("validate_b1c_chain", "40 s at 6 Msps, narrowband, 5 satellites",
         lambda: _drive(lambda: validate_b1c_chain.main([])),
         "B1C CHAIN PASS"),
        ("streaming_demo", f"{DRIVER_STREAM_S} s at 99.375 Msps from a file, "
         "12 channels, 2 blocks",
         lambda: _drive(lambda: streaming_demo.main([str(DRIVER_STREAM_S)])),
         "STREAMING DEMO PASS"),
        ("profile_trace", "0.2 s at 99.375 Msps, 12 channels, 198 epochs",
         lambda: _drive_in_child("bds3_tpu_torch.tools.profile_trace",
                                 [trace_dir]),
         "traced 198 epochs x 12 ch in "),
    )
    runs = {}
    for name, length, drive, want in drivers:
        wall, launches, lines = drive()
        hit = [ln for ln in lines if ln.startswith(want)]
        if not hit:
            raise AssertionError(f"{name}: no line starting {want!r}")
        if launches["track_fused"] <= 0:
            raise AssertionError(f"{name}: K1 was not launched ({launches})")
        runs[name] = {"length": length, "wall_s": wall,
                      "k1_launches": launches["track_fused"],
                      "line": hit[-1]}
    if "correlator=track_fused_cuda" not in runs["profile_trace"]["line"] \
            or not os.path.getsize(os.path.join(trace_dir, "trace.json")):
        raise AssertionError("profile_trace: no trace of the kernel path")
    emit({"phase": "drivers", **runs})
    return runs


# --- the parallel paths: ranks side by side on one card --------------------

PARALLEL = os.path.join(REPO, "bds3_tpu_torch", "_build", "parallel")
TS_RTOL, TS_ATOL = 3e-5, 3e-4   # tests/test_timeshard_track.py:52-54
ACQ_RTOL = 1e-5                 # sharded search vs one rank, same card


def parallel_job(phase: str, nproc: int, cases: list, settings: dict,
                 signal_files: dict, arrays: dict | None = None,
                 backend: str = "gloo") -> tuple[dict, float]:
    """Runs `cases` on nproc ranks of parallel.worker, all on cuda:0
    (parallel.launch.launch_local, a FileStore rendezvous): rank 0's
    results, and the seconds of the whole launch."""
    import shutil

    from bds3_tpu_torch.parallel import worker

    d = os.path.join(PARALLEL, phase)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    job, out = os.path.join(d, "job.npz"), os.path.join(d, "out.npz")
    worker.write_job(job, cases, settings, arrays, signal_files)
    t0 = time.perf_counter()
    res = worker.run_job(nproc, job, out, device="cuda:0", backend=backend,
                         store=os.path.join(d, "store"), timeout=600)
    return res, time.perf_counter() - t0


def _outputs(res: dict, case: str) -> dict:
    return {k.split("/", 1)[1]: v for k, v in res.items()
            if k.startswith(case + "/")}


def _k1_ranks(res: dict, case: str, n: int) -> dict:
    """Each rank's tracking-kernel launches and its K1 check; fails unless
    every rank launched K1 and held it to its plain version."""
    launches = res[f"{case}/k1_launches"][:n]
    if not (launches > 0).all():
        raise AssertionError(f"{case}: a rank launched no K1: {launches}")
    eq = np.concatenate([res[f"{case}/k1_check_blksize_equal"],
                         res[f"{case}/k1_check_cursor_equal"]])
    scaled = res[f"{case}/k1_check_scaled_err"]
    if not eq.all() or not (scaled <= TOL).all():
        raise AssertionError(f"{case}: K1 vs plain in a rank: equal "
                             f"{eq.tolist()}, scaled {scaled.tolist()}")
    return {"k1_launches_by_rank": launches.tolist(),
            "k1_check_scaled_err_by_rank": scaled.tolist(),
            "k1_check_abs_err_by_rank":
                res[f"{case}/k1_check_abs_err"].tolist(),
            "rank_wall_s": float(res[f"{case}/wall_s"])}


def _held_to(label: str, got: dict, ref: dict, names, rtol: float,
             atol: float) -> dict:
    """Asserts got's outputs against ref's (blksize exactly); the largest
    absolute difference of each."""
    if not np.array_equal(got["blksize"], ref["blksize"]):
        raise AssertionError(f"{label}: blksize differs")
    diffs = {}
    for k in names:
        diffs[k] = float(np.abs(got[k] - ref[k]).max())
        if not np.allclose(got[k], ref[k], rtol=rtol, atol=atol):
            raise AssertionError(f"{label}: {k} beyond rtol {rtol}, atol "
                                 f"{atol}: {diffs[k]}")
    return diffs


def phase_parallel_channel(caps: Captures) -> dict:
    """parallel_channel_b2a_12ch and parallel_nccl_world1: the bench's
    headline configuration (B2a, 99.375 Msps, 12 channels) on the full
    capture, 2000 epochs in one block through sharded_track_block: on 2
    ranks x 6 channels over gloo, then on a world of one rank over NCCL.
    The gathered rows must equal the parent's own track(), bit for bit;
    every rank holds a 20-epoch K1 block to its plain version."""
    import torch

    from bds3_tpu_torch.parallel import worker
    from bds3_tpu_torch.track.driver import as_capture

    s = full_settings()
    sig = caps.get("full")
    inits = make_inits(s, FULL_SATS, 12)
    n_ep = 2000
    trk, _, warm, one = _timed_track(as_capture(sig, torch.device("cuda")),
                                     s, inits, n_ep)
    ref = trk.outputs
    case = dict(name="channel", mode="channel", settings="s",
                signal="full", inits="inits", epochs=n_ep,
                epochs_per_block=n_ep, warm=True, check_k1=True)
    files = {"full": caps.paths["full"]}
    arrays = {"inits": worker.inits_to_array(inits)}
    outs = {}
    for phase, n, backend in (("parallel_channel_b2a_12ch", 2, "gloo"),
                              ("parallel_nccl_world1", 1, "nccl")):
        res, launch_s = parallel_job(phase, n, [{**case, "n_devices": n}],
                                     {"s": s}, files, arrays, backend)
        got = _outputs(res, "channel")
        names = [k for k in ref if k != "blksize"]
        diffs = _held_to(phase, got, ref, names, 0.0, 0.0)
        out = {"phase": phase, "ranks": n, "backend": backend,
               "channels": 12, "epochs": n_ep,
               "max_abs_diff_vs_one_process": max(diffs.values()),
               **_k1_ranks(res, "channel", n), "launch_s": launch_s,
               "one_process_warm_s": warm,
               "one_process_k1_launches": one["track_fused"]}
        emit(out)
        outs[phase] = out
    return outs


def phase_parallel_time(caps: Captures) -> dict:
    """parallel_time_b2a_12ch: time_sharded_track over 2 ranks on the time
    axis, 2 groups of 6 channels, 2000 epochs on the full capture,
    against the parent's track() at epochs_per_block = 1000."""
    import torch

    from bds3_tpu_torch.parallel import worker
    from bds3_tpu_torch.track.driver import as_capture

    s = full_settings()
    sig = caps.get("full")
    inits = make_inits(s, FULL_SATS, 12)
    n_ep = 2000
    trk, _, warm, _ = _timed_track(as_capture(sig, torch.device("cuda")), s,
                                   inits, n_ep, per_block=1000)
    res, launch_s = parallel_job(
        "parallel_time_b2a_12ch", 2,
        [dict(name="time", mode="time", n_devices=2, settings="s",
              signal="full", inits="inits", epochs=n_ep, n_groups=2,
              warm=True, check_k1=True)],
        {"s": s}, {"full": caps.paths["full"]},
        {"inits": worker.inits_to_array(inits)})
    diffs = _held_to("parallel_time_b2a_12ch", _outputs(res, "time"),
                     trk.outputs, ("d_ip", "d_qp", "carr_err", "code_err"),
                     TS_RTOL, TS_ATOL)
    out = {"phase": "parallel_time_b2a_12ch", "ranks": 2, "groups": 2,
           "channels": 12, "epochs": n_ep, "max_abs_diff": diffs,
           "locked": lock_count(trk, 500), **_k1_ranks(res, "time", 2),
           "launch_s": launch_s, "one_process_warm_s": warm}
    emit(out)
    return out


def phase_parallel_time2d(caps: Captures) -> dict:
    """parallel_time2d_b1c_wb: the B1C preset (wideband QMBOC, composite,
    10 channels, 99.375 Msps) on a ("time", "channel") mesh of (2, 2),
    200 epochs of the b1c_full capture, 100 a time segment, one group of
    10 channels split 5 and 5 over the channel axis; against the parent's
    track() at epochs_per_block = 100, the BOC(6,1) bank included."""
    import torch

    from bds3_tpu_torch.parallel import worker
    from bds3_tpu_torch.track.driver import as_capture

    s = b1c_preset_settings()
    sig = caps.get("b1c_full")
    inits = make_inits(s, FULL_SATS, 10)
    n_ep = 200
    trk, _, warm, _ = _timed_track(as_capture(sig, torch.device("cuda")), s,
                                   inits, n_ep, per_block=100)
    res, launch_s = parallel_job(
        "parallel_time2d_b1c_wb", 4,
        [dict(name="time2d", mode="time2d", n_devices=4, shape=[2, 2],
              settings="s", signal="b1c_full", inits="inits",
              epochs=n_ep, n_groups=1, warm=True, check_k1=True)],
        {"s": s}, {"b1c_full": caps.paths["b1c_full"]},
        {"inits": worker.inits_to_array(inits)})
    got = _outputs(res, "time2d")
    if "p61_ip" not in got:
        raise AssertionError("parallel_time2d_b1c_wb: no BOC(6,1) outputs")
    diffs = _held_to("parallel_time2d_b1c_wb", got, trk.outputs,
                     ("d_ip", "d_qp", "carr_err", "code_err", "p61_ip",
                      "p61_qp"), TS_RTOL, TS_ATOL)
    out = {"phase": "parallel_time2d_b1c_wb", "ranks": 4, "mesh": [2, 2],
           "groups": 1, "channels": 10, "epochs": n_ep,
           "max_abs_diff": diffs, "locked": lock_count(trk, 100),
           **_k1_ranks(res, "time2d", 4), "launch_s": launch_s,
           "one_process_warm_s": warm}
    emit(out)
    return out


def phase_parallel_acq(caps: Captures) -> dict:
    """parallel_acq_b2a: PRN- and Doppler-sharded coarse search over 2
    ranks, 63 PRNs at 99.375 Msps, against the parent's coarse_search on
    the same grid (PRNs padded to 64 with a repeat, bins to 26 with one
    more); then noncoherent_acquire_timesharded over 2 ranks, 4 rounds a
    rank, 63 PRNs x 25 bins, against one rank with 8 rounds: the planted
    satellites win at their bins and the cubes agree within 1e-5."""
    import dataclasses

    import torch

    from bds3_tpu_torch.acquire.pcps import (
        acq_code_tables, coarse_search, make_acq_config)
    from bds3_tpu_torch.parallel.mesh import make_mesh
    from bds3_tpu_torch.parallel.timeshard import (
        noncoherent_acquire_timesharded)
    from bds3_tpu_torch.utils.phase import phase_tables

    s = full_settings()
    sig = caps.get("full")
    dev = torch.device("cuda")
    cfg = make_acq_config(s)
    prns = list(s.acq_satellite_list)
    grids = {"prn": (prns + prns[-1:], cfg.n_bins),
             "doppler": (prns, 2 * -(-cfg.n_bins // 2))}
    rounds = 4
    cases = [dict(name=m, mode=f"acq_{m}", n_devices=2, settings="s",
                  signal="full", prns=p, bins=b, warm=True)
             for m, (p, b) in grids.items()]
    cases.append(dict(name="noncoh", mode="acq_noncoh", n_devices=2,
                      settings="s", signal="full", prns=prns,
                      rounds=rounds, warm=True))
    res, launch_s = parallel_job("parallel_acq_b2a", 2, cases, {"s": s},
                                 {"full": caps.paths["full"]})
    sig_t = torch.from_numpy(np.asarray(sig[: cfg.n_fft], np.float32)).to(dev)
    out = {"phase": "parallel_acq_b2a", "ranks": 2, "prns": len(prns),
           "launch_s": launch_s}
    for m, (p, b) in grids.items():
        d8, p8 = (torch.from_numpy(x).to(dev)
                  for x in acq_code_tables(s, np.asarray(p)))
        freqs = cfg.freq_base + cfg.freq_step * np.arange(b)
        a_b, c1_b = (torch.from_numpy(x).to(dev)
                     for x in phase_tables(freqs, cfg.fs))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v, bb, ph = (x.cpu().numpy() for x in coarse_search(
            sig_t, d8, p8, a_b, c1_b, dataclasses.replace(cfg, n_bins=b)))
        one_s = time.perf_counter() - t0
        n = len(prns)
        got = _outputs(res, m)
        if not (np.array_equal(got["bin"][:n], bb[:n])
                and np.array_equal(got["phase"][:n], ph[:n])):
            raise AssertionError(f"parallel_acq_b2a {m}: winners differ")
        rel = float((np.abs(got["peak"][:n] - v[:n]) / v[:n]).max())
        if not rel <= ACQ_RTOL:
            raise AssertionError(f"parallel_acq_b2a {m}: peaks {rel} apart")
        out[m] = {"peak_max_rel_diff": rel, "bins": b,
                  "rank_wall_s": float(res[f"{m}/wall_s"]),
                  "one_process_s": one_s}

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cube1, f1, p1 = noncoherent_acquire_timesharded(
        make_mesh(1, device=dev), sig, s, prns, 2 * rounds)
    one_s = time.perf_counter() - t0
    got = _outputs(res, "noncoh")
    if not (np.array_equal(got["freq"], f1)
            and np.array_equal(got["phase"], p1)):
        raise AssertionError("parallel_acq_b2a noncoh: winners differ from "
                             "one rank's")
    rel = float((np.abs(got["cube"] - cube1) / np.abs(cube1)).max())
    if not rel <= ACQ_RTOL:
        raise AssertionError(f"parallel_acq_b2a noncoh: cube {rel} apart")
    planted = {}
    for prn, fd, cp in FULL_SATS:
        i = prns.index(prn)
        f_err = float(got["freq"][i] - (s.intermediate_freq + fd))
        rate = s.code_freq_basis * (1 + fd / s.carr_freq_basis)
        expect = ((s.code_length - cp % s.code_length) % s.code_length) \
            / rate * s.sampling_freq
        ph_err = (got["phase"][i] - expect) % s.samples_per_code
        ph_err = float(min(ph_err, s.samples_per_code - ph_err))
        planted[prn] = {"freq_err_hz": f_err, "phase_err_samples": ph_err}
        if abs(f_err) > cfg.freq_step / 2 or ph_err > s.sampling_freq \
                / s.code_freq_basis:
            raise AssertionError(f"parallel_acq_b2a noncoh: PRN {prn} "
                                 f"won at {planted[prn]}")
    out["noncoh"] = {"cube_shape": list(got["cube"].shape),
                     "rounds_per_rank": rounds, "cube_max_rel_diff": rel,
                     "planted": planted,
                     "rank_wall_s": float(res["noncoh/wall_s"]),
                     "one_process_s": one_s}
    emit(out)
    return out


STREAM_TRANSPORTS = ("none", "int4", "int2")


def phase_stream(caps: Captures) -> dict:
    """The 2.2 s, 99.375 Msps B2a capture written to a .bin and tracked
    from a StreamingCapture (12 channels, 2000 epochs, blocks of 500,
    sync_each_block) in each transport, against the resident run of the
    same blocks on the card; the launch counts of the "none" run are set
    to 0 just before it and read just after."""
    import torch

    from bds3_tpu_torch.io.stream import StreamingCapture
    from bds3_tpu_torch.io.transport import upload
    from bds3_tpu_torch.track import fused
    from bds3_tpu_torch.track.driver import as_capture, setup_tracking, track

    s = full_settings()
    sig = caps.get("full")
    path = os.path.join(CAPTURES, "full_v1.bin")
    if not (os.path.exists(path) and os.path.getsize(path) == sig.size):
        tmp = f"{path}.{os.getpid()}.tmp"
        sig.tofile(tmp)
        os.replace(tmp, path)
    dev = torch.device("cuda")
    inits = make_inits(s, FULL_SATS, 12)
    n_ep, W = 2000, 500
    seconds_tracked = n_ep * s.int_time

    def run(src, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trk = track(src, s, inits, n_epochs=n_ep, epochs_per_block=W,
                    device=dev, **kw)
        torch.cuda.synchronize()
        return trk, time.perf_counter() - t0

    capture = as_capture(sig, dev)
    run(capture)                                   # warm
    resident, resident_s = run(capture)
    del capture
    out = {"phase": "stream_b2a_99msps_12ch", "epochs": n_ep,
           "epochs_per_block": W, "channels": 12,
           "file_bytes": int(sig.size),
           "resident_s": resident_s,
           "resident_realtime_factor": seconds_tracked / resident_s}
    streamed = {}
    for transport in STREAM_TRANSPORTS:
        _reset_launch_counts()
        trk, wall = run(StreamingCapture(path), sync_each_block=True,
                        transport=transport)
        launches = _launch_counts()
        if trk.n_epochs != n_ep or trk.correlator != fused.KERNEL_NAME \
                or launches["track_fused"] != n_ep // W:
            raise AssertionError(
                f"streamed {transport}: {trk.n_epochs} epochs through "
                f"{trk.correlator!r}, launches {launches}")
        locked = lock_count(trk, 500)
        if locked != 12:
            raise AssertionError(f"streamed {transport}: {locked}/12 "
                                 "channels locked")
        streamed[transport] = trk
        out[transport] = {"wall_s": wall, "locked": locked,
                          "launches": launches,
                          "realtime_factor": seconds_tracked / wall}

    # "none" reads the resident run's samples: the same epochs, exactly
    got = streamed["none"]
    if not np.array_equal(got.outputs["blksize"],
                          resident.outputs["blksize"]) \
            or not np.array_equal(got.absolute_sample,
                                  resident.absolute_sample):
        raise AssertionError("streamed run: blksize or absolute_sample "
                             "differ from the resident run")
    checked = [n for n in resident.outputs
               if n.startswith(("d_", "p11_"))] + ["carr_err", "code_err"]
    abs_err = max(float(np.abs(got.outputs[n] - resident.outputs[n]).max())
                  for n in checked)
    scaled = max(float(np.abs(got.outputs[n] - resident.outputs[n]).max())
                 / (float(np.abs(resident.outputs[n]).mean()) + 1.0)
                 for n in checked)
    if not scaled <= TOL:
        raise AssertionError(f"streamed vs resident: {scaled} scaled "
                             f"(limit {TOL})")
    out["none"].update(max_abs_err=abs_err, max_scaled_err=scaled)

    # where a streamed block's time goes: the reads alone (the driver's
    # schedule through a StreamingCapture), and the pageable uploads alone
    sched = setup_tracking(sig, s, inits, n_ep, W, dev).schedule
    cap = StreamingCapture(path)
    t0 = time.perf_counter()
    blocks = [cap[a: a + sched.block_len] for a in sched.starts]
    out["read_s"] = time.perf_counter() - t0
    for transport in STREAM_TRANSPORTS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in blocks:
            upload(b, transport, dev)
        torch.cuda.synchronize()
        out[transport]["upload_s"] = time.perf_counter() - t0
    out["block_bytes"] = sched.block_len
    del blocks

    lazy, lazy_s = run(StreamingCapture(path), sync_each_block=True,
                       download=False)
    real = lazy.outputs.realize()
    if lazy.absolute_sample is not None \
            or sorted(real) != sorted(got.outputs) \
            or not all(np.array_equal(real[n], got.outputs[n])
                       for n in real):
        raise AssertionError("download=False: realize() differs from the "
                             "download=True outputs")
    out["lazy"] = {"wall_s": lazy_s,
                   "realtime_factor": seconds_tracked / lazy_s}
    emit(out)
    return out


def mxu_one_call_operands(a, b, variant: str, iters: int):
    """K3's function as the operands of one product of depth iters * K
    (twice that for "split"): a_cat = [a_0 | a_1 | ...] (M, iters K), a_i
    = a + float32(i) * 1e-9 rounded as the plain version rounds it (bf16
    blocks for "bf16"; hi_i and lo_i in turn for "split"), and b_rep = b
    repeated along K to match (float32 for "fp32", else bf16).  The sum of
    all entries of a_cat @ b_rep is K3's scalar."""
    import torch

    M = a.shape[0]
    off = torch.arange(iters, dtype=torch.float32, device=a.device) \
        * torch.tensor(1e-9, dtype=torch.float32, device=a.device)
    ai = a.to(torch.float32)[:, None, :] + off[None, :, None]
    if variant == "fp32":
        parts, bb = [ai], b.to(torch.float32)
    else:
        hi = ai.to(torch.bfloat16)
        parts = [hi] if variant == "bf16" else [
            hi, (ai - hi.to(torch.float32)).to(torch.bfloat16)]
        bb = b.to(torch.bfloat16)
    a_cat = torch.stack(parts, dim=2).reshape(M, -1)
    return a_cat, bb.repeat(iters * len(parts), 1)


def mxu_one_call_mode(variant: str, dev) -> str:
    """How the one call multiplies: "float32" for "fp32" (TF32 off);
    bf16 operands on the CPU "widened" exactly to float32; on a card
    "out_float32" where torch.mm takes out_dtype=torch.float32
    (aten::mm.dtype), else "bf16_out" (cuBLAS's bf16 result, widened)."""
    import torch

    if variant == "fp32":
        return "float32"
    if dev.type == "cpu":
        return "widened"
    x = torch.ones((16, 16), dtype=torch.bfloat16, device=dev)
    try:
        y = torch.mm(x, x, out_dtype=torch.float32)
    except (RuntimeError, TypeError, NotImplementedError):
        return "bf16_out"
    return "out_float32" if y.dtype == torch.float32 else "bf16_out"


def mxu_one_call(a_cat, b_rep, mode: str):
    """The yardstick of K3: one torch.mm (cuBLAS on a card) over the
    operands of mxu_one_call_operands, summed in float32.  Timed in
    chip_smoke only; the port never calls it."""
    import torch

    if mode == "widened":
        return torch.mm(a_cat.to(torch.float32),
                        b_rep.to(torch.float32)).sum()
    if mode == "out_float32":
        return torch.mm(a_cat, b_rep, out_dtype=torch.float32).sum()
    return torch.mm(a_cat, b_rep).to(torch.float32).sum()


def phase_mxu_micro() -> dict:
    """K3 against its plain version on seeded normal inputs: every shape
    of benchmarks/mxu_micro.py:80-89 in every variant at 8 iterations;
    then the bench's mxu_micro stage at 2000 iterations with the launch
    counts set to 0 just before it and read just after; then each shape
    of the bench at 2000 iterations: K3, the plain version and one
    torch.mm over the concatenated operands (mxu_one_call) in turns, K3
    and the one call held to the plain result."""
    import torch

    from bds3_tpu_torch import bench
    from bds3_tpu_torch.benchmarks import mxu_micro as k3

    dev = torch.device("cuda")
    dtypes = {"fp32": (torch.float32, False), "bf16": (torch.bfloat16, False),
              "split": (torch.float32, True)}
    rng = np.random.default_rng(17)
    inputs = {}
    for shape in dict.fromkeys(sum(k3.SHAPES.values(), [])):
        M, K, N = shape
        inputs[shape] = tuple(
            torch.from_numpy(rng.standard_normal(x).astype(np.float32))
            .to(dev) for x in ((M, K), (K, N)))

    def args(shape, variant):
        a, b = inputs[shape]
        dtype, split = dtypes[variant]
        return a, b.to(dtype), dtype, split

    def check(shape, variant, iters):
        a, b, dtype, split = args(shape, variant)
        got = float(k3.mxu_micro(a, b, dtype, split, iters))
        want = float(k3.mxu_micro_reference(a, b, dtype, split, iters))
        err = abs(got - want)
        lim = 1e-5 * k3.abs_scale(a, b, iters)
        if not err <= lim:
            raise AssertionError(f"K3 {variant} {shape} x{iters}: |{got} - "
                                 f"{want}| = {err} > {lim}")
        return err, err / lim, want, lim

    out = {"phase": "mxu_micro", "check_iters": 8, "tolerance": "1e-5 of "
           "iters * sum|a||b|"}
    errs = [check(shape, v, 8) for shape in inputs for v in k3.VARIANTS]
    out["checks"] = len(errs)
    out["max_abs_err"] = max(e[0] for e in errs)
    out["max_err_of_tolerance"] = max(e[1] for e in errs)

    bench.STATE["device"] = dev
    _reset_launch_counts()
    bench.bench_mxu_micro()
    torch.cuda.synchronize()
    out["bench_launches"] = _launch_counts()["mxu_micro"]
    if out["bench_launches"] <= 0:
        raise AssertionError("the bench's mxu_micro stage launched no K3")
    out["bench"] = bench.DETAIL["configs"]["mxu_micro"]["shapes"]

    modes = {v: mxu_one_call_mode(v, dev) for v in k3.VARIANTS}
    out["library_modes"] = modes
    rows = []
    for M, K, N, dtype, split in k3.bench_shapes():
        variant = k3.variant_of(dtype, split)
        a, b, dtype, split = args((M, K, N), variant)
        a_cat, b_rep = mxu_one_call_operands(a, b, variant, k3.ITERS)
        fns = {"kernel": lambda: k3.mxu_micro(a, b, dtype, split),
               "plain": lambda: k3.mxu_micro_reference(a, b, dtype, split),
               "library": lambda: mxu_one_call(a_cat, b_rep,
                                               modes[variant])}
        # K3 and the one call back to back (the host's launch costs are
        # then hidden where the device takes longer); the plain version,
        # 5-10 launches an iteration, once
        reps = {"kernel": 10, "plain": 1, "library": 10}
        ms = {name: [] for name in fns}
        for name in ("kernel", "plain", "library", "library", "plain",
                     "kernel"):
            ms[name].append(time_call(fns[name], reps=reps[name]))
        err, share, want, lim = check((M, K, N), variant, k3.ITERS)
        lib_err = abs(float(fns["library"]()) - want)
        del a_cat, b_rep
        torch.cuda.empty_cache()
        if not lib_err <= lim and modes[variant] != "bf16_out":
            raise AssertionError(f"one torch.mm {variant} {(M, K, N)}: "
                                 f"{lib_err} > {lim}")
        p = k3.plan(M, N, variant)
        row = {"shape": [M, K, N], "variant": variant,
               **{f"{n}_ms": float(np.mean(v)) for n, v in ms.items()},
               "bound_ms": k3.bound_ms(M, K, N, variant),
               "grid": {"tile": [p.tile_m, p.tile_n], "tiles": p.tiles,
                        "chunks": p.chunks, "blocks": p.blocks},
               "abs_err_2000": err, "err_of_tolerance_2000": share,
               "library_err_of_tolerance_2000": lib_err / lim}
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
        rows.append(row)
    out["timed"] = rows
    emit(out)
    return out


def profile_cell(cell: str, s, sig, n_channels: int, n_ep: int,
                 correlator: str) -> dict:
    """track() on the card once to warm up, then once under torch.profiler:
    device launches per epoch (kernels, and copies or fills apart), the
    device's busy share (the union of its activity over the profiled wall
    time) and the kernels that take the most device time.  The profiler
    slows the host, so the busy share is a lower bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bds3_tpu_torch.track.driver import as_capture, track

    dev = torch.device("cuda")
    capture = as_capture(sig, dev)
    inits = make_inits(s, FULL_SATS, n_channels)

    def run():
        trk = track(capture, s, inits, n_epochs=n_ep, epochs_per_block=n_ep,
                    device=dev, correlator=correlator)
        torch.cuda.synchronize()
        return trk

    run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trk = run()
        wall = time.perf_counter() - t0
    evs = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    busy_us, end = 0.0, -float("inf")
    for e in evs:               # union of the device intervals
        lo, hi = max(e.time_range.start, end), e.time_range.end
        busy_us += max(hi - lo, 0.0)
        end = max(end, hi)
    copies = [e for e in evs if e.name.startswith(("Memcpy", "Memset"))]
    per_kernel = {}
    for e in evs:
        if not e.name.startswith(("Memcpy", "Memset")):
            n, us = per_kernel.get(e.name, (0, 0.0))
            per_kernel[e.name] = (n + 1, us + e.time_range.elapsed_us())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:6]
    out = {"phase": "profile", "cell": cell, "correlator": trk.correlator,
           "epochs": n_ep, "channels": n_channels,
           "profiled_wall_ms_per_epoch": wall / n_ep * 1e3,
           "device_events": len(evs),
           "device_busy_share": busy_us * 1e-6 / wall if evs else None,
           "kernel_launches_per_epoch": (len(evs) - len(copies)) / n_ep,
           "copies_per_epoch": len(copies) / n_ep,
           "top_kernels": [{"name": k[:80], "per_epoch": n / n_ep,
                            "us_per_epoch": us / n_ep}
                           for k, (n, us) in top]}
    emit(out)
    return out


def phase_profile() -> None:
    """The profiler over the tracking cells of PERF.md section 5 on short
    captures: the B1C preset (wideband) and B1C narrowband, 10 channels,
    30 epochs, and B2a 12 channels, 200 epochs, at 99.375 Msps, through
    each path that takes them."""
    from bds3_tpu_torch.io import synthesize_if

    for cell, s, n_ch, n_ep, paths in (
            ("b1c_wb_99msps_10ch", b1c_preset_settings(), 10, 30,
             ("fused", "bucket_pallas")),
            ("b1c_nb_99msps_10ch", b1c_full_settings(), 10, 30,
             ("fused", "bucket_pallas", "bucket")),
            ("b2a_99msps_12ch", full_settings(), 12, 200,
             ("fused", "bucket_pallas", "bucket"))):
        sig = synthesize_if(s, sat_params(FULL_SATS),
                            n_ms=(n_ep + 5) * s.int_time * 1e3,
                            noise_std=2.0, seed=11)
        for correlator in paths:
            profile_cell(cell, s, sig, n_ch, n_ep, correlator)


def main() -> int:
    if sys.argv[1:] not in ([], ["--profile"]):
        print("usage: python3 chip_smoke.py [--profile]", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        import bds3_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the bds3_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 2
    if "jax" in sys.modules:
        raise AssertionError("the port imported JAX")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    name, limit = (x.strip() for x in smi.split(",", 1))
    CARD.update(card=name, power_limit=limit)
    if sys.argv[1:] == ["--profile"]:
        phase_build()
        phase_profile()
        return 0

    caps = Captures()
    try:
        build_s = phase_build()
        mxu = phase_mxu_micro()
        small = phase_kernel_small()
        full = phase_kernel_full()
        k1_iq = phase_kernel_iq()
        b2a = phase_full_rate(caps)
        trk_iq = phase_track_iq8(b2a)
        stream = phase_stream(caps)
        rx = phase_receiver(caps)
        rx_iq = phase_receiver_iq8()
        phase_bucket_compare(caps)
        k1_b1c = phase_kernel_b1c(caps)
        phase_acquire_b1c_preset(caps)
        b1c = phase_b1c_track(caps)
        rx_b1c = phase_receiver_b1c(caps)
        rx_wb = phase_receiver_b1c_wb(caps)
        drv = phase_drivers(caps)
        par_ch = phase_parallel_channel(caps)
        par_t = phase_parallel_time(caps)
        par_2d = phase_parallel_time2d(caps)
        phase_parallel_acq(caps)
        # last: its profiler may leave the driver slower for later phases
        pre = phase_prefix()
    finally:
        caps.stop()
    if "jax" in sys.modules:
        raise AssertionError("the port imported JAX")

    from bds3_tpu_torch.benchmarks import mxu_micro as k3
    from bds3_tpu_torch.track import fused, prefix

    wb = b1c["track_b1c_wb_99msps_10ch"]
    nb = b1c["track_b1c_nb_99msps_10ch"]
    k1 = k1_b1c["wb_composite"]
    k2 = pre["b1c_10ch"]
    k3_row = next(r for r in mxu["timed"] if r["shape"] == [128, 128, 1024]
                  and r["variant"] == "bf16")
    kernels = [{
        "name": "track_fused",
        "route": "cuda",
        "source": fused.SOURCE,
        "replaces": fused.REPLACES,
        # this slice's main path: the B1C preset through track()
        "launches": wb["auto"]["launches"]["track_fused"],
        "launches_by_path": {
            "b1c_wb_preset_track": wb["auto"]["launches"]["track_fused"],
            "b1c_nb_track": nb["auto"]["launches"]["track_fused"],
            "b1c_wb_e2e_receiver": rx_wb["kernel_launches"]["track_fused"],
            "b1c_nb_e2e_receiver": rx_b1c["kernel_launches"]["track_fused"],
            "b2a_e2e_receiver": rx["kernel_launches"]["track_fused"],
            "b2a_e2e_receiver_float32":
                rx["float32"]["kernel_launches"]["track_fused"],
            "b2a_streamed_track":
                stream["none"]["launches"]["track_fused"],
            "b2a_iq8_track_complex64": trk_iq["launches"]["track_fused"],
            "b2a_iq8_e2e_receiver_complex64":
                rx_iq["kernel_launches"]["track_fused"],
            # summed over the ranks, all on this one card
            "b2a_channel_fanout_2ranks": sum(
                par_ch["parallel_channel_b2a_12ch"]["k1_launches_by_rank"]),
            "b2a_channel_fanout_nccl_1rank": sum(
                par_ch["parallel_nccl_world1"]["k1_launches_by_rank"]),
            "b2a_time_sharded_2ranks": sum(par_t["k1_launches_by_rank"]),
            "b1c_wb_time2d_4ranks": sum(par_2d["k1_launches_by_rank"]),
            **{f"driver_{name}": r["k1_launches"]
               for name, r in drv.items()}},
        "max_abs_err": max(
            [small["max_abs_err"], full["max_abs_err"],
             rx["cmp"]["max_abs_err"], rx_b1c["cmp"]["max_abs_err"],
             rx_wb["cmp"]["max_abs_err"]]
            + [k1_b1c[c]["max_abs_err"] for c in k1_b1c if c != "phase"]
            + [k1_iq[label][k]["max_abs_err"]
               for label in ("b2a_12ch", "b1c_wb_preset_10ch")
               for k in K1_KINDS[1:]]
            + [e for r in (*par_ch.values(), par_t, par_2d)
               for e in r["k1_check_abs_err_by_rank"]]),
        # one W = 20 block of the preset (wideband composite, 10 channels)
        # at the chosen blocks per channel, and at one block per channel
        "blocks_per_channel": k1["blocks_per_channel"],
        "ms_blocks1": k1["kernel_block_ms_blocks1"],
        "ms": k1["kernel_block_ms"],
        "plain_ms": k1["plain_block_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": None,
        # one W = 20 block of B2a, 12 channels, 99.375 Msps, through each
        # of K1's instances at its chosen blocks per channel
        "variants_b2a_12ch": {
            k: {f: k1_iq["b2a_12ch"][k][f] for f in (
                "blocks_per_channel", "ms", "plain_ms", "bound_ms",
                "bound_by", "bound_share")} for k in K1_KINDS},
    }, {
        "name": "mix_prefix",
        "route": "cuda",
        "source": prefix.SOURCE,
        "replaces": prefix.REPLACES,
        # its B1C path: narrowband through bucket_pallas
        "launches": nb["bucket_pallas"]["launches"]["mix_prefix"],
        "launches_by_path": {
            "b1c_nb_track_bucket_pallas":
                nb["bucket_pallas"]["launches"]["mix_prefix"],
            "b1c_nb_track_bucket_pallas_float32":
                nb["bucket_pallas_float32"]["launches"]["mix_prefix"]},
        # both instances, at every shape and edge window
        "max_abs_err": max(
            r["max_abs_err"]
            for row in [pre[label] for label, _, _ in prefix_shapes()]
            + list(pre["edges"].values())
            for r in (row, row["float32"])),
        # one B1C epoch, 10 channels: back-to-back calls with output and
        # scratch made once; the device's own time beside them
        "ms": k2["kernel_ms"],
        "device_ms": k2["device_ms"],
        "kernels_per_call": k2["kernels_per_call"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        # no single library call computes K2; one torch.cumsum over
        # pre-mixed samples does less work (no mix, no carry)
        "library_ms": None,
        "scan_only_ms": k2["scan_only_ms"],
        # the float32 instance at the same shape, on samples with fractions
        "float32": {f: k2["float32"][f] for f in (
            "kernel_ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "share_of_bound", "max_abs_err")},
    }, {
        "name": "mxu_micro",
        "route": "cuda",
        "source": k3.SOURCE,
        "replaces": k3.REPLACES,
        # its path: the bench's mxu_micro stage (every shape, 2000 iters)
        "launches": mxu["bench_launches"],
        "max_abs_err": mxu["max_abs_err"],
        # (128, 128) @ (128, 1024) bf16, 2000 iterations
        "ms": k3_row["kernel_ms"],
        "plain_ms": k3_row["plain_ms"],
        "bound_ms": k3_row["bound_ms"],
        "bound_by": "operations",
        # one torch.mm over the concatenated operands (mxu_one_call)
        "library_ms": k3_row["library_ms"],
        "library_mode": mxu["library_modes"]["bf16"],
    }]
    emit({"phase": "summary", "build_s": build_s})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
