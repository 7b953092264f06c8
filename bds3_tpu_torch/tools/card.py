"""What the port's card tests and its A/B tools share.

The card tests (`tests/test_torch_cuda.py`, `tests/test_torch_cuda_paths.py`)
and the A/B tools beside this module (`k1_loop_ab`, `k2_ab`, `k2_times`,
`k3_times`) take from here:

  * the JSON line the tools print with the card's name and power limit
    (`emit`, of `bench.nvidia_smi()`);
  * one reader of the device's own time under torch.profiler
    (`device_ms`; CUDA-event times are `benchmarks.mxu_micro.time_ms`);
  * K1's bound (`roofline_ms`) and a kernel path held to its plain
    version over one block (`assert_block_agrees`);
  * the full-rate captures (99.375 Msps, the bench's four B2a
    satellites) and the end-to-end ones (the receivers' scenarios, fixed
    by seed): rendered on the card the first time and cached under
    `bds3_tpu_torch/_build/bench/` by the bench's own `get_capture` and
    `scenario_file`, so that a second run renders nothing;
  * K2's shapes, inputs, edge windows and byte bound;
  * K3's yardstick, one `torch.mm` over the concatenated operands.

Imports without a card; what renders or times needs one.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from bds3_tpu_torch import bench
from bds3_tpu_torch.config import TrackMode, b1c_settings, b2a_settings
from bds3_tpu_torch.io.scenario import make_scenario

# --- the card ---------------------------------------------------------------


def emit(rec: dict, smi: str | None) -> None:
    """One JSON line on stdout: `rec` with the card's name and power limit
    (`smi`, bench.nvidia_smi()'s; None where it read none)."""
    name, limit = (x.strip() for x in smi.split(",", 1)) if smi \
        else (None, None)
    print(json.dumps({**rec, "card": name, "power_limit": limit}), flush=True)


def device_ms(fn, reps: int = 20) -> tuple[float | None, float]:
    """The device's time per call of fn() (ms) under torch.profiler over
    `reps` calls after a warm one, and its kernel launches per call; (None,
    0) where the profiler saw no device activity.  Each kernel counts its
    mean duration times its launches per call, so an event the profiler
    drops does not shorten the time.  A profiler session can leave later
    launches of the process slower on the host: take CUDA-event times
    first."""
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


BLOCK_TOL = 1e-3   # a kernel path vs its plain version, in |plain|.mean() + 1


def assert_block_agrees(setup, capture, kernel="fused", plain=None,
                        blocks=(1, 2, None)):
    """One block of `setup` through a kernel path (a driver.BLOCK_FNS name;
    K1 at each of `blocks` per channel, None the count it chooses) and
    through `plain` (track_block_reference by default) from the same
    state: blksize and cursors equal, every output within BLOCK_TOL of
    its plain value's |mean| + 1."""
    from bds3_tpu_torch.track import driver
    from bds3_tpu_torch.track.scan import track_block_reference, unpack_rows

    def rows(r):
        return {n: v.cpu().numpy() for n, v in unpack_rows(setup.cfg,
                                                           r).items()}

    args = (setup.cfg, capture, setup.tables, setup.consts, setup.state)
    st_r, rows_r = (plain or track_block_reference)(*args)
    r = rows(rows_r)
    fn = driver.BLOCK_FNS[kernel]
    for b in (blocks if kernel == "fused" else (None,)):
        st_k, rows_k = fn(*args, _blocks=b) if kernel == "fused" \
            else fn(*args)
        torch.cuda.synchronize()
        k = rows(rows_k)
        assert torch.equal(st_k.cursor, st_r.cursor), b
        np.testing.assert_array_equal(k["blksize"], r["blksize"])
        for n in r:
            scale = np.abs(r[n]).mean() + 1.0
            np.testing.assert_allclose(k[n] / scale, r[n] / scale, rtol=0,
                                       atol=BLOCK_TOL, err_msg=f"{n} {b}")


# --- scenarios and their captures -------------------------------------------

def b1c_full_settings():
    """B1C narrowband at the preset's rate, acquisition unresampled (the
    presets, b2a_settings() and b1c_settings(), are 99.375 Msps)."""
    return b1c_settings(track_mode=TrackMode.NARROWBAND, resampling=False)


def e2e_settings():
    """tests/test_e2e_pvt.py's B2a receiver: 20 Msps, 11.5 s."""
    return b2a_settings(
        sampling_freq=20e6, intermediate_freq=5e6, ms_to_process=11_500,
        use_tropo_corr=False, acq_satellite_list=tuple(range(1, 7)),
        num_channels=6)


def e2e_scenario(s=None):
    """Five satellites over bench.RX_TRUTH (seed 3), for `s` (e2e_settings
    by default; its IQ8 form renders the same scenario as pairs)."""
    return make_scenario(s or e2e_settings(), bench.RX_TRUTH, n_sats=5,
                         seed=3)


def b1c_e2e_settings():
    """tests/test_e2e_b1c.py:21-33: B1C narrowband, 6 Msps, 26 s."""
    return b1c_settings(
        sampling_freq=6e6, intermediate_freq=1.5e6, ms_to_process=26_000,
        use_tropo_corr=False, acq_satellite_list=tuple(range(1, 7)),
        num_channels=6, acq_coh_ms=3, acq_step=1000 / 3 / 2,
        acq_search_band=3000.0, track_mode=TrackMode.NARROWBAND)


def b1c_scenario():
    return make_scenario(b1c_e2e_settings(), bench.RX_TRUTH, n_sats=5,
                         sow_base=3600.0 * 3, seed=5)


# kind: (scenario, amplitude, noise seed, cache file)
SCENARIOS = {
    "e2e": (e2e_scenario, 0.7, 1, "card_e2e_b2a_20msps.bin"),
    "b1c_e2e": (b1c_scenario, 1.3, 2, "card_e2e_b1c_6msps.bin"),
}


def capture(kind: str) -> np.ndarray:
    """The int8 capture `kind`, a read-only memmap of its cache file,
    rendered on the card the first time: "full" (the bench's headline
    capture, bench.tracking_capture) and "b1c_full" (the same satellites
    and length at b1c_full_settings); "b1c_wb_e2e" (the bench's B1C
    receiver, bench.b1c_receiver); or the scenario of SCENARIOS[kind]."""
    dev = torch.device("cuda")
    if kind == "full":
        return bench.tracking_capture(dev)[1]
    if kind == "b1c_full":
        return bench.get_capture(b1c_full_settings(), bench.B2A_SATS,
                                 "card_b1c_full.bin", bench.SECONDS * 1e3,
                                 dev)
    if kind == "b1c_wb_e2e":
        path = bench.b1c_receiver(dev)[2]
    else:
        scenario, amplitude, seed, name = SCENARIOS[kind]
        path = bench.scenario_file(name, scenario(), amplitude, seed, dev)
    return np.memmap(path, dtype=np.int8, mode="r")


# --- K2 ----------------------------------------------------------------------

def prefix_shapes():
    """(label, settings, channels) of every tracking path that runs the
    mix+prefix kernel: B1C and B2a at 99.375 Msps, and the B1C receiver's
    scenario (6 Msps, 5 channels)."""
    return (("b1c_10ch", b1c_full_settings(), 10),
            ("b2a_12ch", b2a_settings(), 12),
            ("b1c_e2e_5ch", b1c_e2e_settings(), 5))


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
    phase tables read; 12 operations a sample (the carrier's 10, as in
    K1's count, and one add for each prefix)."""
    valid = np.clip(np.minimum(blk, n), 0, len(capture) - cursor).sum()
    return roofline_ms(12.0 * valid,
                       valid * capture.itemsize + 2 * len(cursor) * (n + 1) * 4
                       + base.nbytes)


PREFIX_EDGE_TOTAL = 50_000   # the edge windows' capture length


def prefix_edge_cases():
    """(label, n, cursor, blk) of K2's edge windows in a capture of
    PREFIX_EDGE_TOTAL samples: a window shorter than one tile, n = 1,
    blk <= 0, cursors below 0 and past the capture's end."""
    total = PREFIX_EDGE_TOTAL
    return (("n_lt_tile", 3000, [0, 1234, total - 100], [3000, 2000, 3000]),
            ("n_1", 1, [0, 5, total - 1], [1, 1, 0]),
            ("blk_le_0", 3 * 4096 + 5, [0, 100, 200], [0, -7, 3 * 4096 + 5]),
            ("cursor_below_0", 2 * 4096 + 17, [-5000, -1, -20_000],
             [10**6] * 3),
            ("cursor_past_end", 2 * 4096 + 17, [total, total + 5, total - 3],
             [2 * 4096 + 17] * 3))


# --- K3's yardstick ----------------------------------------------------------

def mxu_one_call_operands(a, b, variant: str, iters: int):
    """K3's function as the operands of one product of depth iters * K
    (twice that for "split"): a_cat = [a_0 | a_1 | ...] (M, iters K), a_i
    = a + float32(i) * 1e-9 rounded as the plain version rounds it (bf16
    blocks for "bf16"; hi_i and lo_i in turn for "split"), and b_rep = b
    repeated along K to match (float32 for "fp32", else bf16).  The sum of
    all entries of a_cat @ b_rep is K3's scalar."""
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
    """K3's yardstick: one torch.mm (cuBLAS on a card) over the operands
    of mxu_one_call_operands, summed in float32.  Timed beside K3 by
    k3_times; the port never calls it."""
    if mode == "widened":
        return torch.mm(a_cat.to(torch.float32),
                        b_rep.to(torch.float32)).sum()
    if mode == "out_float32":
        return torch.mm(a_cat, b_rep, out_dtype=torch.float32).sum()
    return torch.mm(a_cat, b_rep).to(torch.float32).sum()
