#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`bds3_tpu_torch`).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from `bds3_tpu_torch/csrc`, holds each
kernel against its plain PyTorch version on the card, and drives the
port's main path through its public entry points:

  1. build   nvcc build of the kernels; the card's name and power limit.
  2. kernel  fused_track_block against track_block_reference on the card:
             (a) 10 Msps, 2 satellites, 30 epochs; (b) 99.375 Msps,
             12 channels, 20 epochs.  blksize and cursors must be equal,
             correlators and discriminators within 1e-3 of |a|.mean()+1.
  3. receiver  run_receiver on the synthesized 20 Msps, 11.5 s,
             5-satellite scenario (seeds 3 and 1): 5 channels, the kernel
             launched, >= 3 fixes, median 3D error < 1 m; then the kernel
             against its plain version on one block at these shapes.
  4. full-rate  99.375 Msps, 2.2 s, 4 satellites: acquisition over PRNs
             1-63 must detect exactly those 4; 12 channels tracked for
             2000 epochs must all lock; kernel and plain-version times.

Each phase prints one JSON line.  Then come the kernel table
({"kernels": [...]}), the card's `nvidia-smi` name and power limit, and
last {"ok": true, "device": {...}}.  Any failure exits non-zero without
that last line; so does a machine without a usable CUDA device.  Captures
are synthesized in background processes while the card works, and cached
under bds3_tpu_torch/_build/captures.
"""
from __future__ import annotations

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


def e2e_settings():
    from bds3_tpu.config import b2a_settings

    return b2a_settings(
        sampling_freq=20e6, intermediate_freq=5e6, ms_to_process=11_500,
        use_tropo_corr=False, acq_satellite_list=tuple(range(1, 7)),
        num_channels=6)


def full_settings():
    from bds3_tpu.config import b2a_settings

    return b2a_settings()


def sat_params(sats, amplitude=0.65):
    from bds3_tpu.io import SatParams

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
    if kind == "e2e":
        from bds3_tpu.io.scenario import make_scenario, synthesize_scenario

        sc = make_scenario(e2e_settings(), RX_TRUTH, n_sats=5, seed=3)
        sig = synthesize_scenario(sc, noise_std=2.0, amplitude=0.7, seed=1)
    else:
        from bds3_tpu.io import synthesize_if

        sig = synthesize_if(full_settings(), sat_params(FULL_SATS),
                            n_ms=FULL_MS, noise_std=2.0, seed=11)
    tmp = f"{path}.{os.getpid()}.tmp.npy"
    np.save(tmp, sig)
    os.replace(tmp, path)


class Captures:
    """The two large captures, made in spawned processes while the card
    works; `get` waits for one.  `stop` ends any process still running."""

    def __init__(self):
        os.makedirs(CAPTURES, exist_ok=True)
        ctx = mp.get_context("spawn")
        self.procs = {}
        self.paths = {k: os.path.join(CAPTURES, f"{k}_v1.npy")
                      for k in ("e2e", "full")}
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


def compare_block(cfg, capture, setup, label: str) -> dict:
    """One block through the kernel and through its plain version, from
    the same state, on the card; asserts agreement."""
    import torch

    from bds3_tpu_torch.track.fused import fused_track_block
    from bds3_tpu_torch.track.scan import track_block_reference, unpack_rows

    st_k, rows_k = fused_track_block(cfg, capture, setup.tables,
                                     setup.consts, setup.state)
    st_r, rows_r = track_block_reference(cfg, capture, setup.tables,
                                         setup.consts, setup.state)
    torch.cuda.synchronize()
    k = {n: v.cpu().numpy() for n, v in unpack_rows(cfg, rows_k).items()}
    r = {n: v.cpu().numpy() for n, v in unpack_rows(cfg, rows_r).items()}
    if not np.array_equal(k["blksize"], r["blksize"]):
        raise AssertionError(f"{label}: blksize differs")
    if not torch.equal(st_k.cursor, st_r.cursor):
        raise AssertionError(f"{label}: cursors differ")
    # same sums in another order: correlators and discriminators agree
    # within TOL of |a|.mean() + 1 (test_pallas_fused.py:71's scale)
    checked = [n for n in r if n.startswith(("d_", "p11_"))] \
        + ["carr_err", "code_err"]
    abs_err = {n: float(np.abs(k[n] - r[n]).max()) for n in checked}
    scaled = {n: abs_err[n] / (float(np.abs(r[n]).mean()) + 1.0)
              for n in checked}
    bad = {n: e for n, e in scaled.items() if not e <= TOL}
    if bad:
        raise AssertionError(f"{label}: kernel vs plain version beyond "
                             f"{TOL} scaled: {bad}")
    return {"max_scaled_err": max(scaled.values()),
            "max_abs_err": max(abs_err.values()),
            "tolerance_scaled": TOL,
            "epochs": int(k["blksize"].shape[0]),
            "channels": int(k["blksize"].shape[1])}


def time_block(fn, setup, capture, reps: int) -> float:
    """Mean ms per call of one block, CUDA events, after one warm call."""
    import torch

    fn(setup.cfg, capture, setup.tables, setup.consts, setup.state)
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    for _ in range(reps):
        fn(setup.cfg, capture, setup.tables, setup.consts, setup.state)
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1) / reps


def phase_build() -> float:
    from bds3_tpu_torch import _build

    t0 = time.perf_counter()
    _build.library()
    dt = time.perf_counter() - t0
    log = _build.library_path().with_suffix(".log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln] if log.exists() else []
    emit({"phase": "build", "seconds": dt, "ptxas": ptxas,
          "torch": __import__("torch").__version__})
    return dt


def phase_kernel_small() -> dict:
    import torch

    from bds3_tpu.config import b2a_settings
    from bds3_tpu.io import synthesize_if
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

    from bds3_tpu.io import synthesize_if
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


def phase_receiver(caps: Captures) -> dict:
    import torch

    from bds3_tpu_torch.receiver import run_receiver
    from bds3_tpu_torch.track.driver import as_capture, setup_tracking
    from bds3_tpu_torch.track.fused import KERNEL_NAME, fused_track_block

    s = e2e_settings()
    sig = caps.get("e2e")
    t0 = time.perf_counter()
    fused_track_block.launches = 0
    res = run_receiver(sig, s, epochs_per_block=250, verbose=False,
                       device="cuda")
    torch.cuda.synchronize()
    launches = fused_track_block.launches
    wall = time.perf_counter() - t0
    nav = res.nav
    if len(res.channels) != 5:
        raise AssertionError(f"{len(res.channels)} channels, expected 5: "
                             f"{[c.prn for c in res.channels]}")
    if launches <= 0 or res.track.correlator != KERNEL_NAME:
        raise AssertionError(f"tracking did not run the kernel "
                             f"(launches={launches}, "
                             f"correlator={res.track.correlator!r})")
    if nav is None:
        raise AssertionError("no navigation solution")
    ok = np.isfinite(nav.x)
    err = np.sqrt((nav.x[ok] - RX_TRUTH[0]) ** 2
                  + (nav.y[ok] - RX_TRUTH[1]) ** 2
                  + (nav.z[ok] - RX_TRUTH[2]) ** 2)
    med = float(np.median(err)) if ok.any() else float("inf")
    if ok.sum() < 3 or not med < 1.0:
        raise AssertionError(f"{int(ok.sum())} fixes, median 3D error "
                             f"{med:.3f} m (need >= 3 and < 1 m)")
    out = {"phase": "receiver_e2e", "channels": len(res.channels),
           "kernel_launches": launches, "correlator": res.track.correlator,
           "epochs": int(res.track.n_epochs), "fixes": int(ok.sum()),
           "median_3d_err_m": med, "wall_s": wall,
           **{k: float(v) for k, v in res.timings.items()}}
    emit(out)

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
    from bds3_tpu_torch.track.driver import (
        as_capture, assemble_results, run_blocks, setup_tracking, track)
    from bds3_tpu_torch.track.fused import fused_track_block
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
    ip = np.abs(trk.outputs["d_ip"][:, -500:]).mean(axis=1)
    qp = np.abs(trk.outputs["d_qp"][:, -500:]).mean(axis=1)
    locked = int((ip > 4 * qp).sum())
    if locked != 12:
        raise AssertionError(f"{locked}/12 channels locked: I/Q "
                             f"{np.round(ip / qp, 2).tolist()}")

    # the same tracking through the plain version, on the card
    setup = setup_tracking(capture, s, inits, n_ep, n_ep)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = run_blocks(setup, capture, block_fn=track_block_reference)
    plain = assemble_results(setup, rows, s, n_ep, "reference")
    plain_s = time.perf_counter() - t0
    ip_r = np.abs(plain.outputs["d_ip"][:, -500:]).mean(axis=1)
    qp_r = np.abs(plain.outputs["d_qp"][:, -500:]).mean(axis=1)

    kernel_ms = time_block(fused_track_block, setup, capture, reps=3)
    plain_ms = time_block(track_block_reference, setup, capture, reps=1)
    seconds_tracked = n_ep * s.int_time
    out = {"phase": "track_99msps_12ch", "epochs": n_ep, "channels": 12,
           "locked": locked, "cold_s": trk_s[0], "warm_s": trk_s[1],
           "ms_per_epoch": trk_s[1] / n_ep * 1e3,
           "realtime_factor": seconds_tracked / trk_s[1],
           "plain_track_s": plain_s,
           "plain_realtime_factor": seconds_tracked / plain_s,
           "plain_locked": int((ip_r > 4 * qp_r).sum()),
           "kernel_block_ms": kernel_ms, "plain_block_ms": plain_ms}
    emit(out)
    return out


def main() -> int:
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

    caps = Captures()
    try:
        build_s = phase_build()
        small = phase_kernel_small()
        full = phase_kernel_full()
        rate = phase_full_rate(caps)
        rx = phase_receiver(caps)
    finally:
        caps.stop()
    if "jax" in sys.modules:
        raise AssertionError("the port imported JAX")

    from bds3_tpu_torch.track import fused

    kernels = [{
        "name": "track_fused",
        "route": "cuda",
        "source": fused.SOURCE,
        "replaces": fused.REPLACES,
        "launches": rx["kernel_launches"],
        "max_abs_err": max(small["max_abs_err"], full["max_abs_err"],
                           rx["cmp"]["max_abs_err"]),
        "ms": rate["kernel_block_ms"],
        "plain_ms": rate["plain_block_ms"],
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
