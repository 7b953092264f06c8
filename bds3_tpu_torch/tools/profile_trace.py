"""Capture a torch.profiler trace of the tracking hot path (Chrome trace
format: chrome://tracing or ui.perfetto.dev).

Port of tools/profile_trace.py, whose jax.profiler trace becomes a
torch.profiler one with CPU and (on the card) CUDA activities.  The
counterpart of the reference's tic/toc hooks
(`BDS-3_B1C/postProcessing.m:104-112`): 12 channels of B2a at 99.375 Msps
tracked in one block through track() "auto" (the tracking kernel on the
card), warmed up outside the trace, so the per-kernel device timeline
can be read offline.  The capture is rendered on the device
(`io.render.render_if`).

    python -m bds3_tpu_torch.tools.profile_trace [outdir] [seconds] \
        [--device D] [--receiver]

Writes outdir/trace.json (outdir defaults to
bds3_tpu_torch/_build/trace; seconds of capture to 0.2) and prints the
original's line, then each of the port's spans (`utils/trace.py`) in the
trace with its count and its total and self host time, then each of the
port's counters (`counters()`, since the process started, warm-up
included).  `--receiver` traces `run_receiver` on the capture instead of
track(): acquisition of the two rendered satellites, tracking and
navigation, with the receiver's and acquisition's stage spans.
`chip_smoke.py --profile` gives the launch counts and busy shares of
the tracking cells.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from bds3_tpu_torch._build import BUILD_DIR
from bds3_tpu_torch.config import Settings, b2a_settings
from bds3_tpu_torch.io import SatParams
from bds3_tpu_torch.io.render import render_if
from bds3_tpu_torch.receiver import ReceiverResults, run_receiver
from bds3_tpu_torch.track.driver import TrackResults, track
from bds3_tpu_torch.track.state import ChannelInit
from bds3_tpu_torch.utils.device import resolve_device
from bds3_tpu_torch.utils.trace import counters

OUTDIR = BUILD_DIR / "trace"
# (prn, doppler [Hz], code phase [chips])
SATS = ((5, 1650.0, 4100.0), (19, 700.0, 55.0))


def make_capture(s: Settings, seconds: float,
                 device: torch.device) -> torch.Tensor:
    sats = [SatParams(prn=p, doppler_hz=fd, code_phase_chips=cp,
                      amplitude=0.65) for p, fd, cp in SATS]
    return render_if(s, sats, seconds * 1e3, device, noise_std=2.0, seed=1)


def _track(sig: torch.Tensor, s: Settings, n_ep: int) -> TrackResults:
    inits = [ChannelInit(prn=5, acquired_freq=s.intermediate_freq + 1650.0,
                         code_phase=0, peak_metric=2.0)] * 12
    res = track(sig, s, inits, n_epochs=n_ep, epochs_per_block=n_ep,
                device=sig.device, correlator="auto", download=False)
    res.outputs["d_ip"][:, -1:].cpu()
    return res


def _receive(sig: torch.Tensor, s: Settings, n_ep: int) -> ReceiverResults:
    # two epochs fewer than _track: the acquired channels start up to a
    # code period into the capture, and a block reads one more
    return run_receiver(sig, s, n_epochs=n_ep - 2,
                        prns=[p for p, _, _ in SATS], verbose=False,
                        device=sig.device)


def run(s: Settings, sig: torch.Tensor, outdir: str,
        receiver: bool = False) -> str:
    """Track `sig` (with `receiver`, run the receiver on it) once to warm
    up, then again inside torch.profiler; writes outdir/trace.json and
    returns its path."""
    n_ep = int(len(sig) / (s.sampling_freq * s.int_time)) - 2
    call = _receive if receiver else _track
    call(sig, s, n_ep)                   # warm, outside the trace
    acts = [ProfilerActivity.CPU]
    if sig.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.time()
        res = call(sig, s, n_ep)
        wall = time.time() - t0
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "trace.json")
    prof.export_chrome_trace(path)
    if receiver:
        n = res.track.n_epochs if res.track is not None else 0
        print(f"traced the receiver: {n} epochs x {len(res.channels)} "
              f"ch in {wall*1e3:.1f} ms; trace -> {outdir}")
    else:
        print(f"traced {n_ep} epochs x 12 ch in {wall*1e3:.1f} ms "
              f"(correlator={res.correlator}); trace -> {outdir}")
    print(span_table(prof))
    print(counter_table(counters()))
    return path


def span_table(prof) -> str:
    """One line for each of the port's spans (the host's user
    annotations) in a finished profile: its count, and its total and self
    host time (self: less the operations and spans inside it), longest
    first."""
    spans = sorted((e for e in prof.key_averages() if e.is_user_annotation
                    and e.device_type == DeviceType.CPU),
                   key=lambda e: -e.cpu_time_total)
    return "\n".join(
        [f"{'span':<20} {'count':>6} {'total ms':>10} {'self ms':>10}"]
        + [f"{e.key:<20} {e.count:>6} {e.cpu_time_total / 1e3:>10.3f} "
           f"{e.self_cpu_time_total / 1e3:>10.3f}" for e in spans])


def counter_table(values: dict) -> str:
    """One line for each counter, by name."""
    return "\n".join([f"{'counter':<20} {'value':>14}"]
                     + [f"{k:<20} {v:>14}" for k, v in sorted(values.items())])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bds3_tpu_torch.tools.profile_trace",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("outdir", nargs="?", default=str(OUTDIR))
    ap.add_argument("seconds", nargs="?", type=float, default=0.2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--receiver", action="store_true",
                    help="trace run_receiver instead of track()")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    s = b2a_settings()
    run(s, make_capture(s, args.seconds, dev), args.outdir, args.receiver)
    return 0


if __name__ == "__main__":
    sys.exit(main())
