"""Streaming ingest proof: track 12 channels through an on-disk capture
(by default the reference's dataset envelope: 49 s at 99.375 Msps,
4.9 GB) WITHOUT holding the capture in host or device memory.

Port of tools/streaming_demo.py.  The capture is built once by exact
tiling: with doppler = 0 an integer number of carrier cycles (IF * 1 s)
and code periods (1000) complete in exactly one second (99 375 000
samples), so a 1 s block tiles into an arbitrarily long phase-continuous
capture.  The block is rendered on the device (`io.render.render_if`,
noise from a torch generator seeded with the original's seed) and written
to bds3_tpu_torch/_build/captures/streaming_demo.bin (kept while its size
matches the length asked for).  Tracking then streams it through
StreamingCapture (native pread + lookahead thread) in 2000-epoch blocks
while the tracking kernel walks each block on the card.

    python -m bds3_tpu_torch.tools.streaming_demo [seconds=49] [--device D]

Prints total wall, real-time factor and the lock count, then
"STREAMING DEMO PASS" if at least 10 of 12 channels hold lock.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from bds3_tpu_torch._build import BUILD_DIR
from bds3_tpu_torch.config import Settings, b2a_settings
from bds3_tpu_torch.io import SatParams
from bds3_tpu_torch.io.render import render_if
from bds3_tpu_torch.io.stream import StreamingCapture
from bds3_tpu_torch.track.driver import TrackResults, track
from bds3_tpu_torch.track.state import ChannelInit
from bds3_tpu_torch.utils.device import resolve_device

CAPTURE = BUILD_DIR / "captures" / "streaming_demo.bin"
# (prn, code phase [chips]) of the four satellites, all at doppler 0
BASE = ((5, 4100.0), (12, 8123.0), (19, 55.0), (30, 9000.0))
W = 2000                               # epochs a block


def build_capture(s: Settings, seconds: int, device: torch.device) -> str:
    """The tiled capture file of `seconds` seconds, made unless a file of
    that size is there; its path."""
    n_tile = int(s.sampling_freq)          # exactly 1 s
    total = seconds * n_tile
    if CAPTURE.exists() and CAPTURE.stat().st_size == total:
        return str(CAPTURE)
    sats = [SatParams(prn=p, doppler_hz=0.0, code_phase_chips=cp,
                      amplitude=0.65) for p, cp in BASE]
    t0 = time.time()
    tile = render_if(s, sats, 1000.0, device, noise_std=2.0,
                     seed=11).cpu().numpy()
    if len(tile) != n_tile:
        raise RuntimeError(f"rendered {len(tile)} samples, expected {n_tile}")
    print(f"[stream] rendered 1 s tile in {time.time() - t0:.1f}s on "
          f"{device}; tiling to {total / 1e9:.2f} GB ...", flush=True)
    CAPTURE.parent.mkdir(parents=True, exist_ok=True)
    tmp = f"{CAPTURE}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        for _ in range(seconds):
            tile.tofile(f)
    os.replace(tmp, CAPTURE)
    return str(CAPTURE)


def inits(s: Settings) -> list[ChannelInit]:
    """12 channels, the four satellites three times each."""
    out = []
    for i in range(12):
        prn, cp = BASE[i % 4]
        chi0 = cp % s.code_length
        start = ((s.code_length - chi0) % s.code_length) / s.code_freq_basis
        out.append(ChannelInit(
            prn=prn, acquired_freq=s.intermediate_freq,
            code_phase=int(round(start * s.sampling_freq)), peak_metric=2.0))
    return out


def run(s: Settings, cap, seconds: int, device: torch.device
        ) -> TrackResults:
    """Track the 12 channels through `cap` (the tiled capture, a
    StreamingCapture) for seconds - 1 s; raises AssertionError if fewer
    than 10 hold lock, else prints "STREAMING DEMO PASS"."""
    n_epochs = (seconds - 1) * 1000        # leave block-tail margin
    t0 = time.time()
    res = track(cap, s, inits(s), n_epochs=n_epochs, epochs_per_block=W,
                device=device, download=False)
    ip = res.outputs["d_ip"][:, -400:].cpu().numpy()
    qp = res.outputs["d_qp"][:, -400:].cpu().numpy()
    wall = time.time() - t0
    locked = int((np.abs(ip).mean(axis=1) > 4 * np.abs(qp).mean(axis=1)).sum())
    tracked = res.n_epochs * s.int_time
    print(f"[stream] correlator={res.correlator}: {tracked:.1f}s x 12ch "
          f"from disk in {wall:.1f}s -> {tracked / wall:.2f}x realtime "
          f"(incl. IO), locked {locked}/12", flush=True)
    if locked < 10:
        raise AssertionError("lost lock on streamed capture")
    print("STREAMING DEMO PASS")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bds3_tpu_torch.tools.streaming_demo",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("seconds", nargs="?", type=int, default=49)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.seconds < 2:
        ap.error("seconds must be at least 2 (1 s is left as margin)")
    dev = resolve_device(args.device)
    s = b2a_settings()
    cap = StreamingCapture(build_capture(s, args.seconds, dev))
    print(f"[stream] capture {len(cap) / 1e9:.2f} GB at {cap.path}",
          flush=True)
    run(s, cap, args.seconds, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
