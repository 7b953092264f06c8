"""End-to-end B2a demo at production rates: render a full-rate IF
capture with real B-CNAV2 messages, then run the complete receiver
(acquire -> track -> decode) through the port's public API.

Port of examples/b2a_pipeline_demo.py.  The capture is rendered on the
device (`io.render.render_if`: the host synthesizer's signal, noise from a
torch generator seeded with the original's seed), not synthesized on the
host and cached.  The checks and the "DEMO PASS" line are the original's.

    python -m bds3_tpu_torch.examples.b2a_pipeline_demo [seconds] [--device D]

seconds defaults to 6.5: at least 6.1 s holds one complete 3 s B-CNAV2
frame.  The device defaults to the card.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from bds3_tpu_torch.config import Settings, b2a_settings
from bds3_tpu_torch.examples._truth import sample_eph
from bds3_tpu_torch.io import SatParams
from bds3_tpu_torch.io.render import render_if
from bds3_tpu_torch.navmsg.bcnav2 import decode_bcnav2
from bds3_tpu_torch.navmsg.encode import bcnav2_nav_bits
from bds3_tpu_torch.observe import cn0_pld_series
from bds3_tpu_torch.receiver import ReceiverResults, run_receiver
from bds3_tpu_torch.utils.device import resolve_device

# (prn, doppler [Hz], code phase [chips], amplitude) of the satellites
# present; PRN 7 is searched for and absent
SATS = ((19, 1650.0, 4100.0, 0.65), (30, -2480.0, 8123.0, 0.6))


def settings() -> Settings:
    return b2a_settings(acq_satellite_list=(7, 19, 30))


def make_capture(s: Settings, seconds: float,
                 device: torch.device) -> torch.Tensor:
    """The demo's capture on `device` (noise 2.0, seed 11), each satellite
    carrying B-CNAV2 messages of its sample_eph."""
    sats = [SatParams(prn=p, doppler_hz=fd, code_phase_chips=cp,
                      amplitude=a,
                      nav_bits=bcnav2_nav_bits(sample_eph(p), 3000.0, 8))
            for p, fd, cp, a in SATS]
    t0 = time.time()
    sig = render_if(s, sats, seconds * 1e3, device, noise_std=2.0, seed=11)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"[render] {seconds:.1f}s capture at {s.sampling_freq/1e6:.3f} MHz "
          f"-> {len(sig)/1e6:.0f} MS in {time.time()-t0:.1f}s on {device}")
    return sig


def run(s: Settings, sig, device: torch.device) -> ReceiverResults:
    """The receiver on `sig` and the original's checks; raises
    AssertionError on a failed one, else prints "DEMO PASS"."""
    res = run_receiver(sig, s, verbose=True, device=device)

    if res.track is None:
        raise AssertionError("no channel was tracked")
    prns = list(res.track.prns)
    print(f"[channels] tracking PRNs {prns}")
    for want in (19, 30):
        if want not in prns:
            raise AssertionError(f"PRN {want} not tracked")
    if 7 in prns:
        raise AssertionError("phantom detection of absent PRN 7")

    # carrier convergence check
    for prn, want_fd, _, _ in SATS:
        ch = prns.index(prn)
        cf = np.mean(res.track.carr_freq[ch, -200:])
        err = cf - (s.intermediate_freq + want_fd)
        print(f"[lock] PRN {prn}: carrier err {err:+.2f} Hz")
        if not abs(err) < 1.0:
            raise AssertionError(f"PRN {prn}: carrier error {err} Hz")

    # nav decode check: a short capture holds ~1 of the 3 requisite
    # message types, so require at least one CRC-valid message decoded
    for prn, *_ in SATS:
        ch = prns.index(prn)
        eph, sfs, tow = decode_bcnav2(res.track.outputs["d_ip"][ch])
        print(f"[decode] PRN {prn}: messages={sorted(eph.id_valid)} "
              f"TOW={tow} first_frame_epoch={sfs}")
        if not eph.id_valid:
            raise AssertionError("no CRC-valid B-CNAV2 message decoded")
        if sfs is None:
            raise AssertionError("no frame start found")
        if 10 in eph.id_valid and not abs(eph.m_0 - sample_eph(prn).m_0) \
                < 1e-9:
            raise AssertionError(f"PRN {prn}: decoded m_0 {eph.m_0}")

    # C/N0 sanity
    for ch in range(len(prns)):
        series = cn0_pld_series(res.track, ch)
        print(f"[cn0] PRN {res.track.prns[ch]}: data C/N0 "
              f"{np.nanmean(series['data_cn0'][2:]):.1f} dB-Hz, lock "
              f"{np.nanmean(series['data_lock'][2:]):.2f}")
    print("DEMO PASS")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bds3_tpu_torch.examples.b2a_pipeline_demo",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("seconds", nargs="?", type=float, default=6.5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    s = settings()
    run(s, make_capture(s, args.seconds, dev), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
