"""B1C wideband (QMBOC) demo at the reference dataset rate: render a
full-rate capture, run acquisition + wideband tracking, verify lock and
the pilot secondary code.

Port of examples/b1c_pipeline_demo.py.  The capture is rendered on the
device (`io.render.render_if`, noise from a torch generator seeded with
the original's seed), not synthesized on the host and cached.  The
checks and the "DEMO PASS" line are the original's.  (B-CNAV1 decode
needs >= 2 x 18 s frames, impractical for a demo run; the decode path
is covered by tests/test_navmsg.py round trips and by
`bds3_tpu_torch.tools.validate_b1c_chain`.)

    python -m bds3_tpu_torch.examples.b1c_pipeline_demo [seconds] [--device D]

seconds defaults to 1.0; the device to the card.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from bds3_tpu_torch.config import Settings, TrackMode, b1c_settings
from bds3_tpu_torch.io import SatParams
from bds3_tpu_torch.io.render import render_if
from bds3_tpu_torch.receiver import ReceiverResults, run_receiver
from bds3_tpu_torch.signals import b1c_secondary_code
from bds3_tpu_torch.utils.device import resolve_device

# (prn, doppler [Hz], code phase [chips], amplitude).  The dopplers sit
# within ~5 Hz of the 25 Hz fine-search grid: the reference loop
# parameters (PLL Bn=12 Hz at 10 ms updates) pull that in within ~0.5 s,
# while a worst-case 12 Hz grid residual oscillates for several seconds
# (identical in the reference - real captures give it 37 s).  PRN 5 is
# searched for and absent.
SATS = ((19, 980.0, 5100.0, 1.1), (44, -2405.0, 123.0, 1.0))


def settings() -> Settings:
    return b1c_settings(acq_satellite_list=(5, 19, 44),
                        track_mode=TrackMode.WIDEBAND)


def make_capture(s: Settings, seconds: float,
                 device: torch.device) -> torch.Tensor:
    """The demo's capture on `device` (noise 2.0, seed 21)."""
    sats = [SatParams(prn=p, doppler_hz=fd, code_phase_chips=cp, amplitude=a)
            for p, fd, cp, a in SATS]
    t0 = time.time()
    sig = render_if(s, sats, seconds * 1e3, device, noise_std=2.0, seed=21)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"[render] {seconds:.1f}s at {s.sampling_freq/1e6:.3f} MHz in "
          f"{time.time()-t0:.1f}s on {device}")
    return sig


def run(s: Settings, sig, device: torch.device) -> ReceiverResults:
    """The receiver on `sig` and the original's checks; raises
    AssertionError on a failed one, else prints "DEMO PASS"."""
    res = run_receiver(sig, s, epochs_per_block=25, verbose=True,
                       device=device)
    if res.track is None:
        raise AssertionError("no channel was tracked")
    prns = list(res.track.prns)
    if not (19 in prns and 44 in prns):
        raise AssertionError(f"tracking {prns}, expected 19 and 44")
    # At this synthetic SNR the absent PRN 5 can cross the noise-
    # normalized GLRT via Weil-code cross-correlation with the two
    # strong satellites (the reference's metric behaves identically:
    # BDS-3_B1C/acquisition.m:235).  The receiver's health gate is what
    # catches it: a cross-correlation channel cannot hold PLL lock.
    if 5 in prns:
        h5 = next(h for h in res.health if h["prn"] == 5)
        print(f"[health] PRN 5 false alarm correctly flagged: "
              f"lock {h5['pll_lock']:+.2f}")
        if h5["lock_ok"]:
            raise AssertionError(f"PRN 5 passed the health gate: {h5}")
    for want in (19, 44):
        hw = next(h for h in res.health if h["prn"] == want)
        if not hw["lock_ok"]:
            raise AssertionError(f"PRN {want} failed the health gate: {hw}")

    n_tail = min(50, res.track.n_epochs - 10)
    for prn, fd, _, _ in SATS:
        ch = prns.index(prn)
        cf = np.mean(res.track.carr_freq[ch, -n_tail:])
        err = cf - (s.intermediate_freq + fd)
        print(f"[lock] PRN {prn}: carrier err {err:+.2f} Hz")
        if not abs(err) < 2.0:
            raise AssertionError(f"PRN {prn}: carrier error {err} Hz")

        # composite pilot prompt sign must follow the secondary code
        w11, w61 = np.sqrt(29 / 33), np.sqrt(4 / 33)
        pi = (-w61 * res.track.outputs["p61_ip"][ch]
              + w11 * res.track.outputs["p11_qp"][ch])
        sec = b1c_secondary_code(prn).astype(np.float64)
        signs = np.sign(pi[-n_tail:])
        # search alignment of the 1800-chip secondary over a small window
        best = 0.0
        e0 = res.track.n_epochs - n_tail
        for shift in range(0, 1800):
            ref = sec[(e0 + shift + np.arange(n_tail)) % 1800]
            best = max(best, abs(np.mean(signs == ref) - 0.5) * 2)
        print(f"[pilot] PRN {prn}: best secondary-code agreement {best:.2f}")
        if not best > 0.9:
            raise AssertionError(f"PRN {prn}: secondary-code agreement "
                                 f"{best}")
    print("DEMO PASS")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bds3_tpu_torch.examples.b1c_pipeline_demo",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("seconds", nargs="?", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    s = settings()
    run(s, make_capture(s, args.seconds, dev), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
