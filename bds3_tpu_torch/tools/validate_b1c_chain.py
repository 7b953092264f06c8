"""One-shot full-chain B1C validation: scenario -> IF -> acquire ->
narrowband track -> B-CNAV1 decode -> PVT vs truth.

Port of tools/validate_b1c_chain.py: B1C at 6 Msps (a front end without
the BOC(6,1) component, so narrowband), 40 s (B-CNAV1 frames are 18 s),
5 satellites; scenario seed 5, noise seed 2.  The capture is rendered on
the device (`io.render.render_scenario`, noise from a torch generator),
not synthesized on the host and cached.  The checks (5 channels, a
solution, median 3D error < 2 m) and the "B1C CHAIN PASS" line are the
original's.

    python -m bds3_tpu_torch.tools.validate_b1c_chain [--device D]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from bds3_tpu_torch.config import Settings, TrackMode, b1c_settings
from bds3_tpu_torch.io.render import render_scenario
from bds3_tpu_torch.io.scenario import make_scenario
from bds3_tpu_torch.receiver import ReceiverResults, run_receiver
from bds3_tpu_torch.utils.device import resolve_device

RX = np.array([-1288398.0, -4721697.0, 4078625.0])


def settings() -> Settings:
    return b1c_settings(
        sampling_freq=6e6,
        intermediate_freq=1.5e6,
        ms_to_process=40_000,
        use_tropo_corr=False,
        acq_satellite_list=tuple(range(1, 7)),
        num_channels=6,
        acq_coh_ms=3,
        acq_step=1000 / 3 / 2,
        acq_search_band=3000.0,
        track_mode=TrackMode.NARROWBAND,  # 6 MHz front end: BOC(6,1) absent
    )


def make_capture(s: Settings, device: torch.device) -> torch.Tensor:
    """The chain's capture on `device` (amplitude 1.3, noise 2.0, seed 2)."""
    sc = make_scenario(s, RX, n_sats=5, sow_base=3600.0 * 3, seed=5)
    t0 = time.time()
    sig = render_scenario(sc, device, noise_std=2.0, amplitude=1.3, seed=2)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"[render] {len(sig)/1e6:.0f} MS in {time.time()-t0:.0f}s on "
          f"{device}", flush=True)
    return sig


def run(s: Settings, sig, device: torch.device) -> ReceiverResults:
    """The chain on `sig` and the original's checks; raises AssertionError
    on a failed one, else prints "B1C CHAIN PASS"."""
    res = run_receiver(sig, s, epochs_per_block=100, verbose=True,
                       device=device)
    if res.track is None or len(res.channels) != 5:
        raise AssertionError(f"{len(res.channels)} channels, expected 5")
    nav = res.nav
    if nav is None:
        raise AssertionError("B1C PVT produced no solution")
    ok = np.isfinite(nav.x)
    err = np.sqrt((nav.x[ok] - RX[0])**2 + (nav.y[ok] - RX[1])**2
                  + (nav.z[ok] - RX[2])**2)
    print(f"[pvt] fixes={ok.sum()} 3D err median={np.median(err):.2f} m "
          f"all={np.round(err, 2)}")
    if not np.median(err) < 2.0:
        raise AssertionError(f"3D errors {err}")
    print("B1C CHAIN PASS")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bds3_tpu_torch.tools.validate_b1c_chain",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    s = settings()
    run(s, make_capture(s, dev), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
