"""Residual analysis for the e2e PVT scenario: compare each channel's
measured pseudorange against the geometric truth.

Port of tools/debug_pvt.py, on the tests/test_e2e_pvt.py scenario (B2a,
20 Msps, 11.5 s, 5 satellites; scenario seed 3, noise seed 1).  The
capture is rendered on the device (`io.render.render_scenario`, noise
from a torch generator), or handed to `run` already made; nothing is
cached, since the whole run takes seconds on a card (the original
pickles its results under /tmp).  It prints the original's analysis,
then checks the test's gate (>= 3 fixes, median 3D error < 1 m) and
prints "PVT DEBUG PASS".

    python -m bds3_tpu_torch.tools.debug_pvt [--device D]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from bds3_tpu_torch.config import C_LIGHT, Settings, b2a_settings
from bds3_tpu_torch.io.render import render_scenario
from bds3_tpu_torch.io.scenario import Scenario, make_scenario
from bds3_tpu_torch.pvt.satpos import satpos_one
from bds3_tpu_torch.receiver import ReceiverResults, run_receiver
from bds3_tpu_torch.utils.device import resolve_device

RX = np.array([-1288398.0, -4721697.0, 4078625.0])


def settings() -> Settings:
    return b2a_settings(
        sampling_freq=20e6, intermediate_freq=5e6, ms_to_process=11_500,
        use_tropo_corr=False, acq_satellite_list=tuple(range(1, 7)),
        num_channels=6,
    )


def scenario(s: Settings) -> Scenario:
    return make_scenario(s, RX, n_sats=5, seed=3)


def _zero(eph):
    e = dataclasses.replace(eph)
    e.a_0 = e.a_1 = e.a_2 = 0.0
    return e


def run(s: Settings, sig, device: torch.device) -> ReceiverResults:
    """The receiver on `sig` (the scenario's capture), the original's
    residual analysis, and the gate; raises AssertionError if it fails,
    else prints "PVT DEBUG PASS"."""
    sc = scenario(s)
    res = run_receiver(sig, s, epochs_per_block=250, verbose=True,
                       device=device)
    nav, trk = res.nav, res.track
    if nav is None:
        raise AssertionError("no PVT solution")
    print("PRNs:", trk.prns, "fixes:", np.isfinite(nav.x).sum())
    err = np.sqrt((nav.x - RX[0])**2 + (nav.y - RX[1])**2 + (nav.z - RX[2])**2)
    print("3D err:", np.round(err, 2))
    print("dt [m]:", np.round(nav.dt, 2))

    ephs = {e.prn: e for e in sc.ephemerides}
    for m in (1, 2, 3):
        print(f"--- measurement {m} sample {nav.meas_sample[m]}")
        t_rx_true = nav.meas_sample[m] / s.sampling_freq + sc.sow_base
        resids = []
        for ch in range(len(trk.prns)):
            prn = int(trk.prns[ch])
            raw_p = nav.raw_p[ch, m]
            if not np.isfinite(raw_p):
                continue
            eph = ephs[prn]
            # truth geometric range at true receive time (light-time iter)
            tau = 0.07
            for _ in range(3):
                pos, _ = satpos_one(t_rx_true - tau, _zero(eph), False)
                tau = np.linalg.norm(pos - RX) / C_LIGHT
            # receiver's modeled range: rawP + c*satclk - c*dt_rx
            u = t_rx_true - tau
            dt_sv = eph.a_0 + eph.a_1 * (u - eph.t_oc)
            # measured transmit time check
            meas_tt = (nav.local_time[m] - raw_p / C_LIGHT) if np.isfinite(
                nav.local_time[m]) else np.nan
            resid_t = meas_tt - (u + dt_sv)
            resids.append((prn, tau * C_LIGHT, resid_t * C_LIGHT))
        rr = np.array([r[2] for r in resids])
        for prn, rng, rt in resids:
            print(f"  PRN {prn}: range {rng/1e3:9.1f} km  tt-resid {rt:9.2f} m"
                  f"  (vs mean {rt - rr.mean():7.2f})")

    ok = np.isfinite(err)
    if ok.sum() < 3 or not np.median(err[ok]) < 1.0:
        raise AssertionError(f"{ok.sum()} fixes, 3D errors {err}")
    print(f"[pvt] fixes={ok.sum()} 3D err median={np.median(err[ok]):.3f} m")
    print("PVT DEBUG PASS")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m bds3_tpu_torch.tools.debug_pvt",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    s = settings()
    sig = render_scenario(scenario(s), dev, noise_std=2.0, amplitude=0.7,
                          seed=1)
    run(s, sig, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
