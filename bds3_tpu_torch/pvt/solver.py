"""Navigation-epoch driver: decode -> measurement grid -> pseudoranges ->
satellite positions -> least-squares fixes.

Parity with `BDS-3_B2a/postNavigation.m` / `BDS-3_B1C/postNavigation.m`:
requisite-message gating, >=4-satellite gate, measurement epochs every
nav_sol_period between the channels' common tracked span, receiver-clock
feedback into localTime, elevation masking.

Documented deviation from the reference: `postNavigation.m:293-297`
updates elevations only for satellites in the current solution, so a
satellite that once dips below the mask is excluded forever.  Here,
after every successful fix the elevations of ALL decoded channels are
recomputed from the fix position (satpos already ran for them), so a
satellite is re-admitted when it rises back above the mask
(tests/test_pvt_units.py::TestElevationReadmission).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from bds3_tpu_torch.config import C_LIGHT, Settings, Signal
from bds3_tpu_torch.navmsg.bcnav1 import decode_bcnav1, pilot_prompt_stream
from bds3_tpu_torch.navmsg.bcnav2 import decode_bcnav2
from bds3_tpu_torch.pvt.geodesy import (
    cart2geo,
    cart2utm,
    e_r_corr,
    find_utm_zone,
    topocent,
)
from bds3_tpu_torch.pvt.lsq import least_square_pos
from bds3_tpu_torch.pvt.pseudorange import transmit_times
from bds3_tpu_torch.pvt.satpos import satpos


@dataclasses.dataclass
class NavSolutions:
    meas_sample: np.ndarray      # (M,) measurement sample locations
    x: np.ndarray                # (M,) ECEF
    y: np.ndarray
    z: np.ndarray
    dt: np.ndarray               # (M,) receiver clock bias [m]
    latitude: np.ndarray
    longitude: np.ndarray
    height: np.ndarray
    east: np.ndarray
    north: np.ndarray
    up: np.ndarray
    dop: np.ndarray              # (5, M)
    el: np.ndarray               # (C, M)
    az: np.ndarray               # (C, M)
    raw_p: np.ndarray            # (C, M)
    local_time: np.ndarray       # (M,)
    prns: np.ndarray             # (C,)
    ephemerides: dict            # prn -> Ephemeris


def post_navigation(track, settings: Settings) -> NavSolutions | None:
    """Full PVT pipeline over tracking results."""
    C = len(track.prns)
    sub_frame_start = {}
    tow = {}
    ephs = {}
    active = []
    for ch in range(C):
        prn = int(track.prns[ch])
        if settings.signal == Signal.B2A:
            eph, sfs, t = decode_bcnav2(
                track.outputs["d_ip"][ch],
                ldpc=getattr(settings, "ldpc_decode", False))
            ok = eph.has_b2a_requisites() and sfs is not None
        else:
            pilot = pilot_prompt_stream(track, ch)
            eph, sfs, t = decode_bcnav1(
                track.outputs["d_ip"][ch], pilot, prn,
                ldpc=getattr(settings, "ldpc_decode", False))
            ok = eph.flag and sfs is not None
        if ok:
            ephs[prn] = eph
            sub_frame_start[ch] = sfs
            tow[ch] = t
            active.append(ch)

    if len(active) < 4:
        return None

    sample_start = max(
        track.absolute_sample[ch][sub_frame_start[ch]] for ch in active
    ) + 1
    sample_end = min(track.absolute_sample[ch][-1] for ch in active) - 1
    step = int(settings.sampling_freq * settings.nav_sol_period_ms / 1000)
    n_meas = int((sample_end - sample_start) / step)
    if n_meas < 1:
        return None

    sol = NavSolutions(
        meas_sample=np.zeros(n_meas, dtype=np.int64),
        x=np.full(n_meas, np.nan), y=np.full(n_meas, np.nan),
        z=np.full(n_meas, np.nan), dt=np.full(n_meas, np.nan),
        latitude=np.full(n_meas, np.nan), longitude=np.full(n_meas, np.nan),
        height=np.full(n_meas, np.nan),
        east=np.full(n_meas, np.nan), north=np.full(n_meas, np.nan),
        up=np.full(n_meas, np.nan),
        dop=np.zeros((5, n_meas)),
        el=np.full((C, n_meas), np.nan), az=np.full((C, n_meas), np.nan),
        raw_p=np.full((C, n_meas), np.nan),
        local_time=np.full(n_meas, np.nan),
        prns=track.prns.copy(),
        ephemerides=ephs,
    )

    sat_elev = np.full(C, np.inf)
    local_time = np.inf
    for m in range(n_meas):
        use = [ch for ch in active if sat_elev[ch] >= settings.elevation_mask_deg]
        curr = int(sample_start + step * m)
        sol.meas_sample[m] = curr

        # transmit times + satellite positions for ALL decoded channels
        # (not just the masked-in set): the below-mask ones are needed to
        # re-evaluate their elevation for re-admission
        tt = transmit_times(track, active, sub_frame_start, tow, curr,
                            settings)
        if local_time == np.inf and tt:
            local_time = max(tt[ch] for ch in use) \
                + settings.start_offset_ms / 1000.0
        for ch in use:
            sol.raw_p[ch, m] = (local_time - tt[ch]) * C_LIGHT

        eph_all = [ephs[int(track.prns[ch])] for ch in active]
        apply_tgd = settings.signal == Signal.B1C
        sat_pos_all, sat_clk_all = satpos(
            np.array([tt[ch] for ch in active]), eph_all, apply_tgd
        )
        sel = [active.index(ch) for ch in use]
        sat_positions = sat_pos_all[:, sel]
        sat_clk = sat_clk_all[sel]

        if len(use) > 3:
            obs = sol.raw_p[use, m] + sat_clk * C_LIGHT
            xyzdt, el, az, dop = least_square_pos(
                sat_positions, obs, settings.use_tropo_corr
            )
            sol.x[m], sol.y[m], sol.z[m] = xyzdt[:3]
            sol.dt[m] = 0.0 if m == 0 else xyzdt[3]
            local_time -= xyzdt[3] / C_LIGHT
            sol.local_time[m] = local_time
            sol.dop[:, m] = dop
            for j, ch in enumerate(use):
                sol.el[ch, m] = el[j]
                sol.az[ch, m] = az[j]
                sat_elev[ch] = el[j]
            # re-admission: recompute the elevation of channels currently
            # below the mask from the fresh fix position, so a satellite
            # that rises above the mask re-enters the solution next epoch
            # (fixes postNavigation.m:293-297's permanent exclusion)
            pos = xyzdt[:3]
            for j, ch in enumerate(active):
                if ch in use:
                    continue
                tau = np.linalg.norm(sat_pos_all[:, j] - pos) / C_LIGHT
                sp = e_r_corr(tau, sat_pos_all[:, j])
                az_j, el_j, _ = topocent(pos, sp - pos)
                sat_elev[ch] = el_j
                sol.el[ch, m] = el_j
                sol.az[ch, m] = az_j
            lat, lon, h = cart2geo(sol.x[m], sol.y[m], sol.z[m], 5)
            sol.latitude[m], sol.longitude[m], sol.height[m] = lat, lon, h
            zone = find_utm_zone(lat, lon)
            sol.east[m], sol.north[m], sol.up[m] = cart2utm(
                sol.x[m], sol.y[m], sol.z[m], zone,
                datum=settings.utm_datum,
            )
        local_time += step / settings.sampling_freq
    return sol
