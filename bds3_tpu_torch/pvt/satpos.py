"""BDS-3 broadcast-ephemeris satellite position and clock correction.

Parity with `BDS-3_B1C/include/satpos.m:30-153` (the B2a variant is
identical except its eph struct lacks the group-delay field; per
SURVEY.md section 2.4 our B2a path uses T_GD = 0 via the Ephemeris
default, making the reference's undefined-field access well-defined).
"""
from __future__ import annotations

import math

import numpy as np

from bds3_tpu_torch.navmsg.ephemeris import Ephemeris
from bds3_tpu_torch.pvt.geodesy import check_t

BDS_PI = 3.1415926535898
OMEGA_E = 7.2921150e-5        # [rad/s]
MU = 3.986004418e14           # [m^3/s^2]
F_REL = -4.44280730904398e-10  # relativistic constant [s/sqrt(m)]
A_REF_MEO = 27906100.0
A_REF_IGSO_GEO = 42162200.0


def satpos_one(transmit_time: float, eph: Ephemeris,
               apply_tgd: bool = True) -> tuple[np.ndarray, float]:
    """ECEF position [m] and clock correction [s] of one satellite."""
    tgd = eph.t_gd_b1cp if apply_tgd else 0.0
    dt = check_t(transmit_time - eph.t_oc)
    clk = (eph.a_2 * dt + eph.a_1) * dt + eph.a_0 - tgd
    time = transmit_time - clk
    tk = check_t(time - eph.t_oe)

    a_ref = A_REF_MEO if eph.sat_type == "MEO" else A_REF_IGSO_GEO
    a0 = a_ref + eph.delta_a
    a = a0 + eph.a_dot * tk
    n0 = math.sqrt(MU / a0**3)
    n = n0 + eph.delta_n0 + 0.5 * eph.delta_n0_dot * tk
    m = math.fmod(eph.m_0 + n * tk + 2 * BDS_PI, 2 * BDS_PI)

    e = m
    for _ in range(10):
        e_old = e
        e = m + eph.e * math.sin(e)
        if abs(math.fmod(e - e_old, 2 * BDS_PI)) < 1e-12:
            break
    e = math.fmod(e + 2 * BDS_PI, 2 * BDS_PI)

    dtr = F_REL * eph.e * math.sqrt(a0) * math.sin(e)
    nu = math.atan2(math.sqrt(1 - eph.e**2) * math.sin(e),
                    math.cos(e) - eph.e)
    phi = math.fmod(nu + eph.omega, 2 * BDS_PI)
    u = phi + eph.c_uc * math.cos(2 * phi) + eph.c_us * math.sin(2 * phi)
    r = a * (1 - eph.e * math.cos(e)) \
        + eph.c_rc * math.cos(2 * phi) + eph.c_rs * math.sin(2 * phi)
    i = eph.i_0 + eph.i_0_dot * tk \
        + eph.c_ic * math.cos(2 * phi) + eph.c_is * math.sin(2 * phi)
    omega = math.fmod(
        eph.omega_0 + (eph.omega_dot - OMEGA_E) * tk - OMEGA_E * eph.t_oe
        + 2 * BDS_PI, 2 * BDS_PI,
    )
    xp, yp = r * math.cos(u), r * math.sin(u)
    pos = np.array([
        xp * math.cos(omega) - yp * math.cos(i) * math.sin(omega),
        xp * math.sin(omega) + yp * math.cos(i) * math.cos(omega),
        yp * math.sin(i),
    ])
    clk = (eph.a_2 * dt + eph.a_1) * dt + eph.a_0 - tgd + dtr
    return pos, clk


def satpos(transmit_times: np.ndarray, ephs: list[Ephemeris],
           apply_tgd: bool = True):
    """Batched satellite positions: returns ((3, N) ECEF, (N,) clock)."""
    positions = np.zeros((3, len(ephs)))
    clocks = np.zeros(len(ephs))
    for j, (tt, eph) in enumerate(zip(transmit_times, ephs)):
        positions[:, j], clocks[j] = satpos_one(float(tt), eph, apply_tgd)
    return positions, clocks
