"""Iterative least-squares position solver with earth-rotation, elevation
and tropospheric corrections.

Parity with `Common/leastSquarePos.m:32-121` (10 fixed iterations, rank
guard, DOP vector).
"""
from __future__ import annotations

import math

import numpy as np

from bds3_tpu_torch.config import C_LIGHT
from bds3_tpu_torch.pvt.geodesy import e_r_corr, topocent, tropo


def least_square_pos(sat_pos: np.ndarray, obs: np.ndarray,
                     use_tropo: bool = True):
    """Solve for [X, Y, Z, dt].

    sat_pos: (3, N) ECEF satellite positions at transmit time.
    obs: (N,) clock-corrected pseudoranges [m].
    Returns (pos(4,), el(N,), az(N,), dop(5,)).
    """
    n_iter = 10
    n_sats = sat_pos.shape[1]
    pos = np.zeros(4)
    az = np.zeros(n_sats)
    el = np.zeros(n_sats)
    a_mat = np.zeros((n_sats, 4))
    omc = np.zeros(n_sats)

    for it in range(n_iter):
        for i in range(n_sats):
            if it == 0:
                rot_x = sat_pos[:, i]
                trop = 2.0
            else:
                rho = np.linalg.norm(sat_pos[:, i] - pos[:3])
                rot_x = e_r_corr(rho / C_LIGHT, sat_pos[:, i])
                az[i], el[i], _ = topocent(pos[:3], rot_x - pos[:3])
                if use_tropo:
                    trop = tropo(math.sin(math.radians(el[i])),
                                 0.0, 1013.0, 293.0, 50.0, 0.0, 0.0, 0.0)
                else:
                    trop = 0.0
            rng = np.linalg.norm(rot_x - pos[:3])
            omc[i] = obs[i] - rng - pos[3] - trop
            a_mat[i, :3] = -(rot_x - pos[:3]) / rng
            a_mat[i, 3] = 1.0
        if np.linalg.matrix_rank(a_mat) != 4:
            return np.zeros(4), el, az, np.full(5, np.inf)
        x, *_ = np.linalg.lstsq(a_mat, omc, rcond=None)
        pos = pos + x

    q = np.linalg.inv(a_mat.T @ a_mat)
    dop = np.array([
        math.sqrt(np.trace(q)),
        math.sqrt(q[0, 0] + q[1, 1] + q[2, 2]),
        math.sqrt(q[0, 0] + q[1, 1]),
        math.sqrt(q[2, 2]),
        math.sqrt(q[3, 3]),
    ])
    return pos, el, az, dop
