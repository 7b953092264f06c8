"""Data/pilot DLL combining weight for B1C wideband (QMBOC) tracking.

Parity with `BDS-3_B1C/include/CalcWeighingFactor.m:42-81`: the combining
factor is data_power*RMS_BW^2 weighted by the 11/33 power split, with PSDs
integrated over the front-end bandwidth.

Host-numpy copy of `bds3_tpu/track/weighting.py`: the port imports nothing of
the JAX package and keeps its own copy of every host module it uses.
"""
from __future__ import annotations

import functools

import numpy as np
from scipy import integrate


def _boc_psd(f: np.ndarray, fc: float, m: int) -> np.ndarray:
    """Sine-BOC(m,1) PSD (normalized), the reference's G_BOC1_1f family."""
    tc = 1.0 / fc
    x = np.sin(np.pi / (2 * m) * f / fc) * np.sin(np.pi * f / fc) / (
        np.cos(np.pi / (2 * m) * f / fc)
    ) * fc / f / np.pi
    return tc * x**2


@functools.lru_cache(maxsize=None)
def wb_dll_weight(code_freq: float, fe_bw: float) -> float:
    """DLL weight `factor` for the data channel in WB mode."""
    fc = code_freq
    br = fe_bw

    def g_data(f):
        return _boc_psd(f, fc, 1)

    def g_data_f2(f):
        return _boc_psd(f, fc, 1) * f**2

    def g_pilot(f):
        return 29.0 / 33.0 * _boc_psd(f, fc, 1) + 4.0 / 33.0 * _boc_psd(f, fc, 6)

    def g_pilot_f2(f):
        return g_pilot(f) * f**2

    opts = dict(limit=400, points=[0.0])
    p_d = integrate.quad(g_data, -br / 2, br / 2, **opts)[0]
    p_d2 = integrate.quad(g_data_f2, -br / 2, br / 2, **opts)[0]
    p_p = integrate.quad(g_pilot, -br / 2, br / 2, **opts)[0]
    p_p2 = integrate.quad(g_pilot_f2, -br / 2, br / 2, **opts)[0]
    bw_d2 = p_d2 / p_d
    bw_p2 = p_p2 / p_p
    t1 = 11.0 * p_d * bw_d2
    t2 = 33.0 * p_p * bw_p2
    return float(t1 / (t1 + t2))
