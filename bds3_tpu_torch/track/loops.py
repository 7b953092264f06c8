"""Loop-filter coefficient closed forms.

Parity with `Common/calcLoopCoef.m:40-45` (2nd-order DLL) and
`Common/calcLoopCoefCarr.m:47-56` (3rd-order PLL).

Host-numpy copy of `bds3_tpu/track/loops.py`: the port imports nothing of
the JAX package and keeps its own copy of every host module it uses.
"""
from __future__ import annotations


def dll_coefficients(bn: float, zeta: float, k: float = 1.0) -> tuple[float, float]:
    """(tau1, tau2) for the 2nd-order code loop."""
    wn = bn * 8.0 * zeta / (4.0 * zeta * zeta + 1.0)
    return k / (wn * wn), 2.0 * zeta / wn


def pll_coefficients(bn: float, int_time: float) -> tuple[float, float, float]:
    """(pf3, pf2, pf1) for the 3rd-order carrier loop."""
    wn = 1.2 * bn
    return wn**3 * int_time**2, 2.0 * wn**2 * int_time, 2.0 * wn
