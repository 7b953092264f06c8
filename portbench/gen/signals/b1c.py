"""BDS-3 B1C spreading waveforms: Weil codes + BOC/QMBOC subcarriers.

Behavioral spec from `BDS-3_B1C/include/generateDataBOC11.m`,
`generatePilotBOC11.m`, `generatePilotBOC61.m`, `generate2ndCode.m`:

- primary codes: 10230-chip truncated Weil codes over the N=10243 Legendre
  sequence, per-PRN (w, p) from the ICD;
- data channel transmits BOC(1,1): each chip becomes 2 half-chips (-c, +c);
- pilot channel is QMBOC(6,1,4/33): a BOC(1,1) component (power 29/33 of
  pilot) in phase quadrature with a BOC(6,1) component (power 4/33, 12
  sub-chips per chip starting at -c);
- pilot secondary code: 1800-chip truncated Weil code over N=3607, one chip
  per 10 ms primary period (18 s frame).
"""
from __future__ import annotations

import functools

import numpy as np

from portbench.gen.signals import icd_tables as icd
from portbench.gen.signals.weil import weil_code


@functools.lru_cache(maxsize=None)
def b1c_data_chips(prn: int) -> np.ndarray:
    """Primary data code chips, bipolar int8, shape (10230,)."""
    w, p = icd.B1C_DATA_WP[prn - 1]
    return weil_code(icd.B1C_LEGENDRE_N, w, p, icd.B1C_CODE_LENGTH)


@functools.lru_cache(maxsize=None)
def b1c_pilot_chips(prn: int) -> np.ndarray:
    """Primary pilot code chips, bipolar int8, shape (10230,)."""
    w, p = icd.B1C_PILOT_WP[prn - 1]
    return weil_code(icd.B1C_LEGENDRE_N, w, p, icd.B1C_CODE_LENGTH)


def _boc(chips: np.ndarray, m: int) -> np.ndarray:
    """Expand chips with a sine-phased square subcarrier of 2*m half-chips
    per chip, first half-chip negated (reference sign convention,
    `generateDataBOC11.m:84-91`, `generatePilotBOC61.m:91-96`)."""
    pattern = np.where(np.arange(2 * m) % 2 == 0, -1, 1).astype(np.int8)
    return (chips[:, None] * pattern[None, :]).reshape(-1)


@functools.lru_cache(maxsize=None)
def b1c_data_boc11(prn: int) -> np.ndarray:
    """Data BOC(1,1) waveform, shape (20460,) half-chips."""
    return _boc(b1c_data_chips(prn), 1)


@functools.lru_cache(maxsize=None)
def b1c_pilot_boc11(prn: int) -> np.ndarray:
    """Pilot BOC(1,1) component waveform, shape (20460,) half-chips."""
    return _boc(b1c_pilot_chips(prn), 1)


@functools.lru_cache(maxsize=None)
def b1c_pilot_boc61(prn: int) -> np.ndarray:
    """Pilot BOC(6,1) component waveform, shape (122760,) twelfth-chips."""
    return _boc(b1c_pilot_chips(prn), 6)


@functools.lru_cache(maxsize=None)
def b1c_secondary_code(prn: int) -> np.ndarray:
    """Pilot secondary code, bipolar int8, shape (1800,)."""
    w, p = icd.B1C_SECONDARY_WP[prn - 1]
    return weil_code(
        icd.B1C_SECONDARY_LEGENDRE_N, w, p, icd.B1C_SECONDARY_LENGTH
    )


# QMBOC(6,1,4/33) power-split amplitude weights (ICD-B1C-1.0 section 6;
# reference WB_tracking.m:374-381): pilot = sqrt(29/33)*BOC11 (+/-j) ...
# -sqrt(4/33)*BOC61.
PILOT_BOC11_AMP = float(np.sqrt(29.0 / 33.0))
PILOT_BOC61_AMP = float(np.sqrt(4.0 / 33.0))
# Data/pilot correlator combining weights used by the reference trackers
# (NB_tracking.m:346-361: data 11, pilot 29, of 40; acquisition.m:218-219).
NB_DATA_WEIGHT = 11.0 / 40.0
NB_PILOT_WEIGHT = 29.0 / 40.0
