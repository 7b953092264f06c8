"""BDS-3 B2a spreading codes (QPSK(10), 10230 chips @ 10.23 Mcps, 1 ms).

Behavioral spec from `BDS-3_B2a/include/generateB2aDataCode.m` /
`generateB2aPilotCode.m`: chip = G1 xor G2 where both are 13-bit LFSRs;
G1 starts all-ones and is reset to all-ones after chip 8190; G2 is seeded
per PRN from the ICD table.  Output is bipolar int8 in {+1,-1} with
bit 0 -> +1 (the reference's "-1 represents binary 1" convention).
"""
from __future__ import annotations

import functools

import numpy as np

from portbench.gen.signals import icd_tables as icd
from portbench.gen.signals.lfsr import lfsr_sequence

ALL_ONES = (1 << 13) - 1


@functools.lru_cache(maxsize=4)
def _all_codes(pilot: bool) -> np.ndarray:
    """(63, 10230) int8 bipolar codes for every PRN, one vectorized pass."""
    if pilot:
        g1_taps, g2_taps = icd.B2A_PILOT_G1_TAPS, icd.B2A_PILOT_G2_TAPS
        seeds = icd.B2A_PILOT_G2_SEED
    else:
        g1_taps, g2_taps = icd.B2A_DATA_G1_TAPS, icd.B2A_DATA_G2_TAPS
        seeds = icd.B2A_DATA_G2_SEED
    n = icd.B2A_CODE_LENGTH
    g1 = lfsr_sequence(
        np.array([ALL_ONES]), g1_taps, n,
        reset_chip=icd.B2A_G1_RESET_CHIP, reset_state=ALL_ONES,
    )[0]
    g2 = lfsr_sequence(np.array(seeds), g2_taps, n)
    bits = g1[None, :] ^ g2
    return (1 - 2 * bits.astype(np.int8)).astype(np.int8)


def b2a_data_code(prn: int) -> np.ndarray:
    """B2a data-channel ranging code, bipolar int8, shape (10230,)."""
    return _all_codes(pilot=False)[prn - 1]


def b2a_pilot_code(prn: int) -> np.ndarray:
    """B2a pilot-channel ranging code, bipolar int8, shape (10230,)."""
    return _all_codes(pilot=True)[prn - 1]


def b2a_codes_matrix(pilot: bool) -> np.ndarray:
    """(63, 10230) bipolar chip matrix for batched acquisition."""
    return _all_codes(pilot=pilot)


def b2a_data_secondary() -> np.ndarray:
    """5-chip data-channel secondary code (bipolar int8).

    Reference: `BDS-3_B2a/include/BCNAV2decoding.m:69`.
    """
    return np.array(icd.B2A_DATA_SECONDARY, dtype=np.int8)
