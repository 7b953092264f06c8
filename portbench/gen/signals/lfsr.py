"""Gold-like LFSR code generation for B2a (two 13-bit registers).

TPU-first redesign note: the reference shifts two 13-element bipolar vectors
chip-by-chip per PRN (`generateB2aDataCode.m:123-138`).  Here the registers
are 13-bit integers; the PRN-independent G1 sequence is generated once, and
the 63 G2 registers advance together as a vectorized numpy array, so all 63
PRNs cost one pass.
"""
from __future__ import annotations

import numpy as np

REG_BITS = 13


def _tap_mask(taps: tuple[int, ...]) -> int:
    """Cells are 1-based ICD register positions; cell j maps to bit (13-j),
    so cell 13 (the output cell) is bit 0."""
    mask = 0
    for cell in taps:
        mask |= 1 << (REG_BITS - cell)
    return mask


def _parity(values: np.ndarray, mask: int) -> np.ndarray:
    """Bitwise parity of (values & mask) for 13-bit values."""
    v = values & mask
    v ^= v >> 8
    v ^= v >> 4
    v ^= v >> 2
    v ^= v >> 1
    return v & 1


def lfsr_sequence(
    seeds: np.ndarray,
    taps: tuple[int, ...],
    length: int,
    reset_chip: int | None = None,
    reset_state: int | None = None,
) -> np.ndarray:
    """Generate bit sequences from parallel 13-bit Fibonacci LFSRs.

    seeds: (P,) int array of initial register states (MSB = cell 1).
    Returns (P, length) uint8 bit matrix.  Output bit each chip is cell 13
    (bit 0); feedback = parity over `taps` enters cell 1 (bit 12).  If
    reset_chip is given, registers are reset to reset_state after
    outputting that many chips (the reference's `ind == reset_index`
    G1 restart, `generateB2aDataCode.m:120,135-137`).
    """
    seeds = np.asarray(seeds, dtype=np.int32)
    mask = _tap_mask(taps)
    out = np.empty((seeds.shape[0], length), dtype=np.uint8)
    state = seeds.copy()
    for i in range(length):
        out[:, i] = state & 1
        fb = _parity(state, mask)
        state = (state >> 1) | (fb << (REG_BITS - 1))
        if reset_chip is not None and i + 1 == reset_chip:
            state[:] = reset_state
    return out
