"""Bit-field helpers for navigation-message parsing.

Bit vectors are numpy uint8 arrays of {0,1}.  Field extractors take
MATLAB-style 1-based inclusive ranges so the layouts in ephemeris.py can
be compared line-by-line against the reference decoders.
"""
from __future__ import annotations

import numpy as np


def u(bits: np.ndarray, a: int, b: int) -> int:
    """Unsigned integer from bits a..b (1-based, inclusive, MSB first)."""
    v = 0
    for bit in bits[a - 1 : b]:
        v = (v << 1) | int(bit)
    return v


def s(bits: np.ndarray, a: int, b: int) -> int:
    """Two's-complement integer from bits a..b (Common/twosComp2dec.m)."""
    n = b - a + 1
    v = u(bits, a, b)
    return v - (1 << n) if bits[a - 1] else v


def to_bits(x: int, n: int) -> np.ndarray:
    """Integer -> n-bit MSB-first array."""
    return np.array([(x >> (n - 1 - i)) & 1 for i in range(n)], dtype=np.uint8)
