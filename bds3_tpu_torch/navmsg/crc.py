"""CRC-24Q (polynomial 0x864CFB) over bit vectors.

Replaces the reference's MATLAB Comms-Toolbox dependency
(`comm.CRCDetector([24 23 18 17 14 11 10 7 6 5 4 3 1 0])`,
BCNAV2decoding.m:100): zero initial state, no reflection, zero final XOR.
"""
from __future__ import annotations

import numpy as np

POLY = 0x864CFB  # bits 24,23,18,17,14,11,10,7,6,5,4,3,1,0


def crc24q(bits: np.ndarray) -> int:
    """CRC-24Q remainder of an MSB-first bit vector."""
    reg = 0
    for b in np.asarray(bits, dtype=np.uint8):
        reg = ((reg << 1) | int(b)) & 0xFFFFFFFF
        if reg & 0x1000000:
            reg ^= POLY | 0x1000000
    # flush 24 zero bits
    for _ in range(24):
        reg <<= 1
        if reg & 0x1000000:
            reg ^= POLY | 0x1000000
    return reg & 0xFFFFFF


def crc24q_check(frame_bits: np.ndarray) -> bool:
    """True if the last 24 bits are the CRC-24Q of the preceding bits."""
    frame_bits = np.asarray(frame_bits, dtype=np.uint8)
    data, crc = frame_bits[:-24], frame_bits[-24:]
    expect = crc24q(data)
    got = 0
    for b in crc:
        got = (got << 1) | int(b)
    return expect == got
