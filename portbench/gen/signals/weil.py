"""Legendre sequences and truncated Weil codes (B1C primary/secondary codes).

TPU-first redesign note: the reference evaluates the Legendre symbol with a
recursive quadratic-reciprocity routine per index
(`BDS-3_B1C/include/JacobiSymbol.m`, called 10242x per code).  For prime N the
Legendre sequence is just the quadratic-residue indicator, which we build in
one vectorized O(N) pass — no recursion, no per-index work.
"""
from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def legendre_bits(n: int) -> np.ndarray:
    """Legendre indicator sequence L[0..n-1] for odd prime n.

    L[k] = 1 if k is a nonzero quadratic residue mod n, else 0 (L[0] = 0).
    Matches the reference's `JacobiSymbol`-built table with -1 mapped to 0
    (`generateDataBOC11.m:61-68`).
    """
    residues = (np.arange(1, (n - 1) // 2 + 1, dtype=np.int64) ** 2) % n
    bits = np.zeros(n, dtype=np.uint8)
    bits[residues] = 1
    return bits


def weil_code(n: int, w: int, p: int, length: int) -> np.ndarray:
    """Truncated Weil code in bipolar +-1 (int8).

    chip[i] = L[(i+p-1) mod n] xor L[(i+p-1+w) mod n], i = 0..length-1,
    then bit -> bipolar via 1-2*bit.  Semantics of
    `generateDataBOC11.m:76-82` with (w, p) from the ICD tables.
    """
    bits = legendre_bits(n)
    k = (np.arange(length, dtype=np.int64) + p - 1) % n
    code_bits = bits[k] ^ bits[(k + w) % n]
    return (1 - 2 * code_bits.astype(np.int8)).astype(np.int8)
