"""BCH(21,6) / BCH(51,8) maximum-correlation decoding for B-CNAV1
subframe 1.

Parity with `BDS-3_B1C/include/BCH21_6Decoding.m:47-103` and
`BCH51_8Decoding.m`: every possible information word is re-encoded through
the ICD LFSR and correlated against the received bipolar symbols; the
decode succeeds when the best correlation clears the threshold.  Here the
hypothesis-encoding matrices are built once (host) and decoding is a
single matrix-vector product.
"""
from __future__ import annotations

import functools

import numpy as np

from bds3_tpu_torch.navmsg.bits import to_bits


def _encode_matrix(n_info: int, n_code: int, taps: tuple[int, ...]) -> np.ndarray:
    """(2^n_info, n_code) bipolar encodings of all information words.

    Encoding register semantics (BCH21_6Decoding.m:65-92): the info word is
    written MSB-first, mapped to bipolar (0->+1, 1->-1), flipped; each step
    outputs the last cell and feeds back the XOR of cells `taps` (1-based)
    into cell 1.
    """
    m = np.zeros((1 << n_info, n_code), dtype=np.int8)
    for hyp in range(1 << n_info):
        reg = list(to_bits(hyp, n_info)[::-1])  # fliplr of MSB-first
        out = []
        for _ in range(n_code):
            out.append(reg[-1])
            fb = 0
            for t in taps:
                fb ^= reg[t - 1]
            reg = [fb] + reg[:-1]
        m[hyp] = 1 - 2 * np.array(out, dtype=np.int8)
    return m


@functools.lru_cache(maxsize=None)
def _matrices():
    return {
        (21, 6): _encode_matrix(6, 21, (2, 4, 5, 6)),
        (51, 8): _encode_matrix(8, 51, (1, 4, 5, 6, 7, 8)),
    }


def bch_decode(symbols: np.ndarray, n_code: int, n_info: int,
               threshold: float) -> np.ndarray | None:
    """Decode bipolar symbols; returns the info bits (MSB first) or None.

    symbols: (n_code,) bipolar +-1 (received, 0->+1 1->-1 convention).
    """
    m = _matrices()[(n_code, n_info)]
    corr = m @ np.asarray(symbols, dtype=np.float64)
    best = int(np.argmax(corr))
    if corr[best] >= threshold:
        return to_bits(best, n_info)
    return None


def bch21_6_decode(symbols: np.ndarray) -> np.ndarray | None:
    """BCH(21,6), threshold 20 (BCH21_6Decoding.m:49)."""
    return bch_decode(symbols, 21, 6, 20.0)


def bch51_8_decode(symbols: np.ndarray) -> np.ndarray | None:
    """BCH(51,8), threshold 50 (BCH51_8Decoding.m:45)."""
    return bch_decode(symbols, 51, 8, 50.0)


def bch_decode_soft(symbols: np.ndarray, n_code: int,
                    n_info: int) -> tuple[np.ndarray, float]:
    """Thresholdless soft max-correlation decode: returns (info bits,
    normalized correlation in [-1, 1]).  The reference's hard thresholds
    (20/21, 50/51) require essentially error-free symbols; the LDPC
    extension path (bcnav1.py) decodes subframe 1 softly and gates on
    the normalized correlation instead."""
    m = _matrices()[(n_code, n_info)]
    s = np.asarray(symbols, dtype=np.float64)
    corr = m @ s
    best = int(np.argmax(corr))
    denom = np.abs(s).sum() or 1.0
    return to_bits(best, n_info), float(corr[best] / denom)


def bch_encode(info_bits: np.ndarray, n_code: int) -> np.ndarray:
    """Encode info bits -> bipolar code word (for tests / signal synthesis)."""
    n_info = len(info_bits)
    idx = 0
    for b in info_bits:
        idx = (idx << 1) | int(b)
    return _matrices()[(n_code, n_info)][idx]
