"""Digitizing chip sequences at the IF sampling rate.

Reference semantics (`makeB2aDataTable.m:59-67`, `makeDataTable.m:59-68`):
sample i (1-based) reads chip index ceil(i*ts/tc) with the last index
clamped to the code length — i.e. a zero-order hold with ceil rounding.
In 0-based terms: chip_idx(i) = ceil((i+1) * ts / tc) - 1, clamped.
"""
from __future__ import annotations

import numpy as np


def sample_chips(
    chips: np.ndarray, fs: float, chip_rate: float, n_samples: int
) -> np.ndarray:
    """Zero-order-hold sample `chips` (any dtype) at fs for n_samples.

    chip_rate is the rate of entries of `chips` (so for a BOC(1,1) waveform
    pass 2*code_freq and the half-chip array).
    """
    i = np.arange(1, n_samples + 1, dtype=np.float64)
    idx = np.ceil(i * (chip_rate / fs)).astype(np.int64) - 1
    idx = np.clip(idx, 0, len(chips) - 1)
    idx[-1] = len(chips) - 1
    return chips[idx]


def sample_chips_floor(
    chips: np.ndarray, fs: float, chip_rate: float, n_samples: int
) -> np.ndarray:
    """Floor-rounded zero-order hold, wrapping past the code end.

    Reference semantics of the B2a fine-acquisition sampler
    (`BDS-3_B2a/acquisition.m:279-284`): sample i (1-based) reads chip
    floor(i*ts/tc) mod L (0-based chip index).
    """
    i = np.arange(1, n_samples + 1, dtype=np.float64)
    idx = np.floor(i * (chip_rate / fs)).astype(np.int64) % len(chips)
    return chips[idx]


def sampled_code_table(
    chips: np.ndarray, fs: float, chip_rate: float, code_period_s: float
) -> np.ndarray:
    """Sampled waveform spanning exactly one code period."""
    n = int(round(fs * code_period_s))
    return sample_chips(chips, fs, chip_rate, n)
