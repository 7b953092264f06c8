"""The bound of the CUDA tracking kernel K1 (`csrc/track_fused.cu`): a
frozen copy of `chip_smoke.py:track_fused_bound` and `roofline_ms`.

K1 runs W closed-loop epochs of every channel in one launch.  For the
epochs a launch ran (their lengths, blksize (W, C)) it needs, per sample:
the carrier (2 multiplies and 3 adds for the phase, its mod, the angle
multiply, one sine and one cosine, the two mixed products: 10; a complex
sample's mix 4 more); per bank of taps that share a chip grid (one, or
two for B1C wideband) two multiplies for the sample's ramp terms and,
for each of E/P/L, 3 adds and a ceil for the chip index (14); per tap six
multiply-adds (12).  Bytes: the capture span the launch reads, the chip
tables, the rows written.
"""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM, data sheet, at its 700 W limit: float32 outside the
# tensor cores, and HBM3 bandwidth
FP32_PEAK = 67e12      # operations per second
HBM_PEAK = 3.35e12     # bytes per second
STATE_SLOTS = 8        # the loop state written beside each epoch's outputs


def roofline_s(ops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take for `ops` float32 operations
    moving `nbytes` bytes [s], and which of the two bounds it."""
    t_ops, t_bytes = ops / FP32_PEAK, nbytes / HBM_PEAK
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def launch_bound(use_pilot: bool, wideband: bool, complex_input: bool,
                 code_length: int, m_data: int, m_p61: int, n_outputs: int,
                 blksize: np.ndarray, span: int, sample_bytes: int) -> dict:
    """K1's bound for one launch whose epochs had these lengths (blksize
    (W, C)) and whose channels read `span` samples of `sample_bytes` each
    (1 int8, 4 float32, 8 complex64); n_outputs is the number of per-epoch
    outputs (each row holds them and the loop state)."""
    taps = 2 if use_pilot else 1
    banks = 2 if wideband else 1
    per_sample = 10 + 14 * banks + 12 * (taps + (1 if wideband else 0)) \
        + (4 if complex_input else 0)
    samples = float(np.asarray(blksize).sum())
    n_ch = blksize.shape[1]
    tables = n_ch * (taps * (code_length * m_data + 32)
                     + (code_length * m_p61 + 32 if wideband else 0))
    rows = blksize.size * 4 * (n_outputs + STATE_SLOTS)
    s, by = roofline_s(samples * per_sample,
                       span * sample_bytes + tables + rows)
    return {"bound_s": s, "bound_by": by, "ops_per_sample": per_sample,
            "samples": samples}


def request_bound(lp, blksize: np.ndarray, cursor0: np.ndarray,
                  epochs_per_block: int, sample_bytes: int = 1) -> float:
    """K1's bound [s] summed over the launches of one `track()` request
    whose epochs had these lengths (blksize (C, E)), in blocks of
    `epochs_per_block` epochs from the channels' first code starts.  `lp`
    is the reference's `Loop` of the configuration."""
    blk = np.asarray(blksize, np.int64)
    before = np.concatenate([np.zeros((blk.shape[0], 1), np.int64),
                             np.cumsum(blk, 1)], 1) + cursor0[:, None]
    total = 0.0
    for e0 in range(0, blk.shape[1], epochs_per_block):
        e1 = min(e0 + epochs_per_block, blk.shape[1])
        span = int(before[:, e1].max() - before[:, e0].min())
        total += launch_bound(
            lp.use_pilot, lp.wideband, False, lp.code_length, lp.m_data,
            lp.m_p61, len(lp.output_names()), blk[:, e0:e1].T, span,
            sample_bytes)["bound_s"]
    return total
