"""The exact cheap forms in the CUDA tracking kernel's sample loop
(csrc/track_fused.cu), on the CPU in numpy: each gives the value of the
form it replaces for every input the kernel can see.

  * mod1's fmodf(x, 1) is x - truncf(x) with x's sign;
  * the runs step j_f and r_f as float32 adds of 1 from (float)j0 and
    (float)(j0 % SPLIT);
  * a run's ceil(frac) is frac added onto 1.5 * 2^23 rounded up, read from
    the sum's bits, on the range of frac that chip_index_bound gives;
  * an int8 sample is its byte xored with 0x80 under the exponent of 2^23,
    less 2^23 + 128;
  * the samples outside runs (each rank slice's ragged head and tail) are
    the share PERF.md states for both presets.
"""
import numpy as np
import pytest
import torch

from bds3_tpu_torch.config import b1c_settings, b2a_settings
from bds3_tpu_torch.track.fused import (
    RUN_SAMPLES,
    chip_index_bound,
    choose_blocks,
    rank_runs,
    rank_slice,
)
from bds3_tpu_torch.track.state import SPLIT, make_track_config

F = np.float32
CEIL_MAGIC = F(12582912.0)          # 1.5 * 2^23 (track_fused.cu)
CEIL_MAGIC_BITS = 0x4B400000


def _near_integers(lo: int, hi: int, ulps: int) -> np.ndarray:
    """Every float32 within `ulps` ulps of each integer in [lo, hi)."""
    n = np.arange(lo, hi, dtype=np.float32)
    out = [n]
    up, down = n.copy(), n.copy()
    for _ in range(ulps):
        up = np.nextafter(up, F(np.inf))
        down = np.nextafter(down, F(-np.inf))
        out += [up, down]
    return np.concatenate(out)


def _fmod_inputs() -> np.ndarray:
    rng = np.random.default_rng(17)
    x = rng.uniform(-8192.0, 8192.0, 10_000_000).astype(np.float32)
    # small magnitudes, where the fraction keeps most of x's bits
    tiny = (rng.standard_normal(200_000) * 10.0 ** rng.integers(
        -30, 0, 200_000)).astype(np.float32)
    special = np.array([0.0, -0.0, 1.0, -1.0, 8191.5, -8191.5,
                        np.finfo(np.float32).tiny, -np.finfo(np.float32).tiny,
                        np.inf, -np.inf, np.nan], np.float32)
    return np.concatenate([x, tiny, _near_integers(-8192, 8192, 4), special])


def _bits(x: np.ndarray) -> np.ndarray:
    return x.view(np.int32)


def test_fmod_is_x_less_its_truncation_with_x_sign():
    """np.fmod(x, 1) (C's fmodf) equals copysign(x - trunc(x), x) bit for
    bit, the sign of a zero result included, over 10^7 random float32 in
    (-2^13, 2^13), every value within 4 ulps of each integer there, small
    magnitudes and the special values (NaN where fmodf gives NaN); and the
    kernel's floored mod1 built on either is the same."""
    x = _fmod_inputs()
    with np.errstate(invalid="ignore"):
        want = np.fmod(x, F(1.0))
        got = np.copysign(x - np.trunc(x), x)
    nan = np.isnan(want)
    assert np.array_equal(nan, np.isnan(got))
    assert np.array_equal(_bits(want[~nan]), _bits(got[~nan]))
    assert (want[~nan] == F(-0.0)).any() and np.signbit(
        want[~nan][want[~nan] == 0]).any()

    def floored(r):
        return np.where(r < F(0.0), r + F(1.0), r).astype(np.float32)

    a, b = floored(want[~nan]), floored(got[~nan])
    assert np.array_equal(_bits(a), _bits(b))
    # in [0, 1], 1 itself where a tiny negative fraction rounds up
    assert ((a >= 0) & (a <= 1)).all()


@pytest.mark.parametrize("make", [b2a_settings, b1c_settings],
                         ids=["b2a_preset", "b1c_preset"])
@pytest.mark.parametrize("dtype", list(RUN_SAMPLES))
def test_float_stepped_j_and_r_are_exact(make, dtype):
    """Over every j < n_max, in runs of RUN_SAMPLES[dtype] from j0 = run *
    RUN: (float)j0 + i equals float32(j) and (float)(j0 % SPLIT) + i
    equals float32(j % SPLIT), each add of i exact (n_max < 2^24)."""
    cfg = make_track_config(make())
    assert cfg.n_max < 1 << 24
    run = RUN_SAMPLES[dtype]
    j = np.arange(cfg.n_max, dtype=np.int64)
    j0, i = j - j % run, (j % run).astype(np.float32)
    j_f = j0.astype(np.float32) + i
    r_f = (j0 % SPLIT).astype(np.float32) + i
    assert np.array_equal(j_f, j.astype(np.float32))
    assert np.array_equal(r_f, (j % SPLIT).astype(np.float32))
    # no run crosses a SPLIT segment
    assert SPLIT % run == 0
    assert np.array_equal(j // SPLIT, j0 // SPLIT)


def _fadd_ru_magic(frac: np.ndarray) -> np.ndarray:
    """frac + 1.5 * 2^23 in float32, rounded up (IEEE roundTowardPositive):
    the sum lies in [2^23, 2^24], where float32 steps by 1, so it is the
    round-to-nearest sum, or the next float32 up where that fell below the
    exact sum (compared exactly in float64)."""
    near = frac + CEIL_MAGIC
    below = near.astype(np.float64) - float(CEIL_MAGIC) < frac.astype(
        np.float64)
    return np.where(below, np.nextafter(near, F(np.inf)), near)


@pytest.mark.parametrize("make", [
    b2a_settings, b1c_settings,
    lambda: b2a_settings(sampling_freq=10e6, intermediate_freq=2.5e6),
    lambda: b1c_settings(sampling_freq=30e6, intermediate_freq=7.5e6),
], ids=["b2a_preset", "b1c_preset", "b2a_10msps", "b1c_wb_30msps"])
def test_ceil_by_magic_add_equals_ceil_then_convert(make):
    """For every bank, on the frac range behind chip_index_bound (raw =
    ck_int + ceil(frac) - 1 within [lo, hi], ck_int in [0, L*m)), widened
    by 2: the bits of frac + 1.5 * 2^23 rounded up, less 0x4B400000,
    equal (int)ceilf(frac), which is also cvt.rpi's value; the sums stay
    in [2^23, 2^24], where the bits step with the integers."""
    cfg = make_track_config(make())
    rng = np.random.default_rng(5)
    for lo, hi, lm in chip_index_bound(cfg):
        f_lo, f_hi = lo - lm - 2, hi + 3
        frac = np.concatenate([
            rng.uniform(f_lo, f_hi, 2_000_000).astype(np.float32),
            _near_integers(f_lo, f_hi, 3)])
        assert np.abs(frac).max() < 2 ** 22
        s = _fadd_ru_magic(frac)
        assert (s >= F(2 ** 23)).all() and (s <= F(2 ** 24)).all()
        want = np.ceil(frac).astype(np.int64)
        assert np.array_equal(_bits(s).astype(np.int64) - CEIL_MAGIC_BITS,
                              want)


def test_int8_by_byte_permute_equals_the_conversion():
    """For all 256 int8 values b: the float whose bits are 0x4B000000 | (b
    ^ 0x80) (the byte permute of the kernel's int8 sample), less 2^23 +
    128 in float32, is float32(b), +0.0 for 0."""
    b = np.arange(-128, 128, dtype=np.int64)
    word = (0x4B000000 | ((b & 0xFF) ^ 0x80)).astype(np.uint32)
    got = word.view(np.float32) - F(8388736.0)
    want = b.astype(np.int8).astype(np.float32)
    assert np.array_equal(_bits(got), _bits(want))
    assert not np.signbit(got[b == 0]).any()


H100_RESIDENT = 132   # blocks K1 holds at once on an H100, one an SM
# the samples a full epoch sums outside runs, at the preset's nominal
# epoch length and the H100's blocks per channel (PERF.md section 3,
# layer 3): (channels, blocks, samples, share)
RAGGED = {"b2a_preset": (12, 11, 175, 0.00176),
          "b1c_preset": (10, 13, 198, 0.000199)}


def _ragged(n: int, blocks: int, run: int) -> int:
    out = 0
    for rank in range(blocks):
        lo, hi = rank_slice(n, blocks, rank)
        ra, rb = rank_runs(lo, hi, run)
        head, tail = min(ra * run, hi), max(rb * run, min(ra * run, hi))
        out += (head - lo) + (hi - tail)
    return out


@pytest.mark.parametrize("name,make", [("b2a_preset", b2a_settings),
                                       ("b1c_preset", b1c_settings)])
def test_ragged_share_of_the_presets(name, make):
    """The int8 runs leave each rank slice's ragged head and tail, under 16
    samples each, to the lone path: at the preset's nominal epoch (q0_int
    samples) and the blocks per channel the H100 gives its channels, 175
    of 99,375 B2a samples (0.176%) at 11 blocks and 198 of 993,750 B1C
    ones (0.0199%) at 13; within one run of that for epoch lengths around
    it."""
    channels, blocks, want, share = RAGGED[name]
    cfg = make_track_config(make())
    S = choose_blocks(H100_RESIDENT, channels)
    assert S == blocks
    run = RUN_SAMPLES[torch.int8]
    n = cfg.q0_int
    got = _ragged(n, S, run)
    assert got == want
    assert round(got / n, 6 if share < 1e-3 else 5) == share
    for m in range(n - 64, n + 64):
        assert _ragged(m, S, run) <= 2 * (run - 1) * S
