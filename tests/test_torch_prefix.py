"""The mix+prefix kernel's plain version (bds3_tpu_torch.track.prefix)
against a float64 numpy oracle and against the JAX Pallas kernel run in
interpret mode, as tests/test_pallas_prefix.py runs it, on the CPU; the
buffers the kernel takes and the checks its wrapper makes on them; and the
edge windows the card tests hold the kernel to (`tools/card.py`).

The tolerance is tests/test_pallas_prefix.py's: 5e-4 of max|P_i| + 1 per
channel, since a float32 prefix over many samples is held to a float64
one (and to another float32 summation order)."""
import numpy as np
import pytest
import torch

from bds3_tpu.track.pallas_prefix import mix_prefix as jax_mix_prefix
from bds3_tpu_torch.tools import card
from bds3_tpu_torch.track.prefix import (
    SPLIT,
    buffers,
    mix_prefix,
    mix_prefix_float64,
    mix_prefix_reference,
    n_tiles,
    random_inputs,
    scratch_words,
)
from bds3_tpu_torch.utils.trace import counters

torch.set_num_threads(2)

TOL = 5e-4


def _assert_prefix_close(got_i, got_q, want_i, want_q):
    for c in range(want_i.shape[0]):
        scale = np.abs(want_i[c]).max() + 1.0
        np.testing.assert_allclose(got_i[c] / scale, want_i[c] / scale,
                                   atol=TOL, err_msg=f"P_i channel {c}")
        np.testing.assert_allclose(got_q[c] / scale, want_q[c] / scale,
                                   atol=TOL, err_msg=f"P_q channel {c}")


def _run_reference(capture, cursor, blk, base, slope, n):
    p_i, p_q = mix_prefix_reference(
        torch.from_numpy(capture), torch.tensor(cursor, dtype=torch.int64),
        torch.tensor(blk, dtype=torch.int64), torch.from_numpy(base),
        torch.from_numpy(slope), n)
    assert p_i.shape == p_q.shape == (len(cursor), n + 1)
    assert p_i.dtype == torch.float32
    return p_i.numpy(), p_q.numpy()


@pytest.mark.parametrize("n,cursor,blk", [
    # the Pallas test's shape: whole tiles, blk below and at n
    (4 * SPLIT, [0, 37, 1000], [4 * SPLIT - 10, 4 * SPLIT - 2000, 9000]),
    # a ragged last tile; one window runs past the capture's end, one
    # starts before its beginning, one has blk > n
    (3 * SPLIT + 123, [60_000 - 5000, -7, 500], [3 * SPLIT, 9000, 99_999]),
], ids=["whole_tiles", "ragged_and_edges"])
def test_reference_matches_numpy_oracle(n, cursor, blk):
    capture, base, slope = random_inputs(0, len(cursor), n, 60_000)
    got = _run_reference(capture, cursor, blk, base, slope, n)
    want = mix_prefix_float64(capture, np.array(cursor), np.array(blk), base,
                         slope, n)
    _assert_prefix_close(*got, *want)
    # masked samples add nothing: the total is the prefix at min(blk, n)
    for c in range(len(cursor)):
        assert got[0][c, -1] == got[0][c, min(max(blk[c], 0), n)]


def test_reference_matches_jax_kernel():
    """JAX's kernel takes pre-gathered windows and an in-window offset; with
    the window starting at the cursor (offset 0) and zero padding past the
    capture's end, both compute the same prefixes from the same phases.
    JAX stores no total: P[n] is held to the oracle."""
    n_ch, n = 3, 4 * SPLIT
    total = 30_000
    cursor = np.array([0, 12_345, total - 9000])
    blk = np.array([n - 10, n - 2000, 9000])
    capture, base, slope = random_inputs(1, n_ch, n, total)
    padded = np.concatenate([capture, np.zeros(n, np.int8)])
    windows = np.stack([padded[c:c + n] for c in cursor])
    j_i, j_q = jax_mix_prefix(windows, base, slope, np.zeros(n_ch, np.int32),
                              blk.astype(np.int32), interpret=True)
    got_i, got_q = _run_reference(capture, cursor, blk, base, slope, n)
    _assert_prefix_close(got_i[:, :n], got_q[:, :n], np.asarray(j_i),
                         np.asarray(j_q))
    want_i, want_q = mix_prefix_float64(capture, cursor, blk, base, slope, n)
    _assert_prefix_close(got_i, got_q, want_i, want_q)


def test_wrapper_runs_reference_on_cpu():
    """On CPU tensors the wrapper is the plain version, writes into `out`
    when given (the kernel's scratch is unused), and counts no kernel
    launch."""
    n = 2 * SPLIT + 5
    capture, base, slope = random_inputs(2, 2, n, 20_000)
    args = (torch.from_numpy(capture), torch.tensor([3, 11_000]),
            torch.tensor([n, 7000]), torch.from_numpy(base),
            torch.from_numpy(slope), n)
    before = counters()["k2.launches"]
    want = mix_prefix_reference(*args)
    got = mix_prefix(*args)
    out, scratch = buffers(2, n, "cpu")
    got_out = mix_prefix(*args, out=out, scratch=scratch)
    assert counters()["k2.launches"] == before
    assert got_out[0] is out[0] and got_out[1] is out[1]
    for g in (got, got_out):
        assert torch.equal(g[0], want[0]) and torch.equal(g[1], want[1])
    with pytest.raises(ValueError):
        mix_prefix(args[0].to("meta"), *args[1:])


@pytest.mark.parametrize("c,n", [(1, 1), (3, SPLIT), (10, 993_754),
                                 (5, 60_003)])
def test_buffers_make_the_kernels_scratch(c, n):
    """Two (C, n + 1) float32 outputs and the kernel's scratch: int64 zeros,
    a ticket counter and a generation, then the I and Q totals of each
    (channel, tile)."""
    (p_i, p_q), scratch = buffers(c, n, "cpu")
    for p in (p_i, p_q):
        assert p.shape == (c, n + 1) and p.dtype == torch.float32
    assert scratch_words(c, n) == 2 + 2 * c * n_tiles(n)
    assert scratch.shape == (scratch_words(c, n),)
    assert scratch.dtype == torch.int64 and scratch.is_contiguous()
    assert not scratch.any()


def _scratch_cases(c, n):
    words = scratch_words(c, n)
    return {
        "float32": (torch.zeros(words, dtype=torch.float32), TypeError),
        "one_word_short": (torch.zeros(words - 1, dtype=torch.int64),
                           ValueError),
        "two_dimensional": (torch.zeros(1, words, dtype=torch.int64),
                            ValueError),
        "strided": (torch.zeros(2 * words, dtype=torch.int64)[::2],
                    ValueError),
        "foreign_device": (torch.zeros(words, dtype=torch.int64,
                                       device="meta"), ValueError),
    }


@pytest.mark.parametrize("case", list(_scratch_cases(2, 5)))
def test_wrapper_refuses_a_foreign_or_misshaped_scratch(case):
    """The wrapper checks the scratch on any device, as the kernel needs
    it: int64, one dimension, contiguous, on the inputs' device, at least
    scratch_words(c, n) long.  A longer one (made for a larger shape) is
    taken."""
    n = 2 * SPLIT + 5
    capture, base, slope = random_inputs(2, 2, n, 20_000)
    args = (torch.from_numpy(capture), torch.tensor([3, 11_000]),
            torch.tensor([n, 7000]), torch.from_numpy(base),
            torch.from_numpy(slope), n)
    scratch, error = _scratch_cases(2, n)[case]
    with pytest.raises(error):
        mix_prefix(*args, scratch=scratch)
    out, _ = buffers(2, n, "cpu")
    with pytest.raises(ValueError):
        mix_prefix(*args, out=(out[0][:, :-1], out[1]))
    larger = buffers(3, 4 * n, "cpu")[1]
    got = mix_prefix(*args, out=out, scratch=larger)
    want = mix_prefix_reference(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("label,n,cursor,blk", card.prefix_edge_cases(),
                         ids=[e[0] for e in card.prefix_edge_cases()])
def test_reference_at_the_card_edge_windows(label, n, cursor, blk):
    """The edge windows the card tests hold the kernel to (n < 4096, n = 1,
    blk <= 0, cursors below 0 and past the capture's end), on the same
    inputs: the plain version within the tolerance of the oracle, and
    exactly zero where the window reads no sample."""
    total = card.PREFIX_EDGE_TOTAL
    capture, base, slope = random_inputs(9, len(cursor), n, total)
    got = _run_reference(capture, cursor, blk, base, slope, n)
    want = mix_prefix_float64(capture, np.array(cursor), np.array(blk), base,
                              slope, n)
    _assert_prefix_close(*got, *want)
    cursor, blk = np.array(cursor), np.array(blk)
    reads = (np.minimum(blk, n) > 0) & (cursor < total) & (cursor + n > 0)
    for p in got:
        assert not p[~reads].any()
        assert p[reads].any()


def test_card_prefix_inputs_and_bound():
    """K2's inputs at a shape as the card tests and tools/k2_times.py take
    them, and its bound: the valid samples read once and both rows written
    once over 3.35 TB/s."""
    n_ch, n = 4, 3 * SPLIT + 11
    capture, cursor, blk, base, slope = card.prefix_inputs(n_ch, n)
    assert capture.shape == (3 * n,) and capture.dtype == np.int8
    assert cursor.dtype == blk.dtype == np.int64 and len(cursor) == n_ch
    assert base.shape == (n_ch, n_tiles(n)) and slope.shape == (n_ch,)
    assert (blk < n).all() and (cursor + n > len(capture)).sum() == 2
    ms, by = card.prefix_bound(capture, cursor, blk, base, n)
    valid = sum(min(b, len(capture) - c) for c, b in zip(cursor, blk))
    assert by == "bytes"
    assert ms == pytest.approx((valid + 8 * n_ch * (n + 1) + base.nbytes)
                               / 3.35e12 * 1e3)
