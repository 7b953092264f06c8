"""The mix+prefix kernel's plain version (bds3_tpu_torch.track.prefix)
against a float64 numpy oracle and against the JAX Pallas kernel run in
interpret mode, as tests/test_pallas_prefix.py runs it, on the CPU.

The tolerance is tests/test_pallas_prefix.py's: 5e-4 of max|P_i| + 1 per
channel, since a float32 prefix over many samples is held to a float64
one (and to another float32 summation order)."""
import numpy as np
import pytest
import torch

from bds3_tpu.track.pallas_prefix import mix_prefix as jax_mix_prefix
from bds3_tpu_torch.track.prefix import (
    SPLIT,
    buffers,
    mix_prefix,
    mix_prefix_float64,
    mix_prefix_reference,
    random_inputs,
)

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
    before = mix_prefix.launches
    want = mix_prefix_reference(*args)
    got = mix_prefix(*args)
    out, scratch = buffers(2, n, "cpu")
    got_out = mix_prefix(*args, out=out, scratch=scratch)
    assert mix_prefix.launches == before
    assert got_out[0] is out[0] and got_out[1] is out[1]
    for g in (got, got_out):
        assert torch.equal(g[0], want[0]) and torch.equal(g[1], want[1])
    with pytest.raises(ValueError):
        mix_prefix(args[0].to("meta"), *args[1:])
