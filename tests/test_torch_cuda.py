"""The CUDA kernels against their plain PyTorch versions, on the card: the
tracking kernel (track_fused.cu, for B2a and B1C narrowband and wideband),
the mix+prefix kernel (mix_prefix.cu) and the matrix-throughput kernel
(mxu_micro.cu); and tracking streamed block by block from a host source
against the resident run.  The port's own config and synthesis are used
throughout, so nothing here needs JAX.

Marked `cuda` and skipped without an NVIDIA GPU.  On a machine with one
(and without JAX, which tests/conftest.py imports) run:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import functools

import numpy as np
import pytest
import torch

from bds3_tpu_torch.benchmarks import mxu_micro
from bds3_tpu_torch.config import TrackMode, b1c_settings, b2a_settings
from bds3_tpu_torch.io import SatParams, synthesize_if
from bds3_tpu_torch.track import driver
from bds3_tpu_torch.track.fused import fused_track_block
from bds3_tpu_torch.track.prefix import (
    SPLIT,
    mix_prefix,
    mix_prefix_float64,
    buffers,
    mix_prefix_reference,
    random_inputs,
    scratch_words,
)
from bds3_tpu_torch.track.scan import (
    TrackState,
    pallas_prefix,
    track_block_bucket,
    track_block_reference,
    unpack_rows,
)
from bds3_tpu_torch.track.state import ChannelInit

pytestmark = pytest.mark.cuda

SATS = [SatParams(prn=19, doppler_hz=777.0, code_phase_chips=123.0,
                  amplitude=0.9),
        SatParams(prn=20, doppler_hz=-1200.0, code_phase_chips=5000.0,
                  amplitude=0.7)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _setup(dev, mode, epochs, s=None):
    s = s or b2a_settings(sampling_freq=10e6, intermediate_freq=2.5e6,
                          track_mode=mode)
    sig = synthesize_if(s, SATS, n_ms=(epochs + 15) * s.int_time * 1e3,
                        noise_std=1.0, seed=6)
    inits = []
    for sat in SATS:
        rate = s.code_freq_basis * (1 + sat.doppler_hz / s.carr_freq_basis)
        start = ((s.code_length - sat.code_phase_chips % s.code_length)
                 % s.code_length) / rate
        inits.append(ChannelInit(
            prn=sat.prn, acquired_freq=s.intermediate_freq + sat.doppler_hz,
            code_phase=int(round(start * s.sampling_freq)), peak_metric=2.0))
    cap = driver.as_capture(sig, dev)
    return cap, driver.setup_tracking(cap, s, inits, epochs, epochs)


def _rows(cfg, rows):
    return {n: v.cpu().numpy() for n, v in unpack_rows(cfg, rows).items()}


# blocks per channel: one, a cluster of two, and the size the wrapper
# chooses from the card's occupancy
CLUSTERS = [1, 2, None]


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("mode", [TrackMode.NARROWBAND, TrackMode.DATA_ONLY])
def test_kernel_matches_plain_version(cuda, mode, cluster):
    """Exact blksize and cursors; the same sums in another order agree
    within 1e-3 of |a|.mean()+1, whatever the cluster size."""
    cap, setup = _setup(cuda, mode, 30)
    before = fused_track_block.launches
    st_k, rows_k = fused_track_block(setup.cfg, cap, setup.tables,
                                     setup.consts, setup.state,
                                     _cluster=cluster)
    assert fused_track_block.launches == before + 1
    st_r, rows_r = track_block_reference(setup.cfg, cap, setup.tables,
                                         setup.consts, setup.state)
    torch.cuda.synchronize()
    assert torch.equal(st_k.cursor, st_r.cursor)
    k, r = _rows(setup.cfg, rows_k), _rows(setup.cfg, rows_r)
    np.testing.assert_array_equal(k["blksize"], r["blksize"])
    for n in r:
        scale = np.abs(r[n]).mean() + 1.0
        np.testing.assert_allclose(k[n] / scale, r[n] / scale, atol=1e-3,
                                   err_msg=n)


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("mode,blend", [
    (TrackMode.NARROWBAND, "composite"), (TrackMode.WIDEBAND, "composite"),
    (TrackMode.WIDEBAND, "nb"), (TrackMode.WIDEBAND, "split"),
    (TrackMode.WIDEBAND, "dotprod")])
def test_b1c_kernel_matches_plain_version(cuda, mode, blend, cluster):
    """B1C at 30 Msps (the wideband setup of tests/test_pallas_fused.py),
    10 epochs: exact blksize and cursors, every output within 1e-3 of
    |a|.mean()+1 (both sum exactly and round once), whatever the cluster
    size."""
    s = b1c_settings(sampling_freq=30e6, intermediate_freq=7.5e6,
                     track_mode=mode, wb_code_blend=blend)
    cap, setup = _setup(cuda, mode, 10, s)
    before = fused_track_block.launches
    st_k, rows_k = fused_track_block(setup.cfg, cap, setup.tables,
                                     setup.consts, setup.state,
                                     _cluster=cluster)
    assert fused_track_block.launches == before + 1
    st_r, rows_r = track_block_reference(setup.cfg, cap, setup.tables,
                                         setup.consts, setup.state)
    torch.cuda.synchronize()
    assert torch.equal(st_k.cursor, st_r.cursor)
    k, r = _rows(setup.cfg, rows_k), _rows(setup.cfg, rows_r)
    np.testing.assert_array_equal(k["blksize"], r["blksize"])
    for n in r:
        scale = np.abs(r[n]).mean() + 1.0
        np.testing.assert_allclose(k[n] / scale, r[n] / scale, atol=1e-3,
                                   err_msg=n)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    cap, setup = _setup(cuda, TrackMode.NARROWBAND, 10)
    bad_state = TrackState(setup.state.cursor, setup.state.statef.double())
    with pytest.raises(TypeError):
        fused_track_block(setup.cfg, cap, setup.tables, setup.consts,
                          bad_state)
    cpu_state = TrackState(setup.state.cursor.cpu(), setup.state.statef.cpu())
    with pytest.raises(ValueError):
        fused_track_block(setup.cfg, cap, setup.tables, setup.consts,
                          cpu_state)
    # clusters of 32 blocks are beyond the card: the launch is refused
    # and the wrapper raises
    with pytest.raises(RuntimeError):
        fused_track_block(setup.cfg, cap, setup.tables, setup.consts,
                          setup.state, _cluster=32)


def _prefix_args(dev, n=5 * SPLIT + 77):
    total = 60_000
    cursor = np.array([0, 23_456, total - 9000])
    blk = np.array([n, n - 2000, 12_000])
    capture, base, slope = random_inputs(3, len(cursor), n, total)
    args = (torch.from_numpy(capture).to(dev),
            torch.tensor(cursor, device=dev), torch.tensor(blk, device=dev),
            torch.from_numpy(base).to(dev), torch.from_numpy(slope).to(dev),
            n)
    return args, mix_prefix_float64(capture, cursor, blk, base, slope, n)


def test_mix_prefix_matches_plain_version_and_oracle(cuda):
    """A ragged last tile, a window past the capture's end and blk < n:
    within 5e-4 of max|P_i| + 1 (tests/test_pallas_prefix.py's tolerance)
    of the plain version and of the float64 oracle."""
    args, (want_i, want_q) = _prefix_args(cuda)
    before = mix_prefix.launches
    k_i, k_q = mix_prefix(*args)
    assert mix_prefix.launches == before + 1
    r_i, r_q = mix_prefix_reference(*args)
    torch.cuda.synchronize()
    for got_i, got_q in ((k_i, k_q), (r_i, r_q)):
        got_i, got_q = got_i.cpu().numpy(), got_q.cpu().numpy()
        for c in range(want_i.shape[0]):
            scale = np.abs(want_i[c]).max() + 1.0
            np.testing.assert_allclose(got_i[c] / scale, want_i[c] / scale,
                                       atol=5e-4)
            np.testing.assert_allclose(got_q[c] / scale, want_q[c] / scale,
                                       atol=5e-4)
    scale = float(r_i.abs().max()) + 1.0
    assert float((k_i - r_i).abs().max()) / scale <= 5e-4
    assert float((k_q - r_q).abs().max()) / scale <= 5e-4


def test_mix_prefix_rejects_what_the_kernel_does_not_take(cuda):
    args, _ = _prefix_args(cuda)
    capture, cursor, blk, base, slope, n = args
    with pytest.raises(ValueError):
        mix_prefix(capture, cursor.cpu(), blk, base, slope, n)
    with pytest.raises(TypeError):
        mix_prefix(capture, cursor, blk, base.double(), slope, n)
    with pytest.raises(TypeError):
        mix_prefix(capture, cursor, blk, base, slope.double(), n)
    with pytest.raises(ValueError):
        mix_prefix(capture, cursor, blk, base[:, :-1].contiguous(), slope, n)
    out, scratch = buffers(len(cursor), n, capture.device)
    with pytest.raises(ValueError):
        mix_prefix(capture, cursor, blk, base, slope, n, out=out,
                   scratch=scratch[:-1].contiguous())
    with pytest.raises(ValueError):
        mix_prefix(capture, cursor, blk, base, slope, n, out=out,
                   scratch=scratch.cpu())
    with pytest.raises(TypeError):
        mix_prefix(capture, cursor, blk, base, slope, n, out=out,
                   scratch=scratch.float())


def test_mix_prefix_is_repeatable(cuda):
    """Two calls on the same inputs, on fresh buffers and on one reused
    pair, give the same bits: the float64 carries are summed in a fixed
    order, whatever order the blocks run in.  One launch each."""
    args, _ = _prefix_args(cuda, n=40 * SPLIT + 3)
    out, scratch = buffers(len(args[1]), args[-1], cuda)
    before = mix_prefix.launches
    first = [t.clone() for t in mix_prefix(*args)]
    for got in (mix_prefix(*args), mix_prefix(*args, out=out,
                                              scratch=scratch),
                mix_prefix(*args, out=out, scratch=scratch)):
        torch.cuda.synchronize()
        assert torch.equal(got[0], first[0]) and torch.equal(got[1], first[1])
    assert mix_prefix.launches == before + 4


def test_mix_prefix_scratch_serves_later_calls(cuda):
    """One scratch, made for the largest shape, serves calls of other
    shapes and cursors in turn with no action between them, and gives
    what fresh buffers give, bit for bit."""
    _, shared = buffers(3, 9 * SPLIT, cuda)
    for n, shift in ((9 * SPLIT, 0), (SPLIT + 1, 0), (5 * SPLIT + 77, 1000),
                     (9 * SPLIT, 2000), (100, 5), (5 * SPLIT + 77, 0)):
        args, _ = _prefix_args(cuda, n=n)
        args = (args[0], args[1] + shift) + args[2:]
        want = mix_prefix(*args)
        got = mix_prefix(*args, scratch=shared)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert shared.numel() == scratch_words(3, 9 * SPLIT)


@pytest.mark.parametrize("n,cursor,blk", [
    (3000, [0, 1234, 59_900], [3000, 2000, 3000]),          # n < 4096
    (1, [0, 5, 59_999], [1, 1, 0]),                         # n = 1
    (3 * SPLIT + 5, [0, 100, 200], [0, -7, 3 * SPLIT + 5]),  # blk <= 0
    (2 * SPLIT + 17, [-5000, -1, -20_000], [10**6] * 3),    # cursor < 0
    (2 * SPLIT + 17, [60_000, 60_005, 59_997], [10**6] * 3),  # past the end
], ids=["n_lt_tile", "n_1", "blk_le_0", "cursor_below_0", "cursor_past_end"])
def test_mix_prefix_edge_windows(cuda, n, cursor, blk):
    """Windows at the edges, one launch each: within 5e-4 of max|P_i| + 1
    of the plain version and the oracle, and exactly zero where the window
    reads no sample."""
    total = 60_000
    capture, base, slope = random_inputs(4, len(cursor), n, total)
    args = (torch.from_numpy(capture).to(cuda),
            torch.tensor(cursor, device=cuda), torch.tensor(blk, device=cuda),
            torch.from_numpy(base).to(cuda), torch.from_numpy(slope).to(cuda),
            n)
    before = mix_prefix.launches
    k_i, k_q = mix_prefix(*args)
    assert mix_prefix.launches == before + 1
    r_i, r_q = mix_prefix_reference(*args)
    torch.cuda.synchronize()
    want_i, want_q = mix_prefix_float64(capture, np.array(cursor),
                                        np.array(blk), base, slope, n)
    cursor, blk = np.array(cursor), np.array(blk)
    reads = (np.minimum(blk, n) > 0) & (cursor < total) & (cursor + n > 0)
    for got_i, got_q in ((k_i, k_q), (r_i, r_q)):
        got_i, got_q = got_i.cpu().numpy(), got_q.cpu().numpy()
        for c in range(len(cursor)):
            scale = np.abs(want_i[c]).max() + 1.0
            np.testing.assert_allclose(got_i[c] / scale, want_i[c] / scale,
                                       atol=5e-4)
            np.testing.assert_allclose(got_q[c] / scale, want_q[c] / scale,
                                       atol=5e-4)
        assert not got_i[~reads].any() and not got_q[~reads].any()


@pytest.mark.parametrize("mode", [TrackMode.NARROWBAND, TrackMode.DATA_ONLY])
def test_bucket_pallas_block_matches_bucket_block(cuda, mode):
    """The prefix-sum path through the kernel, one block from the same
    state, against the same path with the kernel's plain version: exact
    blksize and cursors, correlators within 1e-3 of |a|.mean()+1.  Against
    the plain bucket path, whose carrier phase is rounded per sample, not
    per tile: the same geometry, and within 2e-2 (the tolerance between the
    reference's own bucket and bucket_pallas, test_correlator_equiv.py)."""
    cap, setup = _setup(cuda, mode, 30)
    args = (setup.cfg, cap, setup.tables, setup.consts, setup.state)
    before = mix_prefix.launches
    st_k, rows_k = driver.BLOCK_FNS["bucket_pallas"](*args)
    assert mix_prefix.launches == before + 30
    plain_prefix = functools.partial(pallas_prefix, mix=mix_prefix_reference)
    st_r, rows_r = track_block_bucket(*args, prefix_fn=plain_prefix)
    st_b, rows_b = driver.BLOCK_FNS["bucket"](*args)
    assert mix_prefix.launches == before + 30
    torch.cuda.synchronize()
    k, r, b = (_rows(setup.cfg, x) for x in (rows_k, rows_r, rows_b))
    for want, st, tol in ((r, st_r, 1e-3), (b, st_b, 2e-2)):
        assert torch.equal(st_k.cursor, st.cursor)
        np.testing.assert_array_equal(k["blksize"], want["blksize"])
        for n in want:
            scale = np.abs(want[n]).mean() + 1.0
            np.testing.assert_allclose(k[n] / scale, want[n] / scale,
                                       atol=tol, err_msg=n)


def _mxu_check(dev, shape, variant, iters, seed=5, offset=0):
    """K3 against mxu_micro_reference on seeded normal inputs, one launch:
    within 1e-5 of iters * sum |a||b| (float64).  a and b start `offset`
    elements into their storage."""
    M, K, N = shape
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal(offset + M * K)
                         .astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(offset + K * N)
                         .astype(np.float32))
    dtype = torch.bfloat16 if variant == "bf16" else torch.float32
    a = a.to(dev)[offset:].view(M, K)
    b = b.to(dev).to(dtype)[offset:].view(K, N)
    split = variant == "split"
    before = mxu_micro.mxu_micro.launches
    got = mxu_micro.mxu_micro(a, b, dtype, split, iters=iters)
    assert mxu_micro.mxu_micro.launches == before + 1
    want = mxu_micro.mxu_micro_reference(a, b, dtype, split, iters)
    torch.cuda.synchronize()
    scale = mxu_micro.abs_scale(a, b, iters)
    assert abs(float(got) - float(want)) <= 1e-5 * scale, (
        float(got), float(want), scale)


@pytest.mark.parametrize("variant", ["fp32", "bf16", "split"])
@pytest.mark.parametrize("shape", [(8, 128, 512), (128, 128, 1024),
                                   (256, 256, 256), (20, 32, 72),
                                   (32, 128, 512), (16, 128, 512)],
                         ids=lambda s: "x".join(map(str, s)))
def test_mxu_micro_matches_plain_version(cuda, shape, variant):
    """K3 against its plain version at 8 iterations; ragged tiles (20 x 72)
    and rows that pad the tile (M = 8, 16, 32) included."""
    _mxu_check(cuda, shape, variant, 8)


@pytest.mark.parametrize("variant", ["fp32", "bf16", "split"])
@pytest.mark.parametrize("iters", [0, 37, 2000])
def test_mxu_micro_chunks_the_iterations(cuda, iters, variant):
    """K3 at iteration counts that leave no chunk (0), ragged chunks of one
    iteration (37) and the bench's 2000, at (32, 128, 512)."""
    _mxu_check(cuda, (32, 128, 512), variant, iters)


@pytest.mark.parametrize("variant", ["fp32", "bf16", "split"])
def test_mxu_micro_takes_ragged_and_unaligned_operands(cuda, variant):
    """N a multiple of neither 4 nor 8, and a and b one element past a
    16-byte boundary: the kernel's element-wise load paths."""
    _mxu_check(cuda, (20, 32, 70), variant, 8, offset=1)


def test_mxu_micro_rejects_what_the_kernel_does_not_take(cuda):
    a = torch.ones((16, 24), device=cuda)
    with pytest.raises(ValueError):            # K not a multiple of 16
        mxu_micro.mxu_micro(a, torch.ones((24, 8), device=cuda))
    a = torch.ones((16, 32), device=cuda)
    with pytest.raises(TypeError):             # bf16 wants a bf16 b
        mxu_micro.mxu_micro(a, torch.ones((32, 8), device=cuda),
                            torch.bfloat16)
    with pytest.raises(ValueError):
        mxu_micro.mxu_micro(a, torch.ones((32, 8)))


@pytest.mark.parametrize("transport", ["none", "int4"])
def test_streamed_track_matches_resident(cuda, tmp_path, transport):
    """track() from a StreamingCapture, block by block through K1 with
    sync_each_block, against the resident run of the same capture (clipped
    to the int4 grid for "int4"): the same samples are read, so every
    output is equal."""
    from bds3_tpu_torch.io.stream import StreamingCapture

    s = b2a_settings(sampling_freq=10e6, intermediate_freq=2.5e6)
    sig = synthesize_if(s, SATS, n_ms=200.0, noise_std=1.0, seed=6)
    if transport == "int4":
        sig = np.clip(sig, -8, 7).astype(np.int8)
    path = tmp_path / "cap.bin"
    sig.tofile(path)
    _, setup = _setup(cuda, TrackMode.NARROWBAND, 40)
    inits = setup.inits
    res = driver.track(torch.from_numpy(sig).to(cuda), s, inits,
                       n_epochs=150, epochs_per_block=40, device=cuda)
    before = fused_track_block.launches
    got = driver.track(StreamingCapture(str(path)), s, inits, n_epochs=150,
                       epochs_per_block=40, device=cuda,
                       sync_each_block=True, transport=transport)
    assert fused_track_block.launches == before + 4
    assert got.n_epochs == res.n_epochs == 150
    np.testing.assert_array_equal(got.absolute_sample, res.absolute_sample)
    for n in res.outputs:
        np.testing.assert_array_equal(got.outputs[n], res.outputs[n],
                                      err_msg=n)
