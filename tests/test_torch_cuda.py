"""The CUDA kernels against their plain PyTorch versions, on the card: the
tracking kernel (track_fused.cu, for B2a and B1C narrowband and wideband,
on int8, float32 and complex64 captures),
the mix+prefix kernel (mix_prefix.cu) and the matrix-throughput kernel
(mxu_micro.cu); and tracking streamed block by block from a host source
against the resident run.  The port's own config and synthesis are used
throughout, so nothing here needs JAX.

Marked `cuda` and skipped without an NVIDIA GPU.  On a machine with one
(and without JAX, which tests/conftest.py imports) run:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import dataclasses
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


def _inits(s):
    """Channels from the synthesized truth of SATS."""
    inits = []
    for sat in SATS:
        rate = s.code_freq_basis * (1 + sat.doppler_hz / s.carr_freq_basis)
        start = ((s.code_length - sat.code_phase_chips % s.code_length)
                 % s.code_length) / rate
        inits.append(ChannelInit(
            prn=sat.prn, acquired_freq=s.intermediate_freq + sat.doppler_hz,
            code_phase=int(round(start * s.sampling_freq)), peak_metric=2.0))
    return inits


def _setup(dev, mode, epochs, s=None):
    s = s or b2a_settings(sampling_freq=10e6, intermediate_freq=2.5e6,
                          track_mode=mode)
    sig = synthesize_if(s, SATS, n_ms=(epochs + 15) * s.int_time * 1e3,
                        noise_std=1.0, seed=6)
    cap = driver.as_capture(sig, dev)
    return cap, driver.setup_tracking(cap, s, _inits(s), epochs, epochs)


def _rows(cfg, rows):
    return {n: v.cpu().numpy() for n, v in unpack_rows(cfg, rows).items()}


# blocks per channel: one, two, and the count the wrapper chooses from the
# card's occupancy
CLUSTERS = [1, 2, None]


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("mode", [TrackMode.NARROWBAND, TrackMode.DATA_ONLY])
def test_kernel_matches_plain_version(cuda, mode, cluster):
    """Exact blksize and cursors; the same sums in another order agree
    within 1e-3 of |a|.mean()+1, whatever the blocks per channel."""
    cap, setup = _setup(cuda, mode, 30)
    before = fused_track_block.launches
    st_k, rows_k = fused_track_block(setup.cfg, cap, setup.tables,
                                     setup.consts, setup.state,
                                     _blocks=cluster)
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
                                     _blocks=cluster)
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


def _setup_kind(dev, s, epochs, kind):
    """A capture of `kind` for `s` and its setup: "float32" unquantized
    real samples, "complex64" an IQ8 capture's pairs widened on the card."""
    from bds3_tpu_torch.config import FileType
    from bds3_tpu_torch.io.transport import widen_iq8

    n_ms = (epochs + 15) * s.int_time * 1e3
    if kind == "complex64":
        iq = dataclasses.replace(s, file_type=FileType.IQ8)
        raw = synthesize_if(iq, SATS, n_ms=n_ms, noise_std=1.0, seed=6)
        cap = widen_iq8(torch.from_numpy(raw).to(dev))
    else:
        cap = torch.from_numpy(synthesize_if(
            s, SATS, n_ms=n_ms, noise_std=1.0, seed=6, quantize=False)).to(dev)
    return cap, driver.setup_tracking(cap, s, _inits(s), epochs, epochs)


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("kind", ["float32", "complex64"])
@pytest.mark.parametrize("signal_", ["b2a_nb", "b1c_wb"])
def test_kernel_variants_match_plain_version(cuda, signal_, kind, cluster):
    """K1's float32 and complex64 instances against the plain version on
    the same capture: B2a narrowband at 10 Msps (30 epochs) and B1C
    wideband at 30 Msps (10 epochs); exact blksize and cursors, every
    output within 1e-3 of |a|.mean()+1, whatever the blocks per channel."""
    if signal_ == "b2a_nb":
        s, epochs = b2a_settings(sampling_freq=10e6, intermediate_freq=2.5e6,
                                 track_mode=TrackMode.NARROWBAND), 30
    else:
        s, epochs = b1c_settings(sampling_freq=30e6, intermediate_freq=7.5e6,
                                 track_mode=TrackMode.WIDEBAND), 10
    cap, setup = _setup_kind(cuda, s, epochs, kind)
    assert setup.cfg.complex_input == (kind == "complex64")
    before = fused_track_block.launches
    st_k, rows_k = fused_track_block(setup.cfg, cap, setup.tables,
                                     setup.consts, setup.state,
                                     _blocks=cluster)
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


@pytest.mark.parametrize("as_", ["float32", "complex64"])
@pytest.mark.parametrize("mode", [TrackMode.NARROWBAND, TrackMode.WIDEBAND])
def test_kernel_variants_equal_int8_bit_for_bit(cuda, mode, as_):
    """K1 on capture.float() and on capture + 0j equals K1 on the int8
    capture bit for bit: the same values, and with Q = 0 the complex mix
    gives the same products (x c + 0 s = x c, 0 c - x s = -(x s)); B2a
    and B1C wideband (30 Msps), at the chosen blocks per channel."""
    if mode == TrackMode.NARROWBAND:
        cap, setup = _setup(cuda, mode, 30)
    else:
        cap, setup = _setup(cuda, mode, 10, b1c_settings(
            sampling_freq=30e6, intermediate_freq=7.5e6, track_mode=mode))
    st_a, rows_a = fused_track_block(setup.cfg, cap, setup.tables,
                                     setup.consts, setup.state)
    other = cap.float() if as_ == "float32" else cap.to(torch.complex64)
    cfg = dataclasses.replace(setup.cfg, complex_input=as_ == "complex64")
    st_b, rows_b = fused_track_block(cfg, other, setup.tables, setup.consts,
                                     setup.state)
    torch.cuda.synchronize()
    assert torch.equal(st_a.cursor, st_b.cursor)
    assert torch.equal(rows_a.view(torch.int32), rows_b.view(torch.int32))
    assert torch.equal(st_a.statef.view(torch.int32),
                       st_b.statef.view(torch.int32))


@pytest.mark.parametrize("source", ["complex64", "iq8_pairs"])
def test_streamed_complex_track_matches_resident(cuda, source):
    """track() of an IQ8 capture from the host, block by block through
    K1's complex instance (a complex64 array uploaded as it is, or
    IQ8Pairs: int8 pairs widened on the card), equals the resident run
    of the complex64 capture exactly."""
    from bds3_tpu_torch.config import FileType
    from bds3_tpu_torch.io.transport import IQ8Pairs

    s = b2a_settings(sampling_freq=10e6, intermediate_freq=2.5e6,
                     file_type=FileType.IQ8)
    raw = synthesize_if(s, SATS, n_ms=200.0, noise_std=1.0, seed=6)
    sig = (raw[:, 0].astype(np.float32)
           + 1j * raw[:, 1].astype(np.float32)).astype(np.complex64)
    res = driver.track(torch.from_numpy(sig).to(cuda), s, _inits(s),
                       n_epochs=150, epochs_per_block=40, device=cuda)
    before = fused_track_block.launches
    got = driver.track(sig if source == "complex64" else IQ8Pairs(raw), s,
                       _inits(s), n_epochs=150, epochs_per_block=40,
                       device=cuda, sync_each_block=True)
    assert fused_track_block.launches == before + 4
    assert got.n_epochs == res.n_epochs == 150
    np.testing.assert_array_equal(got.absolute_sample, res.absolute_sample)
    for n in res.outputs:
        np.testing.assert_array_equal(got.outputs[n], res.outputs[n],
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
    # a capture dtype the kernel has no instance for, or a complex one
    # for a config built for real input
    for bad_cap in (cap.to(torch.int16), cap.to(torch.complex64)):
        with pytest.raises(TypeError):
            fused_track_block(setup.cfg, bad_cap, setup.tables, setup.consts,
                              setup.state)
    # 200 blocks a channel are beyond the card: the cooperative launch is
    # refused and the wrapper raises
    with pytest.raises(RuntimeError):
        fused_track_block(setup.cfg, cap, setup.tables, setup.consts,
                          setup.state, _blocks=200)


# --- K1's sample loop at its edges, bit for bit -----------------------------
# The kernel sums each epoch in runs of 16 capture bytes with one wrap of the
# chip indices a run, and the rest sample by sample (csrc/track_fused.cu,
# sum_slice); each case below holds every output, the state and the cursors
# of a short block equal to the plain version's bits, for each instance.

KINDS = ["int8", "float32", "complex64"]


@functools.lru_cache(maxsize=None)
def _edge_block(kind, signal_="b2a"):
    """A 4-epoch block's (capture, setup) of `kind`: B2a at 10 Msps or B1C
    wideband at 30 Msps, both channels of SATS."""
    if signal_ == "b2a":
        s = b2a_settings(sampling_freq=10e6, intermediate_freq=2.5e6,
                         track_mode=TrackMode.NARROWBAND)
    else:
        s = b1c_settings(sampling_freq=30e6, intermediate_freq=7.5e6,
                         track_mode=TrackMode.WIDEBAND)
    dev = torch.device("cuda")
    if kind == "int8":
        return _setup(dev, s.track_mode, 4, s)
    return _setup_kind(dev, s, 4, kind)


def _bits(x):
    """float32 bits, every NaN as the one NaN (its payload is the
    library's, not the algorithm's: an epoch of all-zero samples divides
    0 by 0 in both versions)."""
    return torch.where(torch.isnan(x), torch.full_like(x, float("nan")),
                       x).view(torch.int32)


def _assert_bits_equal(cfg, cap, setup, state, cluster=None):
    st_k, rows_k = fused_track_block(cfg, cap, setup.tables, setup.consts,
                                     state, _blocks=cluster)
    st_r, rows_r = track_block_reference(cfg, cap, setup.tables,
                                         setup.consts, state)
    torch.cuda.synchronize()
    assert torch.equal(st_k.cursor, st_r.cursor)
    assert torch.equal(_bits(rows_k), _bits(rows_r)), \
        int((_bits(rows_k) != _bits(rows_r)).sum())
    assert torch.equal(_bits(st_k.statef), _bits(st_r.statef))


@pytest.mark.parametrize("offset", range(16))
@pytest.mark.parametrize("kind", KINDS)
def test_k1_runs_at_every_capture_offset(cuda, kind, offset):
    """The capture from element `offset` on (its first byte 0-15 bytes
    past a 16-byte boundary, and every run's load as far off), the
    cursors moved back to match."""
    cap, setup = _edge_block(kind)
    state = TrackState(setup.state.cursor - offset, setup.state.statef)
    _assert_bits_equal(setup.cfg, cap[offset:], setup, state)


@pytest.mark.parametrize("cluster", [1, 16])
@pytest.mark.parametrize("n_max", [7, 16, 17, 40, 257])
@pytest.mark.parametrize("kind", KINDS)
def test_k1_rank_slices_shorter_than_a_run(cuda, kind, n_max, cluster):
    """Epochs summed over their first n_max samples only: rank slices of
    0 to 17 samples, with no whole run, a run and ragged ends, or ragged
    ends alone.  (From 7 samples: a single int8 sample can sum to 0 and
    send the loop to NaN, whose epoch length the two versions convert to
    int differently.)"""
    cap, setup = _edge_block(kind)
    cfg = dataclasses.replace(setup.cfg, n_max=n_max)
    _assert_bits_equal(cfg, cap, setup, setup.state, cluster)


@pytest.mark.parametrize("kind", KINDS)
def test_k1_slice_crossing_a_split_boundary(cuda, kind):
    """Two ranks over 8,180 samples: rank 1's slice starts 6 samples
    before the SPLIT boundary 4,096 (a ragged head, then runs from the
    next coarse-table segment) and both slices cross one."""
    cap, setup = _edge_block(kind)
    assert 2 * SPLIT - 12 < int(setup.cfg.q0_int)
    cfg = dataclasses.replace(setup.cfg, n_max=2 * SPLIT - 12)
    _assert_bits_equal(cfg, cap, setup, setup.state, 2)


@pytest.mark.parametrize("where", ["before_0", "past_total"])
@pytest.mark.parametrize("signal_", ["b2a", "b1c_wb"])
@pytest.mark.parametrize("kind", KINDS)
def test_k1_zero_fill_at_the_capture_edges(cuda, kind, signal_, where):
    """Epochs that reach before sample 0 (cursors 5,003 samples early) or
    past the capture's end (the capture cut 5,003 samples into the last
    epoch of the channel that starts last): the samples outside read as
    zero, runs that straddle an edge included."""
    cap, setup = _edge_block(kind, signal_)
    state = setup.state
    if where == "before_0":
        state = TrackState(state.cursor - int(state.cursor.min()) - 5003,
                           state.statef)
    else:
        epochs = setup.cfg.epochs_per_block
        cap = cap[:int(state.cursor.max()) + (epochs - 1) * setup.cfg.q0_int
                  + 5003]
    _assert_bits_equal(setup.cfg, cap, setup, state)


@pytest.mark.parametrize("signal_", ["b2a", "b1c_wb"])
@pytest.mark.parametrize("kind", KINDS)
def test_k1_modulo_outside_wraps_once(cuda, kind, signal_):
    """A code phase thousands of chips outside the loop's normal range
    (6,500 chips of B2a's 10,230, 10,150 of B1C's), so the chip indices
    may leave (-L*m, 2*L*m): every sample takes the modulo instead of the
    runs' wrap, and the epochs are short."""
    from bds3_tpu_torch.track.fused import banks, wraps_once

    cap, setup = _edge_block(kind, signal_)
    cfg = setup.cfg
    rem = 6500.0 if signal_ == "b2a" else 10150.0
    statef = setup.state.statef.clone()
    statef[:, 0] = rem
    m, spacing, sm, _ = banks(cfg)[0]
    assert not wraps_once((rem - spacing) * m, (rem + spacing) * m, 0.0,
                          cfg.n_max, sm, cfg.code_length * m)
    _assert_bits_equal(cfg, cap, setup, TrackState(setup.state.cursor,
                                                   statef))


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


def test_mix_prefix_float32_instance(cuda):
    """K2's float32 instance: on the int8 capture's values as float32 it
    gives the int8 instance's P bit for bit (the two share everything
    after the load); on samples with fractions it is within 5e-4 of
    max|P_i| + 1 of the plain version and of the float64 oracle.  One
    launch each."""
    args, _ = _prefix_args(cuda)
    before = mix_prefix.launches
    want = mix_prefix(*args)
    got = mix_prefix(args[0].float(), *args[1:])
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    frac = np.random.default_rng(5).random(args[0].shape[0]) - 0.5
    host = (args[0].cpu().numpy() + frac).astype(np.float32)
    fargs = (torch.from_numpy(host).to(cuda),) + args[1:]
    k_i, k_q = mix_prefix(*fargs)
    assert mix_prefix.launches == before + 3
    r_i, r_q = mix_prefix_reference(*fargs)
    torch.cuda.synchronize()
    o_i, o_q = mix_prefix_float64(host, *(a.cpu().numpy()
                                          for a in args[1:5]), args[5])
    scale = np.abs(o_i).max(axis=1, keepdims=True) + 1.0
    for got_i, got_q in ((k_i, k_q), (r_i, r_q)):
        assert (np.abs(got_i.cpu().numpy() - o_i) / scale).max() <= 5e-4
        assert (np.abs(got_q.cpu().numpy() - o_q) / scale).max() <= 5e-4
    assert float((k_i - r_i).abs().max()) / scale.max() <= 5e-4
    assert float((k_q - r_q).abs().max()) / scale.max() <= 5e-4


def test_mix_prefix_rejects_what_the_kernel_does_not_take(cuda):
    args, _ = _prefix_args(cuda)
    capture, cursor, blk, base, slope, n = args
    for bad in (capture.to(torch.int16), capture.to(torch.complex64)):
        with pytest.raises(TypeError):
            mix_prefix(bad, cursor, blk, base, slope, n)
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
    reference's own bucket and bucket_pallas, test_correlator_equiv.py).
    On the capture's values as float32 (K2's float32 instance) the block
    is the int8 block bit for bit."""
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
    st_f, rows_f = driver.BLOCK_FNS["bucket_pallas"](
        setup.cfg, cap.float(), setup.tables, setup.consts, setup.state)
    torch.cuda.synchronize()
    assert mix_prefix.launches == before + 60
    assert torch.equal(rows_f, rows_k)
    assert all(torch.equal(a, b) for a, b in zip(st_f, st_k))


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


def test_parallel_ranks_on_one_card_equal_one_rank(cuda, tmp_path):
    """Channel fan-out (2 ranks x 2 channels) and time-sharded tracking (2
    ranks, 2 groups) with both ranks on this card over gloo: equal to
    the one-process track(), K1 launched in every rank and held to its
    plain version there."""
    from bds3_tpu_torch.parallel import worker

    s = b2a_settings(sampling_freq=10e6, intermediate_freq=2.5e6)
    sig = synthesize_if(s, SATS, n_ms=90.0, noise_std=1.0, seed=6)
    inits = _inits(s) * 2
    common = dict(settings="s", signal="sig", inits="inits", n_devices=2,
                  check_k1=True)
    cases = [dict(name="channel", mode="channel", epochs=30,
                  epochs_per_block=30, **common),
             dict(name="time", mode="time", epochs=60, n_groups=2,
                  **common)]
    worker.write_job(tmp_path / "job.npz", cases, {"s": s},
                     {"sig": sig, "inits": worker.inits_to_array(inits)})
    res = worker.run_job(2, tmp_path / "job.npz", tmp_path / "out.npz",
                         device="cuda:0", store=str(tmp_path / "store"),
                         timeout=600)
    for name, n_ep, per_block in (("channel", 30, 30), ("time", 60, 30)):
        ref = driver.track(sig, s, inits, n_epochs=n_ep,
                           epochs_per_block=per_block, device=cuda)
        for k, v in ref.outputs.items():
            np.testing.assert_array_equal(res[f"{name}/{k}"], v, err_msg=k)
        assert (res[f"{name}/k1_launches"] > 0).all()
        assert res[f"{name}/k1_check_blksize_equal"].all()
        assert res[f"{name}/k1_check_cursor_equal"].all()
        assert (res[f"{name}/k1_check_scaled_err"] <= 1e-3).all()


def test_track_spans_on_the_card(cuda):
    """track() on the card under the profiler: one `k1.launch` span a
    block, inside the launch loop's span, counted as K1's launches; the
    download's span after the loop's; the four kernels on the device's
    timeline."""
    from torch.profiler import ProfilerActivity, profile

    from bds3_tpu_torch.utils.trace import counters

    s = b2a_settings(sampling_freq=10e6, intermediate_freq=2.5e6)
    cap, setup = _setup(cuda, None, 40, s)
    kw = dict(n_epochs=40, epochs_per_block=10, device=cuda)
    driver.track(cap, s, setup.inits, **kw)                    # warm
    k1 = counters()["k1.launches"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        driver.track(cap, s, setup.inits, **kw)
    assert counters()["k1.launches"] - k1 == 4
    host, kernels = {}, []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if "track_fused_kernel" in e.name:
                kernels.append((e.time_range.start, e.time_range.end))
        else:
            host.setdefault(e.name, []).append((e.time_range.start,
                                                e.time_range.end))
    (b0, b1), = host["track.blocks"]
    assert len(host["k1.launch"]) == 4
    assert all(b0 <= a <= b <= b1 for a, b in host["k1.launch"])
    (d0, _), = host["track.download"]
    assert b1 <= d0
    assert len(kernels) == 4


# --- K1 spread over every SM (exchange through global memory) ---------------

def _render_setup(dev, s, n_channels, epochs=20):
    """A capture of SATS rendered on the card for `epochs` epochs of `s`
    and its setup, n_channels channels fanned out over SATS."""
    from bds3_tpu_torch.io.render import render_if

    cap = render_if(s, SATS, (epochs + 15) * s.int_time * 1e3, dev,
                    noise_std=1.0, seed=6)
    inits = (_inits(s) * n_channels)[:n_channels]
    return cap, driver.setup_tracking(cap, s, inits, epochs, epochs)


@pytest.mark.parametrize("case", ["b1c_preset", "capture_end", "b2a_preset"])
def test_spread_over_every_sm_equals_eight_blocks_and_plain(cuda, case):
    """K1 at the blocks per channel the wrapper chooses (floor(resident /
    C): 13 for the B1C preset's 10 channels and 11 for B2a's 12 on an
    H100) equals K1 at 8 blocks a channel (what clusters gave) and the
    plain version bit for bit (rows, state, cursors); and so does a B2a
    window whose last epochs run past the capture's end (zero fill) at 60
    blocks a channel."""
    from bds3_tpu_torch.track import fused

    if case == "b1c_preset":
        cap, setup = _render_setup(cuda, b1c_settings(), 10)
    elif case == "capture_end":
        cap, setup = _edge_block("int8")
        epochs = setup.cfg.epochs_per_block
        cap = cap[:int(setup.state.cursor.max())
                  + (epochs - 1) * setup.cfg.q0_int + 5003]
    else:
        cap, setup = _render_setup(cuda, b2a_settings(), 12)
    C = int(setup.state.cursor.shape[0])
    resident = fused.occupancy(setup.cfg, C, cuda.index or 0, cap.dtype)
    S = fused.blocks_per_channel(setup.cfg, C, cuda.index or 0, cap.dtype)
    assert S == resident // C >= 2
    if case == "capture_end":
        S = 60
    args = (setup.cfg, cap, setup.tables, setup.consts, setup.state)
    st_8, rows_8 = fused_track_block(*args, _blocks=8)
    st_s, rows_s = fused_track_block(*args, _blocks=S)
    torch.cuda.synchronize()
    assert torch.equal(st_s.cursor, st_8.cursor)
    assert torch.equal(_bits(rows_s), _bits(rows_8))
    assert torch.equal(_bits(st_s.statef), _bits(st_8.statef))
    _assert_bits_equal(*args[:2], setup, setup.state, S)


@pytest.mark.parametrize("spread", [3, 66])
@pytest.mark.parametrize("kind", KINDS)
def test_spread_layout_at_the_sample_loop_edges(cuda, kind, spread):
    """K1 bit for bit against the plain version on the edge block of each
    instance: at 66 blocks a channel (the card's whole width for 2
    channels) rank slices of ~150 samples, and at 3 slices that straddle
    SPLIT boundaries."""
    cap, setup = _edge_block(kind)
    _assert_bits_equal(setup.cfg, cap, setup, setup.state, spread)


def test_k1_counters_count_the_launches(cuda):
    """k1.blocks adds C * S blocks a launch, and k1.launches one, with or
    without the cooperative attribute (S = 1 launches without it)."""
    from bds3_tpu_torch.utils.trace import counters

    cap, setup = _edge_block("int8")
    args = (setup.cfg, cap, setup.tables, setup.consts, setup.state)
    before = counters()
    fused_track_block(*args, _blocks=1)
    fused_track_block(*args, _blocks=5)
    fused_track_block(*args, _blocks=7)
    torch.cuda.synchronize()
    after = counters()
    C = int(setup.state.cursor.shape[0])
    assert after["k1.launches"] - before["k1.launches"] == 3
    assert after["k1.blocks"] - before["k1.blocks"] == C * (1 + 5 + 7)


def test_spread_launch_that_cannot_be_resident_raises(cuda):
    """A launch of more blocks than the card holds at once is refused (a
    cooperative launch), raises, and leaves the card usable: the next
    launch runs and equals the plain version."""
    from bds3_tpu_torch.track import fused

    cap, setup = _edge_block("int8")
    C = int(setup.state.cursor.shape[0])
    resident = fused.occupancy(setup.cfg, C, cuda.index or 0, cap.dtype)
    with pytest.raises(RuntimeError, match="blocks failed"):
        fused_track_block(setup.cfg, cap, setup.tables, setup.consts,
                          setup.state, _blocks=resident // C + 1)
    _assert_bits_equal(setup.cfg, cap, setup, setup.state, 2)
