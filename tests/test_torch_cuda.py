"""The CUDA kernels against their plain PyTorch versions, on the card: the
tracking kernel (track_fused.cu, for B2a and B1C narrowband and wideband,
on int8, float32 and complex64 captures, at 10-30 Msps and at the
presets' 99.375 Msps), the mix+prefix kernel (mix_prefix.cu, at its edge
windows and at the tracking paths' epoch widths) and the
matrix-throughput kernel (mxu_micro.cu); tracking streamed block by
block from a host source against the resident run; the parallel paths
with their ranks on this card against one rank.  The port's own config
and synthesis are used throughout, so nothing here needs JAX.
tests/test_torch_cuda_paths.py drives the port's paths to their results
on the card.

Marked `cuda` and skipped without an NVIDIA GPU.  On a machine with one
(and without JAX, which tests/conftest.py imports) run:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import functools
from collections import defaultdict

import numpy as np
import pytest
import torch

from bds3_tpu_torch.benchmarks import mxu_micro
from bds3_tpu_torch.config import (
    FileType,
    TrackMode,
    b1c_settings,
    b2a_settings,
)
from bds3_tpu_torch.io import SatParams, synthesize_if
from bds3_tpu_torch import bench
from bds3_tpu_torch.tools import card
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
from bds3_tpu_torch.track.state import ChannelInit, make_track_config
from bds3_tpu_torch.utils.trace import counters

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
BLOCKS = [1, 2, None]


def _launches(name="k1.launches"):
    return counters()[name]


@functools.lru_cache(maxsize=None)
def _full_rate_capture(signal_, kind):
    """25 epochs of bench.B2A_SATS at the preset's 99.375 Msps of `signal_`
    ("b2a", or "b1c", whose narrowband and wideband settings share it),
    rendered on the card (noise 2.0, seed 11): int8, its float32 cast, or
    an IQ8 capture's pairs widened there to complex64."""
    from bds3_tpu_torch.io.render import render_if
    from bds3_tpu_torch.io.transport import widen_iq8

    s = b2a_settings() if signal_ == "b2a" else card.b1c_full_settings()
    if kind == "complex64":
        s = dataclasses.replace(s, file_type=FileType.IQ8)
    cap = render_if(s, bench.sat_params(bench.B2A_SATS, 0.65),
                    25 * s.int_time * 1e3, torch.device("cuda"),
                    noise_std=2.0, seed=11)
    if kind == "complex64":
        return widen_iq8(cap)
    return cap.float() if kind == "float32" else cap


# the presets' shapes at 99.375 Msps: settings and channels
FULL_RATE = {"b2a_99msps_12ch": (b2a_settings, 12),
             "b1c_preset_10ch": (b1c_settings, 10),
             "b1c_nb_99msps_10ch": (card.b1c_full_settings, 10)}


def _full_rate(s, n_channels, kind="int8"):
    """One 20-epoch block of `s` at 99.375 Msps, n_channels channels fanned
    out over bench.B2A_SATS from their truth, on _full_rate_capture's
    capture of `kind`: (capture, setup)."""
    cap = _full_rate_capture(s.signal.value, kind)
    inits = bench.make_inits(s, bench.B2A_SATS, n_channels)
    return cap, driver.setup_tracking(cap, s, inits, 20, 20)


def _full_rate_shape(name, kind="int8"):
    make, n_channels = FULL_RATE[name]
    return _full_rate(make(), n_channels, kind)


@pytest.mark.parametrize("blocks", BLOCKS)
@pytest.mark.parametrize("mode", [TrackMode.NARROWBAND, TrackMode.DATA_ONLY,
                                  "b2a_99msps_12ch"])
def test_kernel_matches_plain_version(cuda, mode, blocks):
    """Exact blksize and cursors; the same sums in another order agree
    within 1e-3 of |a|.mean()+1, whatever the blocks per channel: B2a at
    10 Msps (30 epochs) and at its preset (99.375 Msps, 12 channels over
    4 satellites, 20 epochs)."""
    cap, setup = _full_rate_shape(mode) if isinstance(mode, str) \
        else _setup(cuda, mode, 30)
    before = _launches()
    card.assert_block_agrees(setup, cap, blocks=(blocks,))
    assert _launches() == before + 1


B1C_BLENDS = [(TrackMode.NARROWBAND, "composite"),
              (TrackMode.WIDEBAND, "composite"), (TrackMode.WIDEBAND, "nb"),
              (TrackMode.WIDEBAND, "split"), (TrackMode.WIDEBAND, "dotprod")]


@pytest.mark.parametrize("blocks", BLOCKS)
@pytest.mark.parametrize("mode,blend,full_rate", [
    pytest.param(m, b, False, id=f"{int(m)}-{b}") for m, b in B1C_BLENDS] + [
    pytest.param(m, b, True, id=f"99msps-{int(m)}-{b}")
    for m, b in B1C_BLENDS])
def test_b1c_kernel_matches_plain_version(cuda, mode, blend, full_rate,
                                          blocks):
    """B1C at 30 Msps (the wideband setup of tests/test_pallas_fused.py),
    10 epochs, and at the preset's 99.375 Msps (10 channels over 4
    satellites, 20 epochs; narrowband, and wideband in each code blend):
    exact blksize and cursors, every output within 1e-3 of |a|.mean()+1
    (both sum exactly and round once), whatever the blocks per channel."""
    if full_rate:
        s = card.b1c_full_settings() if mode == TrackMode.NARROWBAND \
            else b1c_settings(wb_code_blend=blend)
        cap, setup = _full_rate(s, 10)
    else:
        s = b1c_settings(sampling_freq=30e6, intermediate_freq=7.5e6,
                         track_mode=mode, wb_code_blend=blend)
        cap, setup = _setup(cuda, mode, 10, s)
    before = _launches()
    card.assert_block_agrees(setup, cap, blocks=(blocks,))
    assert _launches() == before + 1


def _setup_kind(dev, s, epochs, kind):
    """A capture of `kind` for `s` and its setup: "float32" unquantized
    real samples, "complex64" an IQ8 capture's pairs widened on the card."""
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


@pytest.mark.parametrize("blocks", BLOCKS)
@pytest.mark.parametrize("kind", ["float32", "complex64"])
@pytest.mark.parametrize("signal_", ["b2a_nb", "b1c_wb", "b2a_99msps_12ch",
                                     "b1c_preset_10ch"])
def test_kernel_variants_match_plain_version(cuda, signal_, kind, blocks):
    """K1's float32 and complex64 instances against the plain version on
    the same capture: B2a narrowband at 10 Msps (30 epochs), B1C wideband
    at 30 Msps (10 epochs), and both presets at 99.375 Msps (20 epochs;
    float32 the int8 capture's cast there); exact blksize and cursors,
    every output within 1e-3 of |a|.mean()+1, whatever the blocks per
    channel."""
    if signal_ in FULL_RATE:
        cap, setup = _full_rate_shape(signal_, kind)
    elif signal_ == "b2a_nb":
        s = b2a_settings(sampling_freq=10e6, intermediate_freq=2.5e6,
                         track_mode=TrackMode.NARROWBAND)
        cap, setup = _setup_kind(cuda, s, 30, kind)
    else:
        s = b1c_settings(sampling_freq=30e6, intermediate_freq=7.5e6,
                         track_mode=TrackMode.WIDEBAND)
        cap, setup = _setup_kind(cuda, s, 10, kind)
    assert setup.cfg.complex_input == (kind == "complex64")
    before = _launches()
    card.assert_block_agrees(setup, cap, blocks=(blocks,))
    assert _launches() == before + 1


@pytest.mark.parametrize("as_", ["float32", "complex64"])
@pytest.mark.parametrize("mode", [TrackMode.NARROWBAND, TrackMode.WIDEBAND,
                                  "b2a_99msps_12ch", "b1c_preset_10ch"])
def test_kernel_variants_equal_int8_bit_for_bit(cuda, mode, as_):
    """K1 on capture.float() and on capture + 0j equals K1 on the int8
    capture bit for bit: the same values, and with Q = 0 the complex mix
    gives the same products (x c + 0 s = x c, 0 c - x s = -(x s)); B2a
    (10 Msps) and B1C wideband (30 Msps), and both presets at 99.375 Msps,
    at the chosen blocks per channel."""
    if mode in FULL_RATE:
        cap, setup = _full_rate_shape(mode)
    elif mode == TrackMode.NARROWBAND:
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
    from bds3_tpu_torch.io.transport import IQ8Pairs

    s = b2a_settings(sampling_freq=10e6, intermediate_freq=2.5e6,
                     file_type=FileType.IQ8)
    raw = synthesize_if(s, SATS, n_ms=200.0, noise_std=1.0, seed=6)
    sig = (raw[:, 0].astype(np.float32)
           + 1j * raw[:, 1].astype(np.float32)).astype(np.complex64)
    res = driver.track(torch.from_numpy(sig).to(cuda), s, _inits(s),
                       n_epochs=150, epochs_per_block=40, device=cuda)
    before = _launches()
    got = driver.track(sig if source == "complex64" else IQ8Pairs(raw), s,
                       _inits(s), n_epochs=150, epochs_per_block=40,
                       device=cuda, sync_each_block=True)
    assert _launches() == before + 4
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


def _assert_bits_equal(cfg, cap, setup, state, blocks=None):
    st_k, rows_k = fused_track_block(cfg, cap, setup.tables, setup.consts,
                                     state, _blocks=blocks)
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


@pytest.mark.parametrize("blocks", [1, 16])
@pytest.mark.parametrize("n_max", [7, 16, 17, 40, 257])
@pytest.mark.parametrize("kind", KINDS)
def test_k1_rank_slices_shorter_than_a_run(cuda, kind, n_max, blocks):
    """Epochs summed over their first n_max samples only: rank slices of
    0 to 17 samples, with no whole run, a run and ragged ends, or ragged
    ends alone.  (From 7 samples: a single int8 sample can sum to 0 and
    send the loop to NaN, whose epoch length the two versions convert to
    int differently.)"""
    cap, setup = _edge_block(kind)
    cfg = dataclasses.replace(setup.cfg, n_max=n_max)
    _assert_bits_equal(cfg, cap, setup, setup.state, blocks)


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


def _prefix_shape_args(dev, shape):
    """K2's arguments and the oracle's P at `shape`: "window_60k" (a ragged
    last tile, a window past the capture's end and blk < n; _prefix_args)
    or a label of card.prefix_shapes (a tracking path's epoch width and
    channels, on card.prefix_inputs)."""
    if shape == "window_60k":
        return _prefix_args(dev)
    _, s, c = next(x for x in card.prefix_shapes() if x[0] == shape)
    n = make_track_config(s).n_max
    host = card.prefix_inputs(c, n)
    args = tuple(torch.from_numpy(a).to(dev) for a in host) + (n,)
    return args, mix_prefix_float64(*host, n)


PREFIX_SHAPES = ["window_60k"] + [x[0] for x in card.prefix_shapes()]


@pytest.mark.parametrize("shape", PREFIX_SHAPES)
def test_mix_prefix_matches_plain_version_and_oracle(cuda, shape):
    """A ragged last tile, a window past the capture's end and blk < n, at
    a 60,000-sample window and at the tracking paths' epoch widths (B1C
    10 channels and B2a 12 at 99.375 Msps, the B1C receiver's 5 at 6
    Msps): within 5e-4 of max|P_i| + 1 (tests/test_pallas_prefix.py's
    tolerance) of the plain version and of the float64 oracle; a second
    call gives the same bits."""
    args, (want_i, want_q) = _prefix_shape_args(cuda, shape)
    before = _launches("k2.launches")
    k_i, k_q = mix_prefix(*args)
    again = mix_prefix(*args)
    assert _launches("k2.launches") == before + 2
    r_i, r_q = mix_prefix_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(k_i, again[0]) and torch.equal(k_q, again[1])
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


def _assert_float32_instance(dev, args, want):
    """K2's float32 instance: on the int8 capture's values as float32 it
    gives the int8 instance's P (`want`) bit for bit; on samples with
    fractions in [-0.5, 0.5) (a front end that does not quantize) it is
    within 5e-4 of max|P_i| + 1 of the plain version and of the float64
    oracle.  One launch each."""
    before = _launches("k2.launches")
    got = mix_prefix(args[0].float(), *args[1:])
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    frac = np.random.default_rng(5).random(args[0].shape[0]) - 0.5
    host = (args[0].cpu().numpy() + frac).astype(np.float32)
    fargs = (torch.from_numpy(host).to(dev),) + args[1:]
    k_i, k_q = mix_prefix(*fargs)
    assert _launches("k2.launches") == before + 2
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


@pytest.mark.parametrize("shape", PREFIX_SHAPES)
def test_mix_prefix_float32_instance(cuda, shape):
    """K2's float32 instance (_assert_float32_instance) at the shapes of
    test_mix_prefix_matches_plain_version_and_oracle: it shares
    everything after the load with the int8 instance."""
    args, _ = _prefix_shape_args(cuda, shape)
    _assert_float32_instance(cuda, args, mix_prefix(*args))


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
    before = _launches("k2.launches")
    first = [t.clone() for t in mix_prefix(*args)]
    for got in (mix_prefix(*args), mix_prefix(*args, out=out,
                                              scratch=scratch),
                mix_prefix(*args, out=out, scratch=scratch)):
        torch.cuda.synchronize()
        assert torch.equal(got[0], first[0]) and torch.equal(got[1], first[1])
    assert _launches("k2.launches") == before + 4


def _edge_args(dev, n, cursor, blk):
    """K2's arguments at one of card.prefix_edge_cases' windows."""
    capture, base, slope = random_inputs(9, len(cursor), n,
                                         card.PREFIX_EDGE_TOTAL)
    return (torch.from_numpy(capture).to(dev),
            torch.tensor(cursor, device=dev), torch.tensor(blk, device=dev),
            torch.from_numpy(base).to(dev), torch.from_numpy(slope).to(dev),
            n)


def test_mix_prefix_scratch_serves_later_calls(cuda):
    """One scratch, made for the largest shape, serves calls of other
    shapes and cursors in turn with no action between them, and gives
    what fresh buffers give, bit for bit: 60,000-sample windows of 3
    channels, the tracking paths' epoch widths at two sets of cursors,
    and the edge windows."""
    calls = []
    for n, shift in ((9 * SPLIT, 0), (SPLIT + 1, 0), (5 * SPLIT + 77, 1000),
                     (9 * SPLIT, 2000), (100, 5), (5 * SPLIT + 77, 0)):
        args, _ = _prefix_args(cuda, n=n)
        calls.append((args[0], args[1] + shift) + args[2:])
    for shape in PREFIX_SHAPES[1:]:
        args, _ = _prefix_shape_args(cuda, shape)
        calls += [(args[0], args[1] + shift) + args[2:]
                  for shift in (0, 12_345)]
    calls += [_edge_args(cuda, n, cursor, blk)
              for _, n, cursor, blk in card.prefix_edge_cases()]
    words = max(scratch_words(len(a[1]), a[-1]) for a in calls)
    shared = torch.zeros(words, dtype=torch.int64, device=cuda)
    for args in calls:
        want = mix_prefix(*args)
        got = mix_prefix(*args, scratch=shared)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert shared.numel() == words


@pytest.mark.parametrize("label,n,cursor,blk", card.prefix_edge_cases(),
                         ids=[e[0] for e in card.prefix_edge_cases()])
def test_mix_prefix_edge_windows(cuda, label, n, cursor, blk):
    """Windows at the edges (card.prefix_edge_cases: n < 4096, n = 1,
    blk <= 0, cursors below 0 and past the capture's end), one launch
    each: within 5e-4 of max|P_i| + 1 of the plain version and the oracle,
    and exactly zero where the window reads no sample; the float32
    instance as _assert_float32_instance holds it."""
    total = card.PREFIX_EDGE_TOTAL
    args = _edge_args(cuda, n, cursor, blk)
    before = _launches("k2.launches")
    k_i, k_q = mix_prefix(*args)
    assert _launches("k2.launches") == before + 1
    r_i, r_q = mix_prefix_reference(*args)
    torch.cuda.synchronize()
    want_i, want_q = mix_prefix_float64(args[0].cpu().numpy(),
                                        np.array(cursor), np.array(blk),
                                        args[3].cpu().numpy(),
                                        args[4].cpu().numpy(), n)
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
    _assert_float32_instance(cuda, args, (k_i, k_q))


@pytest.mark.parametrize("mode", [TrackMode.NARROWBAND, TrackMode.DATA_ONLY,
                                  "b2a_99msps_12ch", "b1c_nb_99msps_10ch"])
def test_bucket_pallas_block_matches_bucket_block(cuda, mode):
    """The prefix-sum path through the kernel, one block from the same
    state (B2a at 10 Msps, 30 epochs; B2a and B1C narrowband at 99.375
    Msps, 20 epochs), against the same path with the kernel's plain
    version: exact blksize and cursors, correlators within 1e-3 of
    |a|.mean()+1.  Against the plain bucket path, whose carrier phase is
    rounded per sample, not per tile: the same geometry, and within 2e-2
    (the tolerance between the reference's own bucket and bucket_pallas,
    test_correlator_equiv.py).  On the capture's values as float32 (K2's
    float32 instance) the block is the int8 block bit for bit."""
    cap, setup = _full_rate_shape(mode) if isinstance(mode, str) \
        else _setup(cuda, mode, 30)
    W = setup.cfg.epochs_per_block
    args = (setup.cfg, cap, setup.tables, setup.consts, setup.state)
    before = _launches("k2.launches")
    st_k, rows_k = driver.BLOCK_FNS["bucket_pallas"](*args)
    assert _launches("k2.launches") == before + W
    plain_prefix = functools.partial(pallas_prefix, mix=mix_prefix_reference)
    st_r, rows_r = track_block_bucket(*args, prefix_fn=plain_prefix)
    st_b, rows_b = driver.BLOCK_FNS["bucket"](*args)
    assert _launches("k2.launches") == before + W
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
    assert _launches("k2.launches") == before + 2 * W
    assert torch.equal(rows_f, rows_k)
    assert all(torch.equal(a, b) for a, b in zip(st_f, st_k))


def _mxu_check(dev, shape, variant, iters, seed=5, offset=0):
    """K3 against mxu_micro_reference on seeded normal inputs, one launch:
    within 1e-5 of iters * sum |a||b| (float64).  a and b start `offset`
    elements into their storage.  Returns a, b, the plain result and the
    tolerance."""
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
    before = _launches("k3.launches")
    got = mxu_micro.mxu_micro(a, b, dtype, split, iters=iters)
    assert _launches("k3.launches") == before + 1
    want = mxu_micro.mxu_micro_reference(a, b, dtype, split, iters)
    torch.cuda.synchronize()
    scale = mxu_micro.abs_scale(a, b, iters)
    assert abs(float(got) - float(want)) <= 1e-5 * scale, (
        float(got), float(want), scale)
    return a, b, float(want), 1e-5 * scale


@pytest.mark.parametrize("variant", ["fp32", "bf16", "split"])
@pytest.mark.parametrize("shape", [(8, 128, 512), (128, 128, 1024),
                                   (256, 256, 256), (20, 32, 72),
                                   (32, 128, 512), (16, 128, 512),
                                   (64, 128, 512), (128, 128, 512),
                                   (32, 128, 768), (128, 128, 128)],
                         ids=lambda s: "x".join(map(str, s)))
def test_mxu_micro_matches_plain_version(cuda, shape, variant):
    """K3 against its plain version at 8 iterations, at every shape of the
    bench (mxu_micro.SHAPES); ragged tiles (20 x 72) and rows that pad
    the tile (M = 8, 16, 32) included."""
    _mxu_check(cuda, shape, variant, 8)


@pytest.mark.parametrize("variant", ["fp32", "bf16", "split"])
@pytest.mark.parametrize("iters", [0, 37, 2000])
def test_mxu_micro_chunks_the_iterations(cuda, iters, variant):
    """K3 at iteration counts that leave no chunk (0), ragged chunks of one
    iteration (37) and the bench's 2000, at (32, 128, 512)."""
    _mxu_check(cuda, (32, 128, 512), variant, iters)


@pytest.mark.parametrize("M,K,N,dtype,split", mxu_micro.bench_shapes(),
                         ids=[f"{M}x{K}x{N}-{mxu_micro.variant_of(d, sp)}"
                              for M, K, N, d, sp in mxu_micro.bench_shapes()])
def test_mxu_micro_at_the_bench_settings(cuda, M, K, N, dtype, split):
    """K3 at each (shape, variant) the bench runs, at its ITERS and with the
    chunks k3.plan gives them, against its plain version; and the
    yardstick, one torch.mm over the concatenated operands, within the
    same tolerance where its result is float32 (cuBLAS's bf16 result is
    timed, not checked)."""
    variant = mxu_micro.variant_of(dtype, split)
    a, b, want, lim = _mxu_check(cuda, (M, K, N), variant, mxu_micro.ITERS)
    mode = card.mxu_one_call_mode(variant, cuda)
    if mode != "bf16_out":
        a_cat, b_rep = card.mxu_one_call_operands(a, b, variant,
                                                  mxu_micro.ITERS)
        got = float(card.mxu_one_call(a_cat, b_rep, mode))
        assert abs(got - want) <= lim, (got, want, lim)


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


@pytest.mark.parametrize("transport", ["none", "int4", "int2",
                                       "download_false"])
def test_streamed_track_matches_resident(cuda, tmp_path, transport):
    """track() from a StreamingCapture, block by block through K1 with
    sync_each_block, against the resident run of the same capture (on the
    int4 grid for "int4", the int2 levels -3, -1, 1, 3 for "int2"): the
    same samples are read, so every output is equal.  With download=False
    ("none" transport) the outputs stay on the card and realize() gives
    the same arrays."""
    from bds3_tpu_torch.io.stream import StreamingCapture

    s = b2a_settings(sampling_freq=10e6, intermediate_freq=2.5e6)
    sig = synthesize_if(s, SATS, n_ms=200.0, noise_std=1.0, seed=6)
    if transport == "int4":
        sig = np.clip(sig, -8, 7).astype(np.int8)
    elif transport == "int2":
        sig = (np.where(sig < 0, -1, 1)
               * np.where(np.abs(sig.astype(np.int16)) >= 3, 3, 1)
               ).astype(np.int8)
    path = tmp_path / "cap.bin"
    sig.tofile(path)
    _, setup = _setup(cuda, TrackMode.NARROWBAND, 40)
    inits = setup.inits
    res = driver.track(torch.from_numpy(sig).to(cuda), s, inits,
                       n_epochs=150, epochs_per_block=40, device=cuda)
    lazy = transport == "download_false"
    before = _launches()
    got = driver.track(StreamingCapture(str(path)), s, inits, n_epochs=150,
                       epochs_per_block=40, device=cuda,
                       sync_each_block=True, download=not lazy,
                       transport="none" if lazy else transport)
    assert _launches() == before + 4
    assert got.n_epochs == res.n_epochs == 150
    outputs = got.outputs
    if lazy:
        assert got.absolute_sample is None
        outputs = outputs.realize()
        assert sorted(outputs) == sorted(res.outputs)
    else:
        np.testing.assert_array_equal(got.absolute_sample,
                                      res.absolute_sample)
    for n in res.outputs:
        np.testing.assert_array_equal(outputs[n], res.outputs[n], err_msg=n)


def _parallel_job(tmp_path, nproc, cases, settings, arrays=None,
                  signal_files=None, backend="gloo"):
    """`cases` on nproc ranks of parallel.worker, all on this card
    (parallel.launch.launch_local, a FileStore rendezvous): rank 0's
    results."""
    from bds3_tpu_torch.parallel import worker

    worker.write_job(tmp_path / "job.npz", cases, settings, arrays,
                     signal_files)
    return worker.run_job(nproc, tmp_path / "job.npz", tmp_path / "out.npz",
                          device="cuda:0", backend=backend,
                          store=str(tmp_path / "store"), timeout=600)


def _assert_k1_ranks(res, case, n):
    """Every rank of `case` launched K1 and held a block of it to its plain
    version within 1e-3 of |a|.mean()+1 (blksize and cursors exact)."""
    assert (res[f"{case}/k1_launches"][:n] > 0).all()
    assert res[f"{case}/k1_check_blksize_equal"].all()
    assert res[f"{case}/k1_check_cursor_equal"].all()
    assert (res[f"{case}/k1_check_scaled_err"] <= 1e-3).all()


def _parallel_channel_time_10msps(dev, tmp_path):
    """Channel fan-out (2 ranks x 2 channels) and time-sharded tracking (2
    ranks, 2 groups) at 10 Msps over gloo: equal to the one-process
    track() bit for bit."""
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
    res = _parallel_job(tmp_path, 2, cases, {"s": s},
                        {"sig": sig, "inits": worker.inits_to_array(inits)})
    for name, n_ep, per_block in (("channel", 30, 30), ("time", 60, 30)):
        ref = driver.track(sig, s, inits, n_epochs=n_ep,
                           epochs_per_block=per_block, device=dev)
        for k, v in ref.outputs.items():
            np.testing.assert_array_equal(res[f"{name}/{k}"], v, err_msg=k)
        _assert_k1_ranks(res, name, 2)


def _parallel_nccl_world1(dev, tmp_path):
    """The B2a preset's 12 channels on card.capture("full"), 2000 epochs in
    one block through sharded_track_block on a world of one rank over
    NCCL: equal to the one-process track() bit for bit."""
    from bds3_tpu_torch.parallel import worker

    s = b2a_settings()
    np.save(tmp_path / "full.npy", card.capture("full"))
    inits = bench.make_inits(s, bench.B2A_SATS, 12)
    res = _parallel_job(
        tmp_path, 1, [dict(name="channel", mode="channel", n_devices=1,
                           settings="s", signal="full", inits="inits",
                           epochs=2000, epochs_per_block=2000,
                           check_k1=True)],
        {"s": s}, {"inits": worker.inits_to_array(inits)},
        {"full": tmp_path / "full.npy"}, backend="nccl")
    ref = driver.track(torch.from_numpy(np.array(card.capture("full")))
                       .to(dev), s, inits, n_epochs=2000,
                       epochs_per_block=2000, device=dev)
    for k, v in ref.outputs.items():
        np.testing.assert_array_equal(res[f"channel/{k}"], v, err_msg=k)
    _assert_k1_ranks(res, "channel", 1)


def _parallel_time2d_b1c_preset(dev, tmp_path):
    """The B1C preset (wideband, composite, 10 channels) on a ("time",
    "channel") mesh of (2, 2) over gloo, 200 epochs of
    card.capture("b1c_full") in time segments of 100, one group of 10
    channels split 5 and 5: against the one-process track() at
    epochs_per_block = 100, blksize exactly and the correlators (the
    BOC(6,1) bank's included) and discriminators within rtol 3e-5, atol
    3e-4 (tests/test_timeshard_track.py:52-54)."""
    from bds3_tpu_torch.parallel import worker

    s = b1c_settings()
    np.save(tmp_path / "b1c.npy", card.capture("b1c_full"))
    inits = bench.make_inits(s, bench.B2A_SATS, 10)
    res = _parallel_job(
        tmp_path, 4, [dict(name="time2d", mode="time2d", n_devices=4,
                           shape=[2, 2], settings="s", signal="b1c",
                           inits="inits", epochs=200, n_groups=1,
                           check_k1=True)],
        {"s": s}, {"inits": worker.inits_to_array(inits)},
        {"b1c": tmp_path / "b1c.npy"})
    ref = driver.track(torch.from_numpy(np.array(card.capture("b1c_full")))
                       .to(dev), s, inits, n_epochs=200,
                       epochs_per_block=100, device=dev).outputs
    assert "time2d/p61_ip" in res
    np.testing.assert_array_equal(res["time2d/blksize"], ref["blksize"])
    for k in ("d_ip", "d_qp", "carr_err", "code_err", "p61_ip", "p61_qp"):
        np.testing.assert_allclose(res[f"time2d/{k}"], ref[k], rtol=3e-5,
                                   atol=3e-4, err_msg=k)
    _assert_k1_ranks(res, "time2d", 4)


def _parallel_acq_b2a_99msps(dev, tmp_path):
    """Acquisition over 2 ranks of the B2a preset's 63 PRNs on
    card.capture("full"): the PRN-sharded (PRNs padded to 64 with a
    repeat) and Doppler-sharded (bins padded to an even count) coarse
    searches against one coarse_search on the same grid, winners equal
    and peaks within 1e-5; the time-sharded non-coherent search (4 rounds
    a rank) against one rank's 8 rounds, winners equal, the cube within
    1e-5, and bench.B2A_SATS won at their bins."""
    from bds3_tpu_torch.acquire.pcps import (
        acq_code_tables, coarse_search, make_acq_config)
    from bds3_tpu_torch.parallel.mesh import make_mesh
    from bds3_tpu_torch.parallel.timeshard import (
        noncoherent_acquire_timesharded)
    from bds3_tpu_torch.utils.phase import phase_tables

    s = b2a_settings()
    sig = card.capture("full")
    np.save(tmp_path / "full.npy", sig)
    cfg = make_acq_config(s)
    prns = list(s.acq_satellite_list)
    grids = {"prn": (prns + prns[-1:], cfg.n_bins),
             "doppler": (prns, 2 * -(-cfg.n_bins // 2))}
    rounds = 4
    cases = [dict(name=m, mode=f"acq_{m}", n_devices=2, settings="s",
                  signal="full", prns=p, bins=b)
             for m, (p, b) in grids.items()]
    cases.append(dict(name="noncoh", mode="acq_noncoh", n_devices=2,
                      settings="s", signal="full", prns=prns,
                      rounds=rounds))
    res = _parallel_job(tmp_path, 2, cases, {"s": s},
                        signal_files={"full": tmp_path / "full.npy"})
    sig_t = torch.from_numpy(np.asarray(sig[: cfg.n_fft], np.float32)).to(dev)
    n = len(prns)
    for m, (p, b) in grids.items():
        d8, p8 = (torch.from_numpy(x).to(dev)
                  for x in acq_code_tables(s, np.asarray(p)))
        freqs = cfg.freq_base + cfg.freq_step * np.arange(b)
        a_b, c1_b = (torch.from_numpy(x).to(dev)
                     for x in phase_tables(freqs, cfg.fs))
        v, bb, ph = (x.cpu().numpy() for x in coarse_search(
            sig_t, d8, p8, a_b, c1_b, dataclasses.replace(cfg, n_bins=b)))
        np.testing.assert_array_equal(res[f"{m}/bin"][:n], bb[:n])
        np.testing.assert_array_equal(res[f"{m}/phase"][:n], ph[:n])
        assert (np.abs(res[f"{m}/peak"][:n] - v[:n]) / v[:n]).max() <= 1e-5
    cube1, f1, p1 = noncoherent_acquire_timesharded(
        make_mesh(1, device=dev), np.asarray(sig), s, prns, 2 * rounds)
    np.testing.assert_array_equal(res["noncoh/freq"], f1)
    np.testing.assert_array_equal(res["noncoh/phase"], p1)
    assert (np.abs(res["noncoh/cube"] - cube1) / np.abs(cube1)).max() <= 1e-5
    for prn, fd, cp in bench.B2A_SATS:
        i = prns.index(prn)
        assert abs(res["noncoh/freq"][i] - (s.intermediate_freq + fd)) \
            <= cfg.freq_step / 2
        rate = s.code_freq_basis * (1 + fd / s.carr_freq_basis)
        expect = ((s.code_length - cp % s.code_length) % s.code_length) \
            / rate * s.sampling_freq
        err = (res["noncoh/phase"][i] - expect) % s.samples_per_code
        assert min(err, s.samples_per_code - err) \
            <= s.sampling_freq / s.code_freq_basis


PARALLEL = {"channel_time_10msps": _parallel_channel_time_10msps,
            "nccl_world1_b2a_99msps": _parallel_nccl_world1,
            "time2d_b1c_preset": _parallel_time2d_b1c_preset,
            "acq_b2a_99msps": _parallel_acq_b2a_99msps}


@pytest.mark.parametrize("case", list(PARALLEL))
def test_parallel_ranks_on_one_card_equal_one_rank(cuda, tmp_path, case):
    """The parallel paths with their ranks side by side on this card, each
    against the one-process run (PARALLEL's functions say how); every
    tracking rank launches K1 and holds a block of it to its plain
    version."""
    PARALLEL[case](cuda, tmp_path)


def test_track_spans_on_the_card(cuda):
    """track() on the card under the profiler: one `k1.launch` span a
    block, inside the launch loop's span, counted as K1's launches; one
    `track.download` and one `track.assemble` span a block, inside the
    loop for a block with LOOKAHEAD blocks launched after it, after the
    loop for the last LOOKAHEAD (here every block), the first drain after
    block LOOKAHEAD's launch (here the last); the four kernels on the
    device's timeline."""
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
    (r0, r1), = host["track"]
    (b0, b1), = host["track.blocks"]
    assert len(host["k1.launch"]) == 4
    assert all(b0 <= a <= b <= b1 for a, b in host["k1.launch"])
    down = sorted(host["track.download"])
    asm = sorted(host["track.assemble"])
    assert len(down) == len(asm) == 4
    looped = max(0, len(down) - driver.LOOKAHEAD)
    assert all(b0 <= a <= b <= b1 for a, b in down[:looped] + asm[:looped])
    assert all(b1 <= a <= b <= r1 for a, b in down[looped:] + asm[looped:])
    # the first drain once LOOKAHEAD blocks are queued behind block 0,
    # or, with fewer blocks, after the last launch
    first = min(driver.LOOKAHEAD, len(down) - 1)
    assert sorted(host["k1.launch"])[first][1] <= down[0][0]
    assert len(kernels) == 4


@functools.lru_cache(maxsize=None)
def _drain_capture(signal_):
    """1,015 epochs of the preset of `signal_` at 99.375 Msps (B2a 1 s,
    B1C 10 s), for 850 epochs in blocks of up to 200 and their margins,
    bench.B2A_SATS rendered on the card (noise 2.0, seed 11), with the
    preset's channels."""
    from bds3_tpu_torch.io.render import render_if

    s, n_channels = ((b2a_settings(), 12) if signal_ == "b2a"
                     else (b1c_settings(), 10))
    cap = render_if(s, bench.sat_params(bench.B2A_SATS, 0.65),
                    (1000 + 15) * s.int_time * 1e3, torch.device("cuda"),
                    noise_std=2.0, seed=11)
    return s, cap, bench.make_inits(s, bench.B2A_SATS, n_channels)


@pytest.mark.parametrize("lookahead,w", [(2, 200), (driver.LOOKAHEAD, 40)])
@pytest.mark.parametrize("signal_", ["b2a", "b1c"])
def test_drain_at_the_presets_shapes(cuda, signal_, lookahead, w,
                                     monkeypatch):
    """track(download=True) at the presets' shapes (B2a 12 channels, B1C
    10 wideband ones), 850 epochs in blocks of W, the last cut: 5 blocks
    of 200 at a lookahead of 2, and 22 of 40 at the driver's own, so that
    at both most blocks are drained while K1 still runs later ones and the
    staging ring wraps while later copies are queued.  The per-block
    drain equals the whole-array assembly of the rows left on the card
    (realize(), the cumulative sum and float64 frequencies over whole
    arrays) bit for bit; two requests in a row take the same pinned
    staging ring, and their answers are their own; each request copies
    exactly its epochs' output columns; the last block's drain is never
    counted as hidden."""
    monkeypatch.setattr(driver, "LOOKAHEAD", lookahead)
    monkeypatch.setattr(driver, "_STAGING", defaultdict(list))  # a new ring
    s, cap, inits = _drain_capture(signal_)
    kw = dict(n_epochs=850, epochs_per_block=w, device=cuda)
    n_blocks = -(-850 // w)
    assert n_blocks > lookahead + 1          # drains between launches; wrap
    lazy = driver.track(cap, s, inits, download=False, **kw)
    outputs = lazy.outputs.realize()
    cfg = driver.require_ported(s)
    cursors0 = np.array([c.code_phase for c in inits], dtype=np.int64)
    base = np.array([c.acquired_freq for c in inits], dtype=np.float64)
    want = (cursors0[:, None] + np.cumsum(outputs["blksize"].astype(np.int64),
                                          axis=1),
            base[:, None] + outputs["d_cyc"].astype(np.float64) * cfg.fs,
            s.code_freq_basis + outputs["d_step"].astype(np.float64) * cfg.fs)
    n_bytes = 850 * len(inits) * len(outputs) * 4
    rings, answers = [], []
    for _ in range(2):
        before = counters()
        res = driver.track(cap, s, inits, **kw)
        after = counters()
        assert after["track.d2h_bytes"] - before["track.d2h_bytes"] \
            == n_bytes
        blocks = after["track.blocks"] - before["track.blocks"]
        hidden = after["track.drains_hidden"] \
            - before.get("track.drains_hidden", 0)
        assert blocks == n_blocks and 0 <= hidden <= blocks - 1
        staging, = driver._STAGING[str(cap.device)]
        rings.append([b.data_ptr() for b in staging.buffers])
        assert all(b.is_pinned() for b in staging.buffers)
        assert res.n_epochs == 850 and sorted(res.outputs) == sorted(outputs)
        for name, v in outputs.items():
            got = res.outputs[name]
            assert got.flags["C_CONTIGUOUS"] and got.dtype == np.float32
            assert np.array_equal(got.view(np.uint32), v.view(np.uint32)), \
                name
        np.testing.assert_array_equal(res.absolute_sample, want[0])
        for got, ref in zip((res.carr_freq, res.code_freq), want[1:]):
            assert np.array_equal(got.view(np.uint64), ref.view(np.uint64))
        answers.append(res)
    assert rings[0] == rings[1] and len(rings[0]) == lookahead + 1
    a, b = answers
    assert not any(np.shares_memory(a.outputs[n], b.outputs[n])
                   for n in outputs)


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
    H100) equals K1 at 8 blocks a channel and the plain version bit for
    bit (rows, state, cursors); and so does a B2a window whose last epochs
    run past the capture's end (zero fill) at 60 blocks a channel."""
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
