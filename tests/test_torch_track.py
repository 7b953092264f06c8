"""bds3_tpu_torch tracking against the JAX reference on the CPU.

The port's CPU path is `track_block_reference`, the plain version of the
CUDA kernel: the direct-sum ("gather") correlator.  It is held to the JAX
gather path, to one JAX scan block started from the same state, and to
the JAX fused Pallas kernel run in interpret mode (as
tests/test_pallas_fused.py runs it).  The integer epoch geometry
(blksize, absolute_sample) must agree exactly; the float outputs agree
within tolerances stated at each check.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bds3_tpu.config import TrackMode, b1c_settings, b2a_settings
from bds3_tpu.io import SatParams, synthesize_if
from bds3_tpu.track import driver as ref_driver
from bds3_tpu.track import scan as ref_scan
from bds3_tpu.track import state as ref_state
from bds3_tpu_torch import convert
from bds3_tpu_torch.track import driver as port_driver
from bds3_tpu_torch.track import state as port_state
from bds3_tpu_torch.track.fused import cuda_supported, fused_track_block
from bds3_tpu_torch.track.scan import (
    output_names,
    slot_names,
    track_block_reference,
    unpack_rows,
)

torch.set_num_threads(2)

# each package gets its own Settings: the port's enums are its own
P = convert.settings_from_reference

S10 = dict(sampling_freq=10e6, intermediate_freq=2.5e6)
SAT19 = SatParams(prn=19, doppler_hz=777.0, code_phase_chips=123.0,
                  amplitude=0.9)
SAT20 = SatParams(prn=20, doppler_hz=-1200.0, code_phase_chips=5000.0,
                  amplitude=0.7)
PROMPTS = ("d_ip", "d_qp", "d_ie", "d_il", "p11_ip", "p11_qp")


def _init_for(mod, s, sat):
    code_rate = s.code_freq_basis * (1 + sat.doppler_hz / s.carr_freq_basis)
    chi0 = sat.code_phase_chips % s.code_length
    start = ((s.code_length - chi0) % s.code_length) / code_rate
    return mod.ChannelInit(
        prn=sat.prn, acquired_freq=s.intermediate_freq + sat.doppler_hz,
        code_phase=int(round(start * s.sampling_freq)), peak_metric=2.0)


def _assert_close(ref, port, names, atol, carr_atol):
    # integer epoch geometry: exact
    np.testing.assert_array_equal(port.outputs["blksize"],
                                  ref.outputs["blksize"])
    np.testing.assert_array_equal(port.absolute_sample, ref.absolute_sample)
    for k in names:
        a, b = ref.outputs[k], port.outputs[k]
        scale = np.abs(a).mean() + 1.0
        np.testing.assert_allclose(b / scale, a / scale, atol=atol,
                                   err_msg=k)
    np.testing.assert_allclose(port.carr_freq, ref.carr_freq, atol=carr_atol)


def test_matches_jax_gather():
    """The test_correlator_equiv.py setup: 1 channel, 100 epochs in two
    blocks.  Tolerances are that test's: ~1% agreement, because XLA
    contracts the chip-index arithmetic into FMAs and so rounds a few
    chip-boundary samples differently, and the closed loop compounds the
    tiny phase differences over epochs."""
    s = b2a_settings(**S10)
    sig = synthesize_if(s, [SAT19], n_ms=150.0, noise_std=1.0, seed=6)
    ref = ref_driver.track(sig, s, [_init_for(ref_state, s, SAT19)],
                           n_epochs=100, epochs_per_block=50,
                           correlator="gather")
    port = port_driver.track(sig, P(s), [_init_for(port_state, s, SAT19)],
                             n_epochs=100, epochs_per_block=50, device="cpu")
    assert port.correlator == "reference" and port.n_epochs == 100
    _assert_close(ref, port, PROMPTS, atol=2e-2, carr_atol=0.05)
    np.testing.assert_allclose(port.code_freq, ref.code_freq, atol=0.05)


@pytest.mark.parametrize("mode,epb", [(TrackMode.NARROWBAND, 10),
                                      (TrackMode.DATA_ONLY, 15)])
def test_matches_jax_fused_interpret(mode, epb):
    """Against the Pallas kernel in interpret mode, multi-block.  The fused
    kernel computes its chip boundaries with a different float32 split
    (tests/test_pallas_fused.py's note), so its tolerances apply: 5e-2
    scaled, 0.25 Hz."""
    s = b2a_settings(track_mode=mode, **S10)
    sig = synthesize_if(s, [SAT19, SAT20], n_ms=60.0, noise_std=1.0, seed=6)
    ref = ref_driver.track(sig, s, [_init_for(ref_state, s, x)
                                    for x in (SAT19, SAT20)],
                           n_epochs=30, epochs_per_block=epb,
                           correlator="fused")
    port = port_driver.track(sig, P(s), [_init_for(port_state, s, x)
                                         for x in (SAT19, SAT20)],
                             n_epochs=30, epochs_per_block=epb, device="cpu")
    assert ref.correlator == "fused"
    assert sorted(port.outputs) == sorted(ref.outputs)
    names = [k for k in PROMPTS if k in ref.outputs]
    _assert_close(ref, port, names, atol=5e-2, carr_atol=0.25)


@pytest.mark.parametrize("mode", [TrackMode.NARROWBAND, TrackMode.DATA_ONLY])
def test_block_matches_jax_scan_block(mode):
    """One block from the same state: the port's plain version against the
    JAX scan (gather) step.  blksize and the new cursors must be equal.
    The float outputs agree within 1e-2 of |a|.mean()+1: XLA contracts the
    chip-index sum into FMAs, and that sum reaches ~4096 chips, where one
    float32 ulp is 5e-4 chip, so a few chip-boundary samples per epoch
    fall into the neighbouring chip (each moves a correlator by ~2|x|)."""
    s = b2a_settings(track_mode=mode, **S10)
    sig = synthesize_if(s, [SAT19, SAT20], n_ms=30.0, noise_std=1.0, seed=2)
    W = 6
    inits = [_init_for(ref_state, s, x) for x in (SAT19, SAT20)]
    cfg = dataclasses.replace(ref_state.make_track_config(s, False, W),
                              correlator="gather")
    consts = ref_state.channel_consts(cfg, inits, s)
    data_t, p11_t, p61_t = ref_driver.channel_code_tables(cfg, inits)
    ck_i, ck_f = ref_state.code_coarse_tables(cfg, cfg.m_data)
    cursors = np.array([c.code_phase for c in inits])
    state = ref_state.initial_state(cfg, inits, consts, cursors)
    new_ref, outs = ref_scan.track_block(
        cfg, jnp.asarray(sig), jnp.asarray(data_t), jnp.asarray(p11_t),
        jnp.asarray(p61_t), jnp.asarray(ck_i), jnp.asarray(ck_f),
        jnp.asarray(ck_i), jnp.asarray(ck_f), consts,
        ref_state.ChannelState(*(jnp.asarray(x) for x in state)))

    pcfg = convert.config_from_reference(cfg)
    new_port, rows = track_block_reference(
        pcfg, torch.from_numpy(sig),
        convert.tables_to_torch(pcfg, data_t, p11_t, ck_i, ck_f, "cpu"),
        convert.consts_to_torch(consts, "cpu"),
        convert.state_to_torch(state, 0, "cpu"))
    assert rows.shape == (W, 2, len(slot_names(pcfg)))
    got = unpack_rows(pcfg, rows)
    assert sorted(got) == sorted(outs) == output_names(pcfg)
    for k, v in outs.items():
        a, b = np.asarray(v), got[k].numpy()
        if k == "blksize":
            np.testing.assert_array_equal(b, a)
        else:
            scale = np.abs(a).mean() + 1.0
            np.testing.assert_allclose(b / scale, a / scale, atol=1e-2,
                                       err_msg=k)
    back = convert.state_from_torch(new_port, 0)
    np.testing.assert_array_equal(back.cursor, np.asarray(new_ref.cursor))
    for f in ref_state.ChannelState._fields[1:]:
        a = np.asarray(getattr(new_ref, f))
        np.testing.assert_allclose(getattr(back, f), a,
                                   atol=1e-2 * (np.abs(a).mean() + 1.0),
                                   err_msg=f)


def test_wrapper_runs_plain_version_on_cpu():
    """On CPU tensors the wrapper is the plain version, and counts no
    kernel launch."""
    s = b2a_settings(**S10)
    sig = synthesize_if(s, [SAT19], n_ms=20.0, noise_std=1.0, seed=1)
    cap = port_driver.as_capture(sig, "cpu")
    setup = port_driver.setup_tracking(
        cap, P(s), [_init_for(port_state, s, SAT19)], 8, 8)
    before = fused_track_block.launches
    st_a, rows_a = fused_track_block(setup.cfg, cap, setup.tables,
                                     setup.consts, setup.state)
    st_b, rows_b = track_block_reference(setup.cfg, cap, setup.tables,
                                         setup.consts, setup.state)
    assert fused_track_block.launches == before
    assert torch.equal(rows_a, rows_b) and torch.equal(st_a.cursor, st_b.cursor)
    assert rows_a.dtype == torch.float32 and st_a.statef.dtype == torch.float32
    with pytest.raises(ValueError):
        fused_track_block(setup.cfg, cap.to("meta"), setup.tables,
                          setup.consts, setup.state)


@pytest.mark.parametrize("settings", [
    b1c_settings(track_mode=TrackMode.WIDEBAND, resampling=False,
                 wb_code_blend="split"),
    b1c_settings(track_mode=TrackMode.WIDEBAND, resampling=False),
    b1c_settings(track_mode=TrackMode.WIDEBAND, resampling=False,
                 wb_code_blend="dotprod"),
], ids=["b1c_wb_split", "b1c_wb", "b1c_wb_dotprod"])
def test_unsupported_config_raises_on_cuda_request(settings):
    """B1C wideband is ported, on real and complex input: the kernel's
    gate takes it in each blend (its tables fit one block's shared memory
    at 99.375 Msps; the capture's dtype does not count).  What does not
    apply raises before any device is touched (so also here, without a
    card): an IQ8 capture's (N, 2) pairs handed to track() (ValueError,
    naming the conversion), bucket_pallas on complex input, and another
    package's Settings (TypeError): its Signal.B1C is not the port's."""
    s = P(settings)
    assert cuda_supported(port_state.make_track_config(s))
    assert cuda_supported(port_state.make_track_config(
        s, complex_input=True))
    init = port_state.ChannelInit(prn=19, acquired_freq=1e6, code_phase=5,
                                  peak_metric=2.0)
    with pytest.raises(ValueError, match="IQ8Pairs"):
        port_driver.track(np.zeros((1000, 2), np.int8), s, [init],
                          n_epochs=10, device="cuda")
    with pytest.raises(NotImplementedError, match="scan.py:378"):
        port_driver.track(np.zeros(1000, np.complex64), s, [init],
                          n_epochs=10, device="cuda",
                          correlator="bucket_pallas")
    with pytest.raises(TypeError, match="settings_from_reference"):
        port_driver.track(np.zeros(1000, np.int8), settings, [init],
                          n_epochs=10, device="cuda")


@pytest.mark.parametrize("capture", [
    np.zeros(1000, np.float32), np.zeros(1000, np.complex64),
    np.zeros((1000, 2), np.int8),
], ids=["float32", "complex64", "iq8"])
def test_unsupported_capture_raises_on_cuda_request(capture):
    """float32 and complex64 captures are taken as they are (here on the
    CPU).  An IQ8 capture's (N, 2) int8 pairs are not a 1-D capture: they
    raise on a request for the card before any device is touched, with
    the conversion run_receiver makes."""
    if capture.ndim == 1:
        got = port_driver.as_capture(capture, "cpu")
        assert got.dtype == {np.float32: torch.float32,
                             np.complex64: torch.complex64}[capture.dtype.type]
        assert got.shape == (1000,)
        return
    with pytest.raises(ValueError, match="widen_iq8"):
        port_driver.as_capture(capture, "cuda")


@pytest.mark.parametrize("capture", [
    np.zeros(120_000, np.complex64), np.zeros(120_000, np.float32),
    np.zeros(120_000, np.int16),
], ids=["complex64", "float32", "int16"])
def test_bucket_pallas_refuses_what_its_kernel_does_not_read(capture):
    """The mix+prefix kernel reads real int8 and float32: bucket_pallas
    refuses complex input before any device work (the reference mixes it
    in XLA instead, bds3_tpu/track/scan.py:378), and any other dtype
    handed to choose_correlator.  A float32 capture is taken and tracked
    (here through the kernel's plain version); an int16 one is tracked as
    float32, as every real capture other than int8 is (capture_dtype; the
    reference casts it so too, bds3_tpu/track/driver.py:333-334).  The
    other paths take them all."""
    s = P(b2a_settings(**S10))
    init = port_state.ChannelInit(prn=19, acquired_freq=1e6, code_phase=5,
                                  peak_metric=2.0)
    cfg = port_state.make_track_config(s, capture.dtype.kind == "c")
    if capture.dtype.kind == "c":
        with pytest.raises(NotImplementedError, match="real int8 or float32"):
            port_driver.track(capture, s, [init], n_epochs=10, device="cuda",
                              correlator="bucket_pallas")
    else:
        if capture.dtype != np.float32:
            with pytest.raises(NotImplementedError,
                               match="real int8 or float32"):
                port_driver.choose_correlator(cfg, "bucket_pallas",
                                              capture.dtype)
        res = port_driver.track(capture, s, [init], n_epochs=10,
                                epochs_per_block=10, device="cpu",
                                correlator="bucket_pallas")
        assert res.correlator == "bucket_pallas" and res.n_epochs == 10
    for ok in ("fused", "gather", "bucket"):
        assert port_driver.choose_correlator(cfg, ok, capture.dtype) == ok


@pytest.mark.parametrize("packing", ["int4", "int2"])
@pytest.mark.parametrize("capture", [
    np.zeros(1000, np.float32), np.zeros(1000, np.complex64),
], ids=["float32", "complex64"])
def test_packing_refuses_captures_other_than_int8(capture, packing):
    """int4 and int2 re-quantize real int8 samples: track() refuses them
    for a float or complex capture before any device work."""
    s = P(b2a_settings(**S10))
    init = port_state.ChannelInit(prn=19, acquired_freq=1e6, code_phase=5,
                                  peak_metric=2.0)
    with pytest.raises(ValueError, match=f"packing '{packing}'"):
        port_driver.track(capture, s, [init], n_epochs=10, device="cuda",
                          transport=packing)


def test_supported_gate():
    """The CUDA tracking kernel takes B2a and B1C in every track mode on
    real and complex input, and "auto" sends them all to it, as the
    reference sends B1C to its fused kernel on its chip."""
    s = P(b2a_settings(**S10))
    assert cuda_supported(port_state.make_track_config(s))
    for mode in (TrackMode.DATA_ONLY, TrackMode.WIDEBAND):
        assert cuda_supported(port_state.make_track_config(
            P(b2a_settings(track_mode=mode))))
    assert cuda_supported(port_state.make_track_config(
        s, complex_input=True))
    assert port_driver.choose_correlator(port_state.make_track_config(
        s, complex_input=True), "auto", np.complex64) == "fused"
    for mode in TrackMode:
        cfg = port_state.make_track_config(
            P(b1c_settings(track_mode=mode, resampling=False)))
        assert cuda_supported(cfg)
        assert port_driver.choose_correlator(cfg) == "fused"
        assert port_driver.choose_correlator(cfg, "bucket_pallas") == \
            "bucket_pallas"
    assert port_driver.choose_correlator(
        port_state.make_track_config(s)) == "fused"
    with pytest.raises(ValueError, match="correlator"):
        port_driver.choose_correlator(port_state.make_track_config(s), "fft")


def test_b2a_mode2_matches_jax_gather():
    """B2a track mode 2 (WIDEBAND) is data+pilot B2a in the reference
    (state.py:62-68, scan.py:230-235): the same outputs as mode 1, held to
    the JAX gather path with test_matches_jax_gather's tolerances."""
    s = b2a_settings(track_mode=TrackMode.WIDEBAND, **S10)
    sig = synthesize_if(s, [SAT19], n_ms=150.0, noise_std=1.0, seed=6)
    ref = ref_driver.track(sig, s, [_init_for(ref_state, s, SAT19)],
                           n_epochs=100, epochs_per_block=50,
                           correlator="gather")
    port = port_driver.track(sig, P(s), [_init_for(port_state, s, SAT19)],
                             n_epochs=100, epochs_per_block=50, device="cpu")
    assert port.correlator == "reference"
    assert sorted(port.outputs) == sorted(ref.outputs)
    assert "p11_ip" in port.outputs and "p61_ip" not in port.outputs
    _assert_close(ref, port, PROMPTS, atol=2e-2, carr_atol=0.05)
