"""The prefix-sum ("bucket") tracking path of bds3_tpu_torch against the
JAX reference on the CPU, for B2a and for B1C narrowband.

The port's "bucket" path mixes each epoch in plain PyTorch and takes a
cumsum; its "bucket_pallas" path runs `prefix.mix_prefix`, whose CPU
version is the plain PyTorch version of the CUDA kernel.  Each is held to
the JAX path of the same name (bucket_pallas through the Pallas kernel in
interpret mode).  The integer epoch geometry (blksize, absolute_sample)
must agree exactly.  The float outputs differ by rounding only: JAX
splits the carrier phase by window index and folds the window offset into
the phase, the port splits it by epoch index, and XLA contracts
multiply-adds into FMAs; the tolerances are the ones `bds3_tpu` applies
between its own paths (tests/test_correlator_equiv.py: 2e-2 scaled,
0.05 Hz).  The B1C receiver against JAX's is in test_torch_receiver.py.

Each case runs on an int8 capture; bucket_pallas also on a real float32
one (the same synthesis unquantized), which both kernels read as float32
(JAX's casts the window, pallas_prefix.py:62), at the same tolerances.
The port's own identity is exact: bucket_pallas on the int8 capture's
values as float32 gives the int8 run bit for bit.
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
from bds3_tpu_torch.track.scan import output_names, slot_names, unpack_rows

torch.set_num_threads(2)

# each package gets its own Settings: the port's enums are its own
P = convert.settings_from_reference

CORRELATORS = ("bucket", "bucket_pallas")
# (correlator, capture dtype): the int8 cases keep their correlator's id
CASES = [pytest.param(c, "int8", id=c) for c in CORRELATORS] + [
    pytest.param("bucket_pallas", "float32", id="bucket_pallas-float32")]
PROMPTS = ("d_ip", "d_qp", "d_ie", "d_il", "p11_ip", "p11_qp")


def _b2a(dtype="int8"):
    """The tests/test_correlator_equiv.py setup: 10 Msps, one channel; an
    int8 capture, or the same synthesis unquantized as float32."""
    s = b2a_settings(sampling_freq=10e6, intermediate_freq=2.5e6)
    sats = [SatParams(prn=19, doppler_hz=777.0, code_phase_chips=123.0,
                      amplitude=0.9)]
    return s, sats, synthesize_if(s, sats, n_ms=150.0, noise_std=1.0, seed=6,
                                  quantize=dtype == "int8")


def _b1c(dtype="int8"):
    """B1C narrowband at 6 Msps (the tests/test_e2e_b1c.py front end), two
    channels; int8, or unquantized float32."""
    s = b1c_settings(sampling_freq=6e6, intermediate_freq=1.5e6,
                     track_mode=TrackMode.NARROWBAND, resampling=False)
    sats = [SatParams(prn=19, doppler_hz=777.0, code_phase_chips=123.0,
                      amplitude=1.3),
            SatParams(prn=20, doppler_hz=-1200.0, code_phase_chips=5000.0,
                      amplitude=1.1)]
    return s, sats, synthesize_if(s, sats, n_ms=700.0, noise_std=2.0, seed=6,
                                  quantize=dtype == "int8")


def _init_for(mod, s, sat):
    code_rate = s.code_freq_basis * (1 + sat.doppler_hz / s.carr_freq_basis)
    chi0 = sat.code_phase_chips % s.code_length
    start = ((s.code_length - chi0) % s.code_length) / code_rate
    return mod.ChannelInit(
        prn=sat.prn, acquired_freq=s.intermediate_freq + sat.doppler_hz,
        code_phase=int(round(start * s.sampling_freq)), peak_metric=2.0)


def _pin_reference(monkeypatch, correlator):
    """Make the JAX driver's "auto" keep `correlator` (as
    test_correlator_equiv.py pins it)."""
    orig = ref_driver.make_track_config
    monkeypatch.setattr(
        ref_driver, "make_track_config",
        lambda st, complex_input=False, epochs_per_block=100,
        correlator=correlator: orig(st, complex_input, epochs_per_block,
                                    correlator))


def _track_both(monkeypatch, correlator, s, sats, sig, n_epochs, epb):
    _pin_reference(monkeypatch, correlator)
    ref = ref_driver.track(sig, s, [_init_for(ref_state, s, x) for x in sats],
                           n_epochs=n_epochs, epochs_per_block=epb)
    port = port_driver.track(sig, P(s),
                             [_init_for(port_state, s, x) for x in sats],
                             n_epochs=n_epochs, epochs_per_block=epb,
                             device="cpu", correlator=correlator)
    assert ref.correlator == correlator
    # on the CPU the plain versions ran, and the result says which path
    assert port.correlator == correlator
    assert port.n_epochs == ref.n_epochs == n_epochs
    assert sorted(port.outputs) == sorted(ref.outputs)
    np.testing.assert_array_equal(port.outputs["blksize"],
                                  ref.outputs["blksize"])
    np.testing.assert_array_equal(port.absolute_sample, ref.absolute_sample)
    return ref, port


@pytest.mark.parametrize("correlator,dtype", CASES)
def test_b2a_matches_jax(monkeypatch, correlator, dtype):
    """100 epochs in two blocks; each prompt within 2e-2 of its mean|.|+1,
    carrier and code frequency within 0.05 Hz."""
    s, sats, sig = _b2a(dtype)
    assert sig.dtype == np.dtype(dtype)
    ref, port = _track_both(monkeypatch, correlator, s, sats, sig, 100, 50)
    for k in PROMPTS:
        a, b = ref.outputs[k], port.outputs[k]
        scale = np.abs(a).mean() + 1.0
        np.testing.assert_allclose(b / scale, a / scale, atol=2e-2,
                                   err_msg=k)
    np.testing.assert_allclose(port.carr_freq, ref.carr_freq, atol=0.05)
    np.testing.assert_allclose(port.code_freq, ref.code_freq, atol=0.05)


@pytest.mark.parametrize("correlator,dtype", CASES)
def test_b1c_narrowband_matches_jax(monkeypatch, correlator, dtype):
    """60 epochs in two blocks, 2 channels; both lock.  The prompts are
    scaled by the channel's mean |I|+|Q| + 1 (test_torch_receiver.py's
    scale): a locked B1C channel's Q is ~I/50, and a carrier phase
    difference moves Q by I times that phase, so Q's own mean is no scale
    (with it the reference's own gather and bucket_pallas paths differ by
    3.6e-2 here)."""
    s, sats, sig = _b1c(dtype)
    assert sig.dtype == np.dtype(dtype)
    ref, port = _track_both(monkeypatch, correlator, s, sats, sig, 60, 30)
    for tap in ("d", "p11"):
        pair = (f"{tap}_ip", f"{tap}_qp")
        scale = sum(np.abs(ref.outputs[k]).mean(axis=1) for k in pair) + 1.0
        for k in (*pair, f"{tap}_ie", f"{tap}_il"):
            np.testing.assert_allclose(port.outputs[k] / scale[:, None],
                                       ref.outputs[k] / scale[:, None],
                                       atol=2e-2, err_msg=k)
    np.testing.assert_allclose(port.carr_freq, ref.carr_freq, atol=0.05)
    ip = np.abs(port.outputs["d_ip"][:, -20:]).mean(axis=1)
    qp = np.abs(port.outputs["d_qp"][:, -20:]).mean(axis=1)
    assert np.all(ip > 10 * qp), ip / qp


@pytest.mark.parametrize("signal", ["b2a", "b1c"])
@pytest.mark.parametrize("correlator,dtype", CASES)
def test_block_matches_jax_scan_block(correlator, dtype, signal):
    """One block from the same state against the JAX scan step of the same
    correlator.  blksize and the new cursors must be equal; the float
    outputs and the new state within 1e-2 of |a|.mean()+1
    (test_torch_track.py's block tolerance)."""
    s, sats, sig = _b2a(dtype) if signal == "b2a" else _b1c(dtype)
    W = 6
    inits = [_init_for(ref_state, s, x) for x in sats]
    cfg = dataclasses.replace(ref_state.make_track_config(s, False, W),
                              correlator=correlator)
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
    new_port, rows = port_driver.BLOCK_FNS[correlator](
        pcfg, torch.from_numpy(sig),
        convert.tables_to_torch(pcfg, data_t, p11_t, ck_i, ck_f, "cpu"),
        convert.consts_to_torch(consts, "cpu"),
        convert.state_to_torch(state, 0, "cpu"))
    assert rows.shape == (W, len(sats), len(slot_names(pcfg)))
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



@pytest.mark.parametrize("signal", ["b2a", "b1c"])
def test_bucket_pallas_float32_equals_int8(signal):
    """The port's identity: bucket_pallas on the int8 capture's values as
    float32 (the kernel's float32 instance on the card, its plain version
    here) gives the int8 run bit for bit: the two share everything after
    the load of a sample."""
    s, sats, sig = _b2a() if signal == "b2a" else _b1c()
    inits = [_init_for(port_state, s, x) for x in sats]
    runs = [port_driver.track(capture, P(s), inits, n_epochs=40,
                              epochs_per_block=20, device="cpu",
                              correlator="bucket_pallas")
            for capture in (sig, sig.astype(np.float32))]
    assert runs[0].correlator == runs[1].correlator == "bucket_pallas"
    np.testing.assert_array_equal(runs[1].absolute_sample,
                                  runs[0].absolute_sample)
    assert sorted(runs[1].outputs) == sorted(runs[0].outputs)
    for k, v in runs[0].outputs.items():
        np.testing.assert_array_equal(runs[1].outputs[k], v, err_msg=k)
