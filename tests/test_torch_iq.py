"""Complex IQ and float32 captures through the port on the CPU, against
the JAX reference.

The port's CPU path is the plain version of the CUDA tracking kernel (the
direct sum, `track_block_reference`); its complex mix is the reference's
(scan.py:145-148) with each product and sum rounded on its own.  XLA on
the CPU contracts `xr*c + xi*s` and the chip-index sums into FMAs, so the
float outputs agree within the reference's own tolerances, stated at each
check: the direct sum against the bucket regrouping 2e-2 of |a|.mean()+1
and 0.05 Hz (tests/test_correlator_equiv.py), against the fused kernel
5e-2 and 0.25 Hz (tests/test_pallas_fused.py).  The integer epoch geometry
(blksize, absolute_sample) is exact.  The port's own identities (float32
against int8, complex with Q = 0 against real) are exact.
"""
import warnings

import numpy as np
import pytest
import torch

import bds3_tpu.track.driver as ref_driver
from bds3_tpu.acquire import acquire as ref_acquire
from bds3_tpu.config import FileType, TrackMode, b1c_settings, b2a_settings
from bds3_tpu.io import SatParams, synthesize_if
from bds3_tpu.io.ifdata import IFDataFile as RefIFDataFile
from bds3_tpu.receiver import run_receiver as ref_run_receiver
from bds3_tpu.track import state as ref_state
from bds3_tpu_torch import convert
from bds3_tpu_torch import receiver as port_receiver
from bds3_tpu_torch.acquire import pcps as port_acq
from bds3_tpu_torch.io.ifdata import IFDataFile
from bds3_tpu_torch.track import driver as port_driver
from bds3_tpu_torch.track import state as port_state

torch.set_num_threads(2)

P = convert.settings_from_reference
S10 = dict(sampling_freq=10e6, intermediate_freq=2.5e6)
SAT19 = SatParams(prn=19, doppler_hz=400.0, code_phase_chips=500.0,
                  amplitude=0.8)
SAT20 = SatParams(prn=20, doppler_hz=-1500.0, code_phase_chips=3000.0,
                  amplitude=0.7)
PROMPTS = ("d_ip", "d_qp", "d_ie", "d_il", "p11_ip", "p11_qp")


def _init_for(mod, s, sat):
    code_rate = s.code_freq_basis * (1 + sat.doppler_hz / s.carr_freq_basis)
    chi0 = sat.code_phase_chips % s.code_length
    start = ((s.code_length - chi0) % s.code_length) / code_rate
    return mod.ChannelInit(
        prn=sat.prn, acquired_freq=s.intermediate_freq + sat.doppler_hz,
        code_phase=int(round(start * s.sampling_freq)), peak_metric=2.0)


def _iq(s, sats, n_ms, seed=12, noise_std=1.5):
    """An IQ8 capture's pairs and their complex64 I + jQ (as
    tests/test_track.py:87-102 makes them)."""
    raw = synthesize_if(s, sats, n_ms=n_ms, noise_std=noise_std, seed=seed)
    return raw, (raw[:, 0].astype(np.float32)
                 + 1j * raw[:, 1].astype(np.float32)).astype(np.complex64)


def _track_both(sig, s, sats, n_epochs, epb, ref_correlator="auto",
                port_correlator="auto"):
    ref = ref_driver.track(sig, s, [_init_for(ref_state, s, x) for x in sats],
                           n_epochs=n_epochs, epochs_per_block=epb,
                           correlator=ref_correlator)
    port = port_driver.track(sig, P(s), [_init_for(port_state, s, x)
                                         for x in sats],
                             n_epochs=n_epochs, epochs_per_block=epb,
                             device="cpu", correlator=port_correlator)
    return ref, port


def _assert_close(ref, port, names, atol, carr_atol):
    np.testing.assert_array_equal(port.outputs["blksize"],
                                  ref.outputs["blksize"])
    np.testing.assert_array_equal(port.absolute_sample, ref.absolute_sample)
    assert sorted(port.outputs) == sorted(ref.outputs)
    for k in names:
        a, b = ref.outputs[k], port.outputs[k]
        scale = np.abs(a).mean() + 1.0
        np.testing.assert_allclose(b / scale, a / scale, atol=atol,
                                   err_msg=k)
    np.testing.assert_allclose(port.carr_freq, ref.carr_freq, atol=carr_atol)


def test_b2a_iq8_matches_jax_track():
    """tests/test_track.py:87-102: B2a IQ8 at 10 Msps, 120 epochs in blocks
    of 60, JAX's track() as it runs on the CPU (its bucket path, W capped
    at 64 for complex input) against the port's direct sum; the loop
    settles on the true carrier within 1 Hz in both."""
    s = b2a_settings(file_type=FileType.IQ8, **S10)
    _, sig = _iq(s, [SAT19], 150.0)
    ref, port = _track_both(sig, s, [SAT19], 120, 60)
    assert ref.correlator == "bucket" and port.correlator == "reference"
    _assert_close(ref, port, PROMPTS, atol=2e-2, carr_atol=0.05)
    true_f = s.intermediate_freq + SAT19.doppler_hz
    for res in (ref, port):
        assert abs(np.mean(res.carr_freq[0, 100:120]) - true_f) < 1.0


def test_complex_matches_jax_fused_interpret():
    """tests/test_pallas_fused.py:126-150: 2 satellites, 30 epochs in one
    block, against JAX's fused kernel in interpret mode, which takes the
    complex capture as two float32 planes: its tolerances, 5e-2 scaled and
    0.25 Hz."""
    s = b2a_settings(file_type=FileType.IQ8, **S10)
    _, sig = _iq(s, [SAT19, SAT20], 60.0)
    ref, port = _track_both(sig, s, [SAT19, SAT20], 30, 30,
                            ref_correlator="fused")
    assert ref.correlator == "fused"
    _assert_close(ref, port, PROMPTS + ("carr_err", "code_err"), atol=5e-2,
                  carr_atol=0.25)


def test_bucket_complex_matches_jax_bucket():
    """The port's plain bucket path (mix, cumsum, chip-boundary
    differences) against JAX's on complex input: the same regrouping, so
    the direct-sum tolerance holds with room (2e-2 scaled, 0.05 Hz)."""
    s = b2a_settings(file_type=FileType.IQ8, **S10)
    _, sig = _iq(s, [SAT19, SAT20], 100.0)
    ref, port = _track_both(sig, s, [SAT19, SAT20], 60, 30,
                            ref_correlator="bucket", port_correlator="bucket")
    assert ref.correlator == port.correlator == "bucket"
    _assert_close(ref, port, PROMPTS, atol=2e-2, carr_atol=0.05)


@pytest.mark.parametrize("mode,kw,epochs", [
    (TrackMode.NARROWBAND, dict(sampling_freq=6e6, intermediate_freq=1.5e6),
     12),
    (TrackMode.WIDEBAND, dict(sampling_freq=30e6, intermediate_freq=7.5e6),
     6)], ids=["b1c_nb_6msps", "b1c_wb_30msps"])
def test_b1c_complex_matches_jax_gather(mode, kw, epochs):
    """B1C IQ8 without resampling, narrowband and wideband (the composite
    pilot with its BOC(6,1) tap), against JAX pinned to its gather path
    (the direct sum the port computes): 2e-2 scaled, 0.05 Hz."""
    s = b1c_settings(file_type=FileType.IQ8, track_mode=mode,
                     resampling=False, **kw)
    sat = SatParams(prn=19, doppler_hz=500.0, code_phase_chips=100.0,
                    amplitude=1.5)
    _, sig = _iq(s, [sat], (epochs + 3) * 10.0, seed=3, noise_std=2.0)
    ref, port = _track_both(sig, s, [sat], epochs, epochs,
                            ref_correlator="gather")
    assert ref.correlator == "gather"
    names = [k for k in ref.outputs
             if k.startswith(("d_", "p11_", "p61_", "p_"))]
    if mode == TrackMode.WIDEBAND:
        assert "p61_ip" in names and "p_qp" in names
    _assert_close(ref, port, names, atol=2e-2, carr_atol=0.05)


def test_float32_matches_jax():
    """A real float32 capture (unquantized synthesis) through JAX's gather
    path, which tracks it as float32 (bds3_tpu/track/driver.py:333-334),
    and the port's direct sum: 2e-2 scaled, 0.05 Hz."""
    s = b2a_settings(**S10)
    sig = synthesize_if(s, [SAT19, SAT20], n_ms=80.0, noise_std=1.5, seed=4,
                        quantize=False)
    assert sig.dtype == np.float32
    ref, port = _track_both(sig, s, [SAT19, SAT20], 60, 30,
                            ref_correlator="gather")
    _assert_close(ref, port, PROMPTS, atol=2e-2, carr_atol=0.05)


@pytest.fixture(scope="module")
def real8():
    s = b2a_settings(**S10)
    return s, synthesize_if(s, [SAT19, SAT20], n_ms=70.0, noise_std=1.5,
                            seed=6)


def _port_track(sig, s, correlator="auto", n_epochs=50, epb=25):
    return port_driver.track(sig, P(s), [_init_for(port_state, s, x)
                                         for x in (SAT19, SAT20)],
                             n_epochs=n_epochs, epochs_per_block=epb,
                             device="cpu", correlator=correlator)


@pytest.mark.parametrize("as_", ["float32", "complex64", "complex64_tensor"])
def test_same_samples_track_exactly_alike(real8, as_):
    """The port's identities, exact: the int8 capture as float32 reads the
    same values, and as complex64 with Q = 0 mixes to the same products
    (x c + 0 s = x c, 0 c - x s = -(x s)); a host source and a tensor
    alike."""
    s, sig = real8
    want = _port_track(sig, s)
    src = sig.astype(np.dtype(as_.split("_")[0]))
    if as_.endswith("tensor"):
        src = torch.from_numpy(src)
    got = _port_track(src, s)
    assert got.correlator == want.correlator == "reference"
    np.testing.assert_array_equal(got.absolute_sample, want.absolute_sample)
    for k in want.outputs:
        np.testing.assert_array_equal(got.outputs[k], want.outputs[k],
                                      err_msg=k)


def test_iq8_pairs_stream_equals_resident():
    """An IQ8 capture's pairs streamed block by block (IQ8Pairs: each
    block's int8 pairs uploaded and widened where they land) and the
    complex64 capture resident as a tensor track exactly alike."""
    from bds3_tpu_torch.io.transport import IQ8Pairs

    s = b2a_settings(file_type=FileType.IQ8, **S10)
    raw, sig = _iq(s, [SAT19, SAT20], 70.0)
    want = _port_track(torch.from_numpy(sig), s)
    got = _port_track(IQ8Pairs(raw), s)
    np.testing.assert_array_equal(got.absolute_sample, want.absolute_sample)
    for k in want.outputs:
        np.testing.assert_array_equal(got.outputs[k], want.outputs[k],
                                      err_msg=k)


def test_complex_bucket_equals_direct_sum():
    """On complex input the port's plain bucket path regroups the direct
    sum: blksize exact, correlators within 2e-2 scaled."""
    s = b2a_settings(file_type=FileType.IQ8, **S10)
    _, sig = _iq(s, [SAT19, SAT20], 70.0)
    direct = _port_track(sig, s)
    bucket = _port_track(sig, s, "bucket")
    assert bucket.correlator == "bucket"
    np.testing.assert_array_equal(bucket.outputs["blksize"],
                                  direct.outputs["blksize"])
    for k in PROMPTS:
        a, b = direct.outputs[k], bucket.outputs[k]
        scale = np.abs(a).mean() + 1.0
        np.testing.assert_allclose(b / scale, a / scale, atol=2e-2,
                                   err_msg=k)


def test_receiver_iq8_file_matches_reference(tmp_path, monkeypatch):
    """run_receiver on an IQ8 file (interleaved int8 I/Q, opened as an
    IFDataFile) in both packages: the same detected PRNs and channel
    inits, the same epoch geometry, and the prompts within the receiver
    tolerance of tests/test_torch_receiver.py (5e-2 of the channel's mean
    |I| + |Q| + 1: over 160 closed-loop epochs XLA's FMA contractions move
    a prompt by up to ~3e-2 of |I| alone), the carrier within 0.25 Hz.
    JAX is pinned to gather, the port's algorithm."""
    s = b2a_settings(file_type=FileType.IQ8, ms_to_process=160,
                     acq_satellite_list=(7, 19, 20), num_channels=3, **S10)
    raw, _ = _iq(s, [SAT19, SAT20], 200.0)
    path = tmp_path / "iq8.bin"
    raw.tofile(path)
    orig = ref_driver.make_track_config
    monkeypatch.setattr(
        ref_driver, "make_track_config",
        lambda st, complex_input=False, epochs_per_block=100,
        correlator="gather": orig(st, complex_input, epochs_per_block,
                                  correlator))
    ref = ref_run_receiver(RefIFDataFile.open(str(path), FileType.IQ8), s,
                           epochs_per_block=80, verbose=False)
    port = port_receiver.run_receiver(
        IFDataFile.open(str(path), P(s).file_type), P(s),
        epochs_per_block=80, verbose=False, device="cpu")
    assert ref.track.correlator == "gather"
    assert port.track.correlator == "reference"
    np.testing.assert_array_equal(port.acq.detected, ref.acq.detected)
    assert list(port.acq.prns[port.acq.detected]) == [19, 20]

    def key(c):
        return c.prn, c.acquired_freq, c.code_phase

    assert [key(c) for c in port.channels] == [key(c) for c in ref.channels]
    rt, pt = ref.track, port.track
    assert pt.n_epochs == rt.n_epochs >= 150
    np.testing.assert_array_equal(pt.absolute_sample, rt.absolute_sample)
    for tap in ("d", "p11"):
        pair = (f"{tap}_ip", f"{tap}_qp")
        scale = sum(np.abs(rt.outputs[k]).mean(axis=1) for k in pair) + 1.0
        for k in pair:
            np.testing.assert_allclose(pt.outputs[k] / scale[:, None],
                                       rt.outputs[k] / scale[:, None],
                                       atol=5e-2, err_msg=k)
    np.testing.assert_allclose(pt.carr_freq, rt.carr_freq, atol=0.25)


def test_b1c_iq8_resampled_acquisition_uses_i_alone():
    """B1C IQ8 at 30 Msps with the preset's resampled acquisition: the
    reference's resampler casts its input to float32 and so drops Q
    (bds3_tpu/acquire/resample.py:86), and the port keeps that: its
    acquisition equals the reference's, and equals its own on I alone."""
    s = b1c_settings(file_type=FileType.IQ8, sampling_freq=30e6,
                     intermediate_freq=7.5e6, acq_satellite_list=(7, 19))
    assert s.resampling and s.sampling_freq > s.resampling_threshold
    n = port_receiver.acquisition_signal_length(P(s))
    sat = SatParams(prn=19, doppler_hz=-800.0, code_phase_chips=100.0,
                    amplitude=1.0)
    _, sig = _iq(s, [sat], n / s.sampling_freq * 1e3 + 1.0, seed=5,
                 noise_std=2.0)
    sig = sig[:n]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the cast's complex warnings
        want = ref_acquire(sig, s)
        got = port_acq.acquire(sig, P(s), device="cpu")
        i_only = port_acq.acquire(sig.real.copy(), P(s), device="cpu")
    np.testing.assert_array_equal(got.detected, want.detected)
    assert list(got.prns[got.detected]) == [19]
    np.testing.assert_array_equal(got.code_phase, want.code_phase)
    assert np.all(np.abs(got.carr_freq - want.carr_freq)
                  < s.acq_fine_step / 2)
    for f in ("detected", "code_phase", "carr_freq", "peak_metric"):
        np.testing.assert_array_equal(getattr(got, f), getattr(i_only, f),
                                      err_msg=f)
