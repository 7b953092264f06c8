"""Streaming through the port on the CPU: StreamingCapture (copied from
bds3_tpu/io/stream.py) against a memmap of the same file; the port's
per-block track() from a host source against JAX track() with the same
streaming arguments, and against the port's own resident run; lazy
outputs, the deadline, the CLI's --transport; and the card renderers of
the bench's captures (io/render.py) against the host synthesizers."""
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from bds3_tpu.config import FileType, b1c_settings, b2a_settings
from bds3_tpu.io import SatParams, synthesize_if
from bds3_tpu.io.stream import StreamingCapture as RefStreamingCapture
from bds3_tpu.track import driver as ref_driver
from bds3_tpu.track import state as ref_state
from bds3_tpu_torch import convert
from bds3_tpu_torch.io import render
from bds3_tpu_torch.io.stream import StreamingCapture
from bds3_tpu_torch.track import driver as port_driver
from bds3_tpu_torch.track import state as port_state

torch.set_num_threads(2)

P = convert.settings_from_reference
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RX_TRUTH = np.array([-1288398.0, -4721697.0, 4078625.0])
S10 = dict(sampling_freq=10e6, intermediate_freq=2.5e6)
SATS = [SatParams(prn=19, doppler_hz=777.0, code_phase_chips=123.0,
                  amplitude=0.9),
        SatParams(prn=20, doppler_hz=-1200.0, code_phase_chips=5000.0,
                  amplitude=0.7)]
PROMPTS = ("d_ip", "d_qp", "d_ie", "d_il", "p11_ip", "p11_qp")


def _init_for(mod, s, sat):
    code_rate = s.code_freq_basis * (1 + sat.doppler_hz / s.carr_freq_basis)
    chi0 = sat.code_phase_chips % s.code_length
    start = ((s.code_length - chi0) % s.code_length) / code_rate
    return mod.ChannelInit(
        prn=sat.prn, acquired_freq=s.intermediate_freq + sat.doppler_hz,
        code_phase=int(round(start * s.sampling_freq)), peak_metric=2.0)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """10 Msps B2a, 2 satellites, 160 ms, as an array and a file."""
    s = b2a_settings(**S10)
    sig = synthesize_if(s, SATS, n_ms=160.0, noise_std=1.0, seed=6)
    path = tmp_path_factory.mktemp("stream") / "cap.bin"
    sig.tofile(path)
    return s, sig, str(path)


def test_slices_equal_memmap_on_driver_schedule(capture):
    """The driver's pattern: fixed-length blocks at strided starts (hit the
    lookahead), the last one past the end; then a repeat and a step back
    (synchronous reads).  Every slice equals the memmap's."""
    s, sig, path = capture
    mm = np.memmap(path, dtype=np.int8, mode="r")
    cap = StreamingCapture(path)
    assert len(cap) == len(mm) and cap.shape == (len(mm),)
    assert cap.dtype == np.int8
    block_len, shift = 412_345, 399_001
    starts = list(range(1234, len(mm), shift)) + [1234 + shift, 77]
    for a in starts:
        np.testing.assert_array_equal(cap[a:a + block_len],
                                      mm[a:a + block_len])


def test_slices_equal_memmap_random(capture):
    s, sig, path = capture
    mm = np.memmap(path, dtype=np.int8, mode="r")
    cap = StreamingCapture(path, skip_samples=11)
    rng = np.random.default_rng(3)
    for _ in range(40):
        a = int(rng.integers(0, len(mm)))
        b = a + int(rng.integers(0, 300_000))
        np.testing.assert_array_equal(cap[a:b], mm[11:][a:b])
    np.testing.assert_array_equal(cap[:100], mm[11:111])
    with pytest.raises(TypeError):
        cap[::2]


def test_copy_matches_reference_stream(capture):
    s, sig, path = capture
    ref, port = RefStreamingCapture(path), StreamingCapture(path)
    for a in (0, 50_000, 100_000, 1_500_000):
        np.testing.assert_array_equal(port[a:a + 60_000], ref[a:a + 60_000])


def _pin_gather(monkeypatch):
    """JAX off its chip picks the bucket regrouping; pin its gather path,
    the direct sum the port computes (test_torch_receiver.py's pin)."""
    orig = ref_driver.make_track_config
    monkeypatch.setattr(
        ref_driver, "make_track_config",
        lambda st, complex_input=False, epochs_per_block=100:
        orig(st, complex_input, epochs_per_block, "gather"))


@pytest.mark.parametrize("transport", ["none", "int4", "int2"])
def test_streamed_track_matches_jax(capture, monkeypatch, transport):
    """track() from a StreamingCapture with sync_each_block and each
    transport, in both packages, 2 channels over 140 epochs in blocks of
    35: blksize and absolute_sample exact, prompts within 2e-2 of
    mean|a|+1 and the carrier within 0.05 Hz (test_torch_track.py's
    tolerances against the JAX gather path)."""
    s, sig, path = capture
    _pin_gather(monkeypatch)
    kw = dict(n_epochs=140, epochs_per_block=35, sync_each_block=True,
              transport=transport)
    ref = ref_driver.track(RefStreamingCapture(path), s,
                           [_init_for(ref_state, s, x) for x in SATS], **kw)
    port = port_driver.track(StreamingCapture(path), P(s),
                             [_init_for(port_state, s, x) for x in SATS],
                             device="cpu", **kw)
    assert ref.correlator == "gather" and port.correlator == "reference"
    assert port.n_epochs == ref.n_epochs == 140
    np.testing.assert_array_equal(port.outputs["blksize"],
                                  ref.outputs["blksize"])
    np.testing.assert_array_equal(port.absolute_sample, ref.absolute_sample)
    for k in PROMPTS:
        a, b = ref.outputs[k], port.outputs[k]
        scale = np.abs(a).mean() + 1.0
        np.testing.assert_allclose(b / scale, a / scale, atol=2e-2,
                                   err_msg=k)
    np.testing.assert_allclose(port.carr_freq, ref.carr_freq, atol=0.05)


def _port_track(src, s, **kw):
    return port_driver.track(src, P(s), [_init_for(port_state, s, x)
                                         for x in SATS],
                             n_epochs=140, epochs_per_block=35, device="cpu",
                             **kw)


@pytest.mark.parametrize("source", ["stream", "memmap", "ndarray"])
def test_streamed_equals_resident(capture, source):
    """The per-block path reads the samples the resident run reads, so the
    two are equal, output for output."""
    s, sig, path = capture
    src = {"stream": lambda: StreamingCapture(path),
           "memmap": lambda: np.memmap(path, dtype=np.int8, mode="r"),
           "ndarray": lambda: sig}[source]()
    res = _port_track(torch.from_numpy(sig), s)
    got = _port_track(src, s, sync_each_block=True)
    assert got.n_epochs == res.n_epochs == 140
    np.testing.assert_array_equal(got.absolute_sample, res.absolute_sample)
    for k in res.outputs:
        np.testing.assert_array_equal(got.outputs[k], res.outputs[k],
                                      err_msg=k)


def test_int4_stream_equals_resident_clipped(capture):
    """int4 packs exactly in [-8, 7]: the streamed int4 run equals the
    resident run of the clipped capture (test_transport.py's check)."""
    s, sig, path = capture
    res = _port_track(torch.from_numpy(np.clip(sig, -8, 7)), s)
    got = _port_track(StreamingCapture(path), s, transport="int4")
    for k in res.outputs:
        np.testing.assert_array_equal(got.outputs[k], res.outputs[k],
                                      err_msg=k)


@pytest.mark.parametrize("source", ["stream", "resident"])
def test_lazy_outputs_realize_equals_download(capture, source):
    s, sig, path = capture
    src = (lambda: StreamingCapture(path)) if source == "stream" \
        else (lambda: torch.from_numpy(sig))
    full = _port_track(src(), s)
    lazy = _port_track(src(), s, download=False)
    out = lazy.outputs
    assert isinstance(out, port_driver.LazyOutputs)
    assert lazy.absolute_sample is None and lazy.carr_freq is None \
        and lazy.code_freq is None
    assert lazy.n_epochs == full.n_epochs and len(out) == len(full.outputs)
    assert sorted(out.keys()) == sorted(full.outputs)
    assert out["d_ip"].shape == (2, 140)
    np.testing.assert_array_equal(out["d_ip"].numpy(), full.outputs["d_ip"])
    assert out.block_until_ready() is out
    real = out.realize()
    for k in full.outputs:
        np.testing.assert_array_equal(real[k], full.outputs[k], err_msg=k)


def test_deadline_zero_stops_after_first_block(capture):
    """deadline_s=0 with sync_each_block: one block of 35 epochs, valid
    (test_stream.py's check of the reference)."""
    s, sig, path = capture
    res = _port_track(StreamingCapture(path), s, sync_each_block=True,
                      deadline_s=0.0)
    assert res.n_epochs == 35
    assert np.isfinite(res.outputs["d_ip"]).all()
    full = _port_track(sig, s)
    np.testing.assert_array_equal(res.outputs["d_ip"],
                                  full.outputs["d_ip"][:, :35])


def test_unknown_transport_and_whole_stream_upload_refused(capture):
    s, sig, path = capture
    with pytest.raises(ValueError, match="transport"):
        _port_track(sig, s, transport="zstd")
    with pytest.raises(TypeError, match="StreamingCapture"):
        port_driver.as_capture(StreamingCapture(path), "cpu")


def test_cli_accepts_transport(capture, tmp_path):
    """python -m bds3_tpu_torch --transport int4 --device cpu runs the
    receiver, the capture packed for its upload."""
    s, sig, path = capture
    out = subprocess.run(
        [sys.executable, "-m", "bds3_tpu_torch", "--signal", "b2a",
         "--file", path, "--device", "cpu", "--transport", "int4",
         "--fs", "10e6", "--if-freq", "2.5e6", "--prns", "19,20",
         "--ms", "100"],
        capture_output=True, text=True, timeout=400, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[acquire]" in out.stdout and "19(" in out.stdout
    assert "[track]" in out.stdout and "reference on cpu" in out.stdout


@pytest.mark.parametrize("signal_, kw", [
    ("b2a", S10), ("b1c", dict(sampling_freq=30e6, intermediate_freq=7.5e6)),
    ("b2a", dict(S10, file_type=FileType.IQ8)),
    ("b1c", dict(sampling_freq=30e6, intermediate_freq=7.5e6,
                 file_type=FileType.IQ8))])
def test_render_if_equals_host(signal_, kw):
    """render_if on the CPU without noise equals synthesize_if sample for
    sample, from an offset start (the 49 s capture's segments).  IQ8: the
    host forms amp * wave * e^{j phase} with complex exp, the render
    a * cos and a * sin; where they round to other integers, the sample
    is a rounding tie (its unquantized value within 1e-4 of k + 1/2) and
    differs by 1, and at most 1e-4 of the values do."""
    from bds3_tpu_torch.io import synth

    s = (b2a_settings if signal_ == "b2a" else b1c_settings)(**kw)
    ps = P(s)
    sats = [synth.SatParams(**vars(x)) for x in SATS]
    want = synth.synthesize_if(ps, sats, n_ms=12.0, start_sample=12_345)
    got = render.render_if(ps, sats, 12.0, "cpu", start_sample=12_345,
                           chunk=1 << 16).numpy()
    if s.file_type != FileType.IQ8:
        np.testing.assert_array_equal(got, want)
        return
    assert got.shape == want.shape == (want.shape[0], 2)
    diff = got.astype(np.int16) - want
    off = diff != 0
    exact = synth.synthesize_if(ps, sats, n_ms=12.0, start_sample=12_345,
                                quantize=False)
    ties = np.abs(np.abs(exact - np.floor(exact)) - 0.5) < 1e-4
    assert np.all(np.abs(diff) <= 1) and np.all(ties[off])
    assert off.sum() <= 1e-4 * off.size, off.sum()


@pytest.mark.parametrize("signal_", ["b2a", "b1c"])
def test_render_scenario_equals_host(signal_):
    """render_scenario on the CPU without noise equals synthesize_scenario
    sample for sample (B2a with its pilot secondary overlay, B1C with the
    QMBOC pilot)."""
    from bds3_tpu_torch.io import scenario

    if signal_ == "b2a":
        s = b2a_settings(**S10, ms_to_process=200, use_tropo_corr=False)
        kw = dict(seed=3)
    else:
        s = b1c_settings(sampling_freq=6e6, intermediate_freq=1.5e6,
                         ms_to_process=200, use_tropo_corr=False)
        kw = dict(sow_base=3600.0 * 3, seed=5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sc = scenario.make_scenario(P(s), RX_TRUTH, n_sats=4, **kw)
        want = scenario.synthesize_scenario(sc, noise_std=0.0, amplitude=0.7)
        got = render.render_scenario(sc, "cpu", noise_std=0.0,
                                     amplitude=0.7, chunk=1 << 18)
    np.testing.assert_array_equal(got.numpy(), want)
