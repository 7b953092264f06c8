"""The whole slice on the CPU: bds3_tpu_torch.receiver.run_receiver
against bds3_tpu.receiver.run_receiver on short synthesized B2a and B1C
narrowband scenarios, the CLI, and the port's independence from JAX."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import bds3_tpu.track.driver as ref_driver
from bds3_tpu.config import FileType as RefFileType
from bds3_tpu.config import TrackMode, b1c_settings, b2a_settings
from bds3_tpu.io import SatParams, synthesize_if
from bds3_tpu.io.scenario import make_scenario, synthesize_scenario
from bds3_tpu.receiver import acquisition_signal_length as \
    ref_acquisition_signal_length
from bds3_tpu.receiver import run_receiver as ref_run_receiver
from bds3_tpu_torch.config import FileType
from bds3_tpu_torch import convert
from bds3_tpu_torch import receiver as port_receiver

torch.set_num_threads(2)

# each package gets its own Settings: the port's enums are its own
P = convert.settings_from_reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RX_TRUTH = np.array([-1288398.0, -4721697.0, 4078625.0])


@pytest.fixture(scope="module")
def scenario():
    s = b2a_settings(sampling_freq=10e6, intermediate_freq=2.5e6,
                     ms_to_process=1500, use_tropo_corr=False,
                     acq_satellite_list=tuple(range(1, 6)), num_channels=5)
    sc = make_scenario(s, RX_TRUTH, n_sats=4, seed=3)
    sig = synthesize_scenario(sc, n_ms=1500, noise_std=2.0, amplitude=0.7,
                              seed=1)
    return s, sig


def _pin_reference(monkeypatch, correlator):
    """Make the JAX driver keep `correlator` where it would pick its own
    (as test_correlator_equiv.py pins it)."""
    orig = ref_driver.make_track_config
    monkeypatch.setattr(
        ref_driver, "make_track_config",
        lambda st, complex_input=False, epochs_per_block=100,
        correlator=correlator: orig(st, complex_input, epochs_per_block,
                                    correlator))


def _assert_same_geometry(got, want):
    """Equal epoch-end samples, up to when a one-sample code slip lands.

    At 10 Msps an epoch is exactly 10000 samples, and Doppler walks the code
    phase across a sample boundary every few hundred epochs; that epoch is
    one sample shorter.  The two loops carry the code phase with ~1e-5 chip
    differences (XLA rounds its chip indices through FMAs), so a slip may
    land one epoch apart: then one epoch-end differs by exactly one sample
    and the next agrees again.  Anything else (a lasting offset, a 2-sample
    difference, two epochs in a row) fails, and every channel must end on
    the same sample."""
    d = got - want
    np.testing.assert_array_equal(d[:, -1], 0)
    bad = np.argwhere(d != 0)
    assert np.all(np.abs(d) <= 1), bad
    for c, e in bad:
        assert d[c, e + 1] == 0, (c, e)
    assert len(bad) <= 2, bad


def _assert_receiver_spans(prof, timings):
    """The receiver's stages each in one span inside its root span, in
    order, each stage's timing within its span; a host capture that is
    not uploaded whole is read and uploaded block by block in tracking."""
    spans = {}
    for e in prof.events():
        spans.setdefault(e.name, []).append((e.time_range.start,
                                             e.time_range.end))
    (r0, r1), = spans["receiver.run"]
    stages = {"receiver.acquire": "acquire_s", "receiver.track": "track_s",
              "receiver.navpvt": "pvt_s"}
    last = r0
    for name, key in stages.items():
        (a, b), = spans[name]
        assert last <= a <= b <= r1, name
        assert 0 < timings[key] <= (b - a) * 1e-6, name
        last = b
    assert "receiver.upload" not in spans
    assert set(timings) == {"acquire_s", "track_s", "track_realtime_factor",
                            "pvt_s"}
    assert len(spans["track.read"]) == len(spans["track.upload"]) > 1
    assert spans["acquire.glrt"] and spans["acquire.fine"]


def test_receiver_matches_reference(scenario, monkeypatch):
    """Same channels and the same epoch geometry (_assert_same_geometry)
    over 1250 closed-loop epochs; prompts within 5e-2 before any loop
    pulls in (the first 50 epochs) and once all are locked (the last 500),
    and the locked carrier within 0.25 Hz.

    In between, a PLL that pulls in with cycle slips amplifies any float
    difference: there the reference's own bucket and gather correlators
    differ by up to ~20 Hz on this scenario, so no float tolerance holds.
    Prompts are scaled by the channel's mean |I|+|Q| + 1, since a carrier
    phase difference moves Q by I times that phase.  The reference is
    pinned to its gather correlator (the port's algorithm; on the CPU it
    would pick the bucket regrouping), as test_correlator_equiv.py pins
    it."""
    s, sig = scenario
    _pin_reference(monkeypatch, "gather")
    ref = ref_run_receiver(sig, s, epochs_per_block=250, verbose=False)
    port = port_receiver.run_receiver(sig, P(s), epochs_per_block=250,
                                      verbose=False, device="cpu")
    assert ref.track.correlator == "gather"
    assert port.track.correlator == "reference"

    # the same channel inits; the metric comes from FFTs of two libraries
    assert len(port.channels) == 4

    def key(c):
        return c.prn, c.acquired_freq, c.code_phase

    assert [key(c) for c in port.channels] == [key(c) for c in ref.channels]
    np.testing.assert_allclose([c.peak_metric for c in port.channels],
                               [c.peak_metric for c in ref.channels],
                               rtol=1e-3)
    np.testing.assert_array_equal(port.acq.detected, ref.acq.detected)
    rt, pt = ref.track, port.track
    assert pt.n_epochs == rt.n_epochs >= 1000
    _assert_same_geometry(pt.absolute_sample, rt.absolute_sample)
    for window in (slice(0, 50), slice(-500, None)):
        for tap, pair in (("d", ("d_ip", "d_qp")),
                          ("p11", ("p11_ip", "p11_qp"))):
            scale = sum(np.abs(rt.outputs[k]).mean(axis=1) for k in pair) \
                + 1.0
            for k in pair:
                a = rt.outputs[k][:, window] / scale[:, None]
                b = pt.outputs[k][:, window] / scale[:, None]
                np.testing.assert_allclose(b, a, atol=5e-2,
                                           err_msg=f"{k} {window}")
    # before lock the discriminator atan(Q/I) is ill-conditioned wherever
    # I is near zero, so the carrier is held to 0.25 Hz once locked
    np.testing.assert_allclose(pt.carr_freq[:, -500:],
                               rt.carr_freq[:, -500:], atol=0.25)
    assert [h["lock_ok"] for h in port.health] == \
        [h["lock_ok"] for h in ref.health]
    assert all(h["lock_ok"] for h in port.health)
    assert (port.nav is None) == (ref.nav is None)


def test_b1c_receiver_matches_reference(monkeypatch):
    """run_receiver on ~2 s of a 6 Msps B1C narrowband scenario (the
    tests/test_e2e_b1c.py settings, shortened): the same channels, the same
    epoch geometry, and the same lock verdicts; the reference is pinned to
    gather, the direct sum that the port's "auto" (the CUDA tracking
    kernel, its plain version on the CPU) computes for B1C."""
    s = b1c_settings(
        sampling_freq=6e6, intermediate_freq=1.5e6, ms_to_process=2_000,
        use_tropo_corr=False, acq_satellite_list=tuple(range(1, 7)),
        num_channels=6, acq_coh_ms=3, acq_step=1000 / 3 / 2,
        acq_search_band=3000.0, track_mode=TrackMode.NARROWBAND)
    sc = make_scenario(s, RX_TRUTH, n_sats=4, sow_base=3600.0 * 3, seed=5)
    sig = synthesize_scenario(sc, noise_std=2.0, amplitude=1.3, seed=2)
    _pin_reference(monkeypatch, "gather")
    ref = ref_run_receiver(sig, s, epochs_per_block=50, verbose=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        port = port_receiver.run_receiver(sig, P(s), epochs_per_block=50,
                                          verbose=False, device="cpu")
    assert ref.track.correlator == "gather"
    assert port.track.correlator == "reference"
    _assert_receiver_spans(prof, port.timings)

    def key(c):
        return c.prn, c.acquired_freq, c.code_phase

    assert len(port.channels) == 4
    assert [key(c) for c in port.channels] == [key(c) for c in ref.channels]
    rt, pt = ref.track, port.track
    assert pt.n_epochs == rt.n_epochs >= 150
    _assert_same_geometry(pt.absolute_sample, rt.absolute_sample)
    np.testing.assert_allclose(pt.carr_freq[:, -50:], rt.carr_freq[:, -50:],
                               atol=0.25)
    assert [h["lock_ok"] for h in port.health] == \
        [h["lock_ok"] for h in ref.health]
    assert all(h["lock_ok"] for h in port.health)


def test_cuda_request_without_card_raises(scenario, monkeypatch):
    """A CUDA request on a machine without a card raises; nothing runs on
    the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    s, sig = scenario

    def must_not_run(*args, **kwargs):
        raise AssertionError("ran on the CPU")

    monkeypatch.setattr(port_receiver, "acquire", must_not_run)
    monkeypatch.setattr(port_receiver, "track", must_not_run)
    with pytest.raises(RuntimeError, match="cuda"):
        port_receiver.run_receiver(sig, P(s), verbose=False, device="cuda")


def test_unsupported_config_raises_before_work():
    """The B1C preset (wideband, resampled acquisition) is ported, real and
    IQ8: it passes the port's checks, and its acquisition window maps back
    from the resampled rate as the reference's does.  An IQ8 capture with
    a packed transport is refused before any work (ValueError, not the
    RuntimeError a CUDA request makes here without a card), and so is
    another package's Settings."""
    s = P(b1c_settings())
    iq8 = dataclasses.replace(s, file_type=FileType.IQ8)
    for ok in (s, iq8):
        port_receiver.check_ported(ok)
        assert port_receiver.acquisition_signal_length(ok) == \
            ref_acquisition_signal_length(b1c_settings())
    for sig, bad, transport, err in (
            (np.zeros((1000, 2), np.int8), iq8, "int4", ValueError),
            (np.zeros((1000, 2), np.int8), s, "int2", ValueError),
            (np.zeros(1000, np.int8), b1c_settings(), "none", TypeError)):
        with pytest.raises(err):
            port_receiver.run_receiver(sig, bad, verbose=False,
                                       device="cuda", transport=transport)


def test_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import bds3_tpu_torch, bds3_tpu_torch.receiver, "
            "bds3_tpu_torch.__main__, bds3_tpu_torch.convert, "
            "bds3_tpu_torch.track.fused, bds3_tpu_torch.track.prefix, "
            "bds3_tpu_torch._build\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'triton') and sys.modules[m] is not None]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-2000:]


class TestCLI:
    def test_probe_track_checkpoint_resume(self, tmp_path):
        s = b2a_settings(sampling_freq=10e6, intermediate_freq=2.5e6)
        sat = SatParams(prn=19, doppler_hz=500.0, code_phase_chips=100.0,
                        amplitude=0.9)
        path = tmp_path / "cap.bin"
        synthesize_if(s, [sat], n_ms=120.0, noise_std=1.5, seed=3).tofile(path)
        env = dict(os.environ, PYTHONPATH=REPO)
        base = [sys.executable, "-m", "bds3_tpu_torch", "--signal", "b2a",
                "--file", str(path), "--device", "cpu"]
        out = subprocess.run(
            base + ["--fs", "10e6", "--if-freq", "2.5e6", "--prns", "19,7",
                    "--ms", "100", "--probe",
                    "--checkpoint", str(tmp_path / "ck.pkl")],
            capture_output=True, text=True, timeout=400, env=env, cwd=REPO)
        assert out.returncode == 0, out.stderr[-2000:]
        assert "probe:" in out.stdout
        assert "[acquire]" in out.stdout and "19" in out.stdout
        assert "[track]" in out.stdout and "reference on cpu" in out.stdout
        assert (tmp_path / "ck.pkl").exists()
        res = subprocess.run(base + ["--resume", str(tmp_path / "ck.pkl")],
                             capture_output=True, text=True, timeout=400,
                             env=env, cwd=REPO)
        assert res.returncode == 0, res.stderr[-2000:]

    # --resample and IQ captures run now (test_iq8_file_tracks); what is
    # refused is packing an IQ capture, whose samples are not real int8
    @pytest.mark.parametrize("extra", [["--file-type", "2",
                                        "--transport", "int2"],
                                       ["--file-type", "2",
                                        "--transport", "int4"]])
    def test_unported_options_exit_with_error(self, tmp_path, extra):
        out = subprocess.run(
            [sys.executable, "-m", "bds3_tpu_torch", "--signal", "b2a",
             "--file", str(tmp_path / "none.bin"), "--device", "cpu",
             *extra],
            capture_output=True, text=True, timeout=400,
            env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
        assert out.returncode != 0
        assert "re-quantizes real int8 samples, and this capture is IQ8" \
            in out.stderr

    def test_iq8_file_tracks(self, tmp_path):
        """--file-type 2 (interleaved int8 I/Q) runs end to end on the CPU,
        with --probe (its spectrum of I alone, as the reference's), through
        the tracking kernel's plain version on the complex samples."""
        s = b2a_settings(sampling_freq=10e6, intermediate_freq=2.5e6,
                         file_type=RefFileType.IQ8)
        sat = SatParams(prn=19, doppler_hz=500.0, code_phase_chips=100.0,
                        amplitude=0.9)
        path = tmp_path / "iq8.bin"
        synthesize_if(s, [sat], n_ms=120.0, noise_std=1.5,
                      seed=3).tofile(path)
        out = subprocess.run(
            [sys.executable, "-m", "bds3_tpu_torch", "--signal", "b2a",
             "--file", str(path), "--device", "cpu", "--file-type", "2",
             "--fs", "10e6", "--if-freq", "2.5e6", "--prns", "19,7",
             "--ms", "100", "--probe"],
            capture_output=True, text=True, timeout=400,
            env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
        assert out.returncode == 0, out.stderr[-2000:]
        assert "probe:" in out.stdout
        assert "[acquire]" in out.stdout and "19(" in out.stdout
        assert "[track]" in out.stdout and "reference on cpu" in out.stdout

    def test_b1c_narrowband_tracks(self, tmp_path):
        """--signal b1c --track-mode 1 runs end to end (6 Msps, no
        resampling below its threshold) through the bucket path."""
        s = b1c_settings(sampling_freq=6e6, intermediate_freq=1.5e6)
        sat = SatParams(prn=19, doppler_hz=500.0, code_phase_chips=100.0,
                        amplitude=1.5)
        path = tmp_path / "b1c.bin"
        synthesize_if(s, [sat], n_ms=400.0, noise_std=2.0, seed=3).tofile(path)
        out = subprocess.run(
            [sys.executable, "-m", "bds3_tpu_torch", "--signal", "b1c",
             "--file", str(path), "--device", "cpu", "--track-mode", "1",
             "--fs", "6e6", "--if-freq", "1.5e6", "--prns", "19,7",
             "--ms", "300"],
            capture_output=True, text=True, timeout=400,
            env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
        assert out.returncode == 0, out.stderr[-2000:]
        assert "[acquire]" in out.stdout and "19(" in out.stdout
        assert "[track]" in out.stdout
        assert "reference on cpu" in out.stdout

    def test_b1c_exits_with_error(self, tmp_path):
        """B1C runs at its preset now, real or IQ; an IQ capture with a
        packed --transport exits with an error before the file is
        opened."""
        for extra in (["--file-type", "2", "--transport", "int4"],
                      ["--file-type", "2", "--transport", "int2"]):
            out = subprocess.run(
                [sys.executable, "-m", "bds3_tpu_torch", "--signal", "b1c",
                 "--file", str(tmp_path / "none.bin"), "--device", "cpu",
                 *extra],
                capture_output=True, text=True, timeout=400,
                env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
            assert out.returncode != 0
            assert "re-quantizes real int8 samples" in out.stderr

    def test_b1c_preset_runs(self, tmp_path):
        """--signal b1c at its preset's track mode (wideband) with its
        resampled acquisition (--resample, the preset's default above
        15 Msps), at 30 Msps to keep the CPU run short: the CLI acquires
        and tracks through the kernel's plain version."""
        s = b1c_settings(sampling_freq=30e6, intermediate_freq=7.5e6)
        sat = SatParams(prn=19, doppler_hz=500.0, code_phase_chips=100.0,
                        amplitude=1.5)
        path = tmp_path / "b1c.bin"
        synthesize_if(s, [sat], n_ms=130.0, noise_std=2.0, seed=3).tofile(path)
        out = subprocess.run(
            [sys.executable, "-m", "bds3_tpu_torch", "--signal", "b1c",
             "--file", str(path), "--device", "cpu", "--resample",
             "--fs", "30e6", "--if-freq", "7.5e6", "--prns", "19,7",
             "--ms", "60"],
            capture_output=True, text=True, timeout=400,
            env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
        assert out.returncode == 0, out.stderr[-2000:]
        assert "[acquire]" in out.stdout and "19(" in out.stdout
        assert "[track]" in out.stdout and "reference on cpu" in out.stdout
