"""The port's band-pass resampling (acquire/resample.py) and the B1C
preset's resampled acquisition against the JAX reference on the CPU.

`resample_signal_device` is the card's path (an rfft convolution with the
filter's autocorrelation, then a gather): here it runs on CPU tensors and
is held to JAX's counterpart and to the host scipy filter away from the
boundary transient, at tests/test_resample.py's scaled 5e-3.  On the CPU
the port's `acquire` takes the host filter, as the reference does off its
chip, so the preset's acquisition must agree with JAX's: the same
detections and code phases, and the carrier in the same fine bin.
"""
import dataclasses

import numpy as np
import pytest
import torch

from bds3_tpu.acquire import acquire as ref_acquire
from bds3_tpu.acquire import resample as ref_resample
from bds3_tpu.config import b1c_settings, b2a_settings
from bds3_tpu.io import SatParams, synthesize_if
from bds3_tpu.receiver import acquisition_signal_length
from bds3_tpu_torch import convert
from bds3_tpu_torch.acquire import pcps as port_acq
from bds3_tpu_torch.acquire import resample as port_resample

torch.set_num_threads(2)

P = convert.settings_from_reference
SETTINGS = {
    # tests/test_resample.py's device case, and the B1C preset
    "b2a_40msps": b2a_settings(sampling_freq=40e6, intermediate_freq=9e6,
                               resampling=True, resampling_threshold=15e6),
    "b1c_preset": b1c_settings(),
}


def _interior(x: np.ndarray, plan) -> np.ndarray:
    """Drop the boundary transient: ~3*701 input samples on each side,
    mapped through the decimation ratio (tests/test_resample.py)."""
    guard = int(3 * 701 * plan.new_fs / plan.old_fs) + 4
    return x[guard:-guard]


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_plan_and_host_filter_equal_reference(name):
    s = SETTINGS[name]
    plan = port_resample.plan_resample(P(s))
    assert dataclasses.asdict(plan) == \
        dataclasses.asdict(ref_resample.plan_resample(s))
    sig = np.random.default_rng(3).integers(-30, 30, 200_000) \
        .astype(np.int8)
    np.testing.assert_array_equal(
        port_resample.resample_signal(sig, P(s), plan),
        ref_resample.resample_signal(sig, s, plan))


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_device_resample_matches_reference(name):
    """The card's path (here on CPU tensors) against JAX's device path and
    the host scipy filter, in the interior, within 5e-3 of mean|host|."""
    s = SETTINGS[name]
    plan = port_resample.plan_resample(P(s))
    sig = np.random.default_rng(5).integers(-30, 30, 400_000) \
        .astype(np.int8)
    got = port_resample.resample_signal_device(
        torch.from_numpy(sig), P(s), plan).numpy()
    want = np.asarray(ref_resample.resample_signal_device(sig, s, plan))
    host = ref_resample.resample_signal(sig, s, plan)
    assert got.dtype == np.float32 and got.shape == want.shape == host.shape
    scale = np.abs(_interior(host, plan)).mean() + 1e-9
    for other in (want, host):
        np.testing.assert_allclose(_interior(got, plan) / scale,
                                   _interior(other, plan) / scale,
                                   atol=5e-3)


def test_preset_acquisition_matches_reference():
    """b1c_settings() (99.375 Msps, resampled acquisition) over three PRNs,
    two of them present: the same detections and code phases as JAX, and
    each carrier within half a fine step of JAX's (the same fine bin)."""
    s = b1c_settings(acq_satellite_list=(7, 19, 30))
    sats = [SatParams(prn=19, doppler_hz=1650.0, code_phase_chips=4100.0,
                      amplitude=0.65),
            SatParams(prn=30, doppler_hz=-2480.0, code_phase_chips=8123.0,
                      amplitude=0.65)]
    n = acquisition_signal_length(s)
    sig = synthesize_if(s, sats, n_ms=n / s.sampling_freq * 1e3 + 1.0,
                        noise_std=2.0, seed=11)[:n]
    want = ref_acquire(sig, s)
    got = port_acq.acquire(sig, P(s), device="cpu")
    np.testing.assert_array_equal(got.prns, want.prns)
    np.testing.assert_array_equal(got.detected, want.detected)
    assert list(got.prns[got.detected]) == [19, 30]
    np.testing.assert_array_equal(got.code_phase, want.code_phase)
    assert np.all(np.abs(got.carr_freq - want.carr_freq)
                  < s.acq_fine_step / 2)
    np.testing.assert_allclose(got.peak_metric, want.peak_metric, rtol=1e-3)
