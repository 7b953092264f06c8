"""bds3_tpu_torch acquisition against bds3_tpu's on the CPU, on the
tests/test_acquire.py setups.

Both run the same float32 FFT search; the FFT libraries differ (XLA's
and PyTorch's), so peak values differ in the last float32 digits.  The
decisions must not: same detected set, identical code phase and carrier
frequency.  The metric must agree within 1e-3 relative.
"""
import dataclasses

import numpy as np
import pytest
import torch

from bds3_tpu.acquire import acquire as ref_acquire
from bds3_tpu.config import b1c_settings, b2a_settings
from bds3_tpu.io import SatParams, synthesize_if
from bds3_tpu_torch import convert
from bds3_tpu_torch.acquire import pcps as port

torch.set_num_threads(2)

# each package gets its own Settings: the port's enums are its own
P = convert.settings_from_reference


def b2a_test_settings(**kw):
    return b2a_settings(**{**dict(sampling_freq=30e6, intermediate_freq=7.5e6,
                                  acq_noncoh_rounds=5,
                                  acq_satellite_list=(5, 19, 32)), **kw})


CASES = {
    "b2a_single_prn": (
        b2a_test_settings(),
        [SatParams(prn=19, doppler_hz=1650.0, code_phase_chips=3210.0,
                   carrier_phase=0.7, amplitude=0.8)], 9.0, 2.0, 1),
    "b2a_negative_doppler": (
        b2a_test_settings(acq_satellite_list=(19,)),
        [SatParams(prn=19, doppler_hz=-3875.0, code_phase_chips=123.0,
                   amplitude=0.8)], 9.0, 1.5, 2),
    "b2a_multiple_sats": (
        b2a_test_settings(acq_satellite_list=(3, 19, 25)),
        [SatParams(prn=3, doppler_hz=900.0, code_phase_chips=55.0,
                   amplitude=0.7),
         SatParams(prn=25, doppler_hz=-2100.0, code_phase_chips=9000.0,
                   amplitude=0.7)], 9.0, 2.0, 3),
    "b1c_single_prn": (
        b1c_settings(sampling_freq=12e6, intermediate_freq=3e6, acq_coh_ms=3,
                     acq_step=1000 / 3 / 2, acq_search_band=2000.0,
                     acq_satellite_list=(7, 19)),
        [SatParams(prn=19, doppler_hz=1225.0, code_phase_chips=5100.0,
                   amplitude=1.2)], 25.0, 2.0, 4),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_reference(name):
    s, sats, n_ms, noise, seed = CASES[name]
    sig = synthesize_if(s, sats, n_ms=n_ms, noise_std=noise, seed=seed)
    want = ref_acquire(sig, s)
    got = port.acquire(sig, P(s), device="cpu")
    np.testing.assert_array_equal(got.prns, want.prns)
    np.testing.assert_array_equal(got.detected, want.detected)
    assert got.detected.any()
    np.testing.assert_array_equal(got.code_phase, want.code_phase)
    np.testing.assert_array_equal(got.coarse_freq, want.coarse_freq)
    np.testing.assert_array_equal(got.carr_freq, want.carr_freq)
    np.testing.assert_allclose(got.peak_metric, want.peak_metric, rtol=1e-3)
    assert got.code_phase.dtype == np.int64


def test_iq_capture_matches_reference():
    """Complex IQ captures (the tests/test_acquire.py B1C case)."""
    from bds3_tpu.config import FileType

    s, _, n_ms, noise, _ = CASES["b1c_single_prn"]
    s = dataclasses.replace(s, file_type=FileType.IQ8,
                            acq_satellite_list=(19,))
    sat = SatParams(prn=19, doppler_hz=-800.0, code_phase_chips=100.0,
                    amplitude=1.0)
    sig = synthesize_if(s, [sat], n_ms=n_ms, noise_std=noise, seed=5)
    x = sig[:, 0].astype(np.float32) + 1j * sig[:, 1].astype(np.float32)
    want = ref_acquire(x, s)
    got = port.acquire(x, P(s), device="cpu")
    assert got.detected[0] and want.detected[0]
    np.testing.assert_array_equal(got.code_phase, want.code_phase)
    np.testing.assert_array_equal(got.carr_freq, want.carr_freq)
    np.testing.assert_allclose(got.peak_metric, want.peak_metric, rtol=1e-3)


def test_tensor_input_and_table_cache():
    s, sats, n_ms, noise, seed = CASES["b2a_single_prn"]
    sig = synthesize_if(s, sats, n_ms=n_ms, noise_std=noise, seed=seed)
    a = port.acquire(sig, P(s), device="cpu")
    b = port.acquire(torch.from_numpy(sig), P(s), device="cpu")
    np.testing.assert_array_equal(a.peak_metric, b.peak_metric)
    assert port._device_acq_tables.cache_info().currsize >= 1
    port.clear_acq_caches()
    assert port._device_acq_tables.cache_info().currsize == 0


def test_resampling_not_ported():
    """Resampled acquisition is ported (test_torch_resample.py holds it
    to the reference).  What the port refuses before any work is another
    package's Settings, whose Signal is not the port's."""
    s = b1c_settings()          # 99.375 Msps with resampling on
    with pytest.raises(TypeError, match="settings_from_reference"):
        port.acquire(np.zeros(10, np.int8), s, device="cpu")
    s_off = dataclasses.replace(P(s), resampling=False)
    assert port.make_acq_config(s_off).n_fft == 2 ** 21
