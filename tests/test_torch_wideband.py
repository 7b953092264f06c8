"""B1C wideband QMBOC tracking of bds3_tpu_torch against the JAX reference
on the CPU, in each of the four code blends.

The setup is tests/test_pallas_fused.py's wideband one: 30 Msps, IF
7.5 MHz, PRNs 7 and 30.  Each port path is held to the JAX path it ports:
"gather" (the direct sum, the plain version of the CUDA tracking kernel)
to JAX's gather, "bucket" and "bucket_pallas" (the prefix-sum path with
its plain prefixes, and with the mix+prefix kernel's plain version) to
JAX's bucket.  The integer epoch geometry (blksize, absolute_sample) must
agree exactly; the correlators of all three banks (data, BOC(1,1) and
BOC(6,1) pilot) and of the composite pilot within 2e-2, the
discriminators within 2e-2 of mean|.|+1, and the carrier within 0.05 Hz:
the tolerances the reference applies between its own paths
(tests/test_correlator_equiv.py).  A tap's correlators are scaled by the
channel's mean |I_P|+|Q_P| + 1 of that tap, test_torch_bucket.py's B1C
scale: the prefix paths take differences of running sums that reach
~1e3, so their rounding is absolute, and a small Q's own mean is no
scale for it (JAX's own bucket and gather paths differ by 7.5e-2 of
mean|p61_il|+1 here, by 5e-3 of the tap scale).
"""
import functools

import numpy as np
import pytest
import torch

from bds3_tpu.config import TrackMode, b1c_settings
from bds3_tpu.io import SatParams, synthesize_if
from bds3_tpu.track import driver as ref_driver
from bds3_tpu.track import state as ref_state
from bds3_tpu_torch import convert
from bds3_tpu_torch.track import driver as port_driver
from bds3_tpu_torch.track import state as port_state

torch.set_num_threads(2)

BLENDS = ("composite", "nb", "split", "dotprod")
# the reference path each port path is held to
REF_PATH = {"gather": "gather", "bucket": "bucket", "bucket_pallas": "bucket"}
SATS = [SatParams(prn=7, doppler_hz=430.0, code_phase_chips=212.0,
                  amplitude=0.9),
        SatParams(prn=30, doppler_hz=-2100.0, code_phase_chips=8000.0,
                  amplitude=0.8)]
TAPS = ("d", "p11", "p61", "p")   # data, BOC(1,1), BOC(6,1), composite


def _settings(blend):
    return b1c_settings(sampling_freq=30e6, intermediate_freq=7.5e6,
                        track_mode=TrackMode.WIDEBAND, wb_code_blend=blend)


@functools.lru_cache(maxsize=None)
def _signal():
    return synthesize_if(_settings("composite"), SATS, n_ms=160.0,
                         noise_std=1.0, seed=12)


def _init_for(mod, s, sat):
    code_rate = s.code_freq_basis * (1 + sat.doppler_hz / s.carr_freq_basis)
    chi0 = sat.code_phase_chips % s.code_length
    start = ((s.code_length - chi0) % s.code_length) / code_rate
    return mod.ChannelInit(
        prn=sat.prn, acquired_freq=s.intermediate_freq + sat.doppler_hz,
        code_phase=int(round(start * s.sampling_freq)), peak_metric=2.0)


@functools.lru_cache(maxsize=None)
def _reference(blend, correlator, n_epochs, epb):
    s = _settings(blend)
    return ref_driver.track(_signal(), s, [_init_for(ref_state, s, x)
                                           for x in SATS],
                            n_epochs=n_epochs, epochs_per_block=epb,
                            correlator=correlator)


def _port(blend, correlator, n_epochs, epb):
    s = convert.settings_from_reference(_settings(blend))
    return port_driver.track(_signal(), s, [_init_for(port_state, s, x)
                                            for x in SATS],
                             n_epochs=n_epochs, epochs_per_block=epb,
                             device="cpu", correlator=correlator)


def _assert_close(ref, port, atol, carr_atol):
    assert sorted(port.outputs) == sorted(ref.outputs)
    np.testing.assert_array_equal(port.outputs["blksize"],
                                  ref.outputs["blksize"])
    np.testing.assert_array_equal(port.absolute_sample, ref.absolute_sample)
    for tap in TAPS:
        scale = sum(np.abs(ref.outputs[f"{tap}_{c}p"]).mean(axis=1)
                    for c in ("i", "q"))[:, None] + 1.0
        for k in (f"{tap}_{c}{t}" for c in ("i", "q") for t in "epl"):
            np.testing.assert_allclose(port.outputs[k] / scale,
                                       ref.outputs[k] / scale, atol=atol,
                                       err_msg=k)
    for k in ("carr_err", "code_err"):
        a, b = ref.outputs[k], port.outputs[k]
        scale = np.abs(a).mean() + 1.0
        np.testing.assert_allclose(b / scale, a / scale, atol=atol,
                                   err_msg=k)
    np.testing.assert_allclose(port.carr_freq, ref.carr_freq, atol=carr_atol)


@pytest.mark.parametrize("correlator", sorted(REF_PATH))
@pytest.mark.parametrize("blend", BLENDS)
def test_wideband_matches_jax(blend, correlator):
    """10 epochs in two blocks, 2 channels."""
    ref_path = REF_PATH[correlator]
    ref = _reference(blend, ref_path, 10, 5)
    port = _port(blend, correlator, 10, 5)
    assert ref.correlator == ref_path
    want = "reference" if correlator == "gather" else correlator
    assert port.correlator == want and port.n_epochs == 10
    _assert_close(ref, port, atol=2e-2, carr_atol=0.05)


def test_kernel_plain_version_matches_jax_fused_interpret():
    """The CUDA tracking kernel's plain version (what "auto" runs on the
    CPU) against the Pallas kernel in interpret mode, 4 epochs of the
    composite blend.  The fused kernel computes its chip boundaries with a
    different float32 split (tests/test_pallas_fused.py's note), so its
    tolerances apply: 5e-2 scaled, 0.25 Hz."""
    ref = _reference("composite", "fused", 4, 4)
    port = _port("composite", "auto", 4, 4)
    assert ref.correlator == "fused" and port.correlator == "reference"
    _assert_close(ref, port, atol=5e-2, carr_atol=0.25)
