"""The CUDA tracking kernel against its plain PyTorch version, on the card.

Marked `cuda` and skipped without an NVIDIA GPU.  On a machine with one
(and without JAX, which tests/conftest.py imports) run:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from bds3_tpu.config import TrackMode, b2a_settings
from bds3_tpu.io import SatParams, synthesize_if
from bds3_tpu_torch.track import driver
from bds3_tpu_torch.track.fused import fused_track_block
from bds3_tpu_torch.track.scan import (
    TrackState,
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


def _setup(dev, mode, epochs):
    s = b2a_settings(sampling_freq=10e6, intermediate_freq=2.5e6,
                     track_mode=mode)
    sig = synthesize_if(s, SATS, n_ms=epochs + 15.0, noise_std=1.0, seed=6)
    inits = []
    for sat in SATS:
        rate = s.code_freq_basis * (1 + sat.doppler_hz / s.carr_freq_basis)
        start = ((s.code_length - sat.code_phase_chips % s.code_length)
                 % s.code_length) / rate
        inits.append(ChannelInit(
            prn=sat.prn, acquired_freq=s.intermediate_freq + sat.doppler_hz,
            code_phase=int(round(start * s.sampling_freq)), peak_metric=2.0))
    cap = driver.as_capture(sig, dev)
    return cap, driver.setup_tracking(cap, s, inits, epochs, epochs)


@pytest.mark.parametrize("mode", [TrackMode.NARROWBAND, TrackMode.DATA_ONLY])
def test_kernel_matches_plain_version(cuda, mode):
    """Exact blksize and cursors; the same sums in another order agree
    within 1e-3 of |a|.mean()+1."""
    cap, setup = _setup(cuda, mode, 30)
    before = fused_track_block.launches
    st_k, rows_k = fused_track_block(setup.cfg, cap, setup.tables,
                                     setup.consts, setup.state)
    assert fused_track_block.launches == before + 1
    st_r, rows_r = track_block_reference(setup.cfg, cap, setup.tables,
                                         setup.consts, setup.state)
    torch.cuda.synchronize()
    assert torch.equal(st_k.cursor, st_r.cursor)
    k = {n: v.cpu().numpy() for n, v in unpack_rows(setup.cfg, rows_k).items()}
    r = {n: v.cpu().numpy() for n, v in unpack_rows(setup.cfg, rows_r).items()}
    np.testing.assert_array_equal(k["blksize"], r["blksize"])
    for n in r:
        scale = np.abs(r[n]).mean() + 1.0
        np.testing.assert_allclose(k[n] / scale, r[n] / scale, atol=1e-3,
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
