"""The port's time-sharded non-coherent acquisition
(bds3_tpu_torch.parallel.timeshard) over 8 gloo ranks on the CPU, on
tests/test_timeshard.py's weak-signal case (8 ranks, 4 rounds each),
against the JAX package's on its 8-device CPU mesh and against the
port's own one-rank run.

The winners must equal JAX's; the cube agrees within rtol 3e-4
(tests/test_timeshard.py's own, for a cube summed another way), because
XLA's FFT and PyTorch's round differently: up to 9.4e-5 apart here.  The
one-rank run over 8 x 4 rounds leaves out the same wrapped rounds, so its
cube differs from the 8-rank sum only in the order of the float32
additions (rtol 1e-5), and its winners are equal.
"""
import numpy as np
import pytest
import torch

from bds3_tpu.config import b2a_settings
from bds3_tpu.io import SatParams, synthesize_if
from bds3_tpu.parallel.mesh import make_mesh as jax_mesh
from bds3_tpu.parallel.timeshard import (
    noncoherent_acquire_timesharded as jax_noncoh,
)
from bds3_tpu_torch import convert
from bds3_tpu_torch.parallel import worker
from bds3_tpu_torch.parallel.mesh import make_mesh
from bds3_tpu_torch.parallel.timeshard import noncoherent_acquire_timesharded

N_DEV, ROUNDS = 8, 4
PRNS = [19, 7]
SAT = SatParams(prn=19, doppler_hz=1250.0, code_phase_chips=2500.0,
                amplitude=0.22)


def settings():
    return b2a_settings(sampling_freq=10e6, intermediate_freq=2.5e6,
                        acq_search_band=2000.0)


@pytest.fixture(scope="module")
def sig():
    s = settings()
    spc = s.samples_per_code
    need_ms = (N_DEV * ROUNDS * spc + 2 * spc) / s.samples_per_ms
    return synthesize_if(s, [SAT], n_ms=need_ms + 1, noise_std=2.0, seed=2)


@pytest.fixture(scope="module")
def ranks(sig, tmp_path_factory):
    d = tmp_path_factory.mktemp("ranks")
    cases = [dict(name="noncoh", mode="acq_noncoh", settings="s",
                  signal="sig", n_devices=N_DEV, rounds=ROUNDS, prns=PRNS)]
    worker.write_job(d / "job.npz", cases,
                     {"s": convert.settings_from_reference(settings())},
                     {"sig": sig})
    r = worker.run_job(N_DEV, d / "job.npz", d / "out.npz",
                       store=str(d / "store"), device="cpu", timeout=600,
                       env_extra={"OMP_NUM_THREADS": "1"})
    return r["noncoh/cube"], r["noncoh/freq"], r["noncoh/phase"]


def test_matches_jax(sig, ranks):
    cube, freq, phase = ranks
    ref_cube, ref_freq, ref_phase = jax_noncoh(
        jax_mesh(N_DEV, ("channel",)), sig, settings(), PRNS,
        rounds_per_device=ROUNDS)
    np.testing.assert_array_equal(freq, ref_freq)
    np.testing.assert_array_equal(phase, ref_phase)
    np.testing.assert_allclose(cube, ref_cube, rtol=3e-4)


def test_detects_the_weak_signal(ranks):
    """tests/test_timeshard.py's detection checks, on the port's cube."""
    s = settings()
    cube, freq, phase = ranks
    assert abs(freq[0] - (s.intermediate_freq + SAT.doppler_hz)) \
        <= s.acq_step / 2 + 1.0
    rate = s.code_freq_basis * (1 + SAT.doppler_hz / s.carr_freq_basis)
    chi0 = SAT.code_phase_chips % s.code_length
    expect = ((s.code_length - chi0) % s.code_length) / rate \
        * s.sampling_freq
    err = (phase[0] - expect) % s.samples_per_code
    assert min(err, s.samples_per_code - err) <= 2.0

    def pk_ratio(c):
        return c.max() / c.mean()

    assert pk_ratio(cube[0]) > 2.0 * pk_ratio(cube[1])


def test_equals_one_rank(sig, ranks):
    cube, freq, phase = ranks
    one = noncoherent_acquire_timesharded(
        make_mesh(1, device="cpu"), torch.from_numpy(sig),
        convert.settings_from_reference(settings()), PRNS,
        rounds_per_device=N_DEV * ROUNDS)
    np.testing.assert_array_equal(freq, one[1])
    np.testing.assert_array_equal(phase, one[2])
    np.testing.assert_allclose(cube, one[0], rtol=1e-5)


def test_refuses_a_segment_shorter_than_the_halo(sig):
    s = convert.settings_from_reference(settings())
    with pytest.raises(ValueError, match="must cover the halo"):
        noncoherent_acquire_timesharded(make_mesh(1, device="cpu"), sig, s,
                                        PRNS, rounds_per_device=1)


def test_refuses_a_signal_too_short(sig):
    s = convert.settings_from_reference(settings())
    with pytest.raises(ValueError, match="signal too short"):
        noncoherent_acquire_timesharded(make_mesh(1, device="cpu"),
                                        sig[: 10 * s.samples_per_code], s,
                                        PRNS, rounds_per_device=11)
