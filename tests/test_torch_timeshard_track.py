"""The port's time-sharded tracking with loop-state handoff
(bds3_tpu_torch.parallel.timeshard_track) over gloo ranks on the CPU, on
tests/test_timeshard_track.py's cases: 4 time shards, 8, 8 with
single-channel groups, and the 2-D ("time", "channel") mesh of (4, 2).

The ranks start once for the module (8 processes, every case in one
launch; the 4-shard case runs on the first 4).  Each case is held:
- to JAX's time_sharded_track on its 8-device CPU mesh of the same
  shape, at tests/test_torch_track.py's rules: with correlator="fused"
  (the Pallas kernel in interpret mode) scaled atol 5e-2 on the prompts
  and the carrier within 0.25 Hz, for the two cases the JAX tests run
  fused (4 shards and the 2-D mesh); with "gather" 2e-2 and 0.05 Hz for
  the 8-shard cases, where JAX's fused run takes 53-83 s of compiling on
  the CPU; blksize within one sample (tests/test_timeshard_track.py's
  rule for a sum rounded another way);
- to the port's own sequential track() at epochs_per_block = one
  segment, at tests/test_timeshard_track.py's tolerances (rtol 3e-5,
  atol 3e-4): the segments are the sequential blocks, so equality is
  expected.
On the CPU the port runs its tracking kernel's plain version
(correlator "auto").
"""
import numpy as np
import pytest
import torch

from bds3_tpu.acquire import acquire
from bds3_tpu.config import b2a_settings
from bds3_tpu.io import SatParams, synthesize_if
from bds3_tpu.parallel.mesh import make_mesh as jax_mesh
from bds3_tpu.parallel.timeshard_track import (
    time_sharded_track as jax_time_sharded_track,
)
from bds3_tpu.track.state import assign_channels
from bds3_tpu_torch import convert
from bds3_tpu_torch.parallel import worker
from bds3_tpu_torch.parallel.mesh import Mesh
from bds3_tpu_torch.parallel.timeshard_track import time_sharded_track
from bds3_tpu_torch.track import driver as port_driver
from bds3_tpu_torch.track.state import ChannelInit

# name: (mesh shape, epochs, groups, JAX's correlator); the 2-D case
# splits each group's channels over the mesh's second axis
CASES = {"ts4": ((4,), 320, 2, "fused"), "ts8": ((8,), 400, 2, "gather"),
         "cg1": ((8,), 400, 4, "gather"), "ts2d": ((4, 2), 320, 2, "fused")}
# JAX's correlator: (scaled atol of the prompts, carrier atol in Hz)
RULES = {"fused": (5e-2, 0.25), "gather": (2e-2, 0.05)}
PROMPTS = ("d_ip", "d_qp", "p11_ip", "p11_qp")


@pytest.fixture(scope="module")
def setup():
    """tests/test_timeshard_track.py's _setup: 20 Msps, 2 satellites
    acquired, 4 channels."""
    s = b2a_settings(sampling_freq=20e6, intermediate_freq=5e6,
                     acq_satellite_list=(7, 19), num_channels=4)
    sats = [
        SatParams(prn=7, doppler_hz=-1830.0, code_phase_chips=700.0,
                  amplitude=0.9, carrier_phase=0.1),
        SatParams(prn=19, doppler_hz=950.0, code_phase_chips=4100.0,
                  amplitude=0.9, carrier_phase=0.6),
    ]
    sig = synthesize_if(s, sats, n_ms=500.0, noise_std=1.5, seed=9)
    chans = assign_channels(acquire(sig, s), s)
    assert len(chans) == 2
    chans = chans + [type(c)(**c.__dict__) for c in chans]
    return s, sig, chans


def _port(s, chans):
    ps = convert.settings_from_reference(s)
    return ps, [ChannelInit(**c.__dict__) for c in chans]


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    s, sig, chans = setup
    ps, pinits = _port(s, chans)
    cases = []
    for name, (shape, n_ep, groups, _) in CASES.items():
        cases.append(dict(name=name, mode="time2d" if len(shape) == 2
                          else "time", shape=list(shape),
                          n_devices=int(np.prod(shape)), epochs=n_ep,
                          n_groups=groups, settings="s", signal="sig",
                          inits="inits"))
    d = tmp_path_factory.mktemp("ranks")
    worker.write_job(d / "job.npz", cases, {"s": ps},
                     {"sig": sig, "inits": worker.inits_to_array(pinits)})
    return worker.run_job(8, d / "job.npz", d / "out.npz",
                          store=str(d / "store"), device="cpu", timeout=900,
                          env_extra={"OMP_NUM_THREADS": "1"})


def _out(ranks, name):
    return {k.split("/", 1)[1]: v for k, v in ranks.items()
            if k.startswith(name + "/")}


@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax(setup, ranks, name):
    s, sig, chans = setup
    shape, n_ep, groups, correlator = CASES[name]
    atol, carr_atol = RULES[correlator]
    two_d = len(shape) == 2
    mesh = jax_mesh(int(np.prod(shape)),
                    ("time", "channel") if two_d else ("time",),
                    shape=shape)
    ref = jax_time_sharded_track(
        mesh, sig, s, chans, n_ep, n_groups=groups,
        channel_axis="channel" if two_d else None, correlator=correlator)
    got = _out(ranks, name)
    assert sorted(k for k in got if k in ref) == sorted(ref)
    db = got["blksize"] - ref["blksize"]
    assert np.abs(db).max() <= 1.0, np.abs(db).max()
    for k in PROMPTS:
        scale = np.abs(ref[k]).mean() + 1.0
        np.testing.assert_allclose(got[k] / scale, ref[k] / scale,
                                   atol=atol, err_msg=k)
    np.testing.assert_allclose(got["d_cyc"] * s.sampling_freq,
                               ref["d_cyc"] * s.sampling_freq, atol=carr_atol)


@pytest.mark.parametrize("name", list(CASES))
def test_equals_sequential_track(setup, ranks, name):
    s, sig, chans = setup
    ps, pinits = _port(s, chans)
    shape, n_ep, _, _ = CASES[name]
    ref = port_driver.track(sig, ps, pinits, n_epochs=n_ep,
                            epochs_per_block=n_ep // shape[0], device="cpu")
    got = _out(ranks, name)
    for k in ("d_ip", "d_qp", "carr_err", "code_err", "blksize"):
        np.testing.assert_allclose(got[k], ref.outputs[k], rtol=3e-5,
                                   atol=3e-4, err_msg=k)


def _mesh(shape):
    """Rank 0 of a mesh of `shape` without a process group: what the
    argument checks see before any exchange."""
    names = ("time", "channel")[: len(shape)]
    return Mesh(names, dict(zip(names, shape)), (0,) * len(shape),
                (None,) * len(shape), (None,) * len(shape),
                torch.device("cpu"))


@pytest.mark.parametrize("shape,n_ep,groups,channel_axis,match", [
    ((4,), 321, 2, None, "n_epochs 321 % n_dev 4"),
    ((4,), 320, 3, None, "channels 4 % groups 3"),
    ((4, 2), 320, 4, "channel", "group channels 1 % mesh"),
])
def test_refuses_what_does_not_divide(setup, shape, n_ep, groups,
                                      channel_axis, match):
    s, sig, chans = setup
    ps, pinits = _port(s, chans)
    with pytest.raises(ValueError, match=match):
        time_sharded_track(_mesh(shape), sig, ps, pinits, n_ep, groups,
                           channel_axis=channel_axis)


def test_refuses_a_signal_too_short(setup):
    s, sig, chans = setup
    ps, pinits = _port(s, chans)
    with pytest.raises(ValueError, match="signal too short"):
        time_sharded_track(_mesh((4,)), sig[: len(sig) // 4], ps, pinits,
                           320, 2)
