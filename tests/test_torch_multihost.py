"""Runs of several processes over torch.distributed (gloo, on the CPU):
the port's counterpart of tests/test_multihost.py.

  channel  channel fan-out over 2 ranks (parallel.sharded_track_block)
  time     time-sharded tracking whose loop-state handoff crosses the
           process boundary (parallel.timeshard_track)

Both run through `python -m bds3_tpu_torch.parallel.worker`, in one
launch, and must reproduce the port's one-process `track()` (rtol 1e-6,
atol 1e-4, as tests/test_multihost.py:118-121).  Then the launcher:
an argument-free `multihost.initialize()` rendezvous, the Slurm script,
and a failing rank stopping the run.
"""
import dataclasses
import os
import sys
import time

import numpy as np
import pytest
import torch

from bds3_tpu_torch.acquire.pcps import acquire
from bds3_tpu_torch.config import b1c_settings, b2a_settings
from bds3_tpu_torch.io import SatParams, synthesize_if
from bds3_tpu_torch.parallel import dryrun, launch, worker
from bds3_tpu_torch.track.driver import track
from bds3_tpu_torch.track.state import assign_channels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("d_ip", "d_qp", "carr_err", "code_err", "blksize")


@pytest.fixture(scope="module")
def scenario():
    """tests/test_multihost.py's: 16 Msps, 2 satellites, 4 channels."""
    s = b2a_settings(sampling_freq=16e6, intermediate_freq=4e6,
                     acq_satellite_list=(7, 19), num_channels=4)
    sats = [
        SatParams(prn=7, doppler_hz=-1830.0, code_phase_chips=700.0,
                  amplitude=0.9, carrier_phase=0.1),
        SatParams(prn=19, doppler_hz=950.0, code_phase_chips=4100.0,
                  amplitude=0.9, carrier_phase=0.6),
    ]
    sig = synthesize_if(s, sats, n_ms=260.0, noise_std=1.5, seed=9)
    chans = assign_channels(acquire(sig, s, device="cpu"), s)
    assert len(chans) == 2
    return s, sig, chans + [dataclasses.replace(c) for c in chans]


@pytest.fixture(scope="module")
def ranks(scenario, tmp_path_factory):
    s, sig, chans = scenario
    common = dict(settings="s", signal="sig", inits="inits", n_devices=2)
    cases = [dict(name="channel", mode="channel", epochs=40,
                  epochs_per_block=40, **common),
             dict(name="time", mode="time", epochs=80, n_groups=2, **common)]
    d = tmp_path_factory.mktemp("ranks")
    worker.write_job(d / "job.npz", cases, {"s": s},
                     {"sig": sig, "inits": worker.inits_to_array(chans)})
    return worker.run_job(2, d / "job.npz", d / "out.npz",
                          store=str(d / "store"), device="cpu", timeout=600,
                          env_extra={"OMP_NUM_THREADS": "1"})


@pytest.mark.parametrize("mode,n_epochs,per_block",
                         [("channel", 40, 40), ("time", 80, 40)])
def test_two_ranks_equal_one_process(scenario, ranks, mode, n_epochs,
                                     per_block):
    s, sig, chans = scenario
    ref = track(sig, s, chans, n_epochs=n_epochs,
                epochs_per_block=per_block, device="cpu")
    for k in NAMES:
        np.testing.assert_allclose(ranks[f"{mode}/{k}"], ref.outputs[k],
                                   rtol=1e-6, atol=1e-4, err_msg=k)
    assert ranks[f"{mode}/k1_launches"].shape == (2,)


def test_local_launch_rendezvous(tmp_path):
    """launch_local's variables let an argument-free initialize() join a
    2-rank group and build its global mesh."""
    prog = (
        "import os, sys\n"
        "sys.path.insert(0, os.environ['BDS3_REPO'])\n"
        "import torch.distributed as dist\n"
        "from bds3_tpu_torch.parallel.multihost import (\n"
        "    global_channel_mesh, initialize)\n"
        "initialize()\n"
        "initialize()   # a second call does nothing\n"
        "mesh = global_channel_mesh(device='cpu')\n"
        "assert mesh.shape == {'channel': 2}, mesh.shape\n"
        "assert mesh.index('channel') == dist.get_rank()\n"
        "open(os.path.join(os.environ['MH_OUT'], \n"
        "     f'rank{dist.get_rank()}'), 'w').write('ok')\n"
        "dist.destroy_process_group()\n"
    )
    rc = launch.launch_local(
        2, [sys.executable, "-c", prog],
        env_extra={"BDS3_REPO": REPO, "MH_OUT": str(tmp_path)}, timeout=120)
    assert rc == 0
    assert (tmp_path / "rank0").exists() and (tmp_path / "rank1").exists()


def test_a_failing_rank_stops_the_run():
    prog = ("import os, sys, time\n"
            "if os.environ['RANK'] == '1':\n"
            "    sys.exit(3)\n"
            "time.sleep(120)\n")
    t0 = time.monotonic()
    rc = launch.launch_local(2, [sys.executable, "-c", prog], timeout=100)
    assert rc == 3
    assert time.monotonic() - t0 < 60      # rank 0 was stopped


def test_a_run_past_its_time_limit_is_stopped():
    rc = launch.launch_local(
        1, [sys.executable, "-c", "import time; time.sleep(60)"], timeout=1)
    assert rc == 124


def test_slurm_emission():
    script = launch.emit_slurm(4, ["python", "run.py"])
    assert "--nodes=4" in script
    assert "SLURM_PROCID" in script and "RANK" in script
    assert 'WORLD_SIZE="$SLURM_NTASKS"' in script


@pytest.mark.parametrize("s", [b2a_settings(), b1c_settings()],
                         ids=["b2a", "b1c"])
def test_settings_cross_to_the_ranks_unchanged(s):
    import json

    back = worker.settings_from_json(json.loads(
        json.dumps(worker.settings_to_json(s))))
    assert back == s


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without a card, where a request for one raises")
@pytest.mark.parametrize("entry", ["worker", "dryrun"])
def test_entry_points_default_to_the_card(entry):
    """With no --device, the worker and the dry run ask for a card: here,
    without one, they raise rather than run on the CPU."""
    with pytest.raises(RuntimeError, match="is_available"):
        if entry == "worker":
            worker.main(["unused.npz", "unused.npz"])
        else:
            dryrun.main(["2"])


def test_worker_refuses_an_unknown_mode(tmp_path):
    case = dict(name="x", mode="bogus", settings="s", signal="sig",
                n_devices=1)
    with pytest.raises(ValueError, match="unknown modes"):
        worker.write_job(tmp_path / "job.npz", [case], {"s": b2a_settings()})
    assert not (tmp_path / "job.npz").exists()
