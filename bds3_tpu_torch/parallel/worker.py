"""One rank of a parallel run: every parallel path, driven from a job file.

Port of `tools/multihost_worker.py`.  The parent writes the job
(`write_job`: settings, captures and channel assignments as arrays, and
a list of cases) and starts the ranks (`run_job`, through
`launch.launch_local`); no rank synthesizes its own capture.  Each case
runs one path on a mesh over the first `n_devices` ranks:

  channel      channel fan-out, sharded_track_block block by block over
               the capture (shard_map_track_block with "shard_map": true)
  time         time_sharded_track on a ("time",) mesh
  time2d       time_sharded_track on a ("time", "channel") mesh of `shape`
  acq_prn      sharded_coarse_search (PRNs split over the ranks)
  acq_doppler  doppler_sharded_coarse_search (bins split over the ranks)
  acq_noncoh   noncoherent_acquire_timesharded

Rank 0 writes each case's global result under "<case>/<name>", beside
every rank's tracking-kernel launches ("<case>/k1_launches", counted from
0 over the case's run) and the slowest rank's wall time.  With
"check_k1" on a card, each rank also holds one 20-epoch block of the
kernel on its own channels against its plain version, after the counted
run.  All ranks meet at a barrier before they exit.

Usage (one process per rank, started by `launch.launch_local` or a
cluster's launcher, which set RANK, WORLD_SIZE and LOCAL_RANK):
  python -m bds3_tpu_torch.parallel.worker JOB.npz OUT.npz [--store S] \\
      [--device cuda:0] [--backend gloo]

Every case of the job runs.  --store: a FileStore's path, "host:port" or
an init_method URL; by default MASTER_ADDR and MASTER_PORT.  --device:
the rank's device, by default the card of its LOCAL_RANK; ranks that
share one card pass cuda:0, the tests cpu.
"""
from __future__ import annotations

import argparse
import dataclasses
import enum
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from bds3_tpu_torch import config
from bds3_tpu_torch.acquire.pcps import acq_code_tables, make_acq_config
from bds3_tpu_torch.parallel import launch, multihost
from bds3_tpu_torch.parallel.mesh import default_device, make_mesh
from bds3_tpu_torch.parallel.sharded import (
    doppler_sharded_coarse_search,
    shard_map_track_block,
    sharded_coarse_search,
    sharded_track_block,
)
from bds3_tpu_torch.parallel.timeshard import noncoherent_acquire_timesharded
from bds3_tpu_torch.parallel.timeshard_track import time_sharded_track
from bds3_tpu_torch.track.driver import as_capture, setup_tracking
from bds3_tpu_torch.track.fused import fused_track_block
from bds3_tpu_torch.track.scan import (
    output_names,
    track_block_reference,
    unpack_rows,
)
from bds3_tpu_torch.track.state import ChannelInit
from bds3_tpu_torch.utils.device import resolve_device
from bds3_tpu_torch.utils.phase import phase_tables

MODES = ("channel", "time", "time2d", "acq_prn", "acq_doppler", "acq_noncoh")
TRACK_MODES = ("channel", "time", "time2d")
ROOT = Path(__file__).resolve().parents[2]


# --- the job file ----------------------------------------------------------

def _encode(v):
    if isinstance(v, enum.Enum):
        return {"enum": type(v).__name__, "name": v.name}
    if isinstance(v, tuple):
        return {"tuple": list(v)}
    return v


def _decode(v):
    if isinstance(v, dict):
        if "enum" in v:
            return getattr(config, v["enum"])[v["name"]]
        return tuple(v["tuple"])
    return v


def settings_to_json(s: config.Settings) -> dict:
    return {f.name: _encode(getattr(s, f.name))
            for f in dataclasses.fields(s)}


def settings_from_json(d: dict) -> config.Settings:
    return config.Settings(**{k: _decode(v) for k, v in d.items()})


def inits_to_array(inits) -> np.ndarray:
    """(C, 4) float64: prn, acquired_freq, code_phase, peak_metric."""
    return np.array([[c.prn, c.acquired_freq, c.code_phase, c.peak_metric]
                     for c in inits], dtype=np.float64)


def inits_from_array(a: np.ndarray) -> list[ChannelInit]:
    return [ChannelInit(prn=int(r[0]), acquired_freq=float(r[1]),
                        code_phase=int(r[2]), peak_metric=float(r[3]))
            for r in np.asarray(a)]


def write_job(path, cases: list[dict], settings: dict,
              arrays: dict | None = None,
              signal_files: dict | None = None) -> None:
    """The job file the ranks read.  cases: dicts with "name", "mode",
    "n_devices" and the keys of their settings ("settings"), capture
    ("signal") and channels ("inits"), plus the mode's parameters.
    settings: key -> Settings; arrays: key -> numpy array (captures, and
    channels as inits_to_array gives them); signal_files: key -> path of
    an .npy capture, which each rank maps rather than copies."""
    unknown = sorted({c["mode"] for c in cases} - set(MODES))
    if unknown:
        raise ValueError(f"unknown modes {unknown}: expected {MODES}")
    spec = {"cases": cases,
            "settings": {k: settings_to_json(s) for k, s in settings.items()},
            "signal_files": {k: str(p) for k, p in (signal_files or {}).items()}}
    np.savez(path, job=np.array(json.dumps(spec)), **(arrays or {}))


class Job:
    def __init__(self, path):
        self._npz = np.load(path)
        spec = json.loads(str(self._npz["job"]))
        self.cases = spec["cases"]
        self.settings = {k: settings_from_json(v)
                         for k, v in spec["settings"].items()}
        self.signal_files = spec["signal_files"]

    def array(self, key: str) -> np.ndarray:
        if key in self.signal_files:
            return np.load(self.signal_files[key], mmap_mode="r")
        return self._npz[key]


def run_job(nproc: int, job_path, out_path, store: str | None = None,
            device: str | None = None, backend: str = "gloo",
            timeout: float | None = None, env_extra: dict | None = None
            ) -> dict:
    """Start nproc ranks of this worker on the job (launch_local) and
    return rank 0's results; raises if a rank failed.  store and device
    as the worker's --store and --device."""
    cmd = [sys.executable, "-m", "bds3_tpu_torch.parallel.worker",
           str(job_path), str(out_path), "--backend", backend]
    if store is not None:
        cmd += ["--store", store]
    if device is not None:
        cmd += ["--device", device]
    path = os.pathsep.join(p for p in (str(ROOT),
                                       os.environ.get("PYTHONPATH")) if p)
    rc = launch.launch_local(nproc, cmd, {"PYTHONPATH": path,
                                          **(env_extra or {})}, timeout)
    if rc != 0:
        raise RuntimeError(f"a rank of the job {job_path} exited with {rc}")
    with np.load(out_path) as res:
        return dict(res)


# --- the cases ------------------------------------------------------------

def _channel(case, s, signal, inits, dev):
    mesh = make_mesh(case["n_devices"], ("channel",), device=dev)
    if mesh.coords is None:
        return mesh, None
    fn = shard_map_track_block if case.get("shard_map") \
        else sharded_track_block
    capture = as_capture(signal, dev)
    setup = setup_tracking(capture, s, inits, case["epochs"],
                           case["epochs_per_block"])

    def run():
        state, rows = setup.state, []
        for _ in range(setup.n_blocks):
            state, r = fn(mesh, setup.cfg, capture, setup.tables,
                          setup.consts, state)
            rows.append(r)
        rows = torch.cat(rows)[: case["epochs"]].cpu().numpy()
        out = {k: np.ascontiguousarray(rows[:, :, i].T)
               for i, k in enumerate(output_names(setup.cfg))}
        out["cursor"] = state.cursor.cpu().numpy()
        out["statef"] = state.statef.cpu().numpy()
        return out

    return mesh, run


def _time(case, s, signal, inits, dev):
    two_d = case["mode"] == "time2d"
    names = ("time", "channel") if two_d else ("time",)
    shape = tuple(case["shape"]) if two_d else None
    mesh = make_mesh(case["n_devices"], names, shape, device=dev)
    if mesh.coords is None:
        return mesh, None
    return mesh, lambda: time_sharded_track(
        mesh, signal, s, inits, case["epochs"], case.get("n_groups"),
        channel_axis="channel" if two_d else None)


def _acq(case, s, signal, dev):
    mesh = make_mesh(case["n_devices"], ("channel",), device=dev)
    if mesh.coords is None:
        return mesh, None
    prns = np.asarray(case.get("prns", s.acq_satellite_list))
    if case["mode"] == "acq_noncoh":
        def run():
            cube, freq, phase = noncoherent_acquire_timesharded(
                mesh, signal, s, prns, case["rounds"])
            return {"cube": cube, "freq": freq, "phase": phase}
        return mesh, run

    cfg = make_acq_config(s)
    d8, p8 = (torch.from_numpy(x).to(dev) for x in acq_code_tables(s, prns))
    n_bins = case.get("bins", cfg.n_bins)
    freqs = cfg.freq_base + cfg.freq_step * np.arange(n_bins)
    a_b, c1_b = (torch.from_numpy(x).to(dev)
                 for x in phase_tables(freqs, cfg.fs))
    sig = torch.from_numpy(np.asarray(signal[: cfg.n_fft],
                                      dtype=np.float32)).to(dev)
    fn = sharded_coarse_search if case["mode"] == "acq_prn" \
        else doppler_sharded_coarse_search

    def run():
        v, b, p = fn(mesh, sig, d8, p8, a_b, c1_b, cfg)
        return {"peak": v.cpu().numpy(), "bin": b.cpu().numpy(),
                "phase": p.cpu().numpy()}

    return mesh, run


def _local_inits(case, mesh, inits):
    """This rank's channels: its slice on the channel axis (of the first
    group, for the time modes)."""
    if case["mode"] == "channel":
        k, c = mesh.shape["channel"], mesh.index("channel")
        n = len(inits) // k
        return inits[c * n:(c + 1) * n]
    g = len(inits) // (case.get("n_groups") or min(mesh.shape["time"],
                                                    len(inits)))
    k = mesh.shape.get("channel", 1)
    c = mesh.index("channel") if "channel" in mesh.shape else 0
    return inits[c * g // k:(c + 1) * g // k]


def k1_check(s, signal, inits, dev) -> dict:
    """One block of CHECK_EPOCHS epochs of `inits` through the tracking kernel
    and through its plain version from the same state: whether blksize
    and the cursors are equal, and the largest correlator and
    discriminator difference, absolute and in units of |plain|.mean()+1."""
    capture = as_capture(signal, dev)
    setup = setup_tracking(capture, s, inits, CHECK_EPOCHS, CHECK_EPOCHS)
    args = (setup.cfg, capture, setup.tables, setup.consts, setup.state)
    st_r, rows_r = track_block_reference(*args)
    st_k, rows_k = fused_track_block(*args)
    k = {n: v.cpu().numpy() for n, v in unpack_rows(setup.cfg, rows_k).items()}
    r = {n: v.cpu().numpy() for n, v in unpack_rows(setup.cfg, rows_r).items()}
    names = [n for n in r if n.startswith(("d_", "p11_", "p61_", "p_"))] \
        + ["carr_err", "code_err"]
    abs_err = [float(np.abs(k[n] - r[n]).max()) for n in names]
    scaled = [e / (float(np.abs(r[n]).mean()) + 1.0)
              for e, n in zip(abs_err, names)]
    return {"blksize_equal": float(np.array_equal(k["blksize"],
                                                  r["blksize"])),
            "cursor_equal": float(torch.equal(st_k.cursor, st_r.cursor)),
            "abs_err": max(abs_err), "scaled_err": max(scaled)}


CHECK_KEYS = ("blksize_equal", "cursor_equal", "abs_err", "scaled_err")
CHECK_EPOCHS = 20


def _world_rows(values: list[float], dev: torch.device) -> np.ndarray:
    """(world, len(values)): every rank's values, on every rank."""
    t = torch.tensor(values, dtype=torch.float64)
    if dist.get_backend() == "nccl":
        t = t.to(dev)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.stack(parts).cpu().numpy()


def run_case(case: dict, job: Job, dev: torch.device) -> dict:
    """One case on every rank; rank 0's dict of results (empty elsewhere)."""
    s = job.settings[case["settings"]]
    signal = job.array(case["signal"])
    inits = inits_from_array(job.array(case["inits"])) \
        if case["mode"] in TRACK_MODES else None
    if case["mode"] == "channel":
        mesh, run = _channel(case, s, signal, inits, dev)
    elif case["mode"] in ("time", "time2d"):
        mesh, run = _time(case, s, signal, inits, dev)
    else:
        mesh, run = _acq(case, s, signal, dev)

    def synced():
        out = run()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    if run is not None and case.get("warm"):
        synced()
    multihost.barrier()
    fused_track_block.launches = 0
    t0 = time.perf_counter()
    out = synced() if run is not None else {}
    wall = time.perf_counter() - t0
    launches = fused_track_block.launches
    check = [0.0] * len(CHECK_KEYS)
    if run is not None and case.get("check_k1") and dev.type == "cuda":
        res = k1_check(s, signal, _local_inits(case, mesh, inits), dev)
        check = [res[k] for k in CHECK_KEYS]
    rows = _world_rows([launches, wall, *check], dev)
    if dist.get_rank() != 0:
        return {}
    name = case["name"]
    res = {f"{name}/{k}": np.asarray(v) for k, v in out.items()}
    res[f"{name}/k1_launches"] = rows[:, 0].astype(np.int64)
    res[f"{name}/wall_s"] = np.asarray(rows[:, 1].max())
    if case.get("check_k1") and dev.type == "cuda":
        members = rows[: case["n_devices"]]
        for i, k in enumerate(CHECK_KEYS):
            res[f"{name}/k1_check_{k}"] = members[:, 2 + i]
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("job")
    ap.add_argument("out")
    ap.add_argument("--store", default=None)
    ap.add_argument("--device", default=None)
    ap.add_argument("--backend", default="gloo",
                    choices=multihost.BACKENDS)
    args = ap.parse_args(argv)
    dev = default_device() if args.device is None \
        else resolve_device(args.device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    multihost.initialize(args.store, backend=args.backend, device=dev)
    job = Job(args.job)
    results = {}
    for case in job.cases:
        results.update(run_case(case, job, dev))
    rank = dist.get_rank()
    if rank == 0:
        tmp = f"{args.out}.{os.getpid()}.tmp.npz"
        np.savez(tmp, **results)
        os.replace(tmp, args.out)
    multihost.barrier()
    dist.destroy_process_group()
    print(f"[rank {rank}] OK", file=sys.stderr, flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
