"""Process-group start-up for runs of several ranks.

Port of `bds3_tpu/parallel/multihost.py`.  The reference starts
`jax.distributed` from JAX_* variables and builds a global mesh over
every device of every host; here each rank is one process with one
device, started by `parallel.launch` (or a cluster's own launcher) with
the torch rendezvous variables MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK
and LOCAL_RANK.  Channel fan-out needs no traffic between ranks but the
final gather; time-sharded acquisition and tracking exchange halos and
loop states through the same helpers (`parallel.mesh`).
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from bds3_tpu_torch.parallel.mesh import Mesh, default_device, make_mesh
from bds3_tpu_torch.utils.device import resolve_device

BACKENDS = ("gloo", "nccl")


def _init_method(coordinator: str | None) -> str:
    if coordinator is None:
        return (f"tcp://{os.environ['MASTER_ADDR']}:"
                f"{os.environ['MASTER_PORT']}")
    if "://" in coordinator:
        return coordinator
    if ":" in coordinator:
        return f"tcp://{coordinator}"
    return f"file://{os.path.abspath(coordinator)}"   # a FileStore's path


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str = "gloo",
               device: str | torch.device | None = None) -> None:
    """Join the default process group; a second call does nothing.

    coordinator: "host:port", an init_method URL ("tcp://...",
    "file://...") or a FileStore's path; num_processes and process_id:
    the world size and this rank.  Each that is None is read from
    MASTER_ADDR/MASTER_PORT, WORLD_SIZE and RANK, as parallel.launch sets
    them.  backend: "gloo" (ranks on the CPU, or sharing one card) or
    "nccl" (one card per rank: `device`, by default default_device(),
    becomes the rank's current card)."""
    if dist.is_initialized():
        return
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if backend == "nccl":
        dev = default_device() if device is None else resolve_device(device)
        if dev.type != "cuda":
            raise ValueError(f"NCCL runs on a card, not {dev}")
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=_init_method(coordinator),
                            world_size=num_processes, rank=process_id)


def barrier() -> None:
    """Wait for every rank of the default group (nothing without one)."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def global_channel_mesh(axis: str = "channel",
                        device: str | torch.device | None = None) -> Mesh:
    """One-axis mesh over every rank of the process group."""
    return make_mesh(None, (axis,), device=device)
