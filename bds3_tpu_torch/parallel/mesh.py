"""Rank geometry and the collectives the parallel paths use, over
torch.distributed.

Port of `bds3_tpu/parallel/mesh.py`.  JAX holds every device in one
process and partitions arrays with `NamedSharding` and `shard_map`;
PyTorch runs one process per rank, with one device each.  A `Mesh` is
that rank geometry: axis names, a shape, this rank's coordinates, one
process group per axis and the rank's compute device.  What JAX writes as
`P(axis)` is the slice of the leading axis this rank owns
(`Placement.local`), `P()` the whole tensor; its `all_gather`, `psum` and
`ppermute` are `gather`, `all_sum` and `shift` on an axis's group.

The backend is the caller's choice (`multihost.initialize`): NCCL where
each rank has its own card, gloo where ranks share a card or run on the
CPU.  Gloo's point-to-point operations and gathers take CPU tensors, so on
gloo a CUDA tensor crosses through an explicit host copy in these helpers.
Their payloads are small (loop states, per-PRN winners, halos, rows of
outputs) next to what each rank computes, which stays on its device.

Without a process group a mesh has one rank and its collectives are the
identity: a single-process run is the same function on a one-rank mesh.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from bds3_tpu_torch.utils.device import resolve_device


def default_device() -> torch.device:
    """The card of this rank's LOCAL_RANK (0 without one); raises where
    there is no card.  Ranks that share one card name it themselves
    (device="cuda:0")."""
    return resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}")


@dataclasses.dataclass(eq=False)
class Mesh:
    """Ranks [0, prod(shape)) of the process group, laid out row-major
    over named axes.  `coords` is this rank's position (None for a rank of
    the group outside the mesh); `groups[i]` is the process group of the
    ranks that share every coordinate but axis i, and `ranks[i]` their
    global ranks in coordinate order (None without a process group)."""

    axis_names: tuple[str, ...]
    shape: dict                       # axis name -> size, as JAX's mesh.shape
    coords: tuple[int, ...] | None
    groups: tuple
    ranks: tuple
    device: torch.device

    def index(self, axis: str) -> int:
        """This rank's coordinate on `axis` (jax.lax.axis_index)."""
        if self.coords is None:
            raise ValueError("this rank is outside the mesh")
        return self.coords[self.axis_names.index(axis)]


def make_mesh(n_devices: int | None = None,
              axis_names: tuple[str, ...] = ("channel",),
              shape: tuple[int, ...] | None = None,
              device: str | torch.device | None = None) -> Mesh:
    """A mesh over the first n_devices ranks of the process group (all of
    them by default; one without a process group).

    Default: 1-D "channel" mesh (satellite fan-out).  For 2-D pass e.g.
    axis_names=("time", "channel"), shape=(2, 4).  Every rank of the group
    must call it, members or not: it creates the axes' process groups.
    device: the rank's compute device; by default the card of its
    LOCAL_RANK (default_device), which raises without one.
    """
    grouped = dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    rank = dist.get_rank() if grouped else 0
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a process group of {world}")
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if len(shape) != len(axis_names) or int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not hold {n} ranks on "
                         f"the axes {axis_names}")
    grid = np.arange(n).reshape(shape)
    coords = tuple(int(c) for c in np.argwhere(grid == rank)[0]) \
        if rank < n else None
    groups, ranks = [], []
    for i in range(len(axis_names)):
        mine_g, mine_r = None, None
        if grouped:
            # every rank creates every group of the axis, in one order
            for line in np.moveaxis(grid, i, -1).reshape(-1, shape[i]):
                members = [int(r) for r in line]
                g = dist.new_group(members)
                if rank in members:
                    mine_g, mine_r = g, tuple(members)
        groups.append(mine_g)
        ranks.append(mine_r)
    dev = default_device() if device is None else resolve_device(device)
    return Mesh(tuple(axis_names), dict(zip(axis_names, shape)), coords,
                tuple(groups), tuple(ranks), dev)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a tensor's leading axis lives: split evenly over a mesh axis
    (JAX's P(axis)), or whole on every rank (axis None, P())."""

    mesh: Mesh
    axis: str | None

    def bounds(self, n: int) -> tuple[int, int]:
        """[lo, hi) of a leading axis of n that this rank holds."""
        if self.axis is None:
            return 0, n
        k = self.mesh.shape[self.axis]
        if n % k:
            raise ValueError(f"a leading axis of {n} does not divide over "
                             f"mesh axis {self.axis!r} of {k}")
        c = self.mesh.index(self.axis)
        return c * n // k, (c + 1) * n // k

    def local(self, x):
        """This rank's part of x (a view of a tensor or numpy array)."""
        lo, hi = self.bounds(x.shape[0])
        return x[lo:hi]


def channel_sharding(mesh: Mesh, axis: str = "channel") -> Placement:
    """Shard leading (channel/PRN) dimension across the mesh."""
    return Placement(mesh, axis)


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, None)


def _axis(mesh: Mesh, axis: str):
    """(group, ranks) of `axis`: group None for an axis of one rank
    without a process group."""
    i = mesh.axis_names.index(axis)
    if mesh.coords is None:
        raise ValueError("this rank is outside the mesh")
    return mesh.groups[i], mesh.ranks[i]


def _wire(group, x: torch.Tensor) -> torch.Tensor:
    """x as the group's backend takes it: a host copy of a CUDA tensor on
    gloo, x itself otherwise."""
    x = x.contiguous()
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return x.cpu()
    return x


def gather(mesh: Mesh, x: torch.Tensor, axis: str, dim: int = 0
           ) -> torch.Tensor:
    """Every rank's x along `axis`, concatenated on `dim` in coordinate
    order (jax.lax.all_gather, tiled); on x's device."""
    group, ranks = _axis(mesh, axis)
    if group is None:
        return x
    w = _wire(group, x)
    parts = [torch.empty_like(w) for _ in ranks]
    dist.all_gather(parts, w, group=group)
    return torch.cat(parts, dim).to(x.device)


def all_sum(mesh: Mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """The sum of every rank's x along `axis` (jax.lax.psum); on x's
    device."""
    group, _ = _axis(mesh, axis)
    if group is None:
        return x
    w = _wire(group, x)
    if w is x:
        w = x.clone()
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=group)
    return w.to(x.device)


def shift(mesh: Mesh, xs, axis: str, offset: int = 1):
    """One step around the ring of `axis` (jax.lax.ppermute): each rank
    sends xs (a tensor or a tuple of tensors) to the coordinate `offset`
    after its own and returns what the coordinate `offset` before it sent.
    offset=1 hands on to the right neighbour, -1 fetches from it."""
    group, ranks = _axis(mesh, axis)
    single = isinstance(xs, torch.Tensor)
    xs = (xs,) if single else tuple(xs)
    if group is None or len(ranks) == 1:
        out = tuple(x.clone() for x in xs)
    else:
        c = mesh.index(axis)
        dst = ranks[(c + offset) % len(ranks)]
        src = ranks[(c - offset) % len(ranks)]
        sends = [_wire(group, x) for x in xs]
        recvs = [torch.empty_like(s) for s in sends]
        ops = [dist.P2POp(dist.isend, s, dst, group=group) for s in sends] \
            + [dist.P2POp(dist.irecv, r, src, group=group) for r in recvs]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        out = tuple(r.to(x.device) for r, x in zip(recvs, xs))
    return out[0] if single else out
