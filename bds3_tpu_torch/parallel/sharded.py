"""Channel- and Doppler-sharded forms of the receiver's device entry
points.

Port of `bds3_tpu/parallel/sharded.py`.  The channel and PRN axes are
pure fan-out: each rank runs the port's own block function or coarse
search on its slice of the leading axis, and the rows or winners are
gathered along the mesh axis (the domain's data parallelism).  The
Doppler-bin axis of acquisition is split the same way, and the global
(peak, bin, phase) winner is picked from a gather of three (P,) vectors.
Every rank returns the global result, as the reference's functions do.
"""
from __future__ import annotations

import dataclasses

import torch

from bds3_tpu_torch.acquire.pcps import AcqConfig, coarse_search
from bds3_tpu_torch.io.transport import capture_dtype
from bds3_tpu_torch.parallel.mesh import (
    Mesh,
    channel_sharding,
    gather,
)
from bds3_tpu_torch.track.driver import BLOCK_FNS, choose_correlator
from bds3_tpu_torch.track.scan import TrackState, TrackTables
from bds3_tpu_torch.track.state import ChannelConsts, TrackConfig


def sharded_coarse_search(mesh: Mesh, signal, data_codes, pilot_codes,
                          a_bins, c1_bins, cfg: AcqConfig,
                          axis: str = "channel"):
    """Coarse PCPS with the PRN axis split over mesh[axis]: each rank
    searches its PRNs; (peak, bin, phase), each (P,), gathered.  The PRN
    count must divide over the axis; signal and bins are whole on every
    rank."""
    place = channel_sharding(mesh, axis)
    res = coarse_search(signal, place.local(data_codes),
                        place.local(pilot_codes), a_bins, c1_bins, cfg)
    return tuple(gather(mesh, x, axis) for x in res)


def doppler_sharded_coarse_search(mesh: Mesh, signal, data_codes,
                                  pilot_codes, a_bins, c1_bins,
                                  cfg: AcqConfig, axis: str = "channel"):
    """Coarse PCPS with the Doppler-bin axis split over mesh[axis].

    The bin count must divide over the axis; the caller pads.  Each rank
    runs the standard search over its bins, all of them valid; the
    winners are combined from a gather of three (P,) vectors, the first
    maximum winning as in the reference (`sharded.py:75-85`)."""
    place = channel_sharding(mesh, axis)
    a_loc, c1_loc = place.local(a_bins), place.local(c1_bins)
    local_cfg = dataclasses.replace(cfg, n_bins=a_loc.shape[0])
    v, b, ph = coarse_search(signal, data_codes, pilot_codes, a_loc, c1_loc,
                             local_cfg)
    b = b + mesh.index(axis) * a_loc.shape[0]
    vs, bs, ps = (gather(mesh, x[None], axis) for x in (v, b, ph))
    win = torch.argmax(vs, dim=0)[None]

    def take(arr):
        return torch.take_along_dim(arr, win, dim=0)[0]

    return take(vs), take(bs), take(ps)


def _local_tables(place, tables: TrackTables) -> TrackTables:
    code61 = None if tables.code61 is None else place.local(tables.code61)
    return tables._replace(code=place.local(tables.code), code61=code61)


def sharded_track_block(mesh: Mesh, cfg: TrackConfig, capture: torch.Tensor,
                        tables: TrackTables, consts: ChannelConsts,
                        state: TrackState, axis: str = "channel",
                        correlator: str = "auto"
                        ) -> tuple[TrackState, torch.Tensor]:
    """One tracking block with the channels split over mesh[axis].

    Every rank holds the capture and the global tables, constants and
    state; it runs the port's block function (`driver.BLOCK_FNS`, chosen
    by `driver.choose_correlator`: "auto" is the CUDA tracking kernel on
    a card, its plain version on the CPU) on its channels, and the new
    states and the rows (W, C, slots) are gathered along the axis.  The
    channel count must divide over the axis.  Returns the global
    (TrackState, rows) on every rank."""
    place = channel_sharding(mesh, axis)
    name = choose_correlator(cfg, correlator, capture_dtype(capture.dtype))
    st, rows = BLOCK_FNS[name](
        cfg, capture, _local_tables(place, tables),
        ChannelConsts(*(place.local(x) for x in consts)),
        TrackState(place.local(state.cursor), place.local(state.statef)))
    return (TrackState(gather(mesh, st.cursor, axis),
                       gather(mesh, st.statef, axis)),
            gather(mesh, rows, axis, dim=1))


def shard_map_track_block(mesh: Mesh, cfg: TrackConfig,
                          capture: torch.Tensor, tables: TrackTables,
                          consts: ChannelConsts, state: TrackState,
                          axis: str = "channel", correlator: str = "auto"
                          ) -> tuple[TrackState, torch.Tensor]:
    """The reference's manual form of `sharded_track_block`
    (`sharded.py:108`), which it needs because XLA cannot split its
    fused kernel.  PyTorch has no auto-partitioner: both names run the
    same code and compute the same thing."""
    n = mesh.shape[axis]
    if state.cursor.shape[0] % n:
        raise ValueError("channel count must divide the mesh axis")
    return sharded_track_block(mesh, cfg, capture, tables, consts, state,
                               axis, correlator)
