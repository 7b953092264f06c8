"""Time-sharded closed-loop tracking with loop-state handoff: the
receiver's analog of sequence parallelism.

Port of `bds3_tpu/parallel/timeshard_track.py`.  The IF stream is cut
into n_dev consecutive segments, one per rank on a "time" mesh axis.
Closed-loop tracking is strictly sequential per channel (the DLL/PLL
recurrence), so the channels are split into G groups and pipelined: at
stage s, rank d tracks group g = s - d through its own segment, rebases
the group's state by the segment shift and hands it to rank d + 1.
After n_dev + G - 1 stages every group has crossed every segment.  Where
the reference hands every group's state around the ring at each stage,
a rank here sends only the group it has just tracked: that is the only
one its neighbour reads next, so the results are the same.

Each rank's segment is the sample slice the sequential driver would feed
to the same block, its cursors are relative to the segment's start (as
`driver.stream_blocks` makes them), and the handoff is the driver's
cursor rebase, so an N-rank run reproduces the sequential `track()` at
epochs_per_block = n_epochs / N.
"""
from __future__ import annotations

import numpy as np
import torch

from bds3_tpu_torch.config import Settings
from bds3_tpu_torch.convert import consts_to_torch, state_to_torch, tables_to_torch
from bds3_tpu_torch.io.transport import capture_dtype
from bds3_tpu_torch.parallel.mesh import Mesh, gather, shift
from bds3_tpu_torch.track.driver import (
    BLOCK_FNS,
    as_capture,
    channel_code_tables,
    choose_correlator,
    require_ported,
)
from bds3_tpu_torch.track.scan import TrackState, output_names
from bds3_tpu_torch.track.state import (
    ChannelConsts,
    ChannelState,
    channel_consts,
    code_coarse_tables,
    initial_state,
)


def time_sharded_track(
    mesh: Mesh,
    signal,
    settings: Settings,
    inits,
    n_epochs: int,
    n_groups: int | None = None,
    axis: str = "time",
    channel_axis: str | None = None,
    correlator: str = "auto",
):
    """Track `inits` channels over `n_epochs` epochs with the sample
    stream split over mesh[axis].

    n_epochs must divide evenly into mesh_size segments; channels are
    split into n_groups pipeline groups (default: time-axis size, capped
    by the channel count).  Returns a dict name -> (C, n_epochs) float32
    numpy array on every rank.

    signal: the whole capture, numpy or a tensor (int8 or float32 real,
    complex64); each rank moves only its segment to mesh.device.
    channel_axis: optional second mesh axis: each group's channels are
    split over it, and the handoff ring runs along the time axis within
    each channel column.  correlator: as `track()` takes it; "auto" runs
    the CUDA tracking kernel on a card and its plain version on the CPU.
    """
    n_dev = mesh.shape[axis]
    if n_epochs % n_dev:
        raise ValueError(f"n_epochs {n_epochs} % n_dev {n_dev} != 0")
    W = n_epochs // n_dev
    C = len(inits)
    if n_groups is None:
        n_groups = min(n_dev, C)
    if C % n_groups:
        raise ValueError(f"channels {C} % groups {n_groups} != 0")
    Cg = C // n_groups
    n_ch_dev = mesh.shape[channel_axis] if channel_axis else 1
    if Cg % n_ch_dev:
        raise ValueError(
            f"group channels {Cg} % mesh[{channel_axis}] {n_ch_dev} != 0")
    Cl = Cg // n_ch_dev

    dtype = capture_dtype(signal.dtype)
    cfg = require_ported(settings, dtype.kind == "c", W)
    block_fn = BLOCK_FNS[choose_correlator(cfg, correlator, dtype)]
    consts = channel_consts(cfg, inits, settings)
    data_t, p11_t, p61_t = channel_code_tables(cfg, inits)
    ck = code_coarse_tables(cfg, cfg.m_data)
    ck61 = code_coarse_tables(cfg, cfg.m_p61) if cfg.m_p61 else (None, None)

    cursors0 = np.array([c.code_phase for c in inits], dtype=np.int64)
    s0 = int(cursors0.min())
    state = initial_state(cfg, inits, consts, cursors0 - s0)

    # the reference's block geometry (timeshard_track.py:159-165), as is
    per_epoch_max = cfg.q0_int + 3
    block_len = int(cursors0.max() - s0) + W * per_epoch_max + cfg.n_max \
        + 2 * cfg.q0_int + 4 * per_epoch_max + W + 64
    exp_adv = cfg.code_length / (
        cfg.step_base + consts.init_dstep.astype(np.float64))
    shift_samples = max(int(np.floor(W * (exp_adv.min() - 0.1))), 0)

    need = s0 + (n_dev - 1) * shift_samples + block_len
    if need > len(signal):
        raise ValueError(f"signal too short: need {need}, have {len(signal)}")
    d = mesh.index(axis)
    dev = mesh.device
    start = s0 + d * shift_samples
    block = as_capture(signal[start: start + block_len], dev)

    # this rank's channels of each group: [lo, lo + Cl)
    cc = mesh.index(channel_axis) if channel_axis else 0
    groups = []
    for g in range(n_groups):
        sl = slice(g * Cg + cc * Cl, g * Cg + (cc + 1) * Cl)
        groups.append((
            tables_to_torch(cfg, data_t[sl], p11_t[sl], *ck, dev, p61_t[sl],
                            *ck61),
            consts_to_torch(ChannelConsts(*(x[sl] for x in consts)), dev),
            state_to_torch(ChannelState(*(x[sl] for x in state)), 0, dev)))

    F = len(output_names(cfg))
    rows = [None] * n_groups
    n_stages = n_dev + n_groups - 1
    handed = None
    for s in range(n_stages):
        g = s - d
        out = None
        if 0 <= g < n_groups:
            tables, consts_g, st = groups[g]
            new, r = block_fn(cfg, block, tables, consts_g,
                              st if d == 0 else handed)
            rows[g] = r[:, :, :F]
            # cursor rebase for the next segment (the driver's per-block
            # `cursor - shift`), after the stage
            out = TrackState(new.cursor - shift_samples, new.statef)
        if n_dev > 1 and s < n_stages - 1:
            # an idle rank sends its first group's state as a filler,
            # which its neighbour does not read
            sent = out if out is not None else groups[0][2]
            handed = TrackState(*shift(mesh, tuple(sent), axis, 1))

    local = torch.stack(rows)                      # (G, W, Cl, F)
    if channel_axis:
        cols = gather(mesh, local[None], channel_axis)   # (n_ch, G, W, Cl, F)
        local = cols.permute(1, 2, 0, 3, 4).reshape(n_groups, W, Cg, F)
    out = gather(mesh, local[None], axis).cpu().numpy()  # (n_dev, G, W, Cg, F)
    # (n_dev, G, W, Cg, F) -> (F, G*Cg, n_dev*W)
    out = out.transpose(4, 1, 3, 0, 2).reshape(F, C, n_epochs)
    return {k: out[i] for i, k in enumerate(output_names(cfg))}
