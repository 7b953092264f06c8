"""Carries configuration and state between numpy and the port's tensors.

The JAX reference (`bds3_tpu.track.state`) and the port's host copies
(`bds3_tpu_torch.track.state`) keep the same numpy types, so each function
here takes either.  The port's driver uses these to put its host tables
on the device, and the tests use them to start both packages from the
same state.  Every float array goes over as float32, never float64.

The two packages' settings and configs are dataclasses of the same fields
whose enums are of different classes; `settings_from_reference` and
`config_from_reference` copy them field by field and map each enum by
name.  Nothing here imports the JAX package: it takes its objects as they
come.
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from bds3_tpu_torch import config
from bds3_tpu_torch.acquire.pcps import AcqResults
from bds3_tpu_torch.track.scan import (
    STATE_FIELDS,
    TrackState,
    TrackTables,
)
from bds3_tpu_torch.track.state import ChannelConsts, ChannelState, TrackConfig


def _t(x, dtype: np.dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=dtype)).to(device)


def _own(value):
    """An enum of another package as this package's member of the same
    name (config.Signal, TrackMode or FileType); anything else as is."""
    if isinstance(value, enum.Enum):
        return getattr(config, type(value).__name__)[value.name]
    return value


def _copy_fields(cls, obj):
    return cls(**{f.name: _own(getattr(obj, f.name))
                  for f in dataclasses.fields(cls)})


def settings_from_reference(s) -> config.Settings:
    """The port's Settings equal to a `bds3_tpu` Settings."""
    return _copy_fields(config.Settings, s)


def config_from_reference(cfg) -> TrackConfig:
    """The port's TrackConfig equal to a `bds3_tpu` TrackConfig."""
    return _copy_fields(TrackConfig, cfg)


def consts_to_torch(consts, device) -> ChannelConsts:
    """ChannelConsts of numpy arrays -> ChannelConsts of tensors."""
    return ChannelConsts(
        carr_t=_t(consts.carr_t, np.float32, device),
        a_base=_t(consts.a_base, np.float32, device),
        q0_cyc=_t(consts.q0_cyc, np.float32, device),
        init_dstep=_t(consts.init_dstep, np.float32, device),
        adv_int=_t(consts.adv_int, np.int32, device),
    )


def tables_to_torch(cfg: TrackConfig, data_tables, pilot11_tables,
                    ck_int, ck_frac, device, pilot61_tables=None,
                    ck61_int=None, ck61_frac=None) -> TrackTables:
    """Padded chip tables (C, L*m + 2*CODE_PAD) and the coarse code-phase
    tables -> TrackTables; the pilot tap is kept only when tracked.  B1C
    wideband also takes the BOC(6,1) pilot tables (C, L*12 + 2*CODE_PAD)
    and their coarse tables at m = 12 (the outputs of the reference's
    channel_code_tables and code_coarse_tables(cfg, cfg.m_p61))."""
    taps = [data_tables, pilot11_tables] if cfg.use_pilot else [data_tables]
    wb = {}
    if cfg.wideband:
        wb = dict(code61=_t(pilot61_tables, np.int8, device),
                  ck61_int=_t(ck61_int, np.int32, device),
                  ck61_frac=_t(ck61_frac, np.float32, device))
    return TrackTables(
        code=_t(np.stack(taps, axis=1), np.int8, device),
        ck_int=_t(ck_int, np.int32, device),
        ck_frac=_t(ck_frac, np.float32, device),
        **wb,
    )


def state_to_torch(state, offset, device) -> TrackState:
    """ChannelState with block-relative cursors -> TrackState with
    absolute int64 cursors (absolute = relative + offset; offset is an
    int or a (C,) array)."""
    return TrackState(
        cursor=_t(np.asarray(state.cursor, np.int64) + offset, np.int64,
                  device),
        statef=_t(np.stack([np.asarray(getattr(state, f)) for f in
                            STATE_FIELDS], axis=1), np.float32, device),
    )


def state_from_torch(state: TrackState, offset: int) -> ChannelState:
    """TrackState -> ChannelState of numpy arrays with cursors relative to
    `offset` (int32, as the reference keeps them)."""
    statef = state.statef.cpu().numpy()
    return ChannelState(
        np.asarray(state.cursor.cpu().numpy() - offset, np.int32),
        *(np.ascontiguousarray(statef[:, i]) for i in range(len(STATE_FIELDS))),
    )


def acq_from_reference(acq) -> AcqResults:
    """A `bds3_tpu` AcqResults -> the port's AcqResults."""
    return _copy_fields(AcqResults, acq)
