"""The CUDA tracking kernel's wrapper (port of
`bds3_tpu/track/pallas_fused.py`).

`fused_track_block` runs one block of W closed-loop epochs for all
channels in one launch of `csrc/track_fused.cu` (design notes there).  On
CPU tensors it runs the plain version, `scan.track_block_reference`; on
CUDA tensors it launches the kernel or raises.  It never falls back.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from bds3_tpu_torch.config import Signal
from bds3_tpu_torch.track.scan import (
    CODE_PAD,
    STATE_FIELDS,
    TrackState,
    TrackTables,
    describe,
    loop_constants,
    reference_supported,
    slot_names,
    track_block_reference,
)
from bds3_tpu_torch.track.state import TrackConfig
from bds3_tpu_torch.utils.device import check_tensor

KERNEL_NAME = "track_fused_cuda"
SOURCE = "bds3_tpu_torch/csrc/track_fused.cu"
REPLACES = "bds3_tpu/track/pallas_fused.py:1153"   # the TPU kernel
SMEM_LIMIT = 227 * 1024   # dynamic shared memory one H100 block may use

# the values one epoch produces, in the kernel's order (TrackParams.slot)
_TAP = [f"{c}{t}" for c in ("i", "q") for t in ("e", "p", "l")]
_CANON = (
    [f"d_{x}" for x in _TAP] + [f"p11_{x}" for x in _TAP]
    + [f"p61_{x}" for x in _TAP] + [f"p_{x}" for x in _TAP]
    + ["carr_err", "code_err", "carr_nco", "code_nco", "d_cyc", "d_step",
       "rem_code_phase", "rem_carr_cyc", "blksize"]
    + [f"st_{f}" for f in STATE_FIELDS]
)
_FLOATS = ("step_base", "inv_step_base", "inv_fs", "q0_frac", "q0_sum",
           "q0_step_minus_l", "sm", "spacing", "inv2pi", "two_pi",
           "pf1", "pf2", "pf3", "dll_c1", "dll_c2", "one_minus_spacing",
           "inv40", "w11", "w61", "spacing61", "dll_f", "one_minus_dll_f",
           "g61", "sm61")
_BLENDS = ("composite", "nb", "split", "dotprod")   # the kernel's BLEND_*


class _Params(ctypes.Structure):
    """TrackParams of csrc/track_fused.cu, field for field."""

    _fields_ = (
        [(n, ctypes.c_int) for n in (
            "n_channels", "n_epochs", "n_taps", "m", "lm", "table_len",
            "k_max", "q0_int", "n_max", "n_slots", "b1c", "wideband", "blend",
            "m61", "lm61", "table_len61")]
        + [("slot", ctypes.c_int * len(_CANON))]
        + [(n, ctypes.c_float) for n in _FLOATS]
    )


def _table_len(cfg: TrackConfig, m: int) -> int:
    return cfg.code_length * m + 2 * CODE_PAD


def _smem_bytes(cfg: TrackConfig) -> int:
    """The kernel's dynamic shared memory (track_fused.cu:smem_bytes)."""
    b = cfg.k_max * 12 + (2 if cfg.use_pilot else 1) \
        * _table_len(cfg, cfg.m_data)
    if cfg.wideband:
        b += cfg.k_max * 8 + _table_len(cfg, cfg.m_p61)
    return b


def cuda_supported(cfg: TrackConfig) -> bool:
    """Whether the CUDA kernel takes this config (the port's counterpart of
    `fused_supported`): B2a and B1C in any track mode, real input, with the
    code tables within one block's shared memory (B1C wideband at the
    99.375 Msps preset takes 168676 of the 232448 bytes)."""
    return reference_supported(cfg) and _smem_bytes(cfg) <= SMEM_LIMIT


@functools.lru_cache(maxsize=None)
def _params(cfg: TrackConfig, n_channels: int) -> _Params:
    names = slot_names(cfg)
    k = loop_constants(cfg)
    p = _Params(
        n_channels=n_channels, n_epochs=cfg.epochs_per_block,
        n_taps=2 if cfg.use_pilot else 1, m=cfg.m_data,
        lm=cfg.code_length * cfg.m_data,
        table_len=_table_len(cfg, cfg.m_data), k_max=cfg.k_max,
        q0_int=cfg.q0_int, n_max=cfg.n_max, n_slots=len(names),
        b1c=int(cfg.signal == Signal.B1C), wideband=int(cfg.wideband),
        blend=_BLENDS.index(cfg.wb_code_blend), m61=cfg.m_p61,
        lm61=cfg.code_length * cfg.m_p61,
        table_len61=_table_len(cfg, cfg.m_p61) if cfg.wideband else 0,
        # sm61 exists only for wideband configs
        **{n: k.get(n, 0.0) for n in _FLOATS})
    for i, n in enumerate(_CANON):
        p.slot[i] = names.index(n) if n in names else -1
    return p


@functools.cache
def _entry():
    """The kernel's C entry point, with every argument type declared (an
    undeclared pointer would be passed as a 32-bit int)."""
    from bds3_tpu_torch._build import library

    fn = library().bds3_track_fused
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 15
                   + [ctypes.POINTER(_Params), ctypes.c_void_p])
    return fn


def fused_track_block(cfg: TrackConfig, capture: torch.Tensor,
                      tables: TrackTables, consts, state: TrackState
                      ) -> tuple[TrackState, torch.Tensor]:
    """W = cfg.epochs_per_block epochs for all channels in one launch.

    capture: (N,) int8, the whole capture, on the device the kernel runs
    on.  consts: ChannelConsts of tensors.  Returns (new TrackState, rows
    (W, C, len(slot_names(cfg))) float32), like track_block_reference.
    The launch is on the current stream and is not synchronized.
    """
    if not cuda_supported(cfg):
        raise NotImplementedError(
            f"the CUDA tracking kernel does not take {describe(cfg)} yet")
    dev = capture.device
    if dev.type == "cpu":
        return track_block_reference(cfg, capture, tables, consts, state)
    if dev.type != "cuda":
        raise ValueError(f"no tracking kernel for device {dev}")

    C = state.cursor.shape[0]
    taps = 2 if cfg.use_pilot else 1
    check_tensor("capture", capture, torch.int8, (capture.shape[0],), dev)
    check_tensor("tables.code", tables.code, torch.int8,
                 (C, taps, _table_len(cfg, cfg.m_data)), dev)
    check_tensor("tables.ck_int", tables.ck_int, torch.int32,
                 (cfg.k_max,), dev)
    check_tensor("tables.ck_frac", tables.ck_frac, torch.float32,
                 (cfg.k_max,), dev)
    wb = (None, None, None)   # NULL: the kernel reads no BOC(6,1) table
    if cfg.wideband:
        check_tensor("tables.code61", tables.code61, torch.int8,
                     (C, _table_len(cfg, cfg.m_p61)), dev)
        check_tensor("tables.ck61_int", tables.ck61_int, torch.int32,
                     (cfg.k_max,), dev)
        check_tensor("tables.ck61_frac", tables.ck61_frac, torch.float32,
                     (cfg.k_max,), dev)
        wb = (tables.code61.data_ptr(), tables.ck61_int.data_ptr(),
              tables.ck61_frac.data_ptr())
    check_tensor("consts.carr_t", consts.carr_t, torch.float32,
                 (C, cfg.k_max), dev)
    for f in ("a_base", "q0_cyc", "init_dstep"):
        check_tensor(f"consts.{f}", getattr(consts, f), torch.float32,
                     (C,), dev)
    check_tensor("state.cursor", state.cursor, torch.int64, (C,), dev)
    check_tensor("state.statef", state.statef, torch.float32, (C, 8), dev)

    params = _params(cfg, C)
    rows = torch.empty((cfg.epochs_per_block, C, params.n_slots),
                       dtype=torch.float32, device=dev)
    statef = torch.empty_like(state.statef)
    cursor = torch.empty_like(state.cursor)
    launch = _entry()
    with torch.cuda.device(dev):
        err = launch(
            capture.data_ptr(), capture.shape[0], tables.code.data_ptr(),
            tables.ck_int.data_ptr(), tables.ck_frac.data_ptr(), *wb,
            consts.carr_t.data_ptr(), consts.a_base.data_ptr(),
            consts.q0_cyc.data_ptr(), consts.init_dstep.data_ptr(),
            state.statef.data_ptr(), state.cursor.data_ptr(),
            rows.data_ptr(), statef.data_ptr(), cursor.data_ptr(),
            ctypes.byref(params), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL_NAME} launch failed: CUDA error {err}")
    fused_track_block.launches += 1
    return TrackState(cursor, statef), rows


fused_track_block.launches = 0   # kernel launches, for run accounting
