"""The CUDA tracking kernel's wrapper (port of
`bds3_tpu/track/pallas_fused.py`).

`fused_track_block` runs one block of W closed-loop epochs for all
channels in one launch of `csrc/track_fused.cu` (design notes there): S
blocks per channel, each summing a contiguous slice of every epoch
(`rank_slice`) and exchanging each epoch's partials through global
memory; C*S blocks, launched cooperatively where S >= 2.  S is chosen
once per (config, channel count, capture dtype) from the card's own
occupancy answer (`blocks_per_channel`, `choose_blocks`).  The capture
is real int8, real float32 or complex64 (`CAPTURE_KINDS`), each read by
its own instance of the kernel.  On CPU tensors it runs the plain
version, `scan.track_block_reference`; on CUDA tensors it launches the
kernel or raises.  It never falls back.

The host-side geometry the kernel mirrors lives here too, in plain
Python, so the CPU tests reach it: the slices (`rank_slice`) and their
runs (`rank_runs`), the choice of S (`choose_blocks`), the chip-index
range checks (`wraps_once`, `chip_index_bound`, `runs_fit`) and the
shared-memory layout (`_smem_bytes`).
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from bds3_tpu_torch.config import Signal
from bds3_tpu_torch.track.scan import (
    CODE_PAD,
    STATE_FIELDS,
    TrackState,
    TrackTables,
    check_capture,
    describe,
    loop_constants,
    slot_names,
    track_block_reference,
)
from bds3_tpu_torch.track.state import SPLIT, TrackConfig
from bds3_tpu_torch.utils.device import check_tensor
from bds3_tpu_torch.utils.trace import count, mirror, span

KERNEL_NAME = "track_fused_cuda"
SOURCE = "bds3_tpu_torch/csrc/track_fused.cu"
REPLACES = "bds3_tpu/track/pallas_fused.py:1153"   # the TPU kernel
SMEM_LIMIT = 227 * 1024   # dynamic shared memory one H100 block may use
# the capture dtypes the kernel reads, by its instance's code
# (track_fused.cu CAPTURE_*); complex64 is read as interleaved float pairs
CAPTURE_KINDS = {torch.int8: 0, torch.float32: 1, torch.complex64: 2}
# samples of one run, the 16 bytes of one vector load, by capture dtype
# (track_fused.cu Capture<KIND>::RUN)
RUN_SAMPLES = {torch.int8: 16, torch.float32: 4, torch.complex64: 2}
SMEM_PAD = 64   # circular padding of a chip table in shared memory
THREADS = 512             # threads of one block (track_fused.cu THREADS)
N_ACC = 18                # correlator sums (track_fused.cu N_ACC)
# the block's bookkeeping (track_fused.cu HEAD_BYTES): warp partials in
# float64, the cursor, the state and the rounded sums
HEAD_BYTES = (THREADS // 32) * N_ACC * 8 + 8 + 8 * 4 + N_ACC * 4
# the loop state's normal range, under which every raw chip index of an
# epoch lies in (-L*m, 2*L*m): |rem_code| < 1 chip (ChannelState) and the
# code rate within DSTEP_REL of nominal (a 10 kHz Doppler is 8.5e-6 on
# B2a); outside it the kernel takes the modulo instead (wraps_once)
DSTEP_REL = 1e-4

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
    """One block's shared memory, all of it dynamic
    (track_fused.cu:smem_bytes): the bookkeeping, then the tables, each
    padded by SMEM_PAD entries on either side."""
    b = HEAD_BYTES + cfg.k_max * 12 + (2 if cfg.use_pilot else 1) \
        * (cfg.code_length * cfg.m_data + 2 * SMEM_PAD)
    if cfg.wideband:
        b += cfg.k_max * 8 + cfg.code_length * cfg.m_p61 + 2 * SMEM_PAD
    return b


def cuda_supported(cfg: TrackConfig) -> bool:
    """Whether the CUDA kernel takes this config (the port's counterpart of
    `fused_supported`): B2a and B1C in any track mode, on a capture of any
    of CAPTURE_KINDS (int8 or float32 real, complex64), with the code
    tables within one block's shared memory (B1C wideband at the 99.375
    Msps preset takes about 171,000 of the 232,448 bytes; the capture is
    read from global memory, so its dtype does not count)."""
    return _smem_bytes(cfg) <= SMEM_LIMIT


def rank_slice(n: int, blocks: int, rank: int) -> tuple[int, int]:
    """The samples [lo, hi) of an n-sample epoch that rank `rank` of a
    channel's `blocks` blocks sums (track_fused.cu): contiguous slices of
    ceil(n / blocks)."""
    chunk = -(-n // blocks)
    lo = min(n, rank * chunk)
    return lo, min(n, lo + chunk)


def rank_runs(lo: int, hi: int, run: int) -> tuple[int, int]:
    """The whole runs [ra, rb) of a slice [lo, hi) (track_fused.cu
    sum_slice): run i holds the samples [i*run, (i+1)*run), so no run
    crosses a SPLIT segment.  The slice's ragged head [lo, min(ra*run,
    hi)) and tail [max(rb*run, ra*run), hi) go sample by sample."""
    return -(-lo // run), hi // run


def choose_blocks(resident: int, n_channels: int) -> int:
    """Blocks per channel: as many as the card holds at once for every
    channel (`resident` blocks of the kernel's instance, one an SM on the
    H100), floor(resident / n_channels), and at least 1 (one block a
    channel needs no co-residence)."""
    return max(1, resident // n_channels)


def wraps_once(lo_m, hi_m, dsm, n, sm, lm) -> bool:
    """track_fused.cu:wraps_once in float32: whether every raw chip index
    ck_int + ceil(frac) - 1 of an n-sample epoch lies in (-lm, 2*lm), for a
    bank whose early and late code phases times m are lo_m and hi_m and
    whose per-sample slope times m is dsm."""
    f = np.float32
    dj = f(n - 1) * f(dsm)
    f_lo = (f(lo_m) + min(dj, f(0))) - f(2)
    f_hi = (((f(hi_m) + f(1)) + f(SPLIT - 1) * f(sm)) + max(dj, f(0))) + f(2)
    return bool(f_lo >= f(1 - lm) and f_hi <= f(lm + 1))


def runs_fit(lo_m, hi_m, dsm, sm, run: int) -> bool:
    """track_fused.cu:runs_fit in float32: whether every raw chip index of
    a run of `run` samples lies within SMEM_PAD of its first sample's
    prompt index (so one wrap offset per run serves it), for a bank whose
    early and late code phases times m are lo_m and hi_m."""
    f = np.float32
    span = (f(hi_m) - f(lo_m)) + f(run - 1) * (f(sm) + abs(f(dsm)))
    return bool(span + f(2) <= f(SMEM_PAD))


def banks(cfg: TrackConfig) -> list[tuple]:
    """(m, E-L spacing, sm, loop_constants suffix) of each bank of taps
    that share a chip grid: the data and BOC(1,1) taps, and B1C
    wideband's BOC(6,1) tap."""
    k = loop_constants(cfg)
    out = [(cfg.m_data, k["spacing"], k["sm"], "")]
    if cfg.wideband:
        out.append((cfg.m_p61, k["spacing61"], k["sm61"], "61"))
    return out


def chip_index_bound(cfg: TrackConfig, rem_code: float = 1.0,
                     dstep_rel: float = DSTEP_REL) -> list[tuple]:
    """For each bank, (lo, hi, L*m): bounds of the raw chip index
    ck_int + ceil(frac) - 1 over any epoch whose |rem_code| <= rem_code
    chips and |d_step| <= dstep_rel * step_base.  frac = (rem_code + off)*m
    + ck_frac + r*sm + j*d_step*m with ck_frac in [0, 1), r < SPLIT and
    j < n_max; ck_int is in [0, L*m)."""
    out = []
    for m, spacing, sm, _ in banks(cfg):
        lm = cfg.code_length * m
        dj = cfg.n_max * dstep_rel * cfg.step_base * m
        f_lo = -(rem_code + spacing) * m - dj
        f_hi = (rem_code + spacing) * m + 1 + (SPLIT - 1) * sm + dj
        out.append((math.ceil(f_lo) - 1, lm - 2 + math.ceil(f_hi), lm))
    return out


@functools.lru_cache(maxsize=None)
def _params(cfg: TrackConfig, n_channels: int) -> _Params:
    if cfg.n_max >= 1 << 24:
        # the kernel steps j and j % SPLIT as float32 by exact adds of 1
        raise ValueError(f"{KERNEL_NAME}: an epoch window of {cfg.n_max} "
                         f"samples is not below 2**24")
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
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_void_p] * 15
                   + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.POINTER(_Params), ctypes.c_void_p])
    return fn


@functools.lru_cache(maxsize=None)
def occupancy(cfg: TrackConfig, n_channels: int, device_index: int,
              dtype: torch.dtype = torch.int8) -> int:
    """The blocks of this config's kernel instance for a `dtype` capture
    the card holds at once, at its shared memory and block size
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor times the SMs)."""
    from bds3_tpu_torch._build import library

    fn = library().bds3_track_occupancy
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int)]
    resident = ctypes.c_int()
    with torch.cuda.device(device_index):
        err = fn(ctypes.byref(_params(cfg, n_channels)), CAPTURE_KINDS[dtype],
                 ctypes.byref(resident))
    if err != 0:
        raise RuntimeError(f"{KERNEL_NAME}: setting the kernel's attributes "
                           f"or asking its occupancy failed: CUDA error "
                           f"{err}")
    return resident.value


def blocks_per_channel(cfg: TrackConfig, n_channels: int, device_index: int,
                       dtype: torch.dtype = torch.int8) -> int:
    """The blocks per channel the kernel runs this config with on a
    `dtype` capture (choose_blocks over the card's occupancy)."""
    return choose_blocks(occupancy(cfg, n_channels, device_index, dtype),
                         n_channels)


def fused_track_block(cfg: TrackConfig, capture: torch.Tensor,
                      tables: TrackTables, consts, state: TrackState,
                      _blocks: int | None = None
                      ) -> tuple[TrackState, torch.Tensor]:
    """W = cfg.epochs_per_block epochs for all channels in one launch.

    capture: (N,), the whole capture, on the device the kernel runs on:
    int8 or float32 real, or complex64 for a config built with
    complex_input (CAPTURE_KINDS).  consts: ChannelConsts of tensors.
    Returns (new TrackState, rows (W, C, len(slot_names(cfg))) float32),
    like track_block_reference.
    The launch is on the current stream and is not synchronized.
    _blocks: blocks per channel; None takes `blocks_per_channel`.  Only
    for checks and A/B timings of the geometry; a count the card cannot
    hold at once raises.
    """
    if not cuda_supported(cfg):
        raise NotImplementedError(
            f"the CUDA tracking kernel does not take {describe(cfg)} yet")
    dev = capture.device
    if dev.type == "cpu":
        return track_block_reference(cfg, capture, tables, consts, state)
    if dev.type != "cuda":
        raise ValueError(f"no tracking kernel for device {dev}")
    with span("k1.launch"):
        return _launch(cfg, capture, tables, consts, state, _blocks)


def _launch(cfg: TrackConfig, capture: torch.Tensor, tables: TrackTables,
            consts, state: TrackState, _blocks: int | None
            ) -> tuple[TrackState, torch.Tensor]:
    """`fused_track_block` on a card: its checks and its launch."""
    dev = capture.device
    check_capture(cfg, capture)

    C = state.cursor.shape[0]
    taps = 2 if cfg.use_pilot else 1
    if capture.dtype not in CAPTURE_KINDS:
        raise TypeError(f"capture has dtype {capture.dtype}, expected one "
                        f"of {list(CAPTURE_KINDS)}")
    check_tensor("capture", capture, capture.dtype, (capture.shape[0],), dev)
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
    index = torch.cuda.current_device() if dev.index is None else dev.index
    S = _blocks or blocks_per_channel(cfg, C, index, capture.dtype)
    rows = torch.empty((cfg.epochs_per_block, C, params.n_slots),
                       dtype=torch.float32, device=dev)
    statef = torch.empty_like(state.statef)
    cursor = torch.empty_like(state.cursor)
    # the exchange: each rank's partials by epoch parity, and the
    # channels' arrival counters, zero
    xch = torch.empty((C, 2, S, N_ACC), dtype=torch.float64, device=dev)
    arrived = torch.zeros(C, dtype=torch.int32, device=dev)
    launch = _entry()
    with torch.cuda.device(dev):
        err = launch(
            capture.data_ptr(), capture.shape[0],
            CAPTURE_KINDS[capture.dtype], tables.code.data_ptr(),
            tables.ck_int.data_ptr(), tables.ck_frac.data_ptr(), *wb,
            consts.carr_t.data_ptr(), consts.a_base.data_ptr(),
            consts.q0_cyc.data_ptr(), consts.init_dstep.data_ptr(),
            state.statef.data_ptr(), state.cursor.data_ptr(),
            rows.data_ptr(), statef.data_ptr(), cursor.data_ptr(),
            S, xch.data_ptr(), arrived.data_ptr(), ctypes.byref(params),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL_NAME} launch of {C} channels of {S} "
                           f"blocks failed: CUDA error {err}")
    fused_track_block.launches += 1
    count("k1.blocks", C * S)
    return TrackState(cursor, statef), rows


fused_track_block.launches = 0   # kernel launches, for run accounting
mirror("k1.launches", lambda: fused_track_block.launches)
count("k1.blocks", 0)   # the blocks launched
