"""Tracking driver: runs the chosen tracking path block by block over a
capture that lives on the device, and assembles the per-epoch results.

Port of `bds3_tpu/track/driver.py`.  The capture goes to the device once;
each block of W epochs is one call of the path's block function, which
reads every channel's samples at its own absolute int64 cursor, so no
block is sliced, padded or shifted (the reference's int32 block offsets
and its 2^31-sample limit are TPU artifacts).  The block schedule is the
reference's, verbatim, so the epoch count, `absolute_sample` and the
derived frequencies match it.
The outputs are downloaded once, at the end.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from bds3_tpu_torch.config import Settings, Signal
from bds3_tpu_torch.convert import consts_to_torch, state_to_torch, tables_to_torch
from bds3_tpu_torch.signals.b1c import b1c_data_boc11, b1c_pilot_boc11, b1c_pilot_boc61
from bds3_tpu_torch.signals.b2a import b2a_data_code, b2a_pilot_code
from bds3_tpu_torch.track import fused, prefix
from bds3_tpu_torch.track.fused import cuda_supported, fused_track_block
from bds3_tpu_torch.track.scan import (
    CODE_PAD,
    TrackState,
    TrackTables,
    bucket_prefix,
    describe,
    output_names,
    pallas_prefix,
    reference_supported,
    track_block_bucket,
    track_block_reference,
)
from bds3_tpu_torch.track.state import (
    ChannelConsts,
    ChannelInit,
    TrackConfig,
    channel_consts,
    code_coarse_tables,
    initial_state,
    make_track_config,
)
from bds3_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class TrackResults:
    """Per-channel, per-epoch tracking archives (the reference's
    trackResults struct, tracking.m:45-96), as numpy on the host."""

    prns: np.ndarray               # (C,)
    acquired_freq: np.ndarray      # (C,) f64
    n_epochs: int
    outputs: dict                  # name -> (C, E) f32 arrays
    absolute_sample: np.ndarray    # (C, E) int64: sample index of epoch END
    carr_freq: np.ndarray          # (C, E) f64 absolute NCO frequency
    code_freq: np.ndarray          # (C, E) f64 absolute code frequency
    int_time: float
    settings: Settings = None
    correlator: str = ""           # which tracking path actually ran

    def prompt(self, name: str) -> np.ndarray:
        return self.outputs[name]


def channel_code_tables(cfg: TrackConfig, inits: list[ChannelInit]):
    """(C, L*m + 2*CODE_PAD) circularly-padded chip tables per channel."""

    def ext(arr):
        return np.concatenate(
            [arr[..., -CODE_PAD:], arr, arr[..., :CODE_PAD]], axis=-1
        )

    if cfg.signal == Signal.B2A:
        data = ext(np.stack([b2a_data_code(c.prn) for c in inits]))
        p11 = ext(np.stack([b2a_pilot_code(c.prn) for c in inits]))
        p61 = np.zeros((len(inits), 1), np.int8)
    else:
        data = ext(np.stack([b1c_data_boc11(c.prn) for c in inits]))
        p11 = ext(np.stack([b1c_pilot_boc11(c.prn) for c in inits]))
        if cfg.wideband:
            p61 = ext(np.stack([b1c_pilot_boc61(c.prn) for c in inits]))
        else:
            p61 = np.zeros((len(inits), 1), np.int8)
    return data, p11, p61


def block_schedule(cfg: TrackConfig, consts: ChannelConsts,
                   cursors0: np.ndarray, total: int, n_epochs: int) -> int:
    """Number of W-epoch blocks the capture holds: the reference's
    schedule (bds3_tpu/track/driver.py:256-296), host arithmetic only."""
    W = cfg.epochs_per_block
    per_epoch_max = cfg.q0_int + 3
    s0 = int(cursors0.min())
    exp_adv = cfg.code_length / (cfg.step_base
                                 + consts.init_dstep.astype(np.float64))
    shift = max(int(np.floor(W * (exp_adv.min() - 0.1))), 0)
    spread0 = int(cursors0.max() - s0)
    n_blocks = 0
    done = 0
    while done < n_epochs:
        # conservative bound on current max cursor without a device sync
        worst = spread0 + int(
            (done // W) * (W * (exp_adv.max() - exp_adv.min()) + 0.1 * W + 2)
        )
        if worst - spread0 > 2 * cfg.q0_int:
            raise RuntimeError(
                "channel cursor spread outgrew the block margin; use a "
                "larger epochs_per_block or re-anchor (very long run)"
            )
        if s0 + worst + W * per_epoch_max + cfg.n_max > total:
            break  # out of data: return partial results (tracking.m:250-254)
        n_blocks += 1
        done += W
        s0 += shift
    if not n_blocks:
        raise ValueError("not enough signal for a single tracking block")
    return n_blocks


@dataclasses.dataclass
class TrackSetup:
    """Everything `track` puts on the device before the first launch."""

    cfg: TrackConfig
    inits: list[ChannelInit]
    cursors0: np.ndarray     # (C,) int64 first code start of each channel
    tables: TrackTables
    consts: ChannelConsts    # of tensors
    state: TrackState
    n_blocks: int


# correlator -> block function (the reference's names, driver.py:183-185)
BLOCK_FNS = {
    "fused": fused_track_block,
    "gather": track_block_reference,
    "bucket": functools.partial(track_block_bucket, prefix_fn=bucket_prefix),
    "bucket_pallas": functools.partial(track_block_bucket,
                                       prefix_fn=pallas_prefix),
}


def choose_correlator(cfg: TrackConfig, correlator: str = "auto") -> str:
    """The tracking path for `cfg`: "auto" takes the CUDA tracking kernel
    ("fused"), as the reference takes its fused kernel on its chip
    (bds3_tpu/track/driver.py:211-222); a config the kernel cannot hold
    raises, it is not sent elsewhere.  The device then picks kernel or
    plain version, so the CPU runs the path the card runs."""
    if correlator == "auto":
        correlator = "fused"
    if correlator not in BLOCK_FNS:
        raise ValueError(f"unknown correlator {correlator!r}: expected "
                         f"'auto' or one of {sorted(BLOCK_FNS)}")
    if correlator == "fused" and not cuda_supported(cfg):
        raise NotImplementedError(
            f"the CUDA tracking kernel does not take {describe(cfg)} yet")
    return correlator


def ran_name(correlator: str, on_card: bool) -> str:
    """What TrackResults.correlator reports: the kernel's name where one
    launched, else the plain path's ("reference" is the direct sum)."""
    if on_card and correlator == "fused":
        return fused.KERNEL_NAME
    if on_card and correlator == "bucket_pallas":
        return prefix.KERNEL_NAME
    return "reference" if correlator in ("fused", "gather") else correlator


def require_ported(settings: Settings,
                   epochs_per_block: int = 100) -> TrackConfig:
    """The real-input TrackConfig, or NotImplementedError naming a
    configuration the port does not cover yet."""
    cfg = make_track_config(settings, False, epochs_per_block)
    if not reference_supported(cfg):
        raise NotImplementedError(
            f"tracking for {describe(cfg)} is not ported yet")
    return cfg


def as_capture(signal, device: str | torch.device) -> torch.Tensor:
    """A real int8 capture as a 1-D int8 tensor on `device` (not copied if
    it is one already)."""
    if isinstance(signal, torch.Tensor):
        kind, ndim = signal.dtype, signal.dim()
        ok = signal.dtype == torch.int8
    else:
        signal = np.asarray(signal)
        kind, ndim = signal.dtype, signal.ndim
        ok = signal.dtype == np.int8
    if not ok or ndim != 1:
        raise NotImplementedError(
            f"{kind} captures with {ndim} dimensions are not ported yet "
            "(real int8 only)")
    dev = resolve_device(device)
    if isinstance(signal, np.ndarray):
        # a writeable, contiguous host copy only where the source is
        # neither (a read-only memmap of a capture file)
        signal = torch.from_numpy(np.require(signal, requirements=["C", "W"]))
    return signal.to(dev)


def setup_tracking(capture: torch.Tensor, settings: Settings,
                   inits: list[ChannelInit], n_epochs: int,
                   epochs_per_block: int) -> TrackSetup:
    """Host half of `track`: config, tables, initial state and schedule,
    with the tensors on the capture's device."""
    cfg = require_ported(settings, epochs_per_block)
    dev = capture.device
    consts = channel_consts(cfg, inits, settings)
    data_t, p11_t, p61_t = channel_code_tables(cfg, inits)
    ck_int, ck_frac = code_coarse_tables(cfg, cfg.m_data)
    # the BOC(6,1) pilot's coarse tables at m = 12 (driver.py:241-242)
    ck61 = code_coarse_tables(cfg, cfg.m_p61) if cfg.m_p61 else (None, None)
    cursors0 = np.array([c.code_phase for c in inits], dtype=np.int64)
    state = initial_state(cfg, inits, consts, np.zeros(len(inits)))
    return TrackSetup(
        cfg=cfg, inits=inits, cursors0=cursors0,
        tables=tables_to_torch(cfg, data_t, p11_t, ck_int, ck_frac, dev,
                               p61_t, *ck61),
        consts=consts_to_torch(consts, dev),
        state=state_to_torch(state, cursors0, dev),
        n_blocks=block_schedule(cfg, consts, cursors0, capture.shape[0],
                                n_epochs),
    )


def run_blocks(setup: TrackSetup, capture: torch.Tensor,
               block_fn) -> torch.Tensor:
    """All blocks, one `block_fn` call each; (n_blocks*W, C, slots) rows
    on the device, not synchronized."""
    state = setup.state
    rows = []
    for _ in range(setup.n_blocks):
        state, r = block_fn(setup.cfg, capture, setup.tables, setup.consts,
                            state)
        rows.append(r)
    return torch.cat(rows)


def track(
    signal,
    settings: Settings,
    inits: list[ChannelInit],
    n_epochs: int | None = None,
    epochs_per_block: int = 100,
    device: str | torch.device = "cuda",
    correlator: str = "auto",
) -> TrackResults:
    """Track all channels for n_epochs integration periods on `device`.

    signal: the whole real int8 capture, numpy or a tensor (a tensor
    already on `device` is not copied).  correlator: "auto"
    (choose_correlator), or one of the reference's paths: "fused" and
    "gather" (the CUDA tracking kernel and its plain version, the direct
    sum), "bucket" and "bucket_pallas" (the prefix-sum correlator with its
    plain prefixes or with the mix+prefix kernel).  On a CUDA device the
    kernel paths launch their kernels; on the CPU their plain versions run
    instead.  Configurations the port does not cover raise
    NotImplementedError before any device work: B2a and B1C in every
    track mode, on real int8 input, are covered.
    """
    cfg = require_ported(settings, epochs_per_block)
    correlator = choose_correlator(cfg, correlator)
    capture = as_capture(signal, device)
    if n_epochs is None:
        n_epochs = settings.int_epochs
    setup = setup_tracking(capture, settings, inits, n_epochs,
                           epochs_per_block)
    rows = run_blocks(setup, capture, BLOCK_FNS[correlator])
    return assemble_results(setup, rows, settings, n_epochs,
                            ran_name(correlator,
                                     capture.device.type == "cuda"))


def assemble_results(setup: TrackSetup, rows: torch.Tensor,
                     settings: Settings, n_epochs: int,
                     correlator: str) -> TrackResults:
    """One download of the packed rows, then the reference's derived
    fields (bds3_tpu/track/driver.py:386-414)."""
    cfg, inits = setup.cfg, setup.inits
    names = output_names(cfg)
    stacked = rows[:n_epochs, :, :len(names)].cpu().numpy()   # (E, C, F)
    outputs = {k: np.ascontiguousarray(stacked[:, :, i].T)
               for i, k in enumerate(names)}                  # (C, E)
    blks = outputs["blksize"].astype(np.int64)
    absolute_sample = setup.cursors0[:, None] + np.cumsum(blks, axis=1)
    base = np.array([c.acquired_freq for c in inits], dtype=np.float64)
    carr_freq = base[:, None] + outputs["d_cyc"].astype(np.float64) * cfg.fs
    code_freq = settings.code_freq_basis \
        + outputs["d_step"].astype(np.float64) * cfg.fs
    return TrackResults(
        prns=np.array([c.prn for c in inits]),
        acquired_freq=base,
        n_epochs=stacked.shape[0],
        outputs=outputs,
        absolute_sample=absolute_sample,
        carr_freq=carr_freq,
        code_freq=code_freq,
        int_time=settings.int_time,
        settings=settings,
        correlator=correlator,
    )
