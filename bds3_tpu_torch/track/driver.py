"""Tracking driver: runs the chosen tracking path block by block over a
capture, and assembles the per-epoch results.

Port of `bds3_tpu/track/driver.py`, with its two paths:

* resident: a capture that is already a tensor stays where it is; each
  block of W epochs is one call of the path's block function, which reads
  every channel's samples at its own absolute int64 cursor, so no block is
  sliced, padded or shifted (the reference's int32 block offsets and its
  2^31-sample limit are TPU artifacts);
* per block (`driver.py:320-366`): a host source (numpy, a memmap, an
  `io.stream.StreamingCapture`, an `io.transport.IQ8Pairs`) is read one
  block at a time, packed if `transport` asks for it, uploaded and
  unpacked on the device, and the same block function runs on that block
  with the cursors relative to its start.  Only about two blocks are ever
  on the device or in host memory, so captures larger than either stream
  through.

The block schedule is the reference's, verbatim, so the epoch count,
`absolute_sample` and the derived frequencies match it, and the two paths
read the same samples.  Each block's rows go to a sink as the block is
launched: with `download=True` a `BlockDrain`, which brings every
block's outputs to the host while the device runs the blocks after it,
into the request's final layout; with `download=False` a `KeepRows`,
which leaves them on the device (`LazyOutputs`).

A capture is real (int8, float32) or complex64, tracked in the dtype
`io.transport.capture_dtype` gives it; the config is built for its kind
(`require_ported`).

Under a profiler each call is one `track` span holding `track.setup`,
then `track.blocks` (resident) or a `track.read` and a `track.upload`
for each block (per block); each block's drain is a `track.download`
(the wait for its copy and its placement) and a `track.assemble` (its
derived fields): on the resident path a block's drain is inside
`track.blocks` when LOOKAHEAD later blocks were launched before it, and
the drains of the last LOOKAHEAD blocks follow the loop.  The requests, seconds of signal, blocks, downloaded bytes and the drains
that finished while a later block was still on the device are counted
(`utils/trace.py`).
"""
from __future__ import annotations

import dataclasses
import functools
import time
from collections import defaultdict, deque
from typing import NamedTuple

import numpy as np
import torch

from bds3_tpu_torch.config import Settings, Signal
from bds3_tpu_torch.convert import consts_to_torch, state_to_torch, tables_to_torch
from bds3_tpu_torch.io.stream import StreamingCapture
from bds3_tpu_torch.io.transport import (
    capture_dtype,
    check_packing,
    read_host,
    upload,
)
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
from bds3_tpu_torch.utils.trace import count, span, spanned


class LazyOutputs:
    """Mapping view over the packed rows (E, C, slots) left on the device
    (`track(download=False)`, `bds3_tpu/track/driver.py:70-139`): each name
    is a (C, E) view of the rows, made when first read.  `realize` downloads
    the rows once and returns plain numpy (C, E) arrays."""

    def __init__(self, rows: torch.Tensor, names, n_epochs: int):
        self._rows = rows
        self._idx = {k: i for i, k in enumerate(names)}
        self._n = n_epochs
        self._cache = {}

    def __getitem__(self, k):
        if k not in self._cache:
            self._cache[k] = self._rows[: self._n, :, self._idx[k]].T
        return self._cache[k]

    def __contains__(self, k):
        return k in self._idx

    def __iter__(self):
        return iter(self._idx)

    def __len__(self):
        return len(self._idx)

    def keys(self):
        return self._idx.keys()

    def items(self):
        return ((k, self[k]) for k in self._idx)

    def block_until_ready(self):
        """Wait for the device's work on the rows without downloading:
        the sync point of throughput timing."""
        if self._rows.device.type == "cuda":
            torch.cuda.synchronize(self._rows.device)
        return self

    def realize(self) -> dict:
        """Download the rows once, counted in `track.d2h_bytes`; name ->
        (C, E) numpy arrays."""
        with span("track.download"):
            rows = self._rows[: self._n].cpu().numpy()
        count("track.d2h_bytes", rows.nbytes)
        with span("track.assemble"):
            return {k: np.ascontiguousarray(rows[:, :, i].T)
                    for k, i in self._idx.items()}


@dataclasses.dataclass
class TrackResults:
    """Per-channel, per-epoch tracking archives (the reference's
    trackResults struct, tracking.m:45-96), as numpy on the host; with
    `download=False`, `outputs` is a LazyOutputs and the three derived
    fields are None."""

    prns: np.ndarray               # (C,)
    acquired_freq: np.ndarray      # (C,) f64
    n_epochs: int
    outputs: dict                  # name -> (C, E) f32 arrays
    absolute_sample: np.ndarray | None  # (C, E) int64: sample of epoch END
    carr_freq: np.ndarray | None   # (C, E) f64 absolute NCO frequency
    code_freq: np.ndarray | None   # (C, E) f64 absolute code frequency
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


class BlockSchedule(NamedTuple):
    """The reference's block schedule: block b reads the capture's samples
    [starts[b], starts[b] + block_len); consecutive starts are `shift`
    apart."""

    starts: list
    block_len: int
    shift: int


def block_schedule(cfg: TrackConfig, consts: ChannelConsts,
                   cursors0: np.ndarray, total: int,
                   n_epochs: int) -> BlockSchedule:
    """The W-epoch blocks the capture holds: the reference's schedule
    (bds3_tpu/track/driver.py:256-296), host arithmetic only."""
    W = cfg.epochs_per_block
    per_epoch_max = cfg.q0_int + 3
    s0 = int(cursors0.min())
    # every sample a block's epochs can read, with the reference's margins
    block_len = int(cursors0.max() - s0) + W * per_epoch_max + cfg.n_max \
        + 2 * cfg.q0_int + 4 * per_epoch_max + W + 64
    exp_adv = cfg.code_length / (cfg.step_base
                                 + consts.init_dstep.astype(np.float64))
    shift = max(int(np.floor(W * (exp_adv.min() - 0.1))), 0)
    spread0 = int(cursors0.max() - s0)
    starts = []
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
        starts.append(s0)
        done += W
        s0 += shift
    if not starts:
        raise ValueError("not enough signal for a single tracking block")
    return BlockSchedule(starts, block_len, shift)


@dataclasses.dataclass
class TrackSetup:
    """Everything `track` puts on the device before the first launch."""

    cfg: TrackConfig
    inits: list[ChannelInit]
    cursors0: np.ndarray     # (C,) int64 first code start of each channel
    tables: TrackTables
    consts: ChannelConsts    # of tensors
    state: TrackState        # cursors absolute
    schedule: BlockSchedule

    @property
    def n_blocks(self) -> int:
        return len(self.schedule.starts)


# correlator -> block function (the reference's names, driver.py:183-185)
BLOCK_FNS = {
    "fused": fused_track_block,
    "gather": track_block_reference,
    "bucket": functools.partial(track_block_bucket, prefix_fn=bucket_prefix),
    "bucket_pallas": functools.partial(track_block_bucket,
                                       prefix_fn=pallas_prefix),
}


def choose_correlator(cfg: TrackConfig, correlator: str = "auto",
                      dtype=np.int8) -> str:
    """The tracking path for `cfg` on a capture tracked in `dtype`: "auto"
    takes the CUDA tracking kernel ("fused"), as the reference takes its
    fused kernel on its chip (bds3_tpu/track/driver.py:211-222); a config
    the kernel cannot hold raises, it is not sent elsewhere.  The device
    then picks kernel or plain version, so the CPU runs the path the card
    runs.  "bucket_pallas" takes real int8 and float32 captures, the two
    its kernel reads (prefix.CAPTURE_KINDS), and raises on any other
    dtype and on complex input: the reference's mixes complex ones in XLA
    instead without a word (bds3_tpu/track/scan.py:378), and the port runs
    no kernel path whose kernel would not launch."""
    if correlator == "auto":
        correlator = "fused"
    if correlator not in BLOCK_FNS:
        raise ValueError(f"unknown correlator {correlator!r}: expected "
                         f"'auto' or one of {sorted(BLOCK_FNS)}")
    if correlator == "fused" and not cuda_supported(cfg):
        raise NotImplementedError(
            f"the CUDA tracking kernel does not take {describe(cfg)} yet")
    if correlator == "bucket_pallas" and (
            cfg.complex_input
            or np.dtype(dtype) not in (np.dtype(np.int8),
                                       np.dtype(np.float32))):
        raise NotImplementedError(
            f"bucket_pallas's mix+prefix kernel reads real int8 or float32 "
            f"captures only, not {describe(cfg)} in {np.dtype(dtype)} (the "
            "reference's takes real input only: bds3_tpu/track/scan.py:378);"
            " use 'fused', 'gather' or 'bucket'")
    return correlator


def ran_name(correlator: str, on_card: bool) -> str:
    """What TrackResults.correlator reports: the kernel's name where one
    launched, else the plain path's ("reference" is the direct sum)."""
    if on_card and correlator == "fused":
        return fused.KERNEL_NAME
    if on_card and correlator == "bucket_pallas":
        return prefix.KERNEL_NAME
    return "reference" if correlator in ("fused", "gather") else correlator


def require_ported(settings: Settings, complex_input: bool = False,
                   epochs_per_block: int = 100) -> TrackConfig:
    """The TrackConfig for a real or complex capture (every signal and
    track mode is ported); TypeError for another package's Settings."""
    return make_track_config(settings, complex_input, epochs_per_block)


# the torch dtype of each capture_dtype
TORCH_DTYPES = {np.dtype(np.int8): torch.int8,
                np.dtype(np.float32): torch.float32,
                np.dtype(np.complex64): torch.complex64}


def _check_1d(shape) -> None:
    if len(shape) != 1:
        raise ValueError(
            f"a capture is 1-D, not {tuple(shape)}: an IQ8 capture's (N, 2) "
            "int8 I/Q pairs go to run_receiver(), or convert them as it "
            "does: io.transport.IQ8Pairs(raw) for a host source, "
            "io.transport.widen_iq8(pairs) for a tensor")


def as_capture(signal, device: str | torch.device) -> torch.Tensor:
    """A capture as the 1-D tensor tracking reads, on `device`: int8,
    float32 and complex64 as they are (not copied if already there),
    other dtypes as io.transport.capture_dtype casts them.  A
    StreamingCapture is refused: it is read block by block (`track`), or
    uploaded whole by `io.transport.upload_capture`; so are IQ8 pairs."""
    if isinstance(signal, StreamingCapture):
        raise TypeError(
            "a StreamingCapture is not uploaded whole here: pass it to "
            "track() or run_receiver(), which read it block by block, or "
            "upload it with bds3_tpu_torch.io.transport.upload_capture")
    if not isinstance(signal, torch.Tensor):
        signal = np.asarray(signal)
    _check_1d(signal.shape)
    dtype = capture_dtype(signal.dtype)
    dev = resolve_device(device)
    if isinstance(signal, np.ndarray):
        # a writeable, contiguous host copy only where the source is
        # neither (a read-only memmap of a capture file)
        signal = torch.from_numpy(np.require(signal.astype(dtype, copy=False),
                                             requirements=["C", "W"]))
    return signal.to(dev, TORCH_DTYPES[dtype])


def check_host_source(signal) -> None:
    """Raise unless `signal` is a host source the per-block path reads: a
    1-D numpy array or memmap of samples, a StreamingCapture, IQ8Pairs."""
    _check_1d(getattr(signal, "shape", ()))
    capture_dtype(getattr(signal, "dtype", None))


@spanned("track.setup")
def setup_tracking(capture, settings: Settings, inits: list[ChannelInit],
                   n_epochs: int, epochs_per_block: int,
                   device: str | torch.device | None = None) -> TrackSetup:
    """Host half of `track`: config, tables, initial state and schedule.
    capture: the capture tensor, whose device the tensors go to, or a host
    source (anything with a length) with the `device` to use."""
    cfg = require_ported(settings, capture_dtype(capture.dtype).kind == "c",
                         epochs_per_block)
    dev = capture.device if isinstance(capture, torch.Tensor) \
        else resolve_device(device)
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
        schedule=block_schedule(cfg, consts, cursors0, len(capture),
                                n_epochs),
    )


def _results(setup: TrackSetup, settings: Settings, n_epochs: int,
             correlator: str, outputs, absolute_sample=None, carr_freq=None,
             code_freq=None) -> TrackResults:
    inits = setup.inits
    return TrackResults(
        prns=np.array([c.prn for c in inits]),
        acquired_freq=np.array([c.acquired_freq for c in inits],
                               dtype=np.float64),
        n_epochs=n_epochs, outputs=outputs, absolute_sample=absolute_sample,
        carr_freq=carr_freq, code_freq=code_freq, int_time=settings.int_time,
        settings=settings, correlator=correlator)


class KeepRows:
    """The sink of `track(download=False)`: every block's rows stay on the
    device, joined at the end into the rows of a LazyOutputs."""

    def __init__(self, setup: TrackSetup, settings: Settings, n_epochs: int,
                 correlator: str):
        self._args = (setup, settings, n_epochs, correlator)
        self._rows = []

    def push(self, rows: torch.Tensor) -> None:
        self._rows.append(rows)

    def finish(self) -> TrackResults:
        setup, settings, n_epochs, correlator = self._args
        rows = torch.cat(self._rows)
        n = min(n_epochs, rows.shape[0])
        return _results(setup, settings, n, correlator,
                        LazyOutputs(rows, output_names(setup.cfg), n))


# Blocks that the device holds queued behind the oldest block not yet
# drained: the host places a block while the device runs these, so a
# stall of the host shorter than their time leaves the device busy.  A
# B2a block of W = 200 takes ~2.2 ms; the host stalls for up to ~23 ms
# (the first block's placement, which faults in the huge pages numpy
# takes for the whole answer, ~10 ms for B2a's 50 MB; garbage
# collection; a shared host's scheduling; a traced B2a run on an H100's
# host), which 16 cover.
LOOKAHEAD = 16
# Staging of BlockDrain not in use, by device: a request on a card takes
# one and gives it back, so pinned memory stays at a few blocks' worth
# whatever the number of requests, and the side stream's allocations are
# served from the caching allocator's blocks of earlier requests.
_STAGING: defaultdict = defaultdict(list)


class Staging(NamedTuple):
    """A side stream and LOOKAHEAD + 1 pinned float32 buffers."""

    stream: torch.cuda.Stream
    buffers: list


def _take_staging(dev: torch.device, n: int) -> Staging:
    """Staging of more than LOOKAHEAD buffers of at least `n` values: one
    an earlier request gave back, or a new one."""
    free = _STAGING[str(dev)]
    while free:
        staging = free.pop()
        if (len(staging.buffers) > LOOKAHEAD
                and staging.buffers[0].numel() >= n):
            return staging
    return Staging(torch.cuda.Stream(dev),
                   [torch.empty(n, dtype=torch.float32, pin_memory=True)
                    for _ in range(LOOKAHEAD + 1)])


class _Queued(NamedTuple):
    """A block whose copy to the host is queued (BlockDrain)."""

    e0: int                          # its first epoch
    k: int                           # its epochs kept
    staged: torch.Tensor             # (F, C, k): the copy's destination
    launched: torch.cuda.Event | None  # after its launch (on a card)
    copied: torch.cuda.Event | None    # after its copy (on a card)
    rows: torch.Tensor               # referenced until the copy is done


class BlockDrain:
    """The sink of `track(download=True)`: each block's outputs reach the
    host in the request's final layout while the device runs the blocks
    after it, with the reference's derived fields of its epochs
    (bds3_tpu/track/driver.py:386-414).

    Every name is a (C, E) view of one fresh (F, C, E) float32 array,
    filled a block at a time.  On a card a block's F output columns (not
    the state's slots) are copied on a side stream, behind an event
    recorded after its launch, into one of LOOKAHEAD + 1 pinned staging
    buffers (`Staging`), permuted there to (F, C, W) by the copy; the
    host waits for that copy alone, LOOKAHEAD blocks later, and places
    it.  With rows on the host (the CPU) the same placement runs on them
    directly.  `absolute_sample` carries its last column from block to
    block, and the frequencies are the same float64 multiply and add on
    each block's slice, so every value equals the whole-array assembly's
    bit for bit.
    """

    def __init__(self, setup: TrackSetup, settings: Settings, n_epochs: int,
                 correlator: str):
        cfg, inits = setup.cfg, setup.inits
        names = output_names(cfg)
        F, C, W = len(names), len(inits), cfg.epochs_per_block
        n = min(n_epochs, setup.n_blocks * W)
        self._setup, self._settings, self._correlator = \
            setup, settings, correlator
        self._names = names
        self._col = {k: names.index(k) for k in ("blksize", "d_cyc", "d_step")}
        self._fs, self._code_basis = cfg.fs, settings.code_freq_basis
        self._base = np.array([c.acquired_freq for c in inits],
                              dtype=np.float64)
        self._carry = setup.cursors0.copy()
        self._out = np.empty((F, C, n), np.float32)
        self._absolute_sample = np.empty((C, n), np.int64)
        self._carr_freq = np.empty((C, n), np.float64)
        self._code_freq = np.empty((C, n), np.float64)
        self._queued = 0                       # epochs whose copy is queued
        self._blocks = 0
        self._pending = deque()
        self._dev = setup.state.cursor.device
        self._staging = (_take_staging(self._dev, F * C * W)
                         if self._dev.type == "cuda" else None)

    def push(self, rows: torch.Tensor) -> None:
        """Queue the copy of a block's rows just launched on the current
        stream; then drain the oldest block if LOOKAHEAD newer ones are
        queued behind it."""
        e0 = self._queued
        k = min(rows.shape[0], self._out.shape[2] - e0)
        src = rows[:k, :, :len(self._names)].permute(2, 1, 0)  # (F, C, k)
        launched = copied = None
        staged = src
        if self._staging is not None:
            side, buffers = self._staging
            launched = torch.cuda.Event()
            launched.record(torch.cuda.current_stream(self._dev))
            buf = buffers[self._blocks % len(buffers)]
            staged = buf[:src.numel()].view(src.shape)
            with torch.cuda.stream(side):
                side.wait_event(launched)
                staged.copy_(src, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(side)
        self._pending.append(_Queued(e0, k, staged, launched, copied, rows))
        self._queued += k
        self._blocks += 1
        if len(self._pending) > LOOKAHEAD:
            self._drain()

    def _drain(self) -> None:
        """The oldest queued block: wait for its copy, place it, and work
        out its derived fields."""
        e0, k, staged, _, copied, _ = self._pending.popleft()
        sl = slice(e0, e0 + k)
        with span("track.download"):
            if copied is not None:
                copied.synchronize()
            self._out[:, :, sl] = staged.numpy()
        count("track.d2h_bytes", staged.numel() * staged.element_size())
        with span("track.assemble"):
            col = self._col
            blk = self._out[col["blksize"], :, sl].astype(np.int64)
            np.cumsum(blk, axis=1, out=self._absolute_sample[:, sl])
            self._absolute_sample[:, sl] += self._carry[:, None]
            self._carry = self._absolute_sample[:, e0 + k - 1].copy()
            np.add(self._base[:, None],
                   self._out[col["d_cyc"], :, sl].astype(np.float64)
                   * self._fs, out=self._carr_freq[:, sl])
            np.add(self._code_basis,
                   self._out[col["d_step"], :, sl].astype(np.float64)
                   * self._fs, out=self._code_freq[:, sl])
        # hidden: a later block was still on the device when this one was
        # done (queried on the newest block's launch event)
        newest = self._pending[-1].launched if self._pending else None
        count("track.drains_hidden",
              int(newest is not None and not newest.query()))

    def finish(self) -> TrackResults:
        """Drain the blocks still queued; the request's results."""
        while self._pending:
            self._drain()
        if self._staging is not None:
            _STAGING[str(self._dev)].append(self._staging)
            self._staging = None
        n = self._queued
        out, fields = self._out, (self._absolute_sample, self._carr_freq,
                                 self._code_freq)
        if n < out.shape[2]:        # a deadline stopped the blocks early
            out = np.ascontiguousarray(out[:, :, :n])
            fields = tuple(np.ascontiguousarray(f[:, :n]) for f in fields)
        return _results(self._setup, self._settings, n, self._correlator,
                        dict(zip(self._names, out)), *fields)


@spanned("track.blocks")
def run_blocks(setup: TrackSetup, capture: torch.Tensor, block_fn,
               sink) -> None:
    """All blocks over a resident capture, one `block_fn` call each, each
    block's rows handed to `sink` (BlockDrain or KeepRows) once launched."""
    state = setup.state
    for _ in range(setup.n_blocks):
        state, r = block_fn(setup.cfg, capture, setup.tables, setup.consts,
                            state)
        count("track.blocks")
        sink.push(r)


def _upload_block(host: np.ndarray, transport: str, dev: torch.device,
                  stream) -> torch.Tensor:
    """One host block to the device; on a card through the side `stream`,
    so that the copy can overlap the kernel still running on the current
    stream, which then waits for it."""
    if stream is None:
        return upload(host, transport, dev)
    with torch.cuda.stream(stream):
        block = upload(host, transport, dev)
    current = torch.cuda.current_stream(dev)
    current.wait_stream(stream)
    block.record_stream(current)
    return block


def stream_blocks(setup: TrackSetup, signal, block_fn, sink,
                  transport: str = "none", sync_each_block: bool = False,
                  deadline_s: float | None = None,
                  t0: float | None = None) -> None:
    """All blocks over a host source, read, packed, uploaded and tracked
    one at a time (bds3_tpu/track/driver.py:320-366): block b is
    signal[starts[b] : starts[b] + block_len], zero-padded past the end,
    and the cursors are relative to its start.  sync_each_block waits for
    the previous block's state before the next block is read (a one-block
    lookahead: host staging stays bounded to ~2 blocks).  deadline_s stops
    after the first block that ends later than deadline_s seconds after
    `t0`.  Each block's rows go to `sink` (BlockDrain or KeepRows) once
    launched."""
    t0 = time.time() if t0 is None else t0
    cfg, sched = setup.cfg, setup.schedule
    dev = setup.state.cursor.device
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    # the reference's relative cursors (driver.py:248): cursor - start
    state = TrackState(setup.state.cursor - sched.starts[0],
                       setup.state.statef)
    pending = None
    for s_cur in sched.starts:
        with span("track.read"):
            host = read_host(signal, s_cur, s_cur + sched.block_len)
            if len(host) < sched.block_len:
                pad = np.zeros((sched.block_len - len(host),)
                               + host.shape[1:], host.dtype)
                host = np.concatenate([host, pad])
        with span("track.upload"):
            block = _upload_block(host, transport, dev, side)
        state, r = block_fn(cfg, block, setup.tables, setup.consts, state)
        count("track.blocks")
        sink.push(r)
        state = TrackState(state.cursor - sched.shift, state.statef)
        if sync_each_block and dev.type == "cuda":
            if pending is not None:
                pending.synchronize()
            pending = torch.cuda.Event()
            pending.record(torch.cuda.current_stream(dev))
        if deadline_s is not None and time.time() - t0 > deadline_s:
            break
    if pending is not None:
        pending.synchronize()


@spanned("track")
def track(
    signal,
    settings: Settings,
    inits: list[ChannelInit],
    n_epochs: int | None = None,
    epochs_per_block: int = 100,
    device: str | torch.device = "cuda",
    correlator: str = "auto",
    download: bool = True,
    sync_each_block: bool = False,
    deadline_s: float | None = None,
    transport: str = "none",
) -> TrackResults:
    """Track all channels for n_epochs integration periods on `device`.

    signal: the whole capture, 1-D: int8 or float32 real, or complex64
    (other dtypes are cast as io.transport.capture_dtype says).  A tensor
    is tracked where it is moved to (not copied if it is on `device`
    already).  A host source (a numpy array, a memmap, an
    io.stream.StreamingCapture, an io.transport.IQ8Pairs) is read,
    uploaded and tracked one block at a time (stream_blocks).
    correlator: "auto" (choose_correlator), or one of the reference's
    paths: "fused" and
    "gather" (the CUDA tracking kernel and its plain version, the direct
    sum), "bucket" and "bucket_pallas" (the prefix-sum correlator with its
    plain prefixes or with the mix+prefix kernel).  On a CUDA device the
    kernel paths launch their kernels; on the CPU their plain versions run
    instead.  B2a and B1C in every track mode are covered; what does not
    apply (bucket_pallas on a capture other than int8, a packing of one)
    raises before any device work.

    The reference's streaming options (driver.py:166-203) apply to a host
    source: sync_each_block and deadline_s as in stream_blocks, and
    transport "int4" or "int2" packs each block of an int8 capture on the
    host and unpacks it on the device (io.transport).  download=False
    leaves the outputs on the device as a LazyOutputs, without the
    derived fields.
    """
    t0 = time.time()
    if isinstance(signal, torch.Tensor):
        _check_1d(signal.shape)
    else:
        check_host_source(signal)
    dtype = capture_dtype(signal.dtype)
    cfg = require_ported(settings, dtype.kind == "c", epochs_per_block)
    correlator = choose_correlator(cfg, correlator, dtype)
    check_packing(transport, str(dtype))
    if n_epochs is None:
        n_epochs = settings.int_epochs
    block_fn = BLOCK_FNS[correlator]
    resident = isinstance(signal, torch.Tensor)
    if resident:
        capture = as_capture(signal, device)
        setup = setup_tracking(capture, settings, inits, n_epochs,
                               epochs_per_block)
    else:
        setup = setup_tracking(signal, settings, inits, n_epochs,
                               epochs_per_block, device)
    ran = ran_name(correlator, setup.state.cursor.device.type == "cuda")
    sink = (BlockDrain if download else KeepRows)(setup, settings, n_epochs,
                                                   ran)
    if resident:
        run_blocks(setup, capture, block_fn, sink)
    else:
        stream_blocks(setup, signal, block_fn, sink, transport,
                      sync_each_block, deadline_s, t0)
    res = sink.finish()
    count("track.requests")
    count("track.signal_ms", res.n_epochs * (settings.int_time * 1e3))
    return res
