"""Fused carrier mix, mask and exclusive prefix sums: the wrapper of
`csrc/mix_prefix.cu` (port of `bds3_tpu/track/pallas_prefix.py`).

For channel c and sample j of an epoch window of n samples that starts at
the absolute capture index cursor[c]:

    x   = capture[cursor[c] + j]  if j < blk[c] and the index lies inside
          the capture, else 0  (an int8 or float32 sample, as float32)
    cyc = mod1(base[c, j // 4096] + (j % 4096) * slope[c])   (floor-mod)
    i   = x * cos(2 pi cyc),   q = -(x * sin(2 pi cyc))
    P_i[c, x] = sum_{j < x} i,   P_q[c, x] = sum_{j < x} q,   x = 0 .. n

so the last entry P[c, n] is the window total.  This is the Pallas kernel
(`pallas_prefix.py:52-82`) on an absolute cursor in place of a
pre-gathered window, with the total stored beside the prefixes: the
bucket correlator's boundaries past the epoch end read it.

`mix_prefix` runs the CUDA kernel on CUDA tensors and raises on anything
it does not take; on CPU tensors it runs `mix_prefix_reference`, its
plain PyTorch version.  It never falls back.  The kernel has an instance
for each real capture dtype the reference's kernel reads (it casts the
window to float32, `pallas_prefix.py:62`): int8 and float32, chosen by
`CAPTURE_KINDS`.  The two share everything after the load, so the
float32 instance on an int8 capture's values gives the int8 result bit
for bit.

The kernel is one launch: each block mixes and scans one 4096-sample
tile, publishes the tile's total, sums the totals of its channel's
earlier tiles in float64 in a fixed order, and writes its prefixes once
(see the header of `csrc/mix_prefix.cu`).  The blocks find each other
through the scratch that `buffers` makes: a ticket counter, the call's
generation number and one published total per tile.  It is zero when
made, every call leaves it ready for the next, and it serves any later
call on the same stream whose shape it holds.  Two calls that run at once
must not share one.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from bds3_tpu_torch.track.state import SPLIT
from bds3_tpu_torch.utils.device import check_tensor
from bds3_tpu_torch.utils.trace import count

KERNEL_NAME = "mix_prefix_cuda"
SOURCE = "bds3_tpu_torch/csrc/mix_prefix.cu"
REPLACES = "bds3_tpu/track/pallas_prefix.py:92"   # the TPU kernel
TWO_PI = float(np.float32(2.0 * np.pi))
# the capture dtypes the kernel reads, and the code of each one's instance
# (csrc/mix_prefix.cu, CAPTURE_INT8 and CAPTURE_FLOAT32)
CAPTURE_KINDS = {torch.int8: 0, torch.float32: 1}


def n_tiles(n: int) -> int:
    """Phase tiles of an n-sample window: base has this many columns."""
    return -(-n // SPLIT)


def scratch_words(c: int, n: int) -> int:
    """64-bit words of the kernel's scratch for C windows of n samples:
    the ticket counter, the generation, and the I and Q totals of each
    (channel, tile)."""
    return 2 + 2 * c * n_tiles(n)


def buffers(c: int, n: int, device) -> tuple[tuple[torch.Tensor,
                                                   torch.Tensor], torch.Tensor]:
    """The kernel's output pair (P_i, P_q), each (C, n + 1) float32, and
    its scratch, (scratch_words(c, n),) int64 zeros.  A caller that runs
    many windows allocates them once; the scratch also serves windows of
    any smaller shape."""
    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=device)
    scratch = torch.zeros(scratch_words(c, n), dtype=torch.int64,
                          device=device)
    return (empty(c, n + 1), empty(c, n + 1)), scratch


def check_buffers(c: int, n: int,
                  out: tuple[torch.Tensor, torch.Tensor] | None,
                  scratch: torch.Tensor | None, device: torch.device) -> None:
    """Raise unless `out` and `scratch`, where given, are what
    `buffers(c, n, device)` makes; the scratch may be longer (one made for
    a larger shape)."""
    for name, t in zip(("out[0]", "out[1]"), out or ()):
        check_tensor(name, t, torch.float32, (c, n + 1), device)
    if scratch is None:
        return
    check_tensor("scratch", scratch, torch.int64, (scratch.numel(),), device)
    if scratch.numel() < scratch_words(c, n):
        raise ValueError(f"scratch has {scratch.numel()} words, expected at "
                         f"least {scratch_words(c, n)}")


def mix_prefix_reference(capture: torch.Tensor, cursor: torch.Tensor,
                         blk: torch.Tensor, base: torch.Tensor,
                         slope: torch.Tensor, n: int,
                         out: tuple[torch.Tensor, torch.Tensor] | None = None,
                         scratch: torch.Tensor | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, on any device; arguments and
    result as mix_prefix (it needs no scratch and ignores it)."""
    total = capture.shape[0]
    j = torch.arange(n, device=capture.device)
    lin_f = (j % SPLIT).to(torch.float32)
    g = cursor[:, None] + j[None, :]
    valid = (j[None, :] < blk[:, None]) & (g >= 0) & (g < total)
    x = torch.where(valid, capture[g.clamp(0, total - 1)], 0)
    x = x.to(torch.float32)
    cyc = torch.remainder(base[:, j // SPLIT] + lin_f * slope[:, None], 1.0)
    ang = TWO_PI * cyc
    z = x.new_zeros((x.shape[0], 1))
    p_i = torch.cat([z, torch.cumsum(x * torch.cos(ang), 1)], 1)
    p_q = torch.cat([z, torch.cumsum(-(x * torch.sin(ang)), 1)], 1)
    if out is None:
        return p_i, p_q
    out[0].copy_(p_i)
    out[1].copy_(p_q)
    return out


def random_inputs(seed: int, c: int, n: int, total: int
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A random int8 capture of `total` samples, per-tile phase bases
    (C, n_tiles(n)) and slopes (C,), with tests/test_pallas_prefix.py's
    distributions: the inputs on which the kernel, its plain version and
    the oracle are held to each other."""
    rng = np.random.default_rng(seed)
    capture = rng.integers(-30, 30, total).astype(np.int8)
    base = rng.random((c, n_tiles(n))).astype(np.float32)
    slope = (rng.random(c) * 0.2).astype(np.float32)
    return capture, base, slope


def mix_prefix_float64(capture: np.ndarray, cursor: np.ndarray,
                       blk: np.ndarray, base: np.ndarray, slope: np.ndarray,
                       n: int) -> tuple[np.ndarray, np.ndarray]:
    """The same prefixes in float64 numpy, from the same float32 phase
    inputs: the oracle both versions are checked against (as
    tests/test_pallas_prefix.py checks the Pallas kernel)."""
    j = np.arange(n)
    g = np.asarray(cursor, np.int64)[:, None] + j[None, :]
    ok = (j[None, :] < np.asarray(blk)[:, None]) & (g >= 0) \
        & (g < len(capture))
    x = np.where(ok, capture[np.clip(g, 0, len(capture) - 1)], 0)
    x = x.astype(np.float64)
    cyc = np.mod(base[:, j // SPLIT].astype(np.float64)
                 + (j % SPLIT) * slope.astype(np.float64)[:, None], 1.0)
    ang = 2 * np.pi * cyc
    z = np.zeros((len(cursor), 1))
    return (np.concatenate([z, np.cumsum(x * np.cos(ang), 1)], 1),
            np.concatenate([z, np.cumsum(-x * np.sin(ang), 1)], 1))


@functools.cache
def _entry():
    """The kernel's C entry point, with every argument type declared (an
    undeclared pointer would be passed as a 32-bit int)."""
    from bds3_tpu_torch._build import library

    fn = library().bds3_mix_prefix
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_void_p] * 4
                   + [ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p] * 4)
    return fn


def mix_prefix(capture: torch.Tensor, cursor: torch.Tensor,
               blk: torch.Tensor, base: torch.Tensor, slope: torch.Tensor,
               n: int, out: tuple[torch.Tensor, torch.Tensor] | None = None,
               scratch: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exclusive I/Q prefixes of C mixed, masked n-sample windows.

    capture (N,) int8 or float32; cursor, blk (C,) int64; base (C, n_tiles(n))
    float32; slope (C,) float32.  Returns (P_i, P_q), each (C, n + 1)
    float32, written into `out` when it is given; `scratch` is where the
    kernel's blocks publish their tiles' totals.  Both are as `buffers`
    makes them (a scratch of a larger shape will do), are checked on any
    device, and are made anew for the call where not given.  The launch
    is one kernel on the current stream and is not synchronized.
    """
    dev = capture.device
    c = cursor.shape[0]
    if dev.type == "cpu":
        check_buffers(c, n, out, scratch, dev)
        return mix_prefix_reference(capture, cursor, blk, base, slope, n, out)
    if dev.type != "cuda":
        raise ValueError(f"no mix_prefix kernel for device {dev}")

    if not 0 < n < 2**31 - 1:
        raise ValueError(f"window length {n} out of range")
    if capture.dtype not in CAPTURE_KINDS:
        raise TypeError(f"capture has dtype {capture.dtype}, expected one "
                        f"of {list(CAPTURE_KINDS)}")
    check_tensor("capture", capture, capture.dtype, (capture.shape[0],), dev)
    check_tensor("cursor", cursor, torch.int64, (c,), dev)
    check_tensor("blk", blk, torch.int64, (c,), dev)
    check_tensor("base", base, torch.float32, (c, n_tiles(n)), dev)
    check_tensor("slope", slope, torch.float32, (c,), dev)
    if out is None or scratch is None:
        made_out, made_scratch = buffers(c, n, dev)
        out = made_out if out is None else out
        scratch = made_scratch if scratch is None else scratch
    check_buffers(c, n, out, scratch, dev)
    launch = _entry()
    with torch.cuda.device(dev):
        err = launch(
            capture.data_ptr(), capture.shape[0],
            CAPTURE_KINDS[capture.dtype], cursor.data_ptr(),
            blk.data_ptr(), base.data_ptr(), slope.data_ptr(), c, n,
            out[0].data_ptr(), out[1].data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL_NAME} launch failed: CUDA error {err}")
    count("k2.launches")
    return out


count("k2.launches", 0)   # kernel launches, for run accounting
