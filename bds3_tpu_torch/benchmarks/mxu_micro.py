"""Matrix-throughput microbenchmark: the wrapper of `csrc/mxu_micro.cu`
(K3, port of `benchmarks/mxu_micro.py`).

The reference timed its TPU's matrix unit at the fused tracking kernel's
stage-2 shapes, in float32, in bfloat16 and in split bfloat16 (hi + lo).
For a (M, K) float32 and b (K, N) every variant computes one float32
scalar

    out = sum over (m, n) of sum_{i < iters} (a_i @ b)[m, n],
    a_i = a + float32(i) * 1e-9

(the i * 1e-9 term keeps the product inside the loop), with a_i @ b:
  "fp32"   in float32 (b float32);
  "bf16"   bf16(a_i) @ bf16(b), float32 accumulation;
  "split"  bf16(a_i) @ bf16(b) + bf16(a_i - bf16(a_i)) @ bf16(b).

`mxu_micro` launches the CUDA kernel on CUDA tensors and raises on what it
does not take; on CPU tensors it runs `mxu_micro_reference`, the plain
PyTorch version.  It never falls back.  `make_bench` and `run` keep the
reference's interface; the shapes are the reference's (SHAPES).

    python3 -m bds3_tpu_torch.benchmarks.mxu_micro      # on a card
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import sys

import numpy as np
import torch

from bds3_tpu_torch.utils.device import check_tensor, resolve_device
from bds3_tpu_torch.utils.trace import count

KERNEL_NAME = "mxu_micro_cuda"
SOURCE = "bds3_tpu_torch/csrc/mxu_micro.cu"
REPLACES = "benchmarks/mxu_micro.py:29"   # the TPU kernel
ITERS = 2000
VARIANTS = ("fp32", "bf16", "split")      # mxu_micro.cu VAR_*
# (M, K, N) of each variant, benchmarks/mxu_micro.py:80-89
SHAPES = {
    "fp32": [(32, 128, 512), (64, 128, 512), (128, 128, 512),
             (32, 128, 768), (128, 128, 1024), (8, 128, 512),
             (16, 128, 512), (128, 128, 128), (256, 256, 256)],
    "bf16": [(32, 128, 512), (128, 128, 512), (128, 128, 1024),
             (256, 256, 256)],
    "split": [(32, 128, 512), (128, 128, 1024)],
}
MAX_K = 256   # a and b's tile rows in one block's shared memory
SMS = 132     # the H100 SXM's streaming multiprocessors
# the planner's aims: blocks per launch (two a SM for wgmma, whose 64 x 256
# tile takes half an SM's shared memory at K = 128; four for FFMA), and
# the fewest iterations a chunk should have where iters allows
TARGET_BLOCKS = {"fp32": 4 * SMS, "bf16": 2 * SMS, "split": 2 * SMS}
MIN_CHUNK = 4
# the FFMA kernel's block tiles (8 TY x 8 TX outputs, TY TX threads), in
# the order the planner prefers them at equal waste
FP32_TILES = ((64, 128), (128, 64), (32, 256), (16, 512), (8, 1024),
              (64, 64), (32, 128), (16, 256), (8, 512))
WGMMA_TILE = (64, 256)   # one warpgroup, m64n256k16
# NVIDIA's H100 SXM dense peaks, operations per second (data sheet, 700 W):
# float32 outside the tensor cores, bf16 on them
PEAK_OPS = {"fp32": 67e12, "bf16": 989e12, "split": 989e12}


def variant_of(dtype: torch.dtype, split: bool = False) -> str:
    """The reference's (dtype, split) arguments as a variant name."""
    if split:
        return "split"
    if dtype == torch.bfloat16:
        return "bf16"
    if dtype == torch.float32:
        return "fp32"
    raise ValueError(f"no variant for dtype {dtype}")


def operations(M: int, K: int, N: int, variant: str,
               iters: int = ITERS) -> float:
    """Multiply-adds counted as two: 2 M K N a product, two products a
    step for "split"."""
    return 2.0 * M * K * N * iters * (2 if variant == "split" else 1)


def bound_ms(M: int, K: int, N: int, variant: str,
             iters: int = ITERS) -> float:
    """The least time the card could take: the operations at the dense
    peak of the variant's type (a and b, read once, are ~0.3 MB at most:
    the bytes bound no shape)."""
    return operations(M, K, N, variant, iters) / PEAK_OPS[variant] * 1e3


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: output tiles of tile_m x tile_n, times `chunks` slices
    of the iterations (chunk c covers [c iters // chunks, (c + 1) iters //
    chunks)); one block and one float64 partial for each pair."""
    tile_m: int
    tile_n: int
    tiles_m: int
    tiles_n: int
    chunks: int

    @property
    def tiles(self) -> int:
        return self.tiles_m * self.tiles_n

    @property
    def blocks(self) -> int:
        return self.tiles * self.chunks

    def chunk_bounds(self, iters: int) -> list[tuple[int, int]]:
        """[start, stop) of every chunk, as the kernel computes them."""
        return [(c * iters // self.chunks, (c + 1) * iters // self.chunks)
                for c in range(self.chunks)]


def _padded(M: int, N: int, tile: tuple[int, int]) -> int:
    return -(-M // tile[0]) * tile[0] * -(-N // tile[1]) * tile[1]


def plan(M: int, N: int, variant: str, iters: int = ITERS) -> Plan:
    """The tile and the chunks of one launch.  bf16 and split take the
    wgmma tile; fp32 the FFMA tile that pads the output least (FP32_TILES'
    order breaks ties).  Chunks: enough blocks to reach TARGET_BLOCKS
    unless a chunk would fall below MIN_CHUNK iterations, but never fewer
    blocks than SMS while iters allows, and at most one chunk an
    iteration (one chunk at iters = 0)."""
    if variant == "fp32":
        tile = min(FP32_TILES, key=lambda t: _padded(M, N, t))
    else:
        tile = WGMMA_TILE
    tiles_m, tiles_n = -(-M // tile[0]), -(-N // tile[1])
    tiles = tiles_m * tiles_n
    want = min(-(-TARGET_BLOCKS[variant] // tiles),
               iters // MIN_CHUNK)
    chunks = max(1, min(iters, max(-(-SMS // tiles), want)))
    return Plan(*tile, tiles_m, tiles_n, chunks)


def abs_scale(a: torch.Tensor, b: torch.Tensor, iters: int) -> float:
    """iters * sum over (m, n, k) of |a[m, k]| |b[k, n]|, in float64: the
    tolerance of a result is 1e-5 of this."""
    a64 = np.abs(a.detach().cpu().double().numpy())
    b64 = np.abs(b.detach().cpu().double().numpy())
    return float(iters * (a64.sum(0) * b64.sum(1)).sum())


def _offset(i: int) -> float:
    """float32(i) * float32(1e-9), rounded as the kernels round it."""
    return float(np.float32(i) * np.float32(1e-9))


def mxu_micro_reference(a: torch.Tensor, b: torch.Tensor,
                        dtype: torch.dtype = torch.float32,
                        split: bool = False,
                        iters: int = ITERS) -> torch.Tensor:
    """Plain PyTorch version, on any device: the ITERS products one by one
    in float32 (bf16 operands widened exactly to float32; keep TF32 off on
    a card).  Returns (1, 1) float32."""
    variant = variant_of(dtype, split)
    a = a.to(torch.float32)
    bb = b.to(torch.float32) if variant == "fp32" \
        else b.to(torch.bfloat16).to(torch.float32)
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    for i in range(iters):
        ai = a + _offset(i)
        if variant == "fp32":
            r = ai @ bb
        else:
            hi = ai.to(torch.bfloat16).to(torch.float32)
            r = hi @ bb
            if variant == "split":
                lo = (ai - hi).to(torch.bfloat16).to(torch.float32)
                r = r + lo @ bb
        acc = acc + r
    return acc.sum().reshape(1, 1)


@functools.cache
def _entry():
    from bds3_tpu_torch._build import library

    fn = library().bds3_mxu_micro
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p] * 3
    return fn


def mxu_micro(a: torch.Tensor, b: torch.Tensor,
              dtype: torch.dtype = torch.float32, split: bool = False,
              iters: int = ITERS) -> torch.Tensor:
    """The scalar of the module docstring as a (1, 1) float32 tensor.

    a: (M, K) float32; b: (K, N), float32 for "fp32" and bfloat16 for
    "bf16" (a float32 b is rounded to bfloat16 for "split", as the
    reference rounds it).  K must be a multiple of 16, at most 256.  One
    launch of the kernel and one of the partials' sum, on the current
    stream, not synchronized; the grid is `plan`'s."""
    variant = variant_of(dtype, split)
    dev = a.device
    if dev.type == "cpu":
        return mxu_micro_reference(a, b, dtype, split, iters)
    if dev.type != "cuda":
        raise ValueError(f"no mxu_micro kernel for device {dev}")
    M, K = a.shape
    N = b.shape[1]
    if K % 16 or K > MAX_K or iters < 0:
        raise ValueError(f"K = {K} must be a multiple of 16 and at most "
                         f"{MAX_K}, iters >= 0 (got {iters})")
    if variant == "split":
        b = b.to(torch.bfloat16)
    b_type = torch.float32 if variant == "fp32" else torch.bfloat16
    check_tensor("a", a, torch.float32, (M, K), dev)
    check_tensor("b", b, b_type, (K, N), dev)
    p = plan(M, N, variant, iters)
    partials = torch.empty(p.blocks, dtype=torch.float64, device=dev)
    out = torch.empty((1, 1), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _entry()(a.data_ptr(), b.data_ptr(), M, K, N,
                       VARIANTS.index(variant), iters, p.tile_m, p.tile_n,
                       p.chunks, partials.data_ptr(),
                       out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL_NAME} launch ({variant}, {M}x{K}x{N}) "
                           f"failed: CUDA error {err}")
    count("k3.launches")
    return out


count("k3.launches", 0)   # kernel launches, for run accounting


def make_bench(M: int, K: int, N: int, dtype: torch.dtype = torch.float32,
               split: bool = False, iters: int = ITERS,
               device: str | torch.device = "cuda"):
    """(f, a, b) as the reference's make_bench returns them: f is a
    callable on (a, b) that runs the kernel, a = ones((M, K)) float32 and
    b = ones((K, N)) of `dtype`, on `device`."""
    dev = resolve_device(device)
    a = torch.ones((M, K), dtype=torch.float32, device=dev)
    b = torch.ones((K, N), dtype=dtype, device=dev)
    return functools.partial(mxu_micro, dtype=dtype, split=split,
                             iters=iters), a, b


def time_ms(fn, reps: int = 3) -> float:
    """Mean ms of fn() on the card by CUDA events, after one warm call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def run(M: int, K: int, N: int, dtype: torch.dtype = torch.float32,
        split: bool = False, iters: int = ITERS,
        device: str | torch.device = "cuda", out=sys.stdout) -> dict:
    """Time one shape on the card and print the reference's line
    (benchmarks/mxu_micro.py:73-74, which counts one product a step for
    split too) to `out`; returns the numbers, with TFLOP/s counting both
    products of split."""
    f, a, b = make_bench(M, K, N, dtype, split, iters, device)
    ms = time_ms(lambda: f(a, b))
    variant = variant_of(dtype, split)
    flops = 2 * M * K * N * iters
    tag = f"{str(dtype).removeprefix('torch.')}{'+split' if split else ''}"
    print(f"({M:4d},{K:4d})@({K:4d},{N:5d}) {tag:14s} "
          f"{ms * 1e3 / iters:8.3f} us/it  {flops / ms / 1e9:6.2f} TFLOP/s",
          file=out, flush=True)
    return {"M": M, "K": K, "N": N, "variant": variant, "iters": iters,
            "ms": ms, "tflops": operations(M, K, N, variant, iters)
            / ms / 1e9, "bound_ms": bound_ms(M, K, N, variant, iters)}


def bench_shapes():
    """(M, K, N, dtype, split) of every run of the reference's main."""
    dtypes = {"fp32": (torch.float32, False), "bf16": (torch.bfloat16, False),
              "split": (torch.float32, True)}
    return [(M, K, N, *dtypes[v]) for v in VARIANTS for M, K, N in SHAPES[v]]


if __name__ == "__main__":
    print("device:", torch.cuda.get_device_name(0))
    torch.backends.cuda.matmul.allow_tf32 = False
    for shape in bench_shapes():
        run(*shape)
