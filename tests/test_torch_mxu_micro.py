"""K3, the matrix-throughput microbenchmark: the port's plain version
(bds3_tpu_torch/benchmarks/mxu_micro.py:mxu_micro_reference) against the
JAX Pallas kernel (benchmarks/mxu_micro.py:make_bench) in interpret mode,
for every variant, on seeded normal inputs; the wrapper's host-side
planner; and chip_smoke's one-call yardstick.  The CUDA kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""
import functools

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from benchmarks import mxu_micro as ref_mxu
from bds3_tpu_torch.benchmarks import mxu_micro

ITERS = 4
TOL = 1e-5   # of ITERS * sum |a| |b| (float64)
VARIANTS = {"fp32": (np.float32, torch.float32, False),
            "bf16": ("bfloat16", torch.bfloat16, False),
            "split": (np.float32, torch.float32, True)}


def _inputs(M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, K)).astype(np.float32),
            rng.standard_normal((K, N)).astype(np.float32))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("shape", [(8, 128, 512), (32, 128, 512),
                                   (128, 128, 128)],
                         ids=lambda s: "x".join(map(str, s)))
def test_reference_matches_pallas_interpret(monkeypatch, shape, variant):
    """The JAX kernel, unedited, with pallas_call in interpret mode and
    ITERS = 4, against mxu_micro_reference on the same seeded inputs:
    within 1e-5 of ITERS * sum |a||b|.  Normal inputs, not the
    reference's ones, so a transposed operand would show."""
    import jax.numpy as jnp

    monkeypatch.setattr(ref_mxu.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(ref_mxu, "ITERS", ITERS)
    M, K, N = shape
    jdt, tdt, split = VARIANTS[variant]
    a, b = _inputs(M, K, N)
    jax_dtype = jnp.bfloat16 if jdt == "bfloat16" else jnp.float32
    f, _, _ = ref_mxu.make_bench(M, K, N, jax_dtype, split)
    want = float(np.asarray(f(jnp.asarray(a), jnp.asarray(b, jax_dtype)),
                            np.float64)[0, 0])
    b_t = torch.from_numpy(b).to(tdt)
    got = mxu_micro.mxu_micro_reference(torch.from_numpy(a), b_t, tdt,
                                        split, ITERS)
    assert got.shape == (1, 1) and got.dtype == torch.float32
    scale = mxu_micro.abs_scale(torch.from_numpy(a), b_t, ITERS)
    assert abs(float(got) - want) <= TOL * scale, (float(got), want, scale)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_wrapper_on_cpu_is_the_plain_version(variant):
    """mxu_micro on CPU tensors runs mxu_micro_reference, and counts no
    kernel launch."""
    _, tdt, split = VARIANTS[variant]
    a, b = _inputs(16, 32, 24, seed=1)
    a_t, b_t = torch.from_numpy(a), torch.from_numpy(b).to(tdt)
    before = mxu_micro.mxu_micro.launches
    got = mxu_micro.mxu_micro(a_t, b_t, tdt, split, iters=3)
    want = mxu_micro.mxu_micro_reference(a_t, b_t, tdt, split, 3)
    assert torch.equal(got, want)
    assert mxu_micro.mxu_micro.launches == before


def test_shapes_are_the_reference_mains():
    """bench_shapes lists the reference's main (benchmarks/mxu_micro.py:
    80-89) in its order, and every shape fits the kernel (K a multiple of
    16, at most 256)."""
    assert [s[:3] for s in mxu_micro.bench_shapes()] == (
        mxu_micro.SHAPES["fp32"] + mxu_micro.SHAPES["bf16"]
        + mxu_micro.SHAPES["split"])
    assert len(mxu_micro.bench_shapes()) == 15
    for M, K, N, _, _ in mxu_micro.bench_shapes():
        assert K % 16 == 0 and K <= mxu_micro.MAX_K


@pytest.mark.parametrize("iters", [0, 1, 37, 2000])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_grid_covers_the_output(variant, iters):
    """The planner, at every shape of the reference in every variant: its
    tiles cover every (m, n) once (and none lies wholly outside), its
    chunks partition [0, iters), one partial per (tile, chunk), and at
    least one block per SM wherever iters allows it."""
    for M, K, N in sum(mxu_micro.SHAPES.values(), []):
        p = mxu_micro.plan(M, N, variant, iters)
        if variant != "fp32":
            assert (p.tile_m, p.tile_n) == mxu_micro.WGMMA_TILE
        else:
            assert (p.tile_m, p.tile_n) in mxu_micro.FP32_TILES
            assert p.tile_m <= max(M, 8)   # no wasted rows at M = 8, 16
        covered = np.zeros((p.tiles_m * p.tile_m, p.tiles_n * p.tile_n),
                           np.int64)
        for tm in range(p.tiles_m):
            for tn in range(p.tiles_n):
                assert tm * p.tile_m < M and tn * p.tile_n < N
                covered[tm * p.tile_m:(tm + 1) * p.tile_m,
                        tn * p.tile_n:(tn + 1) * p.tile_n] += 1
        assert np.all(covered[:M, :N] == 1)
        bounds = p.chunk_bounds(iters)
        assert bounds[0][0] == 0 and bounds[-1][1] == iters
        assert all(lo <= hi for lo, hi in bounds)
        assert all(bounds[c][1] == bounds[c + 1][0]
                   for c in range(len(bounds) - 1))
        assert p.blocks == p.tiles * p.chunks
        assert p.chunks >= 1 and p.chunks <= max(iters, 1)
        if iters >= mxu_micro.SMS:
            assert p.blocks >= mxu_micro.SMS


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_one_call_yardstick_is_the_function(variant):
    """chip_smoke's yardstick, one torch.mm over [a_0 | a_1 | ...] and b
    repeated along K, against mxu_micro_reference at ITERS iterations:
    within 1e-5 of ITERS * sum |a||b| (bf16 widened exactly to float32 on
    the CPU)."""
    import chip_smoke

    _, tdt, split = VARIANTS[variant]
    a, b = _inputs(16, 32, 24, seed=2)
    a_t, b_t = torch.from_numpy(a), torch.from_numpy(b).to(tdt)
    a_cat, b_rep = chip_smoke.mxu_one_call_operands(a_t, b_t, variant, ITERS)
    parts = 2 if variant == "split" else 1
    assert a_cat.shape == (16, parts * ITERS * 32)
    assert b_rep.shape == (parts * ITERS * 32, 24)
    mode = chip_smoke.mxu_one_call_mode(variant, torch.device("cpu"))
    assert mode == ("float32" if variant == "fp32" else "widened")
    got = float(chip_smoke.mxu_one_call(a_cat, b_rep, mode))
    want = float(mxu_micro.mxu_micro_reference(a_t, b_t, tdt, split, ITERS))
    scale = mxu_micro.abs_scale(a_t, b_t, ITERS)
    assert abs(got - want) <= TOL * scale, (got, want, scale)


def test_bound_counts_both_products_of_split():
    """K3's bound: 2 M K N iters operations (twice for split) at the
    variant's dense peak."""
    ops = mxu_micro.operations(128, 128, 1024, "bf16")
    assert ops == 2.0 * 128 * 128 * 1024 * 2000
    assert mxu_micro.operations(128, 128, 1024, "split") == 2 * ops
    assert mxu_micro.bound_ms(128, 128, 1024, "bf16") == pytest.approx(
        ops / 989e12 * 1e3)
    assert mxu_micro.bound_ms(128, 128, 1024, "fp32") == pytest.approx(
        ops / 67e12 * 1e3)


def test_make_bench_keeps_the_reference_interface():
    """make_bench returns (f, ones a, ones b) like the reference's; on the
    CPU f is the plain version, and on all-ones inputs every product entry
    is K (+ the tiny offset)."""
    f, a, b = mxu_micro.make_bench(8, 16, 8, torch.float32, iters=2,
                                   device="cpu")
    assert a.shape == (8, 16) and b.shape == (16, 8)
    assert torch.all(a == 1) and torch.all(b == 1)
    got = float(f(a, b))
    assert got == pytest.approx(2 * 8 * 8 * 16, rel=1e-6)
