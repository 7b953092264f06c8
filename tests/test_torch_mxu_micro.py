"""K3, the matrix-throughput microbenchmark: the port's plain version
(bds3_tpu_torch/benchmarks/mxu_micro.py:mxu_micro_reference) against the
JAX Pallas kernel (benchmarks/mxu_micro.py:make_bench) in interpret mode,
for every variant, on seeded normal inputs; and the wrapper's host-side
geometry.  The CUDA kernel itself is held to the plain version on the card
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


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_grid_covers_the_output(variant):
    """One partial per block of the kernel's tile: the fewest tiles that
    cover every (m, n) of each shape."""
    tm, tn = mxu_micro.TILES[variant]
    for M, K, N in mxu_micro.SHAPES["fp32"]:
        n = mxu_micro.grid(M, N, variant)
        assert n == -(-M // tm) * -(-N // tn)
        assert n * tm * tn >= M * N


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
