"""bds3_tpu_torch.io.transport against bds3_tpu.io.transport on the CPU:
the host packings are byte for byte the reference's, and the torch unpacks
and upload_capture give exactly the reference's int8 samples, at even and
odd lengths."""
import numpy as np
import pytest
import torch

from bds3_tpu.io import transport as ref_tx
from bds3_tpu_torch.io import transport as port_tx

N = 10_001


def _samples(n, seed=0):
    rng = np.random.default_rng(seed)
    # the whole int8 range, so clipping and the int2 threshold are hit
    return rng.integers(-128, 128, n).astype(np.int8)


PACKS = {"int4": (port_tx.pack_int4, port_tx.unpack_int4, ref_tx.pack_int4,
                  ref_tx.unpack_int4),
         "int2": (port_tx.pack_int2, port_tx.unpack_int2, ref_tx.pack_int2,
                  ref_tx.unpack_int2)}


@pytest.mark.parametrize("extra", [0, 1, 2, 3])
@pytest.mark.parametrize("packing", sorted(PACKS))
def test_unpack_equals_reference(packing, extra):
    """n, n+1, n+2 and n+3 samples (every residue of the planar halves and
    quarters): the same packed bytes, and the torch unpack equals the JAX
    unpack sample for sample."""
    pack, unpack, ref_pack, ref_unpack = PACKS[packing]
    a = _samples(N + extra, seed=extra)
    packed = pack(a)
    np.testing.assert_array_equal(packed, ref_pack(a))
    got = unpack(torch.from_numpy(packed), len(a))
    assert got.dtype == torch.int8 and got.shape == (len(a),)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref_unpack(packed, len(a))))


def test_int4_roundtrip_is_exact_in_range():
    a = np.arange(-8, 8, dtype=np.int8)
    got = port_tx.unpack_int4(torch.from_numpy(port_tx.pack_int4(a)), len(a))
    np.testing.assert_array_equal(got.numpy(), a)


def test_int2_levels():
    """thresh=3: |x| < 3 -> +-1, |x| >= 3 -> +-3; zero maps to +1
    (tests/test_transport.py's case)."""
    a = np.array([0, 1, 2, 3, 4, -1, -3, -8, 7], dtype=np.int8)
    got = port_tx.unpack_int2(torch.from_numpy(port_tx.pack_int2(a)), len(a))
    assert got.tolist() == [1, 1, 1, 3, 3, -1, -3, -3, 3]


@pytest.mark.parametrize("packing", ["none", "int4", "int2"])
@pytest.mark.parametrize("source", ["ndarray", "memmap"])
def test_upload_capture_equals_reference(tmp_path, packing, source):
    a = _samples(N, seed=7)
    if source == "memmap":
        a.tofile(tmp_path / "cap.bin")
        a = np.memmap(tmp_path / "cap.bin", dtype=np.int8, mode="r")
    got = port_tx.upload_capture(a, packing, device="cpu")
    assert got.dtype == torch.int8 and got.device.type == "cpu"
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_tx.upload_capture(a, packing)))


def test_upload_capture_refuses_unknown_packing():
    with pytest.raises(ValueError):
        port_tx.upload_capture(_samples(100), "zstd", device="cpu")


def test_upload_capture_refuses_cuda_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        port_tx.upload_capture(_samples(100), "int4", device="cuda")


@pytest.mark.parametrize("dtype", [np.float32, np.complex64, np.int16])
def test_upload_capture_keeps_float_and_complex(dtype):
    """float32 and complex64 captures go up as they are (the reference
    truncates every capture to int8, bds3_tpu/io/transport.py:100); other
    real dtypes as float32, as the reference's per-block path casts them."""
    rng = np.random.default_rng(3)
    a = (rng.standard_normal(N) * 7.3).astype(dtype)
    if dtype == np.complex64:
        a = a + 1j * (rng.standard_normal(N) * 5.1).astype(np.float32)
    got = port_tx.upload_capture(a, "none", device="cpu")
    want = a.astype(port_tx.capture_dtype(a.dtype))
    assert got.dtype == {np.float32: torch.float32, np.int16: torch.float32,
                         np.complex64: torch.complex64}[dtype]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("source", ["ndarray", "pairs", "slice"])
def test_iq8_pairs_widen_to_complex64(source):
    """An IQ8 capture's (N, 2) int8 pairs go up as int8 and are widened
    where they land: raw[:, 0] + 1j * raw[:, 1], as the reference widens
    them on the host (bds3_tpu/receiver.py:87-92); IQ8Pairs' host slices
    widen the same way."""
    raw = _samples(2 * N, seed=4).reshape(N, 2)
    want = (raw[:, 0].astype(np.float32)
            + 1j * raw[:, 1].astype(np.float32)).astype(np.complex64)
    if source == "slice":
        got = port_tx.IQ8Pairs(raw)[123:4567]
        assert got.dtype == np.complex64
        np.testing.assert_array_equal(got, want[123:4567])
        return
    src = raw if source == "ndarray" else port_tx.IQ8Pairs(raw)
    got = port_tx.upload_capture(src, "none", device="cpu")
    assert got.dtype == torch.complex64 and got.shape == (N,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("packing", ["int4", "int2"])
def test_packing_refuses_float_complex_and_pairs(packing):
    """int4 and int2 re-quantize real int8 samples; a float, complex or
    IQ8 capture raises a ValueError naming the packing."""
    for a in (np.zeros(100, np.float32), np.zeros(100, np.complex64),
              np.zeros((100, 2), np.int8)):
        with pytest.raises(ValueError, match=f"packing '{packing}'"):
            port_tx.upload_capture(a, packing, device="cpu")
