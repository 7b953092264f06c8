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
