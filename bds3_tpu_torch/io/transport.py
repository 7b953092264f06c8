"""Host->device capture transport: bulk upload with optional 4- or 2-bit
packing (port of `bds3_tpu/io/transport.py`).

Packing is host numpy, copied from the reference: `pack_int4` re-quantizes
int8 samples to the 4-bit grid of the reference's own NUT4NT captures and
stores them in planar halves, `pack_int2` to 2-bit sign+magnitude in
planar quarters.  The unpacks are PyTorch elementwise operations on the
packed tensor's device (the reference's are XLA elementwise operations,
not Pallas kernels), so a packed block goes over the wire at half or a
quarter of its bytes and is widened to int8 where tracking reads it.
Float32 and complex64 captures go up as they are, and an IQ8 capture as
its int8 I/Q pairs, widened to complex64 on the device (`IQ8Pairs`,
`widen_iq8`).
"""
from __future__ import annotations

import numpy as np
import torch

from bds3_tpu_torch.utils.device import resolve_device
from bds3_tpu_torch.utils.trace import count

PACKINGS = ("none", "int4", "int2")


def pack_int4(arr: np.ndarray) -> np.ndarray:
    """Pack int8 samples to 4 bits, PLANAR halves: byte j carries sample
    j in its low nibble and sample j + ceil(n/2) in its high nibble.

    Values are clipped to [-8, 7].  Odd-length inputs are zero-padded by
    one sample; `unpack_int4` takes the true length to drop the pad.
    """
    a = np.clip(arr, -8, 7).astype(np.int8)
    half = (len(a) + 1) // 2
    if len(a) % 2:
        a = np.concatenate([a, np.zeros(1, np.int8)])
    nib = a.view(np.uint8) & 0xF
    return (nib[:half] | (nib[half:] << 4)).astype(np.uint8)


def unpack_int4(packed: torch.Tensor, n: int) -> torch.Tensor:
    """`pack_int4` bytes (a uint8 tensor) back to (n,) int8 on their
    device."""
    b = packed.to(torch.uint8)
    # sign-extend each 4-bit two's-complement nibble: (x ^ 8) - 8
    lo = ((b & 0xF) ^ 8).to(torch.int8) - 8
    hi = (((b >> 4) & 0xF) ^ 8).to(torch.int8) - 8
    return torch.cat([lo, hi])[:n]


def pack_int2(arr: np.ndarray, thresh: int = 3) -> np.ndarray:
    """Pack int8 samples to 2-bit sign+magnitude, PLANAR quarters: byte
    j carries samples j, j+q, j+2q, j+3q (q = ceil(n/4)) in bit pairs
    (LSB first).  Code = (sign << 1) | (|x| >= thresh) -> levels
    {-3, -1, +1, +3} on unpack."""
    a = np.asarray(arr, dtype=np.int8)
    q = (len(a) + 3) // 4
    if len(a) != 4 * q:
        a = np.concatenate([a, np.zeros(4 * q - len(a), np.int8)])
    sign = (a < 0).astype(np.uint8)
    mag = (np.abs(a.astype(np.int16)) >= thresh).astype(np.uint8)
    code = (sign << 1) | mag
    return (code[:q] | (code[q:2*q] << 2) | (code[2*q:3*q] << 4)
            | (code[3*q:] << 6)).astype(np.uint8)


def unpack_int2(packed: torch.Tensor, n: int) -> torch.Tensor:
    """`pack_int2` bytes (a uint8 tensor) back to (n,) int8 on their
    device (levels -3, -1, +1, +3)."""
    b = packed.to(torch.uint8)
    quarters = []
    for k in range(4):
        code = ((b >> (2 * k)) & 3).to(torch.int8)
        mag = code & 1
        sign = (code >> 1) & 1
        quarters.append((1 - 2 * sign) * (1 + 2 * mag))
    return torch.cat(quarters)[:n]


def capture_dtype(dtype) -> np.dtype:
    """The dtype a capture of `dtype` (numpy's or torch's) is tracked in:
    int8 and float32 as they are, other real dtypes as float32
    (bds3_tpu/track/driver.py:333-334), complex ones as complex64."""
    if isinstance(dtype, torch.dtype):
        if dtype == torch.int8:
            return np.dtype(np.int8)
        return np.dtype(np.complex64 if dtype.is_complex else np.float32)
    dtype = np.dtype(dtype)
    if dtype == np.int8:
        return dtype
    if dtype.kind == "c":
        return np.dtype(np.complex64)
    if dtype.kind in "biuf":
        return np.dtype(np.float32)
    raise TypeError(f"a capture of dtype {dtype} holds no samples")


def check_packing(packing: str, kind: str = "int8") -> None:
    """ValueError unless `packing` is one of PACKINGS and applies to a
    capture of `kind` (its capture_dtype's name, or "IQ8"): "int4" and
    "int2" re-quantize real int8 samples, so they take int8 captures only.
    The reference ignores the packing of such blocks
    (bds3_tpu/track/driver.py:335-337) or truncates them to int8
    (bds3_tpu/io/transport.py:100)."""
    if packing not in PACKINGS:
        raise ValueError(f"unknown transport packing {packing!r}: expected "
                         f"one of {PACKINGS}")
    if packing != "none" and kind != "int8":
        raise ValueError(f"transport packing {packing!r} re-quantizes real "
                         f"int8 samples, and this capture is {kind}: it is "
                         "uploaded as it is (transport 'none')")


def widen_iq8(pairs: torch.Tensor) -> torch.Tensor:
    """(n, 2) int8 I/Q pairs to the (n,) complex64 capture I + jQ, on
    their device (bds3_tpu/receiver.py:87-92 widens them on the host)."""
    return torch.complex(pairs[:, 0].to(torch.float32),
                         pairs[:, 1].to(torch.float32))


class IQ8Pairs:
    """An IQ8 capture's (N, 2) int8 I/Q pairs (an `IFDataFile`'s memmap, an
    array) read as a 1-D complex64 host source: a slice is widened on the
    host (acquisition's window), while the per-block tracking path and
    `upload_capture` send `raw` as it is, 2 bytes a sample instead of 8,
    and widen it on the device (`upload`)."""

    dtype = np.dtype(np.complex64)

    def __init__(self, raw: np.ndarray):
        if raw.ndim != 2 or raw.shape[1] != 2 or raw.dtype != np.int8:
            raise ValueError(f"IQ8 pairs are (N, 2) int8, not {raw.shape} "
                             f"{raw.dtype}")
        self.raw = raw

    def __len__(self) -> int:
        return self.raw.shape[0]

    @property
    def shape(self) -> tuple:
        return (len(self),)

    def __getitem__(self, key: slice) -> np.ndarray:
        w = np.asarray(self.raw[key])
        out = np.empty(w.shape[0], np.complex64)
        out.real, out.imag = w[:, 0], w[:, 1]
        return out


def read_host(signal, start: int, stop: int) -> np.ndarray:
    """signal[start:stop] as the contiguous host array `upload` takes: the
    capture_dtype of a 1-D source, or an IQ8Pairs' raw (n, 2) int8."""
    if isinstance(signal, IQ8Pairs):
        return np.ascontiguousarray(signal.raw[start:stop])
    return np.ascontiguousarray(signal[start:stop],
                                dtype=capture_dtype(signal.dtype))


def upload(host: np.ndarray, packing: str,
           device: torch.device) -> torch.Tensor:
    """One contiguous host array (`read_host`'s) to its (len(host),)
    capture on `device`: int8 packed on the host and unpacked there for
    "int4" and "int2"; float32 and complex64 as they are; (n, 2) int8
    IQ8 pairs as they are, widened there to complex64."""
    n = len(host)
    pairs = host.ndim == 2
    check_packing(packing, "IQ8" if pairs else str(host.dtype))
    if packing == "int4":
        return unpack_int4(_send(pack_int4(host), device), n)
    if packing == "int2":
        return unpack_int2(_send(pack_int2(host), device), n)
    # a writeable host copy only where the source is not (a read-only
    # memmap of a capture file)
    t = _send(np.require(host, requirements=["W"]), device)
    return widen_iq8(t) if pairs else t


def _send(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """`host` copied to `device`, its bytes counted in `upload.h2d_bytes`."""
    count("upload.h2d_bytes", host.nbytes)
    return torch.from_numpy(host).to(device)


def upload_capture(signal, packing: str = "none",
                   device: str | torch.device = "cuda") -> torch.Tensor:
    """Upload a capture (ndarray, memmap, StreamingCapture, IQ8Pairs) to
    `device` as one bulk transfer; returns its 1-D tensor there: int8,
    float32 or complex64 (capture_dtype), never truncated to int8 as the
    reference's is (bds3_tpu/io/transport.py:100).  An (N, 2) int8 array
    is taken as IQ8 pairs: they go up as int8 and are widened there.

    packing="int4" or "int2" (int8 captures only): re-quantize on the
    host, ship a half or a quarter of the bytes, unpack on the device.
    """
    if isinstance(signal, np.ndarray) and signal.ndim == 2:
        signal = IQ8Pairs(signal)
    return upload(read_host(signal, 0, len(signal)), packing,
                  resolve_device(device))
