"""Host->device capture transport: bulk upload with optional 4- or 2-bit
packing (port of `bds3_tpu/io/transport.py`).

Packing is host numpy, copied from the reference: `pack_int4` re-quantizes
int8 samples to the 4-bit grid of the reference's own NUT4NT captures and
stores them in planar halves, `pack_int2` to 2-bit sign+magnitude in
planar quarters.  The unpacks are PyTorch elementwise operations on the
packed tensor's device (the reference's are XLA elementwise operations,
not Pallas kernels), so a packed block goes over the wire at half or a
quarter of its bytes and is widened to int8 where tracking reads it.
"""
from __future__ import annotations

import numpy as np
import torch

from bds3_tpu_torch.utils.device import resolve_device

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


def upload(host: np.ndarray, packing: str,
           device: torch.device) -> torch.Tensor:
    """One contiguous int8 host array to (len(host),) int8 on `device`:
    packed on the host and unpacked there for "int4" and "int2"."""
    n = len(host)
    if packing == "int4":
        return unpack_int4(torch.from_numpy(pack_int4(host)).to(device), n)
    if packing == "int2":
        return unpack_int2(torch.from_numpy(pack_int2(host)).to(device), n)
    if packing != "none":
        raise ValueError(f"unknown packing {packing!r}")
    # a writeable host copy only where the source is not (a read-only
    # memmap of a capture file)
    return torch.from_numpy(np.require(host, requirements=["W"])).to(device)


def upload_capture(signal, packing: str = "none",
                   device: str | torch.device = "cuda") -> torch.Tensor:
    """Upload an int8 capture (ndarray, memmap or StreamingCapture) to
    `device` as one bulk transfer; returns an int8 tensor there.

    packing="int4" or "int2": re-quantize on the host, ship a half or a
    quarter of the bytes, unpack on the device.
    """
    if packing not in PACKINGS:
        raise ValueError(f"unknown packing {packing!r}")
    n = len(signal)
    host = signal[0:n] if not isinstance(signal, np.ndarray) else signal
    host = np.ascontiguousarray(host, dtype=np.int8)
    return upload(host, packing, resolve_device(device))
