"""Native (C++) IF-capture IO with transparent numpy fallback.

The shared library is built on first use (`make` in this directory); if
the toolchain is unavailable every entry point falls back to an
equivalent vectorized numpy implementation, so the package stays
importable anywhere.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_DIR, "libbds3io.so")
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if not os.path.exists(_LIB_PATH):
            subprocess.run(["make", "-C", _DIR], check=True,
                           capture_output=True, timeout=120)
        lib = ctypes.CDLL(_LIB_PATH)
        lib.bds3_pread_block.restype = ctypes.c_int64
        lib.bds3_file_size.restype = ctypes.c_int64
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def has_native() -> bool:
    return _load() is not None


def unpack_nut4nt(packed: np.ndarray) -> np.ndarray:
    """Packed 2-bit NUT4NT bytes -> int8 I/Q stream (4 samples per byte,
    order I1,Q1,I2,Q2; parity with unpack_cplx.m:32-47)."""
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    out = np.empty(4 * packed.size, dtype=np.int8)
    lib = _load()
    if lib is not None:
        lib.bds3_unpack_nut4nt(
            packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int64(packed.size),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        )
        return out
    # numpy fallback via the same LUT construction
    v = np.arange(256, dtype=np.uint8)
    lo, hi = v & 15, v >> 4

    def i_of(nib):
        return ((1 + 2 * ((nib >> 2) & 1)) * (1 - 2 * (nib & 1))).astype(np.int8)

    def q_of(nib):
        return ((1 + 2 * ((nib >> 3) & 1)) * (1 - 2 * ((nib >> 1) & 1))).astype(np.int8)

    out[0::4] = i_of(lo)[packed]
    out[1::4] = q_of(lo)[packed]
    out[2::4] = i_of(hi)[packed]
    out[3::4] = q_of(hi)[packed]
    return out


def deinterleave_iq(data: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """I0,Q0,I1,Q1,... int8 -> (I, Q) int8 arrays."""
    data = np.ascontiguousarray(data, dtype=np.int8)
    n = data.size // 2
    lib = _load()
    if lib is not None:
        i_out = np.empty(n, dtype=np.int8)
        q_out = np.empty(n, dtype=np.int8)
        lib.bds3_deinterleave_iq(
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            ctypes.c_int64(n),
            i_out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            q_out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        )
        return i_out, q_out
    pairs = data[: 2 * n].reshape(-1, 2)
    return pairs[:, 0].copy(), pairs[:, 1].copy()


def pread_block(path: str, offset: int, n: int) -> np.ndarray:
    """Read n bytes at byte offset with kernel readahead hints."""
    lib = _load()
    if lib is not None:
        out = np.empty(n, dtype=np.int8)
        got = lib.bds3_pread_block(
            path.encode(), ctypes.c_int64(offset), ctypes.c_int64(n),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        )
        if got < 0:
            raise OSError(f"bds3_pread_block failed ({got}) for {path}")
        return out[:got]
    with open(path, "rb") as f:
        f.seek(offset)
        return np.frombuffer(f.read(n), dtype=np.int8).copy()


def file_size(path: str) -> int:
    lib = _load()
    if lib is not None:
        return int(lib.bds3_file_size(path.encode()))
    return os.path.getsize(path)
