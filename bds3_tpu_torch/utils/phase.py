"""Precision-safe local-carrier synthesis (port of `bds3_tpu/utils/phase.py`).

Computing 2*pi*f*t directly in float32 is catastrophically wrong for GNSS
spans: f ~ 1.5e7 Hz, t up to 20 ms gives phases ~ 3e5 cycles, where float32
resolution is ~0.03 cycles.  The phase is reduced modulo one cycle before
the rounding can hurt:

  cycles(n) = n * a mod 1,   a = f / fs mod 1  (host float64)

is evaluated as  (k * c1 + r * a) mod 1  with n = 4096*k + r and
c1 = (4096 * a) mod 1 precomputed in float64 on the host.
"""
from __future__ import annotations

import numpy as np
import torch

_SPLIT = 4096


def phase_tables(freqs_hz: np.ndarray, fs: float) -> tuple[np.ndarray, np.ndarray]:
    """Host-side float64 reduction of per-sample cycle increments.

    Returns (a, c1) float32 arrays shaped like freqs_hz.
    """
    a = np.mod(np.asarray(freqs_hz, dtype=np.float64) / fs, 1.0)
    c1 = np.mod(_SPLIT * a, 1.0)
    return a.astype(np.float32), c1.astype(np.float32)


def carrier_table(a: torch.Tensor, c1: torch.Tensor, n: int,
                  sign: float = -1.0) -> torch.Tensor:
    """e^{sign * j*2*pi*f*t} for t = (0..n-1)/fs, complex64, on a's device.

    a, c1: float32 tensors from phase_tables, any leading batch shape; the
    result has shape a.shape + (n,).  `torch.remainder` is a floor-mod,
    as `jnp.mod` is, so negative phases wrap into [0, 1).
    """
    idx = torch.arange(n, dtype=torch.int32, device=a.device)
    k = (idx // _SPLIT).to(torch.float32)
    r = (idx % _SPLIT).to(torch.float32)
    cyc = torch.remainder(a[..., None] * r + c1[..., None] * k, 1.0)
    ang = (2.0 * np.pi * sign) * cyc
    return torch.complex(torch.cos(ang), torch.sin(ang))
