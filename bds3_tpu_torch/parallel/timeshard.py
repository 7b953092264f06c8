"""Time-axis sharding of acquisition: non-coherent PCPS accumulation over
many code periods, with the IF stream split across ranks and each
correlation window's tail fetched from the right-hand neighbour (the
overlap-save halo exchange).

Port of `bds3_tpu/parallel/timeshard.py`.  The full (Doppler x
code-phase) search integrates non-coherently across
K = rounds_per_device * n_ranks code periods, giving cold-start
sensitivity for weak signals while each rank touches only its slice of
the sample stream.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from bds3_tpu_torch.acquire.pcps import (
    _code_spectra,
    acq_code_tables,
    make_acq_config,
)
from bds3_tpu_torch.config import Settings
from bds3_tpu_torch.parallel.mesh import Mesh, all_sum, shift
from bds3_tpu_torch.utils.phase import carrier_table, phase_tables


def _segment(signal, lo: int, hi: int, dev: torch.device) -> torch.Tensor:
    """signal[lo:hi] (numpy or a tensor) as float32 on dev; the cast keeps
    a complex capture's real part, as the reference's does."""
    x = signal[lo:hi]
    if isinstance(x, torch.Tensor):
        return x.to(dev, torch.float32)
    return torch.from_numpy(np.asarray(x).astype(np.float32)).to(dev)


def noncoherent_acquire_timesharded(
    mesh: Mesh,
    signal,
    settings: Settings,
    prns,
    rounds_per_device: int,
    axis: str = "channel",
):
    """Time-sharded deep non-coherent search.

    Rank d holds rounds_per_device code periods from sample
    d * rounds_per_device * samples_per_code and the first
    n_fft - samples_per_code samples of its right neighbour's; the last
    rank's rounds whose window would wrap into rank 0's are left out.
    The (P, B, n_search) float32 cubes are summed over the ranks.
    Returns (metric cube as numpy, best frequency, best phase) per PRN
    on every rank.  signal (numpy or a tensor) must cover
    n_ranks * rounds_per_device code periods.
    """
    cfg = make_acq_config(settings)
    n_dev = mesh.shape[axis]
    spc = cfg.samples_per_code
    seg = rounds_per_device * spc
    halo_len = cfg.n_fft - spc
    if seg < halo_len:
        raise ValueError(
            f"rounds_per_device * samples_per_code ({seg}) must cover the "
            f"halo ({halo_len}): neighbors only hold one segment"
        )
    total = n_dev * seg
    if len(signal) < total:
        raise ValueError(f"signal too short for the requested rounds: need "
                         f"{total} samples, have {len(signal)}")
    d = mesh.index(axis)
    dev = mesh.device
    local = _segment(signal, d * seg, (d + 1) * seg, dev)
    # the start of the right neighbour's segment (wraps at the end; the
    # wrapped rounds are left out below)
    ext = torch.cat([local, shift(mesh, local[:halo_len], axis, -1)])

    prns = np.asarray(prns)
    d8, p8 = (torch.from_numpy(x).to(dev)
              for x in acq_code_tables(settings, prns))
    spec_d = _code_spectra(d8, cfg.n_fft, cfg.n_coh)   # (P, n_fft)
    spec_p = _code_spectra(p8, cfg.n_fft, cfg.n_coh)
    n_bins = settings.num_doppler_bins
    freqs = cfg.freq_base + cfg.freq_step * np.arange(n_bins)
    a_b, c1_b = (torch.from_numpy(x).to(dev)
                 for x in phase_tables(freqs, cfg.fs))
    carr = carrier_table(a_b, c1_b, cfg.n_fft)          # (B, n_fft)

    n_mask = math.ceil(halo_len / spc)
    is_last = d == n_dev - 1
    cube = torch.zeros((len(prns), n_bins, cfg.n_search), dtype=torch.float32,
                       device=dev)
    for r in range(rounds_per_device):
        if is_last and r >= rounds_per_device - n_mask:
            continue    # its window crosses into the wrapped halo
        win = ext[r * spc: r * spc + cfg.n_fft]
        mixed = torch.fft.fft(carr * win[None, :], dim=-1)       # (B, N)
        # PRNs in chunks, as coarse_search takes them: one chunk's
        # products and inverse transforms are (chunk, B, n_fft) complex64
        for p0 in range(0, len(prns), cfg.prn_chunk):
            p1 = min(p0 + cfg.prn_chunk, len(prns))
            corr_d = torch.fft.ifft(mixed[None] * spec_d[p0:p1, None, :],
                                    dim=-1).abs()[:, :, : cfg.n_search]
            corr_p = torch.fft.ifft(mixed[None] * spec_p[p0:p1, None, :],
                                    dim=-1).abs()[:, :, : cfg.n_search]
            cube[p0:p1] += corr_d + corr_p
    cube = all_sum(mesh, cube, axis).cpu().numpy()
    flat = cube.reshape(len(prns), -1)
    best = flat.argmax(axis=1)
    best_bin = best // cfg.n_search
    best_phase = best % cfg.n_search
    best_freq = cfg.freq_base + cfg.freq_step * best_bin
    return cube, best_freq, best_phase
