"""Batched parallel-code-phase-search (PCPS) acquisition in PyTorch.

Port of `bds3_tpu/acquire/pcps.py`.  The host half (settings, the sampled
code tables, `AcqResults`) is a copy of the reference's lines 51-249: the
port imports nothing of the JAX package.  The search itself
runs on the capture's device with `torch.fft`:

- `coarse_search` loops over chunks of Doppler bins (outer) and PRNs
  (inner) and carries the running per-PRN (peak, bin, phase) maxima as
  the reference's `lax.scan` does (pcps.py:296-333), so the whole search
  cube never exists at once;
- `second_peak` is the B2a peak-to-second-peak denominator;
- `fine_search` is one `torch.einsum` against a shared offset-carrier
  matrix (pcps.py:373-421);
- `acquire` computes the metric and every argmax on the device and
  downloads only the per-PRN results.

`torch.argmax`, like `jnp.argmax`, returns the first maximum, so ties
resolve as in the reference.  Above its threshold rate, B1C acquisition
first band-pass decimates the capture (`acquire.resample`, the branch of
pcps.py:437-461): on the card with `torch.fft`, on the CPU with the host
scipy filter, as the reference runs it off its chip.

Under a profiler `acquire`'s stages are spans (`utils/trace.py`):
`acquire.resample`, then of the decimated window `acquire.coarse`,
`acquire.second_peak` (B2a) or `acquire.glrt` (B1C), and `acquire.fine`.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from bds3_tpu_torch.acquire import resample
from bds3_tpu_torch.config import Settings, Signal
from bds3_tpu_torch.signals import sample_chips
from bds3_tpu_torch.signals.b1c import b1c_data_boc11, b1c_pilot_boc11
from bds3_tpu_torch.signals.b2a import b2a_codes_matrix
from bds3_tpu_torch.signals.sampling import sample_chips_floor
from bds3_tpu_torch.track.state import check_settings
from bds3_tpu_torch.utils.device import resolve_device
from bds3_tpu_torch.utils.phase import carrier_table, phase_tables
from bds3_tpu_torch.utils.trace import span


def _pow2_ceil(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


@dataclasses.dataclass(frozen=True)
class AcqConfig:
    """Static (hashable) parameters of one acquisition."""

    signal: Signal
    fs: float
    n_fft: int           # correlation FFT length [samples], power of two
    n_search: int        # code-phase search span (one code period)
    n_coh: int           # coherent local-code length [samples]
    samples_per_code: int
    n_bins: int
    freq_base: float     # first Doppler bin absolute frequency [Hz]
    freq_step: float
    fine_step: float
    fine_bins: int
    fine_span_low: float  # fine grid start relative to coarse freq [Hz]
    fine_noncoh: int      # non-coherent 1-code rounds in fine search
    combine_weighted: bool  # B1C sqrt(11)/sqrt(29) weighting
    bin_chunk: int
    prn_chunk: int
    exclude_chip_samples: int  # B2a second-peak exclusion half-width


@dataclasses.dataclass
class AcqResults:
    """Per-PRN acquisition outputs (0-based code phase in samples)."""

    prns: np.ndarray          # (P,) PRN numbers searched
    carr_freq: np.ndarray     # (P,) acquired carrier freq (IF+Doppler) [Hz]
    code_phase: np.ndarray    # (P,) 0-based sample offset of code start
    peak_metric: np.ndarray   # (P,) detection metric
    detected: np.ndarray      # (P,) bool, metric > threshold
    coarse_freq: np.ndarray   # (P,) coarse-bin frequency [Hz]

    def detected_prns(self) -> np.ndarray:
        return self.prns[self.detected]


def make_acq_config(s: Settings) -> AcqConfig:
    check_settings(s)
    spc = s.samples_per_code
    if s.signal == Signal.B2A:
        n_coh = spc
        fine_bins = int(round(s.acq_step / s.acq_fine_step)) + 1
        fine_span_low = -s.acq_step / 2.0
        fine_noncoh = s.acq_noncoh_rounds
        combine_weighted = False
        bin_chunk, prn_chunk = 13, 16
    else:
        n_coh = int(round(spc / 10 * s.acq_coh_ms))
        fine_bins = 2 * int(round(s.acq_step / s.acq_fine_step)) + 1
        fine_span_low = -s.acq_step
        fine_noncoh = 1
        combine_weighted = True
        bin_chunk, prn_chunk = 3, 8
    # power of two >= one code period of search span plus the coherent
    # window, so every lag in [0, spc) is a full *linear* correlation
    n_fft = _pow2_ceil(spc + n_coh)
    return AcqConfig(
        signal=s.signal,
        fs=s.sampling_freq,
        n_fft=n_fft,
        n_search=spc,
        n_coh=n_coh,
        samples_per_code=spc,
        n_bins=s.num_doppler_bins,
        freq_base=s.intermediate_freq - s.acq_search_band,
        freq_step=s.acq_step,
        fine_step=s.acq_fine_step,
        fine_bins=fine_bins,
        fine_span_low=fine_span_low,
        fine_noncoh=fine_noncoh,
        combine_weighted=combine_weighted,
        bin_chunk=bin_chunk,
        prn_chunk=prn_chunk,
        exclude_chip_samples=int(math.ceil(s.sampling_freq / s.code_freq_basis)) * 2,
    )


def acq_code_tables(s: Settings, prns: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(P, n_coh) int8 sampled data/pilot local codes for the coarse search.

    B2a: one full 1 ms code period (makeB2aDataTable semantics).
    B1C: first acq_coh_ms ms of the 10 ms BOC(1,1) table (makeDataTable).
    """
    cfg = make_acq_config(s)
    d, q = full_code_tables(s, prns)
    return d[:, : cfg.n_coh], q[:, : cfg.n_coh]


def full_code_tables(s: Settings, prns) -> tuple[np.ndarray, np.ndarray]:
    """(P, samples_per_code) int8 full-period ceil-sampled tables (cached:
    re-sampling 63 PRNs at the reference rate costs seconds)."""
    return _full_code_tables_cached(s, tuple(int(p) for p in prns))


@functools.lru_cache(maxsize=8)
def _full_code_tables_cached(s: Settings, prns) -> tuple[np.ndarray, np.ndarray]:
    if s.signal == Signal.B2A:
        data = b2a_codes_matrix(pilot=False)
        pilot = b2a_codes_matrix(pilot=True)
        d = np.stack([
            sample_chips(data[p - 1], s.sampling_freq, s.code_freq_basis,
                         s.samples_per_code) for p in prns
        ])
        q = np.stack([
            sample_chips(pilot[p - 1], s.sampling_freq, s.code_freq_basis,
                         s.samples_per_code) for p in prns
        ])
    else:
        d = np.stack([
            sample_chips(b1c_data_boc11(p), s.sampling_freq,
                         2 * s.code_freq_basis, s.samples_per_code)
            for p in prns
        ])
        q = np.stack([
            sample_chips(b1c_pilot_boc11(p), s.sampling_freq,
                         2 * s.code_freq_basis, s.samples_per_code)
            for p in prns
        ])
    return d.astype(np.int8), q.astype(np.int8)


def fine_code_tables(s: Settings, prns) -> tuple[np.ndarray, np.ndarray]:
    """Local codes for the fine search, (P, fine_noncoh*samples_per_code).

    B1C: the full-period ceil-sampled tables (acquisition.m:257-262).
    B2a: floor-sampled codes tiled over fine_noncoh periods
    (B2a acquisition.m:279-284).
    """
    return _fine_code_tables_cached(s, tuple(int(p) for p in prns))


@functools.lru_cache(maxsize=8)
def _fine_code_tables_cached(s: Settings, prns) -> tuple[np.ndarray, np.ndarray]:
    cfg = make_acq_config(s)
    if s.signal == Signal.B1C:
        return full_code_tables(s, prns)
    data = b2a_codes_matrix(pilot=False)
    pilot = b2a_codes_matrix(pilot=True)
    n = cfg.fine_noncoh * s.samples_per_code
    d = np.stack([
        sample_chips_floor(data[p - 1], s.sampling_freq, s.code_freq_basis, n)
        for p in prns
    ])
    q = np.stack([
        sample_chips_floor(pilot[p - 1], s.sampling_freq, s.code_freq_basis, n)
        for p in prns
    ])
    return d.astype(np.int8), q.astype(np.int8)


@functools.lru_cache(maxsize=8)
def _device_acq_tables(s: Settings, prns: tuple, device: torch.device):
    """(d8, p8, fd, fp) code tables on `device`, uploaded once per
    (settings, PRNs, device).  Each entry holds the tables' device memory
    (about 190 MB at the B2a reference rate) until clear_acq_caches()."""
    d8, p8 = acq_code_tables(s, np.asarray(prns))
    fd, fp = fine_code_tables(s, np.asarray(prns))
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                 for x in (d8, p8, fd, fp))


def clear_acq_caches() -> None:
    """Drop all cached host/device acquisition code tables."""
    _device_acq_tables.cache_clear()
    _full_code_tables_cached.cache_clear()
    _fine_code_tables_cached.cache_clear()


def glrt_noise_power(window) -> float:
    """GLRT denominator sqrt(var(x) * N) (BDS-3_B1C/acquisition.m:150),
    over the complex samples for IQ captures."""
    win = np.asarray(window)
    win = win.astype(np.complex128 if np.iscomplexobj(win) else np.float64)
    return math.sqrt(float(np.var(win).real) * win.shape[0])


def _combine(abs_d: torch.Tensor, abs_p: torch.Tensor,
             cfg: AcqConfig) -> torch.Tensor:
    if cfg.combine_weighted:
        return (abs_d * np.sqrt(11.0) + abs_p * np.sqrt(29.0)) / np.sqrt(40.0)
    return abs_d + abs_p


def _as_float_signal(signal: torch.Tensor) -> torch.Tensor:
    if signal.is_complex():
        return signal.to(torch.complex64)
    return signal.to(torch.float32)


def _code_spectra(codes: torch.Tensor, n_fft: int, n_coh: int) -> torch.Tensor:
    padded = torch.zeros((codes.shape[0], n_fft), dtype=torch.float32,
                         device=codes.device)
    padded[:, :n_coh] = codes[:, :n_coh].to(torch.float32)
    return torch.conj(torch.fft.fft(padded, dim=-1))


def coarse_search(signal: torch.Tensor, data_codes: torch.Tensor,
                  pilot_codes: torch.Tensor, a_bins: torch.Tensor,
                  c1_bins: torch.Tensor, cfg: AcqConfig):
    """Full (PRN x Doppler x phase) search -> per-PRN (peak, bin, phase).

    a_bins/c1_bins: phase tables of the n_bins Doppler bins.  Chunks are
    cut to the real PRN and bin counts; the reference's padding PRNs and
    bins never win, so the results are the same."""
    sig = _as_float_signal(signal[: cfg.n_fft])
    P = data_codes.shape[0]
    dev = sig.device
    cd = _code_spectra(data_codes, cfg.n_fft, cfg.n_coh)
    cp = _code_spectra(pilot_codes, cfg.n_fft, cfg.n_coh)
    best_v = torch.full((P,), -math.inf, dtype=torch.float32, device=dev)
    best_b = torch.zeros(P, dtype=torch.int64, device=dev)
    best_p = torch.zeros(P, dtype=torch.int64, device=dev)
    for b0 in range(0, cfg.n_bins, cfg.bin_chunk):
        b1 = min(b0 + cfg.bin_chunk, cfg.n_bins)
        carr = carrier_table(a_bins[b0:b1], c1_bins[b0:b1], cfg.n_fft)
        mixed = torch.fft.fft(carr * sig[None, :], dim=-1)     # (B, N)
        vals, bins, phases = [], [], []
        for p0 in range(0, P, cfg.prn_chunk):
            p1 = min(p0 + cfg.prn_chunk, P)
            corr_d = torch.fft.ifft(mixed[None] * cd[p0:p1, None, :],
                                    dim=-1).abs()
            corr_p = torch.fft.ifft(mixed[None] * cp[p0:p1, None, :],
                                    dim=-1).abs()
            comb = _combine(corr_d, corr_p, cfg)[:, :, : cfg.n_search]
            flat = comb.reshape(p1 - p0, -1)
            idx = torch.argmax(flat, dim=-1)
            vals.append(flat.gather(1, idx[:, None])[:, 0])
            bins.append(idx // cfg.n_search + b0)
            phases.append(idx % cfg.n_search)
        vals = torch.cat(vals)
        better = vals > best_v
        best_v = torch.where(better, vals, best_v)
        best_b = torch.where(better, torch.cat(bins), best_b)
        best_p = torch.where(better, torch.cat(phases), best_p)
    return best_v, best_b, best_p


def second_peak(signal: torch.Tensor, data_codes: torch.Tensor,
                pilot_codes: torch.Tensor, best_bin: torch.Tensor,
                best_phase: torch.Tensor, a_bins: torch.Tensor,
                c1_bins: torch.Tensor, cfg: AcqConfig) -> torch.Tensor:
    """B2a second-highest peak in the winning Doppler row, excluding +-1
    chip (circularly) around the main peak (B2a acquisition.m:223-249)."""
    sig = _as_float_signal(signal[: cfg.n_fft])
    carr = carrier_table(a_bins[best_bin], c1_bins[best_bin], cfg.n_fft)
    mixed = torch.fft.fft(carr * sig[None, :], dim=-1)       # (P, N)
    row = _combine(
        torch.fft.ifft(mixed * _code_spectra(data_codes, cfg.n_fft, cfg.n_coh),
                       dim=-1).abs(),
        torch.fft.ifft(mixed * _code_spectra(pilot_codes, cfg.n_fft, cfg.n_coh),
                       dim=-1).abs(),
        cfg,
    )[:, : cfg.n_search]
    n = cfg.n_search
    j = torch.arange(n, device=sig.device)[None, :]
    dist = torch.abs(torch.remainder(j - best_phase[:, None] + n // 2, n)
                     - n // 2)
    masked = torch.where(dist >= cfg.exclude_chip_samples, row,
                         torch.full_like(row, -math.inf))
    return masked.max(dim=-1).values


def fine_search(signal: torch.Tensor, fine_data: torch.Tensor,
                fine_pilot: torch.Tensor, code_phase: torch.Tensor,
                a_coarse: torch.Tensor, c1_coarse: torch.Tensor,
                a_off: torch.Tensor, c1_off: torch.Tensor,
                cfg: AcqConfig) -> torch.Tensor:
    """Fine carrier search; returns (P, F) scores.

    f[p, f] = coarse[p] + offset[f], so the carrier factorizes: the
    code-wiped windows are mixed by the per-PRN coarse carrier and
    contracted against one shared (F, seg) offset matrix."""
    spc = cfg.samples_per_code
    n_win = cfg.fine_noncoh * spc
    sig = _as_float_signal(signal)
    # the window start, clamped as the reference's dynamic_slice clamps it
    start = torch.where(code_phase + n_win > sig.shape[0],
                        code_phase - spc, code_phase)
    start = start.clamp(min=0).clamp(max=sig.shape[0] - n_win)
    windows = sig.unfold(0, n_win, 1)[start]                  # (P, n_win)
    if cfg.signal == Signal.B1C:
        windows = windows - windows.mean(dim=-1, keepdim=True)
        seg = n_win
    else:
        seg = spc
    k_rounds = n_win // seg
    carr_c = carrier_table(a_coarse, c1_coarse, n_win)       # (P, n_win)
    offs = carrier_table(a_off, c1_off, seg)                  # (F, seg)
    wm = windows.to(carr_c.dtype) * carr_c

    def score(codes):
        x = (wm * codes.to(torch.float32)).reshape(-1, k_rounds, seg)
        return torch.einsum("pks,fs->pfk", x, offs).abs().sum(dim=-1)

    if cfg.combine_weighted:
        return (score(fine_data) * 11.0 + score(fine_pilot) * 29.0) / 40.0
    return score(fine_data) + score(fine_pilot)


def acquire(signal, settings: Settings, prns=None,
            device: str | torch.device = "cuda") -> AcqResults:
    """Coarse search -> metric -> fine carrier estimate, on `device`.

    `signal` (numpy or a tensor; a tensor already on `device` is not
    copied) must cover n_fft samples plus the fine window (B2a:
    (2+fine_noncoh) ms; B1C: (10+X) ms + one code period), or with
    resampling the receiver's acquisition_signal_length.
    """
    s = settings
    check_settings(s)
    dev = resolve_device(device)
    prns = np.asarray(prns if prns is not None else s.acq_satellite_list)
    if not isinstance(signal, torch.Tensor):
        signal = torch.from_numpy(np.require(signal, requirements=["C", "W"]))
    sig = signal.to(dev)

    if s.resampling and s.sampling_freq > s.resampling_threshold:
        # bandpass-sampling decimation (acquisition.m:52-124); results are
        # mapped back to the original rate (pcps.py:437-461)
        plan = resample.plan_resample(s)
        with span("acquire.resample"):
            if dev.type == "cpu":
                low = torch.from_numpy(
                    resample.resample_signal(sig.numpy(), s, plan))
            else:
                low = resample.resample_signal_device(sig, s, plan)
        s_low = dataclasses.replace(
            s, sampling_freq=plan.new_fs, intermediate_freq=plan.new_if,
            resampling=False)
        return resample.recover_results(acquire(low, s_low, prns, dev), plan)

    cfg = make_acq_config(s)
    d8, p8, fd, fp = _device_acq_tables(s, tuple(int(p) for p in prns), dev)

    with span("acquire.coarse"):
        bin_freqs = cfg.freq_base + cfg.freq_step * np.arange(cfg.n_bins)
        a_bins, c1_bins = (torch.from_numpy(x).to(dev)
                           for x in phase_tables(bin_freqs, cfg.fs))
        best_v, best_b, best_p = coarse_search(sig, d8, p8, a_bins, c1_bins,
                                               cfg)
    if s.signal == Signal.B2A:
        with span("acquire.second_peak"):
            metric = best_v / second_peak(sig, d8, p8, best_b, best_p,
                                          a_bins, c1_bins, cfg)
    else:
        with span("acquire.glrt"):
            metric = best_v / glrt_noise_power(
                sig[: cfg.n_coh].cpu().numpy())

    with span("acquire.fine"):
        best_b_h = best_b.cpu().numpy()
        coarse_freq = cfg.freq_base \
            + cfg.freq_step * best_b_h.astype(np.float64)
        offsets = cfg.fine_span_low \
            + cfg.fine_step * np.arange(cfg.fine_bins)
        a_c, c1_c = (torch.from_numpy(x).to(dev)
                     for x in phase_tables(coarse_freq, cfg.fs))
        a_o, c1_o = (torch.from_numpy(x).to(dev)
                     for x in phase_tables(offsets, cfg.fs))
        scores = fine_search(sig, fd, fp, best_p, a_c, c1_c, a_o, c1_o, cfg)
        best_fine = torch.argmax(scores, dim=-1).cpu().numpy()
    metric = metric.cpu().numpy()
    carr = coarse_freq + offsets[best_fine]
    carr = np.where(carr == 0.0, 1.0, carr)  # acquisition.m:303-305
    return AcqResults(
        prns=prns,
        carr_freq=carr,
        code_phase=best_p.cpu().numpy().astype(np.int64),
        peak_metric=metric,
        detected=metric > s.acq_threshold,
        coarse_freq=coarse_freq,
    )
