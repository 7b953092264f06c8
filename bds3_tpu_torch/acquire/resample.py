"""Band-pass-sampling decimation for acquisition (port of
`bds3_tpu/acquire/resample.py`).

Parity with the reference's resampling strategy
(`BDS-3_B2a/acquisition.m:52-124`, identical in the B1C variant): filter
the IF capture to the code main lobe (zero-phase FIR), pick a bandpass
sampling frequency from the acceptable range, nearest-index decimate, and
alias the IF down.  The recovery of the original-rate code phase and
carrier frequency mirrors the reference's "downsampling recovery"
(acquisition.m:337-356).

`plan_resample`, `resample_signal` (host scipy) and `recover_results` are
the reference's, copied.  `resample_signal_device` runs the same filter on
the capture's device with `torch.fft`: the zero-phase filtfilt of a
symmetric FIR equals, away from its boundary transient, one convolution
with the kernel's autocorrelation conv(b, b), done here as a
power-of-two-length rfft product (cuFFT on the card), then a gather at the
nearest-index positions.  The reference's counterpart is an XLA FFT
convolution, not a Pallas kernel.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from scipy import signal as sp_signal

from bds3_tpu_torch.config import Settings


@dataclasses.dataclass
class ResamplePlan:
    old_fs: float
    old_if: float
    new_fs: float
    new_if: float


def plan_resample(s: Settings) -> ResamplePlan | None:
    """Bandpass-sampling plan (acquisition.m:74-122), or None if the
    sampling rate is already below the threshold."""
    bw = s.code_freq_basis * 2 + 0.5e6
    fu = s.intermediate_freq + bw / 2
    n = max(int(np.floor(fu / bw)), 1)
    lower = 2 * fu / n
    fl = s.intermediate_freq - bw / 2
    upper = 2 * fl / (n - 1) if n > 1 else lower
    new_fs = float(np.ceil((lower + upper) / 2))
    new_if = float(np.fmod(s.intermediate_freq, new_fs))
    return ResamplePlan(s.sampling_freq, s.intermediate_freq, new_fs, new_if)


def _bandpass_taps(s: Settings, plan: ResamplePlan) -> np.ndarray:
    """The reference's 701-tap band-pass FIR around the IF."""
    fs = plan.old_fs
    bw = s.code_freq_basis * 2 + 0.5e6
    w1 = (plan.old_if - bw / 2) * 2 / fs - 0.002
    w2 = (plan.old_if + bw / 2) * 2 / fs + 0.002
    return sp_signal.firwin(701, [max(w1, 1e-6), min(w2, 1 - 1e-6)],
                            pass_zero=False)


def _decimation_indices(n_in: int, plan: ResamplePlan) -> np.ndarray:
    """Nearest-index decimation positions (acquisition.m:104-115)."""
    n_out = int(np.floor((n_in - 1) / plan.old_fs * plan.new_fs))
    idx = np.ceil(np.arange(n_out) / plan.new_fs * plan.old_fs) \
        .astype(np.int64)
    idx[0] = 0
    return idx


def resample_signal(signal: np.ndarray, s: Settings,
                    plan: ResamplePlan) -> np.ndarray:
    """Zero-phase band-pass filter + nearest-index decimation
    (acquisition.m:59-115), on the host."""
    b = _bandpass_taps(s, plan)
    filtered = sp_signal.filtfilt(b, [1.0], np.asarray(signal, np.float64))
    return filtered[_decimation_indices(len(signal), plan)] \
        .astype(np.float32)


def resample_signal_device(signal: torch.Tensor, s: Settings,
                           plan: ResamplePlan) -> torch.Tensor:
    """`resample_signal` on the signal's device: float32 (n_out,).

    Differences from the host path are confined to the first and last
    ~3*701 samples (filtfilt's reflect padding), which the acquisition
    correlation never keys on (tests/test_resample.py)."""
    b = _bandpass_taps(s, plan)
    bb = np.convolve(b, b).astype(np.float32)         # zero-phase kernel
    dev = signal.device
    x = signal.to(torch.float32)
    n, k = x.shape[0], len(bb)
    nfft = 1
    while nfft < n + k:
        nfft <<= 1
    spec = torch.fft.rfft(x, nfft) \
        * torch.fft.rfft(torch.from_numpy(bb).to(dev), nfft)
    full = torch.fft.irfft(spec, nfft)
    filtered = full[(k - 1) // 2: (k - 1) // 2 + n]  # 'same' alignment
    return filtered[torch.from_numpy(_decimation_indices(n, plan)).to(dev)]


def recover_results(acq, plan: ResamplePlan):
    """Map code phase and carrier frequency back to the original rate.

    Code phase scales by the fs ratio (acquisition.m:311-314).  For the
    carrier, the complex mixer always locks the correlation peak at the
    positive-frequency alias new_if + fd — even when new_if exceeds the
    resampled Nyquist — so doppler = carrFreq - new_if unconditionally.
    (Deviation: the reference's mirror branch for IF >= fs/2,
    acquisition.m:317-325, contradicts its own complex mixing and yields
    MHz-scale errors on synthesized truth; verified in
    tests/test_resample.py.)"""
    code_phase = np.floor(
        acq.code_phase / plan.new_fs * plan.old_fs
    ).astype(np.int64)
    carr = np.asarray(acq.carr_freq, dtype=np.float64)
    doppler = carr - plan.new_if
    acq.code_phase = code_phase
    acq.carr_freq = doppler + plan.old_if
    return acq
