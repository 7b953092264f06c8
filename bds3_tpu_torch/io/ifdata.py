"""IF sample-file ingest.

TPU-first redesign of the reference's sequential `fopen/fseek/fread` pattern
(`BDS-3_B2a/postProcessing.m:60-96`, `tracking.m:237-254`): the file is
memory-mapped once and exposed as zero-copy numpy views; callers slice
arbitrary windows (acquisition block, tracking block ranges) and upload them
to device HBM in large chunks instead of reading one code period at a time.

Supports the two reference file layouts (`initSettings.m` fileType):
  REAL8 - 8-bit real samples S0,S1,S2,...
  IQ8   - 8-bit interleaved I0,Q0,I1,Q1,...  (complex samples)
"""
from __future__ import annotations

import dataclasses

import numpy as np

from bds3_tpu_torch.config import FileType, Settings


@dataclasses.dataclass
class IFDataFile:
    """Memory-mapped IF capture."""

    data: np.ndarray        # (N,) int8 for REAL8; (N, 2) int8 for IQ8
    file_type: FileType

    @classmethod
    def open(cls, path: str, file_type: FileType = FileType.REAL8,
             skip_samples: int = 0) -> "IFDataFile":
        raw = np.memmap(path, dtype=np.int8, mode="r")
        if file_type == FileType.IQ8:
            raw = raw[: (len(raw) // 2) * 2].reshape(-1, 2)
        return cls(data=raw[skip_samples:], file_type=file_type)

    @classmethod
    def from_array(cls, samples: np.ndarray,
                   file_type: FileType = FileType.REAL8) -> "IFDataFile":
        """Wrap an in-memory capture (tests / synthesized signals)."""
        if file_type == FileType.IQ8 and samples.ndim == 1:
            samples = samples.reshape(-1, 2)
        return cls(data=samples, file_type=file_type)

    @property
    def num_samples(self) -> int:
        return self.data.shape[0]

    def read_raw(self, offset: int, n: int) -> np.ndarray:
        """Raw int8 window: (n,) for REAL8, (n, 2) for IQ8.  Clipped at EOF
        (caller checks length, mirroring the reference short-read exit
        `tracking.m:250-254`)."""
        return np.asarray(self.data[offset : offset + n])

    def read_complex(self, offset: int, n: int) -> np.ndarray:
        """Window as complex64 baseband-at-IF samples (REAL8 -> imag=0)."""
        w = self.read_raw(offset, n)
        if self.file_type == FileType.IQ8:
            return w[:, 0].astype(np.float32) + 1j * w[:, 1].astype(np.float32)
        return w.astype(np.float32) + 0j

    def read_float(self, offset: int, n: int) -> np.ndarray:
        """REAL8 window as float32 (errors for IQ8 — use read_complex)."""
        assert self.file_type == FileType.REAL8
        return self.read_raw(offset, n).astype(np.float32)


def open_settings_file(s: Settings, path: str | None = None) -> IFDataFile:
    return IFDataFile.open(path or s.file_name, s.file_type, s.skip_samples)


def probe_stats(f: IFDataFile, n: int = 1_000_000) -> dict:
    """Numeric core of the reference's `probeData.m` sanity plots: sample
    moments, histogram, and spectrum peak (the plots live in observe/)."""
    if f.file_type == FileType.IQ8:
        w = f.read_complex(0, n)
        real = np.concatenate([w.real, w.imag])
    else:
        real = f.read_float(0, n)
        w = real
    hist, edges = np.histogram(real, bins=np.arange(-128.5, 129.5))
    spec = np.abs(np.fft.rfft(np.asarray(w, dtype=np.float64)[: 1 << 18])) ** 2
    return {
        "mean": float(real.mean()),
        "std": float(real.std()),
        "min": float(real.min()),
        "max": float(real.max()),
        "hist": hist,
        "hist_edges": edges,
        "spectrum_peak_bin": int(np.argmax(spec[1:]) + 1),
        # probeData.m:86-170's remaining panels: a time-domain snippet
        # and the Welch-averaged PSD (pwelch(data, 32768, 2048, 32768, fs))
        "time_snippet": np.asarray(w[:2000]).copy(),
        "welch": welch_psd(np.asarray(w, dtype=np.float64)),
        "complex": bool(np.iscomplexobj(w)),
    }


def welch_psd(x: np.ndarray, nseg: int = 32768, overlap: int = 2048) -> dict:
    """Segment-averaged Hann periodogram (the numeric core of probeData.m's
    `pwelch(data, 32768, 2048, 32768, fs)` panel).  Returns one-sided bins
    for real input, fftshifted two-sided for complex; frequencies are in
    cycles/sample (multiply by fs for Hz)."""
    step = nseg - overlap
    n_seg = max((len(x) - overlap) // step, 1)
    nseg = min(nseg, len(x))
    win = np.hanning(nseg)
    scale = 1.0 / (win ** 2).sum() / n_seg
    cplx = np.iscomplexobj(x)
    nbins = nseg if cplx else nseg // 2 + 1
    acc = np.zeros(nbins)
    for i in range(n_seg):
        seg = x[i * step: i * step + nseg]
        if len(seg) < nseg:
            break
        segw = seg * win
        f = np.fft.fft(segw) if cplx else np.fft.rfft(segw)
        acc += np.abs(f) ** 2 * scale
    if cplx:
        acc = np.fft.fftshift(acc)
        freqs = np.fft.fftshift(np.fft.fftfreq(nseg))
    else:
        freqs = np.arange(nbins) / nseg
    return {"psd": acc, "freq_cycles": freqs}
