"""Synthetic IF-signal generation for tests and benchmarks.

The reference repo validates against recorded NUT4NT captures that are not
distributed with the code (README download links only), so this framework
ships a synthesizer that produces IF captures with *known* ground truth
(PRN, Doppler, code phase, C/N0, nav bits) for golden-value testing — the
missing test infrastructure SURVEY.md section 4 calls for.

Signal conventions match the receiver's canonical mixing e^{-j theta},
I = real (the reference B1C trackers' convention, `WB_tracking.m:341-346`;
the B2a tracker's e^{+j theta} with I=imag is the same up to conjugation):

  B2a : s = A.[ d(t).sec_d(t).c_d(t).cos(theta) - c_p(t).sin(theta) ]
        (pilot "pi/2 ahead of data", `tracking.m:342-345`)
  B1C : s = A.[ (1/2).d(t).BOC11_d.cos(theta)
                - sec(t).( sqrt(29/44).BOC11_p.sin(theta)
                          + sqrt(4/44).BOC61_p.cos(theta) ) ]
        (QMBOC(6,1,4/33) split; composite correlator `WB_tracking.m:374-381`)

where theta = 2.pi.(IF+fd).t + phi0 and the code rate is Doppler-scaled by
(1 + fd/f_carrier).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from bds3_tpu_torch.config import FileType, Settings, Signal
from bds3_tpu_torch.signals import (
    b1c_data_chips,
    b1c_pilot_boc11,
    b1c_pilot_boc61,
    b1c_secondary_code,
    b2a_data_code,
    b2a_data_secondary,
    b2a_pilot_code,
)
from bds3_tpu_torch.signals.b1c import b1c_data_boc11


@dataclasses.dataclass
class SatParams:
    """Ground truth for one synthesized satellite."""

    prn: int
    doppler_hz: float = 0.0
    code_phase_chips: float = 0.0   # code phase at sample 0 (chips into code)
    carrier_phase: float = 0.0      # phi0 [rad]
    amplitude: float = 1.0          # per-component unit amplitude pre-split
    nav_bits: np.ndarray | None = None  # +-1 data symbols (cycled)


def amplitude_for_cn0(settings: Settings, cn0_db: float,
                      noise_std: float = 2.0) -> float:
    """SatParams.amplitude that puts the DATA channel at cn0_db [dB-Hz].

    Real-IF sampling at fs spreads noise power noise_std^2 over the
    one-sided band fs/2, so N0 = 2.noise_std^2/fs; a data component of
    amplitude A_d on a real carrier carries power A_d^2/2, giving
    C/N0 = A_d^2.fs/(4.noise_std^2).  B2a's data component uses the full
    SatParams.amplitude; B1C's data channel gets sqrt(11/44) of it
    (QMBOC power split above), hence the 2x factor.

    Calibration check (matches observe/cn0.py VSM measurements on the
    bench captures): B2a amplitude 0.65, noise 2.0 at 99.375 Msps
    -> 64.2 dB-Hz; B1C 0.22 -> 48.8 dB-Hz.
    """
    a_d = math.sqrt(10.0 ** (cn0_db / 10.0) * 4.0 * noise_std ** 2
                    / settings.sampling_freq)
    return a_d * (2.0 if settings.signal == Signal.B1C else 1.0)


@dataclasses.dataclass
class _Component:
    waveform: np.ndarray       # int8 entries, entries_per_chip per chip
    entries_per_chip: int
    overlay: np.ndarray | None  # +-1 per code period (cycled)
    phase_offset: float         # psi in cos(theta + psi)
    amplitude: float


def _b2a_components(sat: SatParams, n_periods: int) -> list[_Component]:
    sec = b2a_data_secondary().astype(np.int8)
    bits = (
        np.asarray(sat.nav_bits, dtype=np.int8)
        if sat.nav_bits is not None
        else np.ones(1, dtype=np.int8)
    )
    periods = np.arange(n_periods)
    overlay = bits[(periods // len(sec)) % len(bits)] * sec[periods % len(sec)]
    return [
        _Component(b2a_data_code(sat.prn), 1, overlay, 0.0, sat.amplitude),
        # pilot pi/2 ahead: cos(theta + pi/2) = -sin(theta)
        _Component(b2a_pilot_code(sat.prn), 1, None, math.pi / 2, sat.amplitude),
    ]


def _b1c_components(sat: SatParams, n_periods: int) -> list[_Component]:
    bits = (
        np.asarray(sat.nav_bits, dtype=np.int8)
        if sat.nav_bits is not None
        else np.ones(1, dtype=np.int8)
    )
    periods = np.arange(n_periods)
    data_overlay = bits[periods % len(bits)]
    sec = b1c_secondary_code(sat.prn)
    sec_overlay = sec[periods % len(sec)]
    a = sat.amplitude
    return [
        _Component(b1c_data_boc11(sat.prn), 2, data_overlay, 0.0,
                   a * math.sqrt(11.0 / 44.0)),
        # pilot BOC11 "pi/2 ahead" with secondary: -sec.sin(theta)
        _Component(b1c_pilot_boc11(sat.prn), 2, -sec_overlay, math.pi / 2,
                   a * math.sqrt(29.0 / 44.0)),
        # pilot BOC61 in antiphase with data (reference -sqrt(4/33) weight)
        _Component(b1c_pilot_boc61(sat.prn), 12, -sec_overlay, 0.0,
                   a * math.sqrt(4.0 / 44.0)),
    ]


def synthesize_if(
    settings: Settings,
    sats: list[SatParams],
    n_ms: float,
    noise_std: float = 0.0,
    seed: int = 0,
    quantize: bool = True,
    chunk: int = 1 << 21,
    start_sample: int = 0,
) -> np.ndarray:
    """Synthesize an IF capture.  Returns int8 (quantize=True) or float32.

    REAL8: shape (N,).  IQ8: shape (N, 2) interleaved I/Q.

    start_sample: absolute sample index of the first output sample —
    phase-continuous segmented generation (a 49 s capture rendered in
    500 ms file-append chunks is bit-identical in signal content to a
    single call, modulo the per-chunk noise stream).
    """
    fs = settings.sampling_freq
    n = int(round(n_ms * 1e-3 * fs))
    L = settings.code_length
    complex_out = settings.file_type == FileType.IQ8

    total_periods = int(
        (start_sample / fs * 1e3 + n_ms) / settings.code_period_ms) + 2
    comps_per_sat = []
    for sat in sats:
        if settings.signal == Signal.B2A:
            comps_per_sat.append(_b2a_components(sat, total_periods))
        else:
            comps_per_sat.append(_b1c_components(sat, total_periods))

    rng = np.random.default_rng(seed)
    out = np.empty((n, 2) if complex_out else (n,),
                   dtype=np.int8 if quantize else np.float32)

    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        t = np.arange(start_sample + start, start_sample + stop,
                      dtype=np.float64) / fs
        acc = np.zeros(stop - start, dtype=np.complex128) if complex_out \
            else np.zeros(stop - start, dtype=np.float64)
        for sat, comps in zip(sats, comps_per_sat):
            f_carr = settings.intermediate_freq + sat.doppler_hz
            theta = 2.0 * math.pi * f_carr * t + sat.carrier_phase
            code_rate = settings.code_freq_basis * (
                1.0 + sat.doppler_hz / settings.carr_freq_basis
            )
            chips = sat.code_phase_chips + t * code_rate  # absolute chip count
            period_idx = np.floor(chips / L).astype(np.int64)
            for c in comps:
                entry = np.floor(chips * c.entries_per_chip).astype(np.int64) \
                    % (L * c.entries_per_chip)
                wave = c.waveform[entry].astype(np.float64)
                if c.overlay is not None:
                    wave = wave * c.overlay[period_idx % len(c.overlay)]
                if complex_out:
                    acc += c.amplitude * wave * np.exp(1j * (theta + c.phase_offset))
                else:
                    acc += c.amplitude * wave * np.cos(theta + c.phase_offset)
        if noise_std > 0.0:
            if complex_out:
                acc += noise_std * (
                    rng.standard_normal(stop - start)
                    + 1j * rng.standard_normal(stop - start)
                )
            else:
                acc += noise_std * rng.standard_normal(stop - start)
        if complex_out:
            pair = np.stack([acc.real, acc.imag], axis=-1)
            out[start:stop] = (
                np.clip(np.round(pair), -128, 127).astype(np.int8)
                if quantize else pair.astype(np.float32)
            )
        else:
            out[start:stop] = (
                np.clip(np.round(acc), -128, 127).astype(np.int8)
                if quantize else acc.astype(np.float32)
            )
    return out
