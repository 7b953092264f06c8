"""A real int8 IF capture rendered on a PyTorch device from a sky.

Frozen copy of the program's `io/synth.py:synthesize_if` conventions as
`io/render.py:render_if` computes them on a card (REAL8 only), with its
own code tables (`gen/signals`):

  B2a : s = A.[ d(t).sec_d(t).c_d(t).cos(theta) - c_p(t).sin(theta) ]
  B1C : s = A.[ sqrt(11/44).d(t).BOC11_d.cos(theta)
                - sec(t).( sqrt(29/44).BOC11_p.sin(theta)
                          + sqrt(4/44).BOC61_p.cos(theta) ) ]

with theta = 2.pi.(IF + fd).t + phi0 and the code rate scaled by
(1 + fd/f_carrier); every phase is computed in float64 and the sum plus
Gaussian noise is rounded to int8 as numpy rounds (half to even).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from portbench.gen.signals import (
    b1c_data_boc11,
    b1c_pilot_boc11,
    b1c_pilot_boc61,
    b1c_secondary_code,
    b2a_data_code,
    b2a_data_secondary,
    b2a_pilot_code,
)


@dataclasses.dataclass(frozen=True)
class Front:
    """The front end and signal a capture is rendered for."""

    signal: str              # "b2a" or "b1c"
    fs: float                # sampling rate [Hz]
    if_hz: float             # intermediate frequency [Hz]
    code_length: int         # primary code chips
    code_freq: float         # chipping rate [Hz]
    carr_freq: float         # RF carrier [Hz]

    @property
    def code_period_ms(self) -> float:
        return self.code_length / self.code_freq * 1e3


@dataclasses.dataclass(frozen=True)
class Sat:
    """One satellite of a sky: its truth at sample 0."""

    prn: int
    doppler_hz: float
    code_phase_chips: float
    carrier_phase: float
    amplitude: float
    nav_bits: tuple = (1,)   # +-1 data symbols, cycled


def amplitude_for_cn0(front: Front, cn0_db: float, noise_std: float) -> float:
    """The amplitude that puts the data component at cn0_db [dB-Hz]: real
    sampling at fs spreads noise_std^2 over fs/2, so N0 = 2 noise_std^2/fs,
    and a data component of amplitude A_d carries A_d^2/2; B1C's data
    component gets sqrt(11/44) of the amplitude, hence the factor 2
    (`io/synth.py:amplitude_for_cn0`)."""
    a_d = math.sqrt(10.0 ** (cn0_db / 10.0) * 4.0 * noise_std ** 2 / front.fs)
    return a_d * (2.0 if front.signal == "b1c" else 1.0)


def components(front: Front, sat: Sat, n_periods: int) -> list[tuple]:
    """(waveform, entries per chip, overlay per code period or None,
    phase offset, amplitude) of each component of one satellite."""
    bits = np.asarray(sat.nav_bits, dtype=np.int8)
    periods = np.arange(n_periods)
    a = sat.amplitude
    if front.signal == "b2a":
        sec = b2a_data_secondary()
        overlay = bits[(periods // len(sec)) % len(bits)] \
            * sec[periods % len(sec)]
        return [(b2a_data_code(sat.prn), 1, overlay, 0.0, a),
                (b2a_pilot_code(sat.prn), 1, None, math.pi / 2, a)]
    sec = b1c_secondary_code(sat.prn)[periods % 1800]
    return [(b1c_data_boc11(sat.prn), 2, bits[periods % len(bits)], 0.0,
             a * math.sqrt(11.0 / 44.0)),
            (b1c_pilot_boc11(sat.prn), 2, -sec, math.pi / 2,
             a * math.sqrt(29.0 / 44.0)),
            (b1c_pilot_boc61(sat.prn), 12, -sec, 0.0,
             a * math.sqrt(4.0 / 44.0))]


def render(front: Front, sats: list[Sat], n: int, device, noise_std: float,
           seed: int, chunk: int = 1 << 24) -> torch.Tensor:
    """The (n,) int8 capture of `sats` on `device`, noise from a torch
    generator on that device seeded with `seed`."""
    dev = torch.device(device)
    fs, L = front.fs, front.code_length
    n_periods = int(n / fs * 1e3 / front.code_period_ms) + 2
    per_sat = []
    for sat in sats:
        comps = [(torch.as_tensor(w, device=dev).to(torch.float64), m,
                  None if o is None else torch.as_tensor(
                      np.asarray(o, np.float64), device=dev), psi, amp)
                 for w, m, o, psi, amp in components(front, sat, n_periods)]
        per_sat.append((sat, comps))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out = torch.empty(n, dtype=torch.int8, device=dev)
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        t = torch.arange(start, stop, dtype=torch.float64, device=dev) / fs
        acc = torch.zeros(stop - start, dtype=torch.float64, device=dev)
        for sat, comps in per_sat:
            theta = 2.0 * math.pi * (front.if_hz + sat.doppler_hz) * t \
                + sat.carrier_phase
            chips = sat.code_phase_chips + t * (
                front.code_freq * (1.0 + sat.doppler_hz / front.carr_freq))
            period = torch.floor(chips / L).to(torch.int64)
            for wave, m, ovl, psi, amp in comps:
                entry = torch.remainder(
                    torch.floor(chips * m).to(torch.int64), L * m)
                w = wave[entry]
                if ovl is not None:
                    w = w * ovl[torch.remainder(period, len(ovl))]
                acc += amp * w * torch.cos(theta + psi)
        if noise_std > 0:
            acc += noise_std * torch.randn(acc.shape, generator=gen,
                                           dtype=torch.float64, device=dev)
        out[start:stop] = torch.clamp(torch.round(acc), -128, 127) \
            .to(torch.int8)
    return out
