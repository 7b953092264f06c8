"""IF captures rendered on a PyTorch device: `io.synth.synthesize_if` and
`io.scenario.synthesize_scenario` computed in float64 with tensors.

The host synthesizers take minutes of one core for a few seconds of a
99.375 Msps capture (and hours for the 49 s one of the streaming bench);
on a card the same arithmetic takes seconds.  Both renderers take the
host module's own code tables, overlays and delay grids and repeat its
expressions in its order, so without noise a capture rendered on the CPU
equals the host's sample for sample (tests/test_torch_stream.py).  The
noise comes from a torch generator seeded with `seed`: with noise a
capture is another draw of the same distribution, not the host's.

Both render the settings' file type: REAL8 as (n,) int8, a component
adding amp * wave * cos(theta + psi); IQ8 as (n, 2) int8 I/Q pairs with
the host's IQ convention (io/synth.py:183-191), a component adding
amp * wave * e^{j(theta + psi)}, noise on I and on Q.  `synthesize_scenario`
renders REAL8 only; `render_scenario` takes the same convention to IQ8.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from bds3_tpu_torch.config import FileType, Settings, Signal
from bds3_tpu_torch.io import scenario as scn
from bds3_tpu_torch.io.synth import SatParams, _b1c_components, _b2a_components
from bds3_tpu_torch.signals import (
    b1c_data_boc11,
    b1c_pilot_boc11,
    b1c_pilot_boc61,
    b1c_secondary_code,
    b2a_data_code,
    b2a_pilot_code,
    b2a_pilot_secondary,
)
from bds3_tpu_torch.utils.device import resolve_device


def _dev64(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float64), device=device)


def _quantize(acc: torch.Tensor, noise_std: float, gen) -> torch.Tensor:
    """(n,) or (n, 2) float64 samples, plus noise on each component, to
    int8 as the host rounds them (np.round: half to even)."""
    if noise_std > 0:
        acc += noise_std * torch.randn(acc.shape, generator=gen,
                                       dtype=torch.float64,
                                       device=acc.device)
    return torch.clamp(torch.round(acc), -128, 127).to(torch.int8)


def _add(acc: torch.Tensor, a: torch.Tensor, phase: torch.Tensor) -> None:
    """acc += a * cos(phase) for REAL8 (acc (n,)), acc += a * e^{j phase}
    for IQ8 (acc (n, 2), I and Q): the product a * (cos + j sin) is
    (a cos, a sin) exactly, as the host's complex multiply gives it."""
    if acc.dim() == 1:
        acc += a * torch.cos(phase)
    else:
        acc[:, 0] += a * torch.cos(phase)
        acc[:, 1] += a * torch.sin(phase)


def _samples(settings: Settings, n: int, device) -> tuple:
    """(the sample shape of each output row, the empty int8 capture)."""
    row = (2,) if settings.file_type == FileType.IQ8 else ()
    return row, torch.empty((n,) + row, dtype=torch.int8, device=device)


def render_if(settings: Settings, sats: list[SatParams], n_ms: float,
              device: str | torch.device = "cuda", noise_std: float = 0.0,
              seed: int = 0, start_sample: int = 0,
              chunk: int = 1 << 24) -> torch.Tensor:
    """synthesize_if (io/synth.py) on `device`: the (n,) int8 capture of
    `sats` from sample `start_sample` on, or (n, 2) int8 I/Q pairs for an
    IQ8 file type, as a tensor there."""
    dev = resolve_device(device)
    fs, L = settings.sampling_freq, settings.code_length
    n = int(round(n_ms * 1e-3 * fs))
    total_periods = int(
        (start_sample / fs * 1e3 + n_ms) / settings.code_period_ms) + 2
    comps = _b2a_components if settings.signal == Signal.B2A \
        else _b1c_components
    per_sat = [(sat, [(torch.as_tensor(c.waveform, device=dev)
                       .to(torch.float64), c.entries_per_chip,
                       None if c.overlay is None
                       else _dev64(c.overlay, dev), c.phase_offset,
                       c.amplitude)
                      for c in comps(sat, total_periods)])
               for sat in sats]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    row, out = _samples(settings, n, dev)
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        t = torch.arange(start_sample + start, start_sample + stop,
                         dtype=torch.float64, device=dev) / fs
        acc = torch.zeros((stop - start,) + row, dtype=torch.float64,
                          device=dev)
        for sat, sat_comps in per_sat:
            f_carr = settings.intermediate_freq + sat.doppler_hz
            theta = 2.0 * math.pi * f_carr * t + sat.carrier_phase
            code_rate = settings.code_freq_basis * (
                1.0 + sat.doppler_hz / settings.carr_freq_basis)
            chips = sat.code_phase_chips + t * code_rate
            period = torch.floor(chips / L).to(torch.int64)
            for wave, m, ovl, psi, amp in sat_comps:
                entry = torch.remainder(
                    torch.floor(chips * m).to(torch.int64), L * m)
                w = wave[entry]
                if ovl is not None:
                    w = w * ovl[torch.remainder(period, len(ovl))]
                _add(acc, amp * w, theta + psi)
        out[start:stop] = _quantize(acc, noise_std, gen)
    return out


def render_scenario(sc: scn.Scenario, device: str | torch.device = "cuda",
                    noise_std: float = 2.0, amplitude: float = 0.65,
                    seed: int = 0, chunk: int = 1 << 24) -> torch.Tensor:
    """synthesize_scenario (io/scenario.py) on `device`, B2a (with its
    pilot secondary overlay) or B1C: the same geometry, codes, overlays and
    power split; the delay grid is interpolated as np.interp does on its
    uniform grid.  Returns the (n,) int8 capture, or (n, 2) int8 I/Q pairs
    for an IQ8 file type, as a tensor there."""
    dev = resolve_device(device)
    s = sc.settings
    fs, L, f_rf = s.sampling_freq, s.code_length, s.carr_freq_basis
    n_ms = s.ms_to_process
    n = int(round(n_ms * 1e-3 * fs))
    grid_dt = 0.01
    t_grid = np.arange(0.0, n_ms * 1e-3 + 3 * grid_dt, grid_dt)
    t_grid_d = _dev64(t_grid, dev)
    sats = []
    for eph, (a0, a1) in zip(sc.ephemerides, sc.sat_clock):
        tau_g = scn._delay_grid(sc, eph, t_grid)
        overlay = scn._nav_symbol_lookup(sc, eph)
        # every code period the capture can reach, with a margin; the
        # overlays become per-period tables on the device
        t_sv = sc.sow_base + np.array([0.0, n / fs]) \
            - np.array([tau_g.max(), tau_g.min()])
        t_sv = t_sv + a0 + a1 * (t_sv - eph.t_oc)
        p0 = int(np.floor(t_sv[0] * s.code_freq_basis / L)) - 2
        periods = np.arange(
            p0, int(np.ceil(t_sv[1] * s.code_freq_basis / L)) + 3)
        if s.signal == Signal.B2A:
            sec = b2a_pilot_secondary(eph.prn).astype(np.float64)
            pilot_ovl = -sec[periods % len(sec)]
            comps = [(b2a_data_code(eph.prn), 1, overlay(periods), 0.0,
                      amplitude),
                     (b2a_pilot_code(eph.prn), 1, pilot_ovl, math.pi / 2,
                      amplitude)]
        else:
            sec = b1c_secondary_code(eph.prn).astype(np.float64)
            pilot_ovl = -sec[periods % len(sec)]
            comps = [
                (b1c_data_boc11(eph.prn), 2, overlay(periods), 0.0,
                 amplitude * math.sqrt(11.0 / 44.0)),
                (b1c_pilot_boc11(eph.prn), 2, pilot_ovl, math.pi / 2,
                 amplitude * math.sqrt(29.0 / 44.0)),
                (b1c_pilot_boc61(eph.prn), 12, pilot_ovl, 0.0,
                 amplitude * math.sqrt(4.0 / 44.0)),
            ]
        sats.append((eph, a0, a1, _dev64(tau_g, dev), p0,
                     [(_dev64(w, dev), m, _dev64(o, dev), psi, amp)
                      for w, m, o, psi, amp in comps]))

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    row, out = _samples(s, n, dev)
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        t = torch.arange(start, stop, dtype=torch.float64, device=dev) / fs
        acc = torch.zeros((stop - start,) + row, dtype=torch.float64,
                          device=dev)
        for eph, a0, a1, tau_g, p0, comps in sats:
            # np.interp on the uniform grid t_grid
            i = torch.floor(t / grid_dt).to(torch.int64) \
                .clamp(0, len(t_grid) - 2)
            tau = tau_g[i] + (t - t_grid_d[i]) / grid_dt \
                * (tau_g[i + 1] - tau_g[i])
            u = sc.sow_base + t - tau
            dt_sv = a0 + a1 * (u - eph.t_oc)
            chips = (u + dt_sv) * s.code_freq_basis
            period = torch.floor(chips / L).to(torch.int64) - p0
            theta = 2 * np.pi * (s.intermediate_freq * t
                                 - f_rf * (tau - dt_sv))
            for wave, m, ovl, psi, amp in comps:
                entry = torch.remainder(
                    torch.floor(chips * m).to(torch.int64), L * m)
                _add(acc, amp * (wave[entry] * ovl[period]), theta + psi)
        out[start:stop] = _quantize(acc, noise_std, gen)
    return out
