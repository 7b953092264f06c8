"""Geometry-consistent multi-satellite scenario synthesis.

Generates an IF capture in which code delays, carrier Doppler, satellite
clocks, and navigation messages are all mutually consistent with a chosen
receiver position and a synthetic BDS-3 constellation — ground truth for
end-to-end PVT accuracy tests (the missing golden-data infrastructure;
SURVEY.md section 4, BASELINE config 4).

Timeline model (true receive time T = sow_base + t, t from 0):

  chips_i(t)  = fc * (T - tau_i(t) + dt_sv_i)    [sat-clock code phase]
  theta_i(t)  = 2*pi*(IF*t - f_RF*(tau_i(t) - dt_sv_i)) + phi0

with tau_i the light-time-iterated geometric delay to the ephemeris
position.  Eccentricities are exactly zero so the relativistic clock
term vanishes identically on both sides.  No troposphere/ionosphere is
modeled — PVT tests disable the tropo correction.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from bds3_tpu_torch.config import C_LIGHT, Settings, Signal
from bds3_tpu_torch.navmsg.encode import (
    bcnav1_frame_symbols,
    bcnav2_symbols,
    build_bcnav2_message,
)
from bds3_tpu_torch.navmsg.ephemeris import Ephemeris
from bds3_tpu_torch.pvt.geodesy import topocent
from bds3_tpu_torch.pvt.satpos import A_REF_MEO, MU, satpos_one
from bds3_tpu_torch.signals import (
    b1c_secondary_code,
    b2a_data_code,
    b2a_data_secondary,
    b2a_pilot_code,
)
from bds3_tpu_torch.signals.b1c import (
    b1c_data_boc11,
    b1c_pilot_boc11,
    b1c_pilot_boc61,
)


@dataclasses.dataclass
class Scenario:
    settings: Settings
    rx_pos_ecef: np.ndarray
    ephemerides: list[Ephemeris]
    sow_base: float
    sat_clock: list[tuple[float, float]]   # (a0, a1) per satellite


def make_constellation(
    rx_pos: np.ndarray, n_sats: int, sow_base: float, seed: int = 0,
    min_elevation: float = 20.0,
) -> list[Ephemeris]:
    """Sample circular-MEO ephemerides visible from rx_pos at sow_base."""
    rng = np.random.default_rng(seed)
    out = []
    prn = 0
    attempts = 0
    while len(out) < n_sats and attempts < 4000:
        attempts += 1
        eph = Ephemeris()
        eph.sat_type = "MEO"
        eph.delta_a = float(rng.uniform(-2000.0, 2000.0))
        eph.e = 0.0
        eph.i_0 = math.radians(55.0) + float(rng.uniform(-0.03, 0.03))
        eph.omega_0 = float(rng.uniform(-math.pi, math.pi))
        eph.omega = 0.0
        eph.m_0 = float(rng.uniform(-math.pi, math.pi))
        eph.t_oe = sow_base
        eph.t_oc = sow_base
        eph.wn = 800
        pos, _ = satpos_one(sow_base, eph, apply_tgd=False)
        _, el, _ = topocent(rx_pos, pos - rx_pos)
        if el >= min_elevation:
            prn += 1
            eph.prn = prn
            eph.iodc = 100 + prn
            eph.iode = 10 + prn
            out.append(eph)
    if len(out) < n_sats:
        raise RuntimeError("could not place constellation; relax mask")
    return out


def make_scenario(settings: Settings, rx_pos: np.ndarray, n_sats: int = 5,
                  sow_base: float = 3600.0 * 3, seed: int = 0,
                  clock_scale: float = 1e-4) -> Scenario:
    rng = np.random.default_rng(seed + 99)
    ephs = make_constellation(rx_pos, n_sats, sow_base, seed)
    clocks = []
    for eph in ephs:
        a0 = float(rng.uniform(-clock_scale, clock_scale))
        a1 = float(rng.uniform(-1e-11, 1e-11))
        eph.a_0, eph.a_1, eph.a_2 = a0, a1, 0.0
        clocks.append((a0, a1))
    return Scenario(settings, np.asarray(rx_pos, float), ephs, sow_base, clocks)


def _delay_grid(sc: Scenario, eph: Ephemeris, t_grid: np.ndarray) -> np.ndarray:
    """Light-time-iterated geometric delay tau(t) on a coarse grid [s].

    Includes the Sagnac term: the ECEF satellite position at transmit time
    is rotated by omega_e*tau into the receive-epoch frame before
    differencing (matching `Common/e_r_corr.m`, which the receiver's
    least-squares applies) — without this the synthesized geometry is
    inconsistent with the solver by tens of meters.
    """
    from bds3_tpu_torch.pvt.geodesy import e_r_corr

    tau = np.full(len(t_grid), 0.07)
    for _ in range(4):
        for j, t in enumerate(t_grid):
            u = sc.sow_base + t - tau[j]
            pos, _ = satpos_one(u, _zero_clock(eph), apply_tgd=False)
            pos_rx_frame = e_r_corr(tau[j], pos)
            tau[j] = np.linalg.norm(pos_rx_frame - sc.rx_pos_ecef) / C_LIGHT
    return tau


def _zero_clock(eph: Ephemeris) -> Ephemeris:
    e = dataclasses.replace(eph)
    e.a_0 = e.a_1 = e.a_2 = 0.0
    e.t_gd_b1cp = 0.0
    return e


def _nav_symbol_lookup(sc: Scenario, eph: Ephemeris):
    """Returns f(period_idx_array) -> +-1 overlay for the data channel,
    where period_idx is the absolute primary-code period count (sat time
    in code periods)."""
    s = sc.settings
    if s.signal == Signal.B2A:
        # messages every 3000 ms; build enough to cover the capture window
        first_msg = int(sc.sow_base // 3) - 1
        n_msgs = int(np.ceil(s.ms_to_process / 3000)) + 3
        mtypes = [10, 11, 30]
        msgs = [
            build_bcnav2_message(eph, mtypes[m % 3], (first_msg + m) * 3.0)
            for m in range(n_msgs)
        ]
        stream = bcnav2_symbols(msgs, seed=eph.prn)  # one per 5ms symbol
        sec = b2a_data_secondary()
        sym_start = first_msg * 600  # absolute 5-ms symbol index

        def overlay(period_idx):
            sym = stream[(period_idx // 5) - sym_start]
            return sym * sec[period_idx % 5]

        return overlay
    else:
        # B-CNAV1: 1800-symbol frames every 18 s, aligned to SOH
        first_frame = int(sc.sow_base // 18) - 1
        n_frames = int(np.ceil(s.ms_to_process / 18000)) + 2
        frames = []
        for fidx in range(first_frame, first_frame + n_frames):
            t_abs = fidx * 18.0
            e2 = dataclasses.replace(eph)
            e2.how = int(t_abs // 3600)
            frames.append(bcnav1_frame_symbols(e2, t_abs % 3600.0))
        stream = np.concatenate(frames)
        sym_start = first_frame * 1800

        def overlay(period_idx):
            return stream[period_idx - sym_start]

        return overlay


def synthesize_scenario(sc: Scenario, n_ms: float | None = None,
                        noise_std: float = 2.0, amplitude: float = 0.65,
                        seed: int = 0, chunk: int = 1 << 21,
                        pilot_secondary: bool = True) -> np.ndarray:
    """Render the IF capture (int8 real samples).

    pilot_secondary: modulate the B2a pilot with its 100-chip secondary
    overlay (on by default — the on-air signal has it; see the note at
    the component setup).  B1C pilots always carry their 1800-chip
    secondary code."""
    s = sc.settings
    if n_ms is None:
        n_ms = s.ms_to_process
    fs = s.sampling_freq
    n = int(round(n_ms * 1e-3 * fs))
    L = s.code_length
    f_rf = s.carr_freq_basis

    grid_dt = 0.01
    t_grid = np.arange(0.0, n_ms * 1e-3 + 3 * grid_dt, grid_dt)

    per_sat = []
    for eph, (a0, a1) in zip(sc.ephemerides, sc.sat_clock):
        tau = _delay_grid(sc, eph, t_grid)
        overlay = _nav_symbol_lookup(sc, eph)
        if s.signal == Signal.B2A:
            comps = [
                (b2a_data_code(eph.prn), 1, True, 0.0, amplitude),
                (b2a_pilot_code(eph.prn), 1,
                 "sec" if pilot_secondary else False, math.pi / 2,
                 amplitude),
            ]
            # B2a pilot 100-chip secondary overlay (1 chip per 1 ms code
            # period, B2a ICD section 5.2.3): the ICD Weil-1021-truncated
            # construction via signals.b2a.b2a_pilot_secondary (per-PRN
            # parameters are a documented placeholder — see
            # icd_tables.B2A_PILOT_SECONDARY_WP).  The receiver-side
            # secondary sync (observe.secondary.b2a_pilot_secondary_sync)
            # uses the same generator, so pilot-aided frame alignment
            # works end to end on synthesized captures.
            if pilot_secondary:
                from bds3_tpu_torch.signals import b2a_pilot_secondary

                sec_pilot = b2a_pilot_secondary(eph.prn).astype(np.float64)
            else:
                sec_pilot = None
        else:
            sec_pilot = b1c_secondary_code(eph.prn)
            comps = [
                (b1c_data_boc11(eph.prn), 2, True, 0.0,
                 amplitude * math.sqrt(11.0 / 44.0)),
                (b1c_pilot_boc11(eph.prn), 2, "sec", math.pi / 2,
                 amplitude * math.sqrt(29.0 / 44.0)),
                (b1c_pilot_boc61(eph.prn), 12, "sec", 0.0,
                 amplitude * math.sqrt(4.0 / 44.0)),
            ]
        per_sat.append((eph, a0, a1, tau, overlay, comps, sec_pilot))

    rng = np.random.default_rng(seed)
    out = np.empty(n, dtype=np.int8)
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        t = np.arange(start, stop, dtype=np.float64) / fs
        acc = np.zeros(stop - start)
        for eph, a0, a1, tau_g, overlay, comps, sec_pilot in per_sat:
            tau = np.interp(t, t_grid, tau_g)
            u = sc.sow_base + t - tau
            dt_sv = a0 + a1 * (u - eph.t_oc)
            t_sv = u + dt_sv                       # sat-clock time [SOW s]
            chips = t_sv * s.code_freq_basis       # absolute chip count
            period = np.floor(chips / L).astype(np.int64)
            theta = 2 * np.pi * (
                s.intermediate_freq * t - f_rf * (tau - dt_sv)
            )
            for wave, m, ovl, psi, amp in comps:
                entry = np.floor(chips * m).astype(np.int64) % (L * m)
                v = wave[entry].astype(np.float64)
                if ovl is True:
                    v = v * overlay(period)
                elif ovl == "sec":
                    v = v * -sec_pilot[period % len(sec_pilot)]
                acc += amp * v * np.cos(theta + psi)
        if noise_std > 0:
            acc += noise_std * rng.standard_normal(stop - start)
        out[start:stop] = np.clip(np.round(acc), -128, 127).astype(np.int8)
    return out
