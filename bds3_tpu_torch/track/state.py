"""Tracking configuration, per-channel state, and host-precomputed phase
tables.

Float strategy (TPU has no usable 64-bit types — see utils/phase.py): all
device math is float32; the precision that the reference gets from MATLAB
float64 comes from splitting every per-sample phase into

  value(i) = [host-f64 coarse table at k = i // 4096]  +  small f32 residual

so that no f32 quantity ever exceeds a few hundred while representing
phases that accumulate over millions of samples.  NCO frequencies are
stored as small f32 *deltas* from per-channel f64 bases (an f32 absolute
carrier frequency would quantize to ~1 Hz).

Host-numpy copy of `bds3_tpu/track/state.py`: the port imports nothing
of the JAX package, so it keeps its own copy of every host module it
uses.  The port keeps these numpy types on the host;
`bds3_tpu_torch.convert` turns them into tensors.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from bds3_tpu_torch.config import Settings, Signal, TrackMode
from bds3_tpu_torch.track.loops import dll_coefficients, pll_coefficients
from bds3_tpu_torch.track.weighting import wb_dll_weight

SPLIT = 4096  # per-sample phase decomposition block (matches utils/phase.py)


@dataclasses.dataclass(frozen=True)
class TrackConfig:
    """Static parameters of one tracking compile (hashable)."""

    signal: Signal
    mode: TrackMode
    fs: float
    code_length: int
    code_freq_basis: float
    int_time: float
    spacing: float            # E-L half spacing [chips]
    m_data: int               # table entries per chip (1 B2a, 2 B1C BOC11)
    m_p61: int                # 12 for B1C WB, else 0
    n_max: int                # fixed per-epoch sample window
    n_win: int                # pre-gathered window length (SPLIT multiple)
    k_max: int                # coarse-table length = n_win/SPLIT + 1
    q0_int: int               # int part of nominal samples/epoch L/step
    q0_frac: float            # frac part
    step_base: float          # nominal chips/sample (f64 as python float)
    tau1: float
    tau2: float
    pf3: float
    pf2: float
    pf1: float
    dll_factor: float         # WB data/pilot DLL weight; unused otherwise
    wb_code_blend: str        # WB code DLL: "composite" | "nb" | "split"
                              # | "dotprod" (see config)
    complex_input: bool
    epochs_per_block: int
    correlator: str = "bucket"  # "bucket" (prefix-sum) or "gather"
    spacing61: float = 0.02   # BOC(6,1) E-L half spacing [chips], used by
                              # the "split" blend only (config note)

    @property
    def use_pilot(self) -> bool:
        return self.mode != TrackMode.DATA_ONLY

    @property
    def wideband(self) -> bool:
        return self.signal == Signal.B1C and self.mode == TrackMode.WIDEBAND


class ChannelState(NamedTuple):
    """Per-channel loop state carried through the epoch scan; all (C,) f32
    except cursor (int32).  Mirrors the reference's scalar loop variables
    (`tracking.m:165-193`)."""

    cursor: np.ndarray          # sample offset of next epoch in the block
    rem_code_phase: np.ndarray  # [chips], in [-1, 1)
    rem_carr_cyc: np.ndarray    # carrier phase remainder [cycles, 0..1)
    d_cyc: np.ndarray           # (carrFreq - base)/fs [cycles/sample]
    d_step: np.ndarray          # (codeFreq - code_freq_basis)/fs [chips/sample]
    code_nco: np.ndarray        # DLL filter memory (oldCodeNco)
    code_error: np.ndarray      # DLL filter memory (oldCodeError)
    d1_carr: np.ndarray         # PLL integrator (dCarrError)
    d2_carr: np.ndarray         # PLL double integrator (d2CarrError)


class ChannelConsts(NamedTuple):
    """Per-channel constants for the scan; (C,) or (C, K) arrays."""

    carr_t: np.ndarray       # (C, k_max) f32: (base*SPLIT*k/fs) mod 1
    a_base: np.ndarray       # (C,) f32: (base/fs) mod 1
    q0_cyc: np.ndarray       # (C,) f32: (q0_int*base/fs) mod 1
    init_dstep: np.ndarray   # (C,) f32: initial (codeFreq-basis)/fs
    adv_int: np.ndarray      # (C,) int32: floor(expected samples/epoch)


@dataclasses.dataclass
class ChannelInit:
    """Host-side channel assignment (the reference's preRun.m output)."""

    prn: int
    acquired_freq: float      # acquisition carrier frequency [Hz]
    code_phase: int           # 0-based sample offset of first code start
    peak_metric: float


def assign_channels(acq, settings: Settings) -> list[ChannelInit]:
    """Sort detected PRNs by peak metric and fill channels
    (`include/preRun.m:44-76` semantics)."""
    order = np.argsort(-acq.peak_metric)
    out = []
    for i in order:
        if not acq.detected[i]:
            continue
        if len(out) >= settings.num_channels:
            break
        out.append(ChannelInit(
            prn=int(acq.prns[i]),
            acquired_freq=float(acq.carr_freq[i]),
            code_phase=int(acq.code_phase[i]),
            peak_metric=float(acq.peak_metric[i]),
        ))
    return out


def check_settings(s) -> None:
    """TypeError unless `s` is this package's Settings.  Another package's
    Settings (the JAX package's) has enums of another class: its
    Signal.B2A is not this package's, and would silently take the B1C
    branches here.  Convert it with convert.settings_from_reference."""
    if not isinstance(s, Settings):
        raise TypeError(
            f"expected bds3_tpu_torch.config.Settings, got "
            f"{type(s).__module__}.{type(s).__qualname__}: convert it with "
            "bds3_tpu_torch.convert.settings_from_reference")


def make_track_config(s: Settings, complex_input: bool = False,
                      epochs_per_block: int = 100,
                      correlator: str = "bucket") -> TrackConfig:
    check_settings(s)
    if s.signal == Signal.B2A:
        m_data, m_p61 = 1, 0
    else:
        m_data = 2
        m_p61 = 12 if s.track_mode == TrackMode.WIDEBAND else 0
    step_base = s.code_freq_basis / s.sampling_freq
    q0 = s.code_length / step_base
    q0_int = int(np.floor(q0))
    n_max = q0_int + 4
    # pre-gathered window: epoch + in-block drift slack + guards + the
    # fused kernel's 128-sample start alignment, rounded to a whole
    # number of SPLIT tiles (the pallas prefix kernel's tile)
    n_win = n_max + epochs_per_block + 2 * 16 + 128
    n_win = -(-n_win // SPLIT) * SPLIT
    tau1, tau2 = dll_coefficients(s.dll_bw, s.dll_damping, 1.0)
    pf3, pf2, pf1 = pll_coefficients(s.pll_bw, s.int_time)
    dll_factor = (
        wb_dll_weight(s.code_freq_basis, s.front_end_bw)
        if (s.signal == Signal.B1C and s.track_mode == TrackMode.WIDEBAND)
        else 0.5
    )
    return TrackConfig(
        signal=s.signal,
        mode=s.track_mode,
        fs=s.sampling_freq,
        code_length=s.code_length,
        code_freq_basis=s.code_freq_basis,
        int_time=s.int_time,
        spacing=s.dll_spacing,
        m_data=m_data,
        m_p61=m_p61,
        n_max=n_max,
        n_win=n_win,
        k_max=n_win // SPLIT + 1,
        q0_int=q0_int,
        q0_frac=float(q0 - q0_int),
        step_base=step_base,
        tau1=tau1,
        tau2=tau2,
        pf3=pf3,
        pf2=pf2,
        pf1=pf1,
        dll_factor=dll_factor,
        wb_code_blend=getattr(s, "wb_code_blend", "composite"),
        spacing61=min(getattr(s, "dll_spacing_boc61", 0.02), s.dll_spacing),
        complex_input=complex_input,
        epochs_per_block=epochs_per_block,
        correlator=correlator,
    )


def code_coarse_tables(cfg: TrackConfig, m: int) -> tuple[np.ndarray, np.ndarray]:
    """Host f64 split tables for the code-phase ramp at chip multiple m.

    C_k = (SPLIT*k*step_base*m) mod (L*m), split into int32 floor and f32
    fraction; device index = (Ck_int[k] + ceil(frac terms)) - 1 mod L*m.
    """
    lm = cfg.code_length * m
    k = np.arange(cfg.k_max, dtype=np.float64)
    ck = np.mod(SPLIT * k * (cfg.step_base * m), lm)
    ck_int = np.floor(ck).astype(np.int32)
    ck_frac = (ck - ck_int).astype(np.float32)
    return ck_int, ck_frac


def channel_consts(cfg: TrackConfig, inits: list[ChannelInit],
                   settings: Settings) -> ChannelConsts:
    """Per-channel host-f64 carrier tables + initial code-rate aiding.

    Code-rate aiding uses the physically-consistent sign
    codeFreq = basis * (1 + fd/f_carrier): a satellite whose carrier
    Doppler is +fd also clocks its code proportionally faster.  (The
    reference B1C preRun.m:70-73 subtracts this term and B2a comments it
    out; the DLL re-converges either way, ours just starts closer.)
    """
    base = np.array([c.acquired_freq for c in inits], dtype=np.float64)
    k = np.arange(cfg.k_max, dtype=np.float64)
    carr_t = np.mod(base[:, None] * SPLIT * k[None, :] / cfg.fs, 1.0)
    a_base = np.mod(base / cfg.fs, 1.0)
    q0_cyc = np.mod(cfg.q0_int * base / cfg.fs, 1.0)
    fd = base - settings.intermediate_freq
    code_freq = cfg.code_freq_basis * (1.0 + fd / settings.carr_freq_basis)
    init_dstep = (code_freq - cfg.code_freq_basis) / cfg.fs
    adv = cfg.code_length / (cfg.step_base + init_dstep)
    return ChannelConsts(
        carr_t=carr_t.astype(np.float32),
        a_base=a_base.astype(np.float32),
        q0_cyc=q0_cyc.astype(np.float32),
        init_dstep=init_dstep.astype(np.float32),
        adv_int=np.floor(adv).astype(np.int32),
    )


def initial_state(cfg: TrackConfig, inits: list[ChannelInit],
                  consts: ChannelConsts, cursors: np.ndarray) -> ChannelState:
    c = len(inits)
    z = np.zeros(c, dtype=np.float32)
    return ChannelState(
        cursor=np.asarray(cursors, dtype=np.int32),
        rem_code_phase=z.copy(),
        rem_carr_cyc=z.copy(),
        d_cyc=z.copy(),
        d_step=consts.init_dstep.copy(),
        code_nco=z.copy(),
        code_error=z.copy(),
        d1_carr=z.copy(),
        d2_carr=z.copy(),
    )
