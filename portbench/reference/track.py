"""Closed-loop tracking epochs in plain PyTorch: the reference of the
tracking cells.

A frozen copy of the arithmetic the program documents for its tracking
path (`bds3_tpu_torch/track/state.py`, the split-phase float32 NCO
scheme, and `track/scan.py:track_block_reference`, the direct sum), made
from the configuration's own numbers and this package's own code tables:

* per sample, the carrier phase is a float64 coarse table every 4096
  samples plus float32 residuals, and the chip index is the float32
  ceil() of a coarse table plus residuals, in the program's order;
* the E/P/L correlators sum the float32 products x.c.chip of each epoch
  in float64 and round once to float32 (`sum_dtype`; the control sums in
  float32);
* the discriminators of B2a and of B1C narrowband and wideband (the QMBOC
  composite pilot and its four code blends), the 3rd-order PLL and the
  2nd-order DLL, the phase remainders and the next epoch's length.

Every row of a call is one channel at its own cursor and loop state, so
one call runs any set of (channel, epoch) starting points together.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from scipy import integrate

from portbench.gen.signals import (
    b1c_data_boc11,
    b1c_pilot_boc11,
    b1c_pilot_boc61,
    b2a_data_code,
    b2a_pilot_code,
)

SPLIT = 4096
W11 = float(np.sqrt(29.0 / 33.0))   # QMBOC pilot BOC(1,1) amplitude
W61 = float(np.sqrt(4.0 / 33.0))    # QMBOC pilot BOC(6,1) amplitude
STATE = ("rem_code_phase", "rem_carr_cyc", "d_cyc", "d_step",
         "code_nco", "code_error", "d1_carr", "d2_carr")
MODES = ("DATA_ONLY", "NARROWBAND", "WIDEBAND")


def _f32(x: float) -> float:
    return float(np.float32(x))


def _boc_psd(f, fc: float, m: int):
    """Sine-BOC(m,1) PSD, normalised (`weighting.py:_boc_psd`)."""
    tc = 1.0 / fc
    x = np.sin(np.pi / (2 * m) * f / fc) * np.sin(np.pi * f / fc) / (
        np.cos(np.pi / (2 * m) * f / fc)) * fc / f / np.pi
    return tc * x**2


def wb_dll_weight(fc: float, br: float) -> float:
    """The wideband data/pilot DLL weight (`CalcWeighingFactor.m:42-81`)."""
    def data(f):
        return _boc_psd(f, fc, 1)

    def pilot(f):
        return 29.0 / 33.0 * _boc_psd(f, fc, 1) \
            + 4.0 / 33.0 * _boc_psd(f, fc, 6)

    def power(g):
        return integrate.quad(g, -br / 2, br / 2, limit=400, points=[0.0])[0]

    p_d, p_d2 = power(data), power(lambda f: data(f) * f ** 2)
    p_p, p_p2 = power(pilot), power(lambda f: pilot(f) * f ** 2)
    t1 = 11.0 * p_d * (p_d2 / p_d)
    t2 = 33.0 * p_p * (p_p2 / p_p)
    return float(t1 / (t1 + t2))


@dataclasses.dataclass(frozen=True)
class Loop:
    """The tracking loop of a configuration (`state.py:make_track_config`)."""

    signal: str
    mode: str
    fs: float
    code_length: int
    code_freq_basis: float
    carr_freq_basis: float
    intermediate_freq: float
    int_time: float
    spacing: float
    spacing61: float
    m_data: int
    m_p61: int
    n_max: int
    q0_int: int
    q0_frac: float
    step_base: float
    tau1: float
    tau2: float
    pf1: float
    pf2: float
    pf3: float
    dll_factor: float
    wb_code_blend: str

    @property
    def use_pilot(self) -> bool:
        return self.mode != "DATA_ONLY"

    @property
    def wideband(self) -> bool:
        return self.signal == "b1c" and self.mode == "WIDEBAND"

    @property
    def k_max(self) -> int:
        return self.n_max // SPLIT + 1

    def output_names(self) -> list[str]:
        """The program's per-epoch outputs, sorted (`scan.py:output_names`)."""
        names = [f"d_{c}{t}" for c in "iq" for t in "epl"]
        if self.use_pilot:
            names += [f"p11_{c}{t}" for c in "iq" for t in "epl"]
        if self.wideband:
            names += [f"p61_{c}{t}" for c in "iq" for t in "epl"]
            names += [f"p_{c}{t}" for c in "iq" for t in "epl"]
        names += ["carr_err", "code_err", "carr_nco", "code_nco", "d_cyc",
                  "d_step", "rem_code_phase", "rem_carr_cyc", "blksize"]
        return sorted(names)


def make_loop(st: dict) -> Loop:
    """The loop of the configuration's settings `st` (its file's
    `settings`, with the preset's values filled in)."""
    signal, mode = st["signal"], st["track_mode"]
    if mode not in MODES:
        raise ValueError(f"track_mode {mode!r} is not one of {MODES}")
    step_base = st["code_freq_basis"] / st["sampling_freq"]
    q0 = st["code_length"] / step_base
    q0_int = int(np.floor(q0))
    zeta, bn = st["dll_damping"], st["dll_bw"]
    wn = bn * 8.0 * zeta / (4.0 * zeta * zeta + 1.0)
    wn_c = 1.2 * st["pll_bw"]
    t = st["int_time"]
    wide = signal == "b1c" and mode == "WIDEBAND"
    return Loop(
        signal=signal, mode=mode, fs=st["sampling_freq"],
        code_length=st["code_length"],
        code_freq_basis=st["code_freq_basis"],
        carr_freq_basis=st["carr_freq_basis"],
        intermediate_freq=st["intermediate_freq"], int_time=t,
        spacing=st["dll_spacing"],
        spacing61=min(st["dll_spacing_boc61"], st["dll_spacing"]),
        m_data=1 if signal == "b2a" else 2, m_p61=12 if wide else 0,
        n_max=q0_int + 4, q0_int=q0_int, q0_frac=float(q0 - q0_int),
        step_base=step_base, tau1=1.0 / (wn * wn), tau2=2.0 * zeta / wn,
        pf1=2.0 * wn_c, pf2=2.0 * wn_c ** 2 * t, pf3=wn_c ** 3 * t ** 2,
        dll_factor=(wb_dll_weight(st["code_freq_basis"], st["front_end_bw"])
                    if wide else 0.5),
        wb_code_blend=st["wb_code_blend"])


def constants(lp: Loop) -> dict:
    """The float32 constants of one epoch (`scan.py:loop_constants`)."""
    one = np.float32(1.0)
    k = dict(
        step_base=_f32(lp.step_base),
        inv_step_base=float(one / np.float32(lp.step_base)),
        inv_fs=float(one / np.float32(lp.fs)),
        q0_frac=_f32(lp.q0_frac),
        q0_sum=_f32(lp.q0_int + lp.q0_frac),
        q0_step_minus_l=_f32(lp.q0_int * lp.step_base - lp.code_length),
        spacing=_f32(lp.spacing),
        inv2pi=_f32(1.0 / (2.0 * np.pi)),
        two_pi=_f32(2.0 * np.pi),
        pf1=_f32(lp.pf1), pf2=_f32(lp.pf2), pf3=_f32(lp.pf3),
        dll_c1=_f32(lp.tau2 / lp.tau1),
        dll_c2=_f32(lp.int_time / lp.tau1),
        one_minus_spacing=_f32(1.0 - lp.spacing),
        inv40=float(one / np.float32(40.0)),
        w11=_f32(W11), w61=_f32(W61),
        spacing61=_f32(lp.spacing61 if lp.wb_code_blend == "split"
                       else lp.spacing),
        dll_f=_f32(lp.dll_factor),
        one_minus_dll_f=_f32(1.0 - lp.dll_factor),
        sm=_f32(lp.step_base * lp.m_data),
    )
    if lp.wideband:
        k["sm61"] = _f32(lp.step_base * lp.m_p61)
    return k


@dataclasses.dataclass
class Channels:
    """Per-row tables and constants of a set of channels, on a device."""

    prn: np.ndarray            # (R,)
    cursor0: np.ndarray        # (R,) int64 first code start
    carr_t: torch.Tensor       # (R, k_max) float32
    a_base: torch.Tensor       # (R,) float32
    q0_cyc: torch.Tensor
    init_dstep: torch.Tensor
    banks: list                # (names, tables (R, taps, L*m) int8, m,
                               #  spacing key, ck_int, ck_frac, sfx)

    def take(self, rows) -> "Channels":
        """The channels of `rows` (an index array), in that order."""
        ix = torch.as_tensor(np.asarray(rows), device=self.carr_t.device)
        return Channels(
            self.prn[rows], self.cursor0[rows], self.carr_t[ix],
            self.a_base[ix], self.q0_cyc[ix], self.init_dstep[ix],
            [(n, t[ix], m, sp, ci, cf, sfx)
             for n, t, m, sp, ci, cf, sfx in self.banks])


def _coarse(lp: Loop, m: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """(SPLIT k step_base m) mod (L m) split into int32 and float32."""
    k = np.arange(lp.k_max, dtype=np.float64)
    ck = np.mod(SPLIT * k * (lp.step_base * m), lp.code_length * m)
    ck_int = np.floor(ck).astype(np.int32)
    return (torch.as_tensor(ck_int, device=dev),
            torch.as_tensor((ck - ck_int).astype(np.float32), device=dev))


def make_channels(lp: Loop, starts: list[dict], dev) -> Channels:
    """Tables and constants of the channels `starts` (prn, acquired_freq,
    code_phase), as `state.py:channel_consts` forms them."""
    base = np.array([c["acquired_freq"] for c in starts], np.float64)
    k = np.arange(lp.k_max, dtype=np.float64)
    fd = base - lp.intermediate_freq
    code_freq = lp.code_freq_basis * (1.0 + fd / lp.carr_freq_basis)
    init_dstep = (code_freq - lp.code_freq_basis) / lp.fs

    def dev32(x):
        return torch.as_tensor(np.asarray(x).astype(np.float32), device=dev)

    prns = [c["prn"] for c in starts]
    if lp.signal == "b2a":
        codes = [b2a_data_code, b2a_pilot_code]
    else:
        codes = [b1c_data_boc11, b1c_pilot_boc11]
    names = ("d", "p11") if lp.use_pilot else ("d",)
    tab = np.stack([np.stack([codes[t](p) for t in range(len(names))])
                    for p in prns])
    banks = [(names, torch.as_tensor(tab, device=dev), lp.m_data, "spacing",
              *_coarse(lp, lp.m_data, dev), "")]
    if lp.wideband:
        t61 = np.stack([b1c_pilot_boc61(p) for p in prns])[:, None]
        banks.append((("p61",), torch.as_tensor(t61, device=dev), lp.m_p61,
                      "spacing61", *_coarse(lp, lp.m_p61, dev), "61"))
    return Channels(
        prn=np.array(prns), cursor0=np.array([c["code_phase"] for c in starts],
                                             np.int64),
        carr_t=dev32(np.mod(base[:, None] * SPLIT * k[None, :] / lp.fs, 1.0)),
        a_base=dev32(np.mod(base / lp.fs, 1.0)),
        q0_cyc=dev32(np.mod(lp.q0_int * base / lp.fs, 1.0)),
        init_dstep=dev32(init_dstep), banks=banks)


def initial_state(ch: Channels) -> tuple[torch.Tensor, torch.Tensor]:
    """(cursor (R,) int64, state (R, 8) float32) before the first epoch."""
    st = torch.zeros((len(ch.prn), len(STATE)), dtype=torch.float32,
                     device=ch.carr_t.device)
    st[:, 3] = ch.init_dstep
    return torch.as_tensor(ch.cursor0, device=ch.carr_t.device), st


def _eml(ie, qe, il, ql):
    e = torch.sqrt(ie * ie + qe * qe)
    l = torch.sqrt(il * il + ql * ql)
    return (e - l) / (e + l)


def blksize(lp: Loop, k: dict, rem_code, d_step):
    """(delta, samples in the epoch) = ceil((L - rem)/step), int64."""
    e_rel = d_step * k["inv_step_base"]
    corr = 1.0 - e_rel + e_rel * e_rel
    resid = k["q0_frac"] - (rem_code * k["inv_step_base"]
                            + k["q0_sum"] * e_rel) * corr
    delta = torch.ceil(resid).to(torch.int64)
    return delta, lp.q0_int + delta


def errors(lp: Loop, k: dict, out: dict):
    """(carr_err, code_err) of one epoch from its correlators in `out`;
    adds the wideband composite correlators p_* to `out`."""
    carr_d = torch.atan(out["d_qp"] / out["d_ip"]) * k["inv2pi"]
    code_d = _eml(out["d_ie"], out["d_qe"], out["d_il"], out["d_ql"])
    b1c = lp.signal == "b1c"
    if b1c:
        code_d = code_d * k["one_minus_spacing"]
    if not lp.use_pilot:
        return carr_d, code_d
    if not lp.wideband:
        carr_p = torch.atan(-out["p11_ip"] / out["p11_qp"]) * k["inv2pi"]
        code_p = _eml(out["p11_ie"], out["p11_qe"], out["p11_il"],
                      out["p11_ql"])
        if b1c:
            code_p = code_p * k["one_minus_spacing"]
            return ((carr_d * 11.0 + carr_p * 29.0) * k["inv40"],
                    (code_d * 11.0 + code_p * 29.0) * k["inv40"])
        return 0.5 * (carr_d + carr_p), 0.5 * (code_d + code_p)
    for x in "epl":
        out[f"p_i{x}"] = -k["w61"] * out[f"p61_i{x}"] \
            + k["w11"] * out[f"p11_q{x}"]
        out[f"p_q{x}"] = -k["w61"] * out[f"p61_q{x}"] \
            - k["w11"] * out[f"p11_i{x}"]
    carr_p = torch.atan(out["p_qp"] / out["p_ip"]) * k["inv2pi"]
    carr_err = (carr_d + 3.0 * carr_p) * 0.25
    blend = lp.wb_code_blend
    if blend in ("nb", "split"):
        code_p11 = _eml(out["p11_ie"], out["p11_qe"], out["p11_il"],
                        out["p11_ql"]) * k["one_minus_spacing"]
    if blend == "nb":
        return carr_err, (code_d * 11.0 + code_p11 * 29.0) * k["inv40"]
    if blend == "split":
        g61 = _f32(3.0 * (1.0 - lp.spacing) * (1.0 - 23.0 * lp.spacing61)
                   / (23.0 * (1.0 - 3.0 * lp.spacing)))
        code_p61 = _eml(out["p61_ie"], out["p61_qe"], out["p61_il"],
                        out["p61_ql"]) * g61
        code_p = 0.3 * code_p11 + 0.7 * code_p61
    elif blend == "dotprod":
        num = (out["p_ie"] - out["p_il"]) * out["p_ip"] \
            + (out["p_qe"] - out["p_ql"]) * out["p_qp"]
        den = out["p_ip"] * out["p_ip"] + out["p_qp"] * out["p_qp"]
        code_p = 0.25 * num / den * k["one_minus_spacing"]
    else:
        code_p = _eml(out["p_ie"], out["p_qe"], out["p_il"],
                      out["p_ql"]) * k["one_minus_spacing"]
    return carr_err, code_d * k["dll_f"] + code_p * k["one_minus_dll_f"]


def filters(k: dict, carr_err, code_err, code_nco, code_error, d1, d2,
            init_dstep):
    """The PLL and DLL of one epoch: (carr_nco, code_nco, d1, d2, next
    d_cyc, next d_step)."""
    d2_new = d2 + carr_err * k["pf3"]
    d1_new = d2_new + carr_err * k["pf2"] + d1
    carr_nco = d1_new + carr_err * k["pf1"]
    code_nco_new = code_nco + k["dll_c1"] * (code_err - code_error) \
        + code_err * k["dll_c2"]
    return (carr_nco, code_nco_new, d1_new, d2_new, carr_nco * k["inv_fs"],
            init_dstep - code_nco_new * k["inv_fs"])


def remainders(k: dict, q0_cyc, a_base, rem_code, rem_cyc, d_cyc, d_step,
               delta, blk):
    """The code and carrier phase remainders after an epoch; q0_cyc and
    a_base are the channels' constants, shaped to broadcast."""
    delta_f = delta.to(torch.float32)
    blk_f = blk.to(torch.float32)
    rem_cyc_new = torch.remainder(
        rem_cyc + q0_cyc + delta_f * a_base + blk_f * d_cyc, 1.0)
    rem_code_new = rem_code + k["q0_step_minus_l"] \
        + delta_f * k["step_base"] + blk_f * d_step
    return rem_code_new, rem_cyc_new


def correlate(lp: Loop, k: dict, ch: Channels, capture: torch.Tensor,
              cursor, blk, rem_code, rem_cyc, d_cyc, d_step,
              sum_dtype=torch.float64) -> dict:
    """The E/P/L correlators of one epoch of every row: the samples
    [cursor, cursor + blk) mixed with the local carrier and summed against
    the chip each falls in."""
    dev = capture.device
    total = capture.shape[0]
    j = torch.arange(lp.n_max, device=dev)
    k_idx = j // SPLIT
    r_f = (j % SPLIT).to(torch.float32)
    j_f = j.to(torch.float32)
    g = cursor[:, None] + j[None, :]
    valid = (j[None, :] < blk[:, None]) & (g >= 0) & (g < total)
    x = torch.where(valid, capture[g.clamp(0, total - 1)], 0) \
        .to(torch.float32)
    cyc = torch.remainder(ch.carr_t[:, k_idx] + rem_cyc[:, None]
                          + r_f * ch.a_base[:, None] + j_f * d_cyc[:, None],
                          1.0)
    ang = k["two_pi"] * cyc
    i_bb, q_bb = x * torch.cos(ang), -(x * torch.sin(ang))
    out = {}
    for names, tables, m, sp_key, ck_int, ck_frac, sfx in ch.banks:
        lm = lp.code_length * m
        ci = ck_int[k_idx].to(torch.int64)
        cf = ck_frac[k_idx]
        rsm = r_f * k[f"sm{sfx}"]
        jd = j_f * (d_step * m)[:, None]
        for tn, off in (("e", -k[sp_key]), ("p", 0.0), ("l", k[sp_key])):
            base = rem_code + off
            frac = (base * m)[:, None] + cf + rsm + jd
            idx = torch.remainder(ci + torch.ceil(frac).to(torch.int64) - 1,
                                  lm)
            for t, name in enumerate(names):
                cv = tables[:, t].gather(1, idx).to(torch.float32)
                out[f"{name}_i{tn}"] = (cv * i_bb).sum(1, dtype=sum_dtype) \
                    .to(torch.float32)
                out[f"{name}_q{tn}"] = (cv * q_bb).sum(1, dtype=sum_dtype) \
                    .to(torch.float32)
    return out


def run(lp: Loop, ch: Channels, capture: torch.Tensor, cursor, state,
        n_epochs: int, sum_dtype=torch.float64):
    """n_epochs closed-loop epochs of every row from (cursor, state).
    Returns ({name: (R, n_epochs) float32 numpy}, cursor, state)."""
    k = constants(lp)
    names = lp.output_names()
    st = list(state.unbind(1))
    rows = {n: [] for n in names}
    for _ in range(n_epochs):
        rem_code, rem_cyc, d_cyc, d_step, code_nco, code_error, d1, d2 = st
        delta, blk = blksize(lp, k, rem_code, d_step)
        out = correlate(lp, k, ch, capture, cursor, blk, rem_code, rem_cyc,
                        d_cyc, d_step, sum_dtype)
        carr_err, code_err = errors(lp, k, out)
        carr_nco, code_nco_new, d1, d2, d_cyc_new, d_step_new = filters(
            k, carr_err, code_err, code_nco, code_error, d1, d2,
            ch.init_dstep)
        rem_code_new, rem_cyc_new = remainders(
            k, ch.q0_cyc, ch.a_base, rem_code, rem_cyc, d_cyc, d_step, delta,
            blk)
        out.update(carr_err=carr_err, code_err=code_err, carr_nco=carr_nco,
                   code_nco=code_nco_new, d_cyc=d_cyc, d_step=d_step,
                   rem_code_phase=rem_code, rem_carr_cyc=rem_cyc,
                   blksize=blk.to(torch.float32))
        for n in names:
            rows[n].append(out[n])
        st = [rem_code_new, rem_cyc_new, d_cyc_new, d_step_new, code_nco_new,
              code_err, d1, d2]
        cursor = cursor + blk
    return ({n: torch.stack(v, 1).cpu().numpy() for n, v in rows.items()},
            cursor, torch.stack(st, 1))


def track(lp: Loop, ch: Channels, capture: torch.Tensor, n_epochs: int,
          sum_dtype=torch.float64, chunk: int = 200) -> dict:
    """Every channel from its start over n_epochs epochs: the reference in
    the program's place.  {name: (C, n_epochs) float32 numpy}."""
    cursor, state = initial_state(ch)
    parts = []
    for start in range(0, n_epochs, chunk):
        out, cursor, state = run(lp, ch, capture, cursor, state,
                                 min(chunk, n_epochs - start), sum_dtype)
        parts.append(out)
    return {n: np.concatenate([p[n] for p in parts], 1) for n in parts[0]}

