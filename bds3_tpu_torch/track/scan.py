"""The tracking epochs in plain PyTorch: the reference the CUDA kernel is
held to.

Port of `bds3_tpu/track/scan.py`.  `track_block_reference` runs W
closed-loop epochs for all channels with the channels as a batch
dimension and a Python loop over the epochs.  Each epoch computes the
direct-sum ("gather") correlator of `scan.py:162-168`: every sample of
the epoch is mixed with the local carrier and multiplied by the code chip
it falls in, indexed as `_code_indices` (`scan.py:76-89`) does.  Then come
the B2a discriminators (`scan.py:216-235`), the 3rd-order PLL and
2nd-order DLL, and the phase remainders (`scan.py:298-320`).

Samples are read at `cursor + j` straight from the capture: the cursor is
an absolute int64 sample index, so neither the reference's per-block
shift nor its pre-gathered, 128-aligned windows (which exist for the
TPU's DMA) are needed.  Samples past the end of the capture read as zero,
as the reference's zero-padded tail does.

Every expression keeps the reference's operation order, and divisions by
configuration constants are multiplications by the float32 reciprocal:
XLA's simplifier rewrites `x / const` that way, so the reference computes
them so too.  PyTorch runs each operation separately, without fused
multiply-adds, and `csrc/track_fused.cu` is compiled the same way
(`-fmad=false`), so the kernel takes the same `ceil()` branches for the
epoch length and the chip indices as this version does.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from bds3_tpu.config import Signal, TrackMode
from bds3_tpu_torch.track.state import SPLIT, TrackConfig

W11 = float(np.sqrt(29.0 / 33.0))  # QMBOC pilot BOC(1,1) amplitude
W61 = float(np.sqrt(4.0 / 33.0))   # QMBOC pilot BOC(6,1) amplitude

START_GUARD = 16  # the reference's window guard; reading at the cursor needs none
CODE_PAD = 16     # circular padding of the code tables

# float32 loop state carried between epochs, in ChannelState's order
STATE_FIELDS = ("rem_code_phase", "rem_carr_cyc", "d_cyc", "d_step",
                "code_nco", "code_error", "d1_carr", "d2_carr")


class TrackState(NamedTuple):
    """Per-channel loop state on the device."""

    cursor: torch.Tensor   # (C,) int64 absolute sample index of the next epoch
    statef: torch.Tensor   # (C, 8) float32, STATE_FIELDS order


class TrackTables(NamedTuple):
    """Code tables on the device."""

    code: torch.Tensor     # (C, taps, L*m + 2*CODE_PAD) int8; tap 0 data, 1 pilot
    ck_int: torch.Tensor   # (k_max,) int32 coarse code-phase table
    ck_frac: torch.Tensor  # (k_max,) float32


def output_names(cfg: TrackConfig) -> list[str]:
    """Sorted per-epoch output keys emitted for this config."""
    names = [f"d_{c}{t}" for c in ("i", "q") for t in ("e", "p", "l")]
    if cfg.use_pilot:
        names += [f"p11_{c}{t}" for c in ("i", "q") for t in ("e", "p", "l")]
    if cfg.wideband:
        names += [f"p61_{c}{t}" for c in ("i", "q") for t in ("e", "p", "l")]
        names += [f"p_{c}{t}" for c in ("i", "q") for t in ("e", "p", "l")]
    names += ["carr_err", "code_err", "carr_nco", "code_nco",
              "d_cyc", "d_step", "rem_code_phase", "rem_carr_cyc", "blksize"]
    return sorted(names)


def slot_names(cfg: TrackConfig) -> list[str]:
    """Columns of one packed output row: the outputs, then the new state."""
    return output_names(cfg) + [f"st_{f}" for f in STATE_FIELDS]


def reference_supported(cfg: TrackConfig) -> bool:
    """Configs this module (and the CUDA kernel) implement: B2a, data-only
    or data+pilot, real input."""
    return (cfg.signal == Signal.B2A
            and cfg.mode in (TrackMode.DATA_ONLY, TrackMode.NARROWBAND)
            and not cfg.complex_input)


def describe(cfg: TrackConfig) -> str:
    return (f"{cfg.signal.name} {cfg.mode.name} "
            f"{'complex' if cfg.complex_input else 'real'} input")


def _f32(x: float) -> float:
    return float(np.float32(x))


@functools.lru_cache(maxsize=None)
def loop_constants(cfg: TrackConfig) -> dict:
    """The float32 constants of one epoch, as Python floats that are exact
    float32 values; the kernel's parameter block carries the same ones."""
    one = np.float32(1.0)
    return dict(
        step_base=_f32(cfg.step_base),
        inv_step_base=float(one / np.float32(cfg.step_base)),
        inv_fs=float(one / np.float32(cfg.fs)),
        q0_frac=_f32(cfg.q0_frac),
        q0_sum=_f32(cfg.q0_int + cfg.q0_frac),
        q0_step_minus_l=_f32(cfg.q0_int * cfg.step_base - cfg.code_length),
        sm=_f32(cfg.step_base * cfg.m_data),
        spacing=_f32(cfg.spacing),
        inv2pi=_f32(1.0 / (2.0 * np.pi)),
        two_pi=_f32(2.0 * np.pi),
        pf1=_f32(cfg.pf1),
        pf2=_f32(cfg.pf2),
        pf3=_f32(cfg.pf3),
        dll_c1=_f32(cfg.tau2 / cfg.tau1),
        dll_c2=_f32(cfg.int_time / cfg.tau1),
    )


def _eml(ie, qe, il, ql):
    e = torch.sqrt(ie * ie + qe * qe)
    l = torch.sqrt(il * il + ql * ql)
    return (e - l) / (e + l)


def track_block_reference(cfg: TrackConfig, capture: torch.Tensor,
                          tables: TrackTables, consts, state: TrackState
                          ) -> tuple[TrackState, torch.Tensor]:
    """Run cfg.epochs_per_block epochs for all channels.

    capture: (N,) int8, the whole capture.  consts: ChannelConsts of
    tensors (carr_t (C, k_max), a_base/q0_cyc/init_dstep (C,) float32).
    Returns (new TrackState, rows (W, C, len(slot_names(cfg))) float32).
    """
    if not reference_supported(cfg):
        raise NotImplementedError(
            f"tracking for {describe(cfg)} is not ported yet")
    k = loop_constants(cfg)
    dev = capture.device
    total = capture.shape[0]
    m = cfg.m_data
    lm = cfg.code_length * m

    j = torch.arange(cfg.n_max, device=dev)
    k_idx = j // SPLIT
    r_f = (j % SPLIT).to(torch.float32)
    j_f = j.to(torch.float32)
    rsm = r_f * k["sm"]
    ck_int = tables.ck_int[k_idx].to(torch.int64)
    ck_frac = tables.ck_frac[k_idx]
    carr_tk = consts.carr_t[:, k_idx]                       # (C, n_max)
    a_base = consts.a_base
    taps = [("d", tables.code[:, 0])]
    if cfg.use_pilot:
        taps.append(("p11", tables.code[:, 1]))
    spc = k["spacing"]
    names = slot_names(cfg)

    cursor = state.cursor.clone()
    (rem_code, rem_cyc, d_cyc, d_step,
     code_nco, code_error, d1_carr, d2_carr) = state.statef.unbind(1)
    rows = []
    for _ in range(cfg.epochs_per_block):
        # --- blksize = ceil((L - rem)/step) (scan.py:125-131) -------------
        e_rel = d_step * k["inv_step_base"]
        corr = 1.0 - e_rel + e_rel * e_rel
        resid = k["q0_frac"] - (rem_code * k["inv_step_base"]
                                + k["q0_sum"] * e_rel) * corr
        delta = torch.ceil(resid).to(torch.int64)
        blksize = cfg.q0_int + delta

        # --- samples [cursor, cursor + blksize) -------------------------
        g = cursor[:, None] + j[None, :]
        valid = (j[None, :] < blksize[:, None]) & (g >= 0) & (g < total)
        x = torch.where(valid, capture[g.clamp(0, total - 1)], 0)
        x = x.to(torch.float32)

        # --- local carrier e^{-j theta} (scan.py:140-152) ---------------
        cyc = torch.remainder(carr_tk + rem_cyc[:, None]
                              + r_f * a_base[:, None]
                              + j_f * d_cyc[:, None], 1.0)
        ang = k["two_pi"] * cyc
        i_bb = x * torch.cos(ang)
        q_bb = -(x * torch.sin(ang))

        # --- E/P/L correlators (scan.py:76-89, 162-168) -----------------
        out = {}
        jd = j_f * (d_step * m)[:, None]
        for tap_name, table in taps:
            for tn, off in (("e", -spc), ("p", 0.0), ("l", spc)):
                base = rem_code + off
                frac = (base * m)[:, None] + ck_frac + rsm + jd
                idx = ck_int + torch.ceil(frac).to(torch.int64) - 1
                idx = torch.remainder(idx, lm)
                cv = table.gather(1, idx + CODE_PAD).to(torch.float32)
                out[f"{tap_name}_i{tn}"] = (cv * i_bb).sum(1)
                out[f"{tap_name}_q{tn}"] = (cv * q_bb).sum(1)

        # --- discriminators (scan.py:216-235) ----------------------------
        carr_d = torch.atan(out["d_qp"] / out["d_ip"]) * k["inv2pi"]
        code_d = _eml(out["d_ie"], out["d_qe"], out["d_il"], out["d_ql"])
        if not cfg.use_pilot:
            carr_err, code_err = carr_d, code_d
        else:
            # pilot pi/2 ahead of data; rotate back (tracking.m:341-353)
            carr_p = torch.atan(-out["p11_ip"] / out["p11_qp"]) * k["inv2pi"]
            code_p = _eml(out["p11_ie"], out["p11_qe"], out["p11_il"],
                          out["p11_ql"])
            carr_err = 0.5 * (carr_d + carr_p)
            code_err = 0.5 * (code_d + code_p)

        # --- loop filters (scan.py:298-306) ------------------------------
        d2_new = d2_carr + carr_err * k["pf3"]
        d1_new = d2_new + carr_err * k["pf2"] + d1_carr
        carr_nco = d1_new + carr_err * k["pf1"]
        d_cyc_new = carr_nco * k["inv_fs"]
        code_nco_new = code_nco + k["dll_c1"] * (code_err - code_error) \
            + code_err * k["dll_c2"]
        d_step_new = consts.init_dstep - code_nco_new * k["inv_fs"]

        # --- phase remainders (scan.py:308-317) --------------------------
        delta_f = delta.to(torch.float32)
        blk_f = blksize.to(torch.float32)
        rem_cyc_new = torch.remainder(
            rem_cyc + consts.q0_cyc + delta_f * a_base + blk_f * d_cyc, 1.0)
        rem_code_new = rem_code + k["q0_step_minus_l"] \
            + delta_f * k["step_base"] + blk_f * d_step

        out.update(
            carr_err=carr_err, code_err=code_err,
            carr_nco=carr_nco, code_nco=code_nco_new,
            d_cyc=d_cyc, d_step=d_step,
            rem_code_phase=rem_code, rem_carr_cyc=rem_cyc,
            blksize=blk_f,
        )
        cursor = cursor + blksize
        (rem_code, rem_cyc, d_cyc, d_step,
         code_nco, code_error, d1_carr, d2_carr) = (
            rem_code_new, rem_cyc_new, d_cyc_new, d_step_new,
            code_nco_new, code_err, d1_new, d2_new)
        for f, v in zip(STATE_FIELDS, (rem_code, rem_cyc, d_cyc, d_step,
                                       code_nco, code_error, d1_carr,
                                       d2_carr)):
            out[f"st_{f}"] = v
        rows.append(torch.stack([out[n] for n in names], dim=-1))

    statef = torch.stack([rem_code, rem_cyc, d_cyc, d_step,
                          code_nco, code_error, d1_carr, d2_carr], dim=1)
    return TrackState(cursor, statef), torch.stack(rows)


def unpack_rows(cfg: TrackConfig, rows: torch.Tensor) -> dict:
    """name -> (W, C) views of packed rows (W, C, slots)."""
    return {n: rows[..., i] for i, n in enumerate(output_names(cfg))}
