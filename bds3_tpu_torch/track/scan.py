"""The tracking epochs in plain PyTorch: the references the CUDA kernels
are held to, and the prefix-sum ("bucket") correlator path.

Port of `bds3_tpu/track/scan.py`.  Each block function runs W closed-loop
epochs for all channels with the channels as a batch dimension and a
Python loop over the epochs:

* `track_block_reference` computes the direct-sum ("gather") correlator of
  `scan.py:162-168`: every sample of the epoch is mixed with the local
  carrier and multiplied by the code chip it falls in, indexed as
  `_code_indices` (`scan.py:76-89`) does.  It is the plain version of
  `csrc/track_fused.cu`.
* `track_block_bucket` computes the same sums regrouped (`scan.py:170-196`):
  exclusive prefix sums of the mixed samples, differenced at the sample
  boundary of every chip, dotted with the chip table.  Its `prefix_fn`
  makes the prefixes: `bucket_prefix` with the in-epoch mix and a cumsum
  (the XLA path, `scan.py:137-160`), or `pallas_prefix` through
  `prefix.mix_prefix`, the wrapper of `csrc/mix_prefix.cu` (the
  `bucket_pallas` path, `scan.py:378-405`).

Both end in `_finish_epoch`: the discriminators of B2a and of B1C in
every track mode, with the wideband QMBOC composite pilot and its four
code blends (`scan.py:215-296`), the 3rd-order PLL and 2nd-order DLL, and
the phase remainders (`scan.py:298-320`).  B1C wideband adds a third tap,
the BOC(6,1) pilot at 12 table entries per chip, with its own coarse
code-phase table and, in the bucket path, its own chip boundaries.

The capture is real (int8 or float32) or complex64 (`_mix`); the bucket
path's `pallas_prefix` takes real int8 and float32 only, as its kernel
does.
Samples are read at `cursor + j` straight from the capture: the cursor is
an absolute int64 sample index, so neither the reference's per-block
shift nor its pre-gathered, 128-aligned windows (which exist for the
TPU's DMA) are needed, and the window offset `off` of the reference is 0.
Samples past the end of the capture read as zero, as the reference's
zero-padded tail does.

Every expression keeps the reference's operation order, and divisions by
configuration constants are multiplications by the float32 reciprocal:
XLA's simplifier rewrites `x / const` that way, so the reference computes
them so too.  PyTorch runs each operation separately, without fused
multiply-adds, and the CUDA kernels are compiled the same way
(`-fmad=false`), so they take the same `ceil()` branches for the epoch
length and the chip indices as these versions do.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from bds3_tpu_torch.config import Signal
from bds3_tpu_torch.track.prefix import (
    buffers as prefix_buffers,
    mix_prefix,
    n_tiles,
)
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
    # B1C wideband only: the BOC(6,1) pilot at m_p61 = 12 entries per chip
    code61: torch.Tensor | None = None     # (C, L*12 + 2*CODE_PAD) int8
    ck61_int: torch.Tensor | None = None   # (k_max,) int32, at m = 12
    ck61_frac: torch.Tensor | None = None  # (k_max,) float32


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


def describe(cfg: TrackConfig) -> str:
    return (f"{cfg.signal.name} {cfg.mode.name} "
            f"{'complex' if cfg.complex_input else 'real'} input")


def _f32(x: float) -> float:
    return float(np.float32(x))


def _boundary_constants(cfg: TrackConfig, m: int, sfx: str) -> dict:
    """step*m and the bucket boundaries' 1/(step*m), split into int and
    fraction on the host in float64 (scan.py:174-180), for a table of m
    entries per chip; the keys end in `sfx`."""
    inv0 = 1.0 / (cfg.step_base * m)
    inv0_int = int(np.floor(inv0))
    return {f"sm{sfx}": _f32(cfg.step_base * m),
            f"inv0_int{sfx}": inv0_int,
            f"inv0_int_f{sfx}": _f32(inv0_int),
            f"inv0_frac{sfx}": _f32(inv0 - inv0_int)}


@functools.lru_cache(maxsize=None)
def loop_constants(cfg: TrackConfig) -> dict:
    """The float32 constants of one epoch, as Python floats that are exact
    float32 values; the kernel's parameter block carries the same ones.
    Where the reference writes a constant as a Python expression (1 - f,
    g61, W11), it is formed in float64 and cast once, as JAX casts it."""
    one = np.float32(1.0)
    k = dict(
        step_base=_f32(cfg.step_base),
        inv_step_base=float(one / np.float32(cfg.step_base)),
        inv_fs=float(one / np.float32(cfg.fs)),
        q0_frac=_f32(cfg.q0_frac),
        q0_sum=_f32(cfg.q0_int + cfg.q0_frac),
        q0_step_minus_l=_f32(cfg.q0_int * cfg.step_base - cfg.code_length),
        spacing=_f32(cfg.spacing),
        inv2pi=_f32(1.0 / (2.0 * np.pi)),
        two_pi=_f32(2.0 * np.pi),
        pf1=_f32(cfg.pf1),
        pf2=_f32(cfg.pf2),
        pf3=_f32(cfg.pf3),
        dll_c1=_f32(cfg.tau2 / cfg.tau1),
        dll_c2=_f32(cfg.int_time / cfg.tau1),
        # B1C: E-L slope normalisation and the 11/29 blend (scan.py:225-242)
        one_minus_spacing=_f32(1.0 - cfg.spacing),
        inv40=float(one / np.float32(40.0)),
        # B1C wideband (scan.py:243-296): the composite pilot's weights,
        # the BOC(6,1) bank's spacing, the data/pilot DLL factor, and the
        # "split" blend's BOC(6,1) slope normalisation
        w11=_f32(W11),
        w61=_f32(W61),
        spacing61=_f32(cfg.spacing61 if cfg.wb_code_blend == "split"
                       else cfg.spacing),
        dll_f=_f32(cfg.dll_factor),
        one_minus_dll_f=_f32(1.0 - cfg.dll_factor),
        g61=_f32(3.0 * (1.0 - cfg.spacing) * (1.0 - 23.0 * cfg.spacing61)
                 / (23.0 * (1.0 - 3.0 * cfg.spacing))),
        **_boundary_constants(cfg, cfg.m_data, ""),
    )
    if cfg.wideband:
        k.update(_boundary_constants(cfg, cfg.m_p61, "61"))
    return k


def _eml(ie, qe, il, ql):
    e = torch.sqrt(ie * ie + qe * qe)
    l = torch.sqrt(il * il + ql * ql)
    return (e - l) / (e + l)


def check_capture(cfg: TrackConfig, capture: torch.Tensor) -> None:
    """Raise unless the capture's kind is the one `cfg` was built for:
    complex64 for complex input, else real (int8, float32)."""
    if capture.is_complex() != cfg.complex_input:
        raise TypeError(f"a {capture.dtype} capture for a config built for "
                        f"{describe(cfg)}")


class _Bank(NamedTuple):
    """Taps that share one chip grid: m table entries per chip, the same
    E/P/L offsets and the same coarse tables."""

    names: tuple           # tap names, "d" "p11" or "p61"
    tables: torch.Tensor   # (C, taps, L*m + 2*CODE_PAD) int8
    m: int
    spacing: float         # E/L offset [chips]
    ck_int: torch.Tensor   # (k_max,) int32
    ck_frac: torch.Tensor  # (k_max,) float32
    sfx: str               # suffix of its loop_constants keys


def _banks(cfg: TrackConfig, k: dict, tables: TrackTables) -> list[_Bank]:
    names = ("d", "p11") if cfg.use_pilot else ("d",)
    banks = [_Bank(names, tables.code, cfg.m_data, k["spacing"],
                   tables.ck_int, tables.ck_frac, "")]
    if cfg.wideband:
        # "split" runs the BOC(6,1) bank at its own narrow spacing
        # (scan.py:207-210)
        banks.append(_Bank(("p61",), tables.code61[:, None], cfg.m_p61,
                           k["spacing61"], tables.ck61_int, tables.ck61_frac,
                           "61"))
    return banks


def _blksize(cfg: TrackConfig, k: dict, rem_code, d_step):
    """delta and blksize = ceil((L - rem)/step) (scan.py:125-131), int64."""
    e_rel = d_step * k["inv_step_base"]
    corr = 1.0 - e_rel + e_rel * e_rel
    resid = k["q0_frac"] - (rem_code * k["inv_step_base"]
                            + k["q0_sum"] * e_rel) * corr
    delta = torch.ceil(resid).to(torch.int64)
    return delta, cfg.q0_int + delta


class _SampleGrid(NamedTuple):
    """Per-sample indices of one epoch window, j in [0, n_max)."""

    j: torch.Tensor        # (n,) int64
    k_idx: torch.Tensor    # (n,) int64 coarse-table index j // SPLIT
    r_f: torch.Tensor      # (n,) float32 j % SPLIT
    j_f: torch.Tensor      # (n,) float32 j
    carr_tk: torch.Tensor  # (C, n) float32 coarse carrier phase


def _sample_grid(cfg: TrackConfig, consts) -> _SampleGrid:
    j = torch.arange(cfg.n_max, device=consts.carr_t.device)
    k_idx = j // SPLIT
    return _SampleGrid(j, k_idx, (j % SPLIT).to(torch.float32),
                       j.to(torch.float32), consts.carr_t[:, k_idx])


def _mix(k: dict, capture, grid: _SampleGrid, a_base, cursor, blksize,
         rem_cyc, d_cyc):
    """The epoch's samples [cursor, cursor + blksize) times the local
    carrier e^{-j theta} (scan.py:140-152): (i_bb, q_bb), each (C, n).
    A real sample x (int8 or float32) gives (x c, -(x s)); a complex one
    xr + j xi gives (xr c + xi s, xi c - xr s), each product and sum its
    own float32 operation, in that order (scan.py:145-148)."""
    total = capture.shape[0]
    g = cursor[:, None] + grid.j[None, :]
    valid = (grid.j[None, :] < blksize[:, None]) & (g >= 0) & (g < total)
    x = torch.where(valid, capture[g.clamp(0, total - 1)], 0)
    cyc = torch.remainder(grid.carr_tk + rem_cyc[:, None]
                          + grid.r_f * a_base[:, None]
                          + grid.j_f * d_cyc[:, None], 1.0)
    ang = k["two_pi"] * cyc
    c, s = torch.cos(ang), torch.sin(ang)
    if x.is_complex():
        xr, xi = x.real, x.imag
        return xr * c + xi * s, xi * c - xr * s
    x = x.to(torch.float32)
    return x * c, -(x * s)


def _wideband_errors(cfg: TrackConfig, k: dict, out: dict, code_d, carr_d):
    """The B1C wideband QMBOC composite pilot and its code blends
    (scan.py:243-296); adds the composite correlators p_* to `out`."""
    for x in ("e", "p", "l"):
        out[f"p_i{x}"] = -k["w61"] * out[f"p61_i{x}"] \
            + k["w11"] * out[f"p11_q{x}"]
        out[f"p_q{x}"] = -k["w61"] * out[f"p61_q{x}"] \
            - k["w11"] * out[f"p11_i{x}"]
    carr_p = torch.atan(out["p_qp"] / out["p_ip"]) * k["inv2pi"]
    carr_err = (carr_d + 3.0 * carr_p) * 0.25
    blend = cfg.wb_code_blend
    if blend in ("nb", "split"):
        code_p11 = _eml(out["p11_ie"], out["p11_qe"], out["p11_il"],
                        out["p11_ql"]) * k["one_minus_spacing"]
    if blend == "nb":
        return carr_err, (code_d * 11.0 + code_p11 * 29.0) * k["inv40"]
    if blend == "split":
        code_p61 = _eml(out["p61_ie"], out["p61_qe"], out["p61_il"],
                        out["p61_ql"]) * k["g61"]
        code_p = 0.3 * code_p11 + 0.7 * code_p61
    elif blend == "dotprod":
        dp_num = (out["p_ie"] - out["p_il"]) * out["p_ip"] \
            + (out["p_qe"] - out["p_ql"]) * out["p_qp"]
        dp_den = out["p_ip"] * out["p_ip"] + out["p_qp"] * out["p_qp"]
        code_p = 0.25 * dp_num / dp_den * k["one_minus_spacing"]
    else:
        code_p = _eml(out["p_ie"], out["p_qe"], out["p_il"],
                      out["p_ql"]) * k["one_minus_spacing"]
    return carr_err, code_d * k["dll_f"] + code_p * k["one_minus_dll_f"]


def _finish_epoch(cfg: TrackConfig, k: dict, consts, out: dict, st: tuple,
                  delta, blksize) -> tuple:
    """Discriminators, loop filters and phase remainders of one epoch from
    its correlators in `out` (scan.py:215-320).  Adds the epoch's outputs
    and new state to `out`; returns the new state tuple."""
    (rem_code, rem_cyc, d_cyc, d_step,
     code_nco, code_error, d1_carr, d2_carr) = st

    # --- discriminators (scan.py:223-296) --------------------------------
    carr_d = torch.atan(out["d_qp"] / out["d_ip"]) * k["inv2pi"]
    code_d = _eml(out["d_ie"], out["d_qe"], out["d_il"], out["d_ql"])
    b1c = cfg.signal == Signal.B1C
    if b1c:
        code_d = code_d * k["one_minus_spacing"]   # WB_tracking.m:409-410
    if not cfg.use_pilot:
        carr_err, code_err = carr_d, code_d
    elif cfg.wideband:
        carr_err, code_err = _wideband_errors(cfg, k, out, code_d, carr_d)
    else:
        # pilot pi/2 ahead of data; rotate back (tracking.m:341-353)
        carr_p = torch.atan(-out["p11_ip"] / out["p11_qp"]) * k["inv2pi"]
        code_p = _eml(out["p11_ie"], out["p11_qe"], out["p11_il"],
                      out["p11_ql"])
        if b1c:
            # narrowband 11/29 power weighting (NB_tracking.m:353-384)
            code_p = code_p * k["one_minus_spacing"]
            carr_err = (carr_d * 11.0 + carr_p * 29.0) * k["inv40"]
            code_err = (code_d * 11.0 + code_p * 29.0) * k["inv40"]
        else:
            carr_err = 0.5 * (carr_d + carr_p)
            code_err = 0.5 * (code_d + code_p)

    # --- loop filters (scan.py:298-306) ----------------------------------
    d2_new = d2_carr + carr_err * k["pf3"]
    d1_new = d2_new + carr_err * k["pf2"] + d1_carr
    carr_nco = d1_new + carr_err * k["pf1"]
    d_cyc_new = carr_nco * k["inv_fs"]
    code_nco_new = code_nco + k["dll_c1"] * (code_err - code_error) \
        + code_err * k["dll_c2"]
    d_step_new = consts.init_dstep - code_nco_new * k["inv_fs"]

    # --- phase remainders (scan.py:308-317) ------------------------------
    delta_f = delta.to(torch.float32)
    blk_f = blksize.to(torch.float32)
    rem_cyc_new = torch.remainder(
        rem_cyc + consts.q0_cyc + delta_f * consts.a_base + blk_f * d_cyc,
        1.0)
    rem_code_new = rem_code + k["q0_step_minus_l"] \
        + delta_f * k["step_base"] + blk_f * d_step

    out.update(
        carr_err=carr_err, code_err=code_err,
        carr_nco=carr_nco, code_nco=code_nco_new,
        d_cyc=d_cyc, d_step=d_step,
        rem_code_phase=rem_code, rem_carr_cyc=rem_cyc,
        blksize=blk_f,
    )
    new = (rem_code_new, rem_cyc_new, d_cyc_new, d_step_new,
           code_nco_new, code_err, d1_new, d2_new)
    for f, v in zip(STATE_FIELDS, new):
        out[f"st_{f}"] = v
    return new


def _sum_rounded(x: torch.Tensor) -> torch.Tensor:
    """Row sums of float32 products, summed in float64 and rounded once,
    as the CUDA kernel's compensated sums are (track_fused.cu)."""
    return x.sum(1, dtype=torch.float64).to(torch.float32)


def track_block_reference(cfg: TrackConfig, capture: torch.Tensor,
                          tables: TrackTables, consts, state: TrackState
                          ) -> tuple[TrackState, torch.Tensor]:
    """Run cfg.epochs_per_block epochs for all channels, direct sums.

    capture: (N,), the whole capture: int8 or float32 real, or complex64
    for a config built with complex_input.  consts: ChannelConsts of
    tensors (carr_t (C, k_max), a_base/q0_cyc/init_dstep (C,) float32).
    Returns (new TrackState, rows (W, C, len(slot_names(cfg))) float32).
    """
    check_capture(cfg, capture)
    k = loop_constants(cfg)
    grid = _sample_grid(cfg, consts)
    # per bank: (bank, coarse int (n,) int64, coarse frac (n,), r_f * sm)
    banks = [(b, b.ck_int[grid.k_idx].to(torch.int64), b.ck_frac[grid.k_idx],
              grid.r_f * k[f"sm{b.sfx}"]) for b in _banks(cfg, k, tables)]
    names = slot_names(cfg)

    cursor = state.cursor.clone()
    st = tuple(state.statef.unbind(1))
    rows = []
    for _ in range(cfg.epochs_per_block):
        rem_code, rem_cyc, d_cyc, d_step = st[:4]
        delta, blksize = _blksize(cfg, k, rem_code, d_step)
        i_bb, q_bb = _mix(k, capture, grid, consts.a_base, cursor, blksize,
                          rem_cyc, d_cyc)

        # --- E/P/L correlators (scan.py:76-89, 162-168) -----------------
        out = {}
        for bank, ck_int, ck_frac, rsm in banks:
            m = bank.m
            lm = cfg.code_length * m
            jd = grid.j_f * (d_step * m)[:, None]
            for tn, off in (("e", -bank.spacing), ("p", 0.0),
                            ("l", bank.spacing)):
                base = rem_code + off
                frac = (base * m)[:, None] + ck_frac + rsm + jd
                idx = ck_int + torch.ceil(frac).to(torch.int64) - 1
                idx = torch.remainder(idx, lm)
                for t, tap_name in enumerate(bank.names):
                    cv = bank.tables[:, t].gather(1, idx + CODE_PAD) \
                        .to(torch.float32)
                    out[f"{tap_name}_i{tn}"] = _sum_rounded(cv * i_bb)
                    out[f"{tap_name}_q{tn}"] = _sum_rounded(cv * q_bb)

        st = _finish_epoch(cfg, k, consts, out, st, delta, blksize)
        cursor = cursor + blksize
        rows.append(torch.stack([out[n] for n in names], dim=-1))

    return TrackState(cursor, torch.stack(st, dim=1)), torch.stack(rows)


# --- prefix functions of the bucket path ----------------------------------
# prefix_fn(cfg, capture, consts) is called once per block and returns
# prefix(cursor, blksize, rem_cyc, d_cyc) -> (P_i, P_q), each (C, n_max + 1)
# float32 with P[:, x] = sum of the epoch's mixed samples j < x (so the last
# entry is the epoch total).


def bucket_prefix(cfg: TrackConfig, capture: torch.Tensor, consts):
    """The "bucket" path: the in-epoch mix of track_block_reference, then
    cat(0, cumsum) (scan.py:157-160).  Plain PyTorch on any device."""
    k = loop_constants(cfg)
    grid = _sample_grid(cfg, consts)

    def prefix(cursor, blksize, rem_cyc, d_cyc):
        i_bb, q_bb = _mix(k, capture, grid, consts.a_base, cursor, blksize,
                          rem_cyc, d_cyc)
        z = i_bb.new_zeros((i_bb.shape[0], 1))
        return (torch.cat([z, torch.cumsum(i_bb, 1)], 1),
                torch.cat([z, torch.cumsum(q_bb, 1)], 1))

    return prefix


def pallas_prefix(cfg: TrackConfig, capture: torch.Tensor, consts,
                  mix=mix_prefix):
    """The "bucket_pallas" path: `prefix.mix_prefix` (the CUDA kernel on
    the card, its plain version on the CPU), fed the per-tile carrier
    phase of scan.py:400-403 with the window offset 0.  The outputs and
    the kernel's scratch are allocated once per block and rewritten every
    epoch.  `mix` may be
    `prefix.mix_prefix_reference`, to hold the kernel to its plain version
    along a whole block on the card."""
    n = cfg.n_max
    dev = consts.carr_t.device
    carr_t = consts.carr_t[:, :n_tiles(n)]
    tile_f = torch.arange(n_tiles(n), dtype=torch.float32, device=dev) \
        * float(SPLIT)
    out, scratch = prefix_buffers(carr_t.shape[0], n, dev)

    def prefix(cursor, blksize, rem_cyc, d_cyc):
        slope = consts.a_base + d_cyc
        base = carr_t + rem_cyc[:, None] + tile_f[None, :] * d_cyc[:, None]
        return mix(capture, cursor, blksize, base, slope, n, out=out,
                   scratch=scratch)

    return prefix


class _BucketGrid(NamedTuple):
    """A bank's chip boundaries k in [-CODE_PAD, L*m + CODE_PAD], with the
    parts of j_k that do not change between epochs."""

    bank: _Bank
    cv: torch.Tensor       # (C, taps, K) float32 chip tables
    offs: torch.Tensor     # (3,) float32 E/P/L offsets [chips]
    k_f: torch.Tensor      # (K+1,) float32 k
    kj: torch.Tensor       # (K+1,) int64 k * inv0_int
    kfrac: torch.Tensor    # (K+1,) float32 k * inv0_frac


def _bucket_grid(cfg: TrackConfig, k: dict, bank: _Bank, dev) -> _BucketGrid:
    lm = cfg.code_length * bank.m
    k_i = torch.arange(-CODE_PAD, lm + CODE_PAD + 1, device=dev)
    k_f = k_i.to(torch.float32)
    return _BucketGrid(
        bank, bank.tables.to(torch.float32),
        torch.tensor([-bank.spacing, 0.0, bank.spacing], dtype=torch.float32,
                     device=dev),
        k_f, k_i * k[f"inv0_int{bank.sfx}"], k_f * k[f"inv0_frac{bank.sfx}"])


def _bucket_sums(k: dict, g: _BucketGrid, n: int, rem_code, d_step,
                 p_i, p_q, out: dict) -> None:
    """One bank's correlators from the epoch's prefixes (scan.py:170-196)
    into `out`.  The sum over the samples of chip bucket k, j in
    ((k - base*m)/sm, (k+1 - base*m)/sm], is P[j_{k+1}] - P[j_k]; the
    boundaries j_k depend only on m, the tap offset and d_step, so the taps
    of a bank share them, and one gather of P serves all its correlators
    of a component (I or Q)."""
    m, sfx = g.bank.m, g.bank.sfx
    # --- chip boundaries j_k (scan.py:174-185), (C, 3, K+1) --------------
    smm = k[f"sm{sfx}"] + d_step * m
    inv = 1.0 / smm
    dinv = inv - k[f"inv0_int_f{sfx}"] - k[f"inv0_frac{sfx}"]
    base = rem_code[:, None] + g.offs[None, :]                # (C, 3)
    frac_part = g.kfrac + g.k_f * dinv[:, None, None] \
        - ((base * m) * inv[:, None])[:, :, None]
    j_k = g.kj + torch.floor(frac_part).to(torch.int64) + 1
    iw = j_k.clamp(0, n).reshape(j_k.shape[0], -1)
    # --- bucket sums and the dot with the tables (scan.py:186-196) -------
    gi = p_i.gather(1, iw).reshape(j_k.shape)
    gq = p_q.gather(1, iw).reshape(j_k.shape)
    bi = (gi[..., 1:] - gi[..., :-1])[:, None]                # (C, 1, 3, K)
    bq = (gq[..., 1:] - gq[..., :-1])[:, None]
    ci = (g.cv[:, :, None] * bi).sum(-1)                      # (C, taps, 3)
    cq = (g.cv[:, :, None] * bq).sum(-1)
    for t, tap_name in enumerate(g.bank.names):
        for e, tn in enumerate(("e", "p", "l")):
            out[f"{tap_name}_i{tn}"] = ci[:, t, e]
            out[f"{tap_name}_q{tn}"] = cq[:, t, e]


def track_block_bucket(cfg: TrackConfig, capture: torch.Tensor,
                       tables: TrackTables, consts, state: TrackState,
                       prefix_fn=bucket_prefix
                       ) -> tuple[TrackState, torch.Tensor]:
    """Run cfg.epochs_per_block epochs for all channels with the prefix-sum
    correlator (scan.py:170-196); arguments and result as
    track_block_reference.  B1C wideband's BOC(6,1) bank takes the same
    prefixes on its own boundary grid at m = 12."""
    check_capture(cfg, capture)
    k = loop_constants(cfg)
    n = cfg.n_max
    prefix = prefix_fn(cfg, capture, consts)
    grids = [_bucket_grid(cfg, k, b, capture.device)
             for b in _banks(cfg, k, tables)]
    names = slot_names(cfg)

    cursor = state.cursor.clone()
    st = tuple(state.statef.unbind(1))
    rows = []
    for _ in range(cfg.epochs_per_block):
        rem_code, rem_cyc, d_cyc, d_step = st[:4]
        delta, blksize = _blksize(cfg, k, rem_code, d_step)
        p_i, p_q = prefix(cursor, blksize, rem_cyc, d_cyc)
        out = {}
        for g in grids:
            _bucket_sums(k, g, n, rem_code, d_step, p_i, p_q, out)
        st = _finish_epoch(cfg, k, consts, out, st, delta, blksize)
        cursor = cursor + blksize
        rows.append(torch.stack([out[name] for name in names], dim=-1))

    return TrackState(cursor, torch.stack(st, dim=1)), torch.stack(rows)


def unpack_rows(cfg: TrackConfig, rows: torch.Tensor) -> dict:
    """name -> (W, C) views of packed rows (W, C, slots)."""
    return {n: rows[..., i] for i, n in enumerate(output_names(cfg))}
