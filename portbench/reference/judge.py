"""The comparison that decides `correct` in the tracking cells.

The program's answer to one request is every channel's per-epoch outputs
over the whole recording.  The reference cannot rerun 48,800 closed-loop
epochs inside a run's time, so it checks them in three parts, each exact:

* `start`: the first epochs of every channel, run by the reference from
  the channels' starts, closed loop, with nothing taken from the program;
* `segments`: short closed-loop stretches from epochs drawn from the
  seed, each started from the program's own state at that epoch (read
  from its outputs; the PLL's two integrators, which are no output, are
  summed again from its carrier errors in float32);
* `replay`: every epoch's discriminators, loop filters, phase remainders
  and epoch length, worked out again from the program's correlators and
  state of that epoch and held against what the program gives there and
  at the next epoch; and the program's cursors against the channels'
  starts plus the epoch lengths.

The numbers are in units in the last place of float32 (`ulps`), and in
samples for the cursors.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import track as ref

CORRELATOR_PREFIXES = ("d_", "p11_", "p61_", "p_")


def ulps(a: np.ndarray, b: np.ndarray) -> float:
    """The largest distance between two float32 arrays in units in the last
    place: 0 where they are equal bit for bit (+0 and -0 alike), 2**31 where
    one is NaN and the other is not."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {a.shape} and {b.shape}")
    if a.size == 0:
        return 0.0

    def ordered(x):
        i = x.view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    na, nb = np.isnan(a), np.isnan(b)
    d = np.abs(ordered(a) - ordered(b)).astype(np.float64)
    d = np.where(na & nb, 0.0, d)
    d = np.where(na ^ nb, 2.0 ** 31, d)
    return float(d.max())


def pll_integrators(k: dict, carr_err: np.ndarray):
    """(d1, d2) before every epoch, (C, E) float32: the PLL's integrators
    summed again from the program's carrier errors, in float32 as the loop
    sums them."""
    ce = np.ascontiguousarray(carr_err.T, np.float32)      # (E, C)
    pf2, pf3 = np.float32(k["pf2"]), np.float32(k["pf3"])
    d1 = np.zeros_like(ce)
    d2 = np.zeros_like(ce)
    a = np.zeros(ce.shape[1], np.float32)
    b = np.zeros(ce.shape[1], np.float32)
    for e in range(ce.shape[0]):
        d1[e], d2[e] = a, b
        b = b + ce[e] * pf3
        a = b + ce[e] * pf2 + a
    return d1.T, d2.T


def state_at(out: dict, d1, d2, cursor0: np.ndarray, epochs) -> tuple:
    """(cursor (C·S,), state (C·S, 8)) of every channel before each epoch
    in `epochs`, from the program's outputs; rows run epoch-major."""
    blk = out["blksize"].astype(np.int64)
    before = np.concatenate([np.zeros((blk.shape[0], 1), np.int64),
                             np.cumsum(blk, 1)], 1)
    cur, st = [], []
    for e in epochs:
        cur.append(cursor0 + before[:, e])
        prev = (lambda n: out[n][:, e - 1]) if e > 0 else \
            (lambda n: np.zeros(blk.shape[0], np.float32))
        st.append(np.stack([out["rem_code_phase"][:, e],
                            out["rem_carr_cyc"][:, e], out["d_cyc"][:, e],
                            out["d_step"][:, e], prev("code_nco"),
                            prev("code_err"), d1[:, e], d2[:, e]], 1))
    return np.concatenate(cur), np.concatenate(st).astype(np.float32)


def replay(lp: ref.Loop, k: dict, ch: ref.Channels, out: dict,
           absolute_sample: np.ndarray, d1, d2) -> tuple[float, float]:
    """(loop ulps, cursor samples): every epoch's loop stage worked out
    again from the program's own correlators and state."""
    dev = ch.carr_t.device

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=dev)

    def host(x):
        return x.cpu().numpy()

    c = {n: t(v) for n, v in out.items()
         if n.startswith(CORRELATOR_PREFIXES) and not n.startswith("p_")}
    carr_err, code_err = ref.errors(lp, k, c)
    gaps = [ulps(host(carr_err), out["carr_err"]),
            ulps(host(code_err), out["code_err"])]
    gaps += [ulps(host(v), out[n]) for n, v in c.items()
             if n.startswith("p_")]
    zero = np.zeros((out["blksize"].shape[0], 1), np.float32)
    nco_prev = np.concatenate([zero, out["code_nco"][:, :-1]], 1)
    err_prev = np.concatenate([zero, out["code_err"][:, :-1]], 1)
    carr_nco, code_nco, _, _, d_cyc, d_step = ref.filters(
        k, t(out["carr_err"]), t(out["code_err"]), t(nco_prev), t(err_prev),
        t(d1), t(d2), ch.init_dstep[:, None])
    delta, blk = ref.blksize(lp, k, t(out["rem_code_phase"]),
                             t(out["d_step"]))
    rem_code, rem_cyc = ref.remainders(
        k, ch.q0_cyc[:, None], ch.a_base[:, None], t(out["rem_code_phase"]),
        t(out["rem_carr_cyc"]), t(out["d_cyc"]), t(out["d_step"]), delta,
        blk)
    gaps += [ulps(host(carr_nco), out["carr_nco"]),
             ulps(host(code_nco), out["code_nco"]),
             ulps(host(blk.to(torch.float32)), out["blksize"])]
    nxt = {"d_cyc": d_cyc, "d_step": d_step, "rem_code_phase": rem_code,
           "rem_carr_cyc": rem_cyc}
    _, first = ref.initial_state(ch)
    for i, n in enumerate(("rem_code_phase", "rem_carr_cyc", "d_cyc",
                           "d_step")):
        gaps.append(ulps(host(nxt[n])[:, :-1], out[n][:, 1:]))
        gaps.append(ulps(host(first[:, i]), out[n][:, 0]))
    ends = ch.cursor0[:, None] + np.cumsum(host(blk), 1)
    cursor = float(np.abs(ends - absolute_sample).max())
    return max(gaps), cursor


def check(lp: ref.Loop, ch: ref.Channels, capture: torch.Tensor, out: dict,
          absolute_sample: np.ndarray, rng: np.random.Generator,
          start_epochs: int, segments: int, segment_epochs: int,
          sum_dtype=torch.float64) -> dict:
    """The numbers compared for one request's answer `out` ({name: (C, E)
    float32}) and its cursors: {"epoch_ulps", "loop_ulps", "cursor_off"}.
    Missing outputs or a wrong shape read as the largest gap."""
    k = ref.constants(lp)
    names = lp.output_names()
    C = len(ch.prn)
    n_ep = out["blksize"].shape[1] if "blksize" in out else 0
    if sorted(out) != names or any(v.shape != (C, n_ep)
                                   for v in out.values()) or n_ep == 0:
        return {"epoch_ulps": 2.0 ** 31, "loop_ulps": 2.0 ** 31,
                "cursor_off": 2.0 ** 62}
    d1, d2 = pll_integrators(k, out["carr_err"])
    loop_gap, cursor = replay(lp, k, ch, out, absolute_sample, d1, d2)

    n0 = min(start_epochs, n_ep)
    cur, st = ref.initial_state(ch)
    got, _, _ = ref.run(lp, ch, capture, cur, st, n0, sum_dtype)
    gaps = [ulps(got[n], out[n][:, :n0]) for n in names]
    seg = min(segment_epochs, n_ep - n0)
    if seg > 0 and segments > 0:
        starts = np.sort(rng.choice(np.arange(n0, n_ep - seg + 1),
                                    size=min(segments, n_ep - seg + 1 - n0),
                                    replace=False))
        cur, st = state_at(out, d1, d2, ch.cursor0, starts)
        rows = ch.take(np.tile(np.arange(C), len(starts)))
        dev = ch.carr_t.device
        got, _, _ = ref.run(lp, rows, capture,
                            torch.as_tensor(cur, device=dev),
                            torch.as_tensor(st, device=dev), seg, sum_dtype)
        for i, e in enumerate(starts):
            sl = slice(i * C, (i + 1) * C)
            gaps += [ulps(got[n][sl], out[n][:, e:e + seg]) for n in names]
    return {"epoch_ulps": max(gaps), "loop_ulps": loop_gap,
            "cursor_off": cursor}
