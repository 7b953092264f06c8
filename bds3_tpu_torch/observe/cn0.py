"""C/N0 (Variance Summing Method) and PLL lock detector.

Parity with `BDS-3_B2a/include/Calc_CNo_PLD.m:38-100` (the B1C variant
differs only in which pilot stream carries power by tracking mode).  The
reference computes these online inside the tracking loop every
CNoInterval epochs; here they are vectorized post-passes over the stored
prompt archives — same numbers, computed over the same windows.
"""
from __future__ import annotations

import numpy as np

from bds3_tpu_torch.config import Signal, TrackMode


def vsm_cn0(i_p: np.ndarray, q_p: np.ndarray, int_time: float) -> float:
    """VSM C/N0 [ratio-Hz] over one window (Calc_CNo_PLD.m:48-58)."""
    z = i_p.astype(np.float64) ** 2 + q_p.astype(np.float64) ** 2
    zm = z.mean()
    zv = z.var(ddof=1) if len(z) > 1 else 0.0
    pav = np.sqrt(max(zm * zm - zv, 0.0))
    nv = 0.5 * (zm - pav)
    if nv <= 0:
        # noiseless/very clean window (variance estimate hit zero): a
        # genuinely locked channel, not the NaN false-alarm signature
        # (variance above mean power).  Clamp to a large finite C/N0 so
        # downstream median/floor gates treat it as healthy instead of
        # dropping it as non-finite.
        return 1e10
    return abs((1.0 / int_time) * pav / (2.0 * nv))


def pll_lock(i_p: np.ndarray, q_p: np.ndarray) -> float:
    """Narrowband-power lock detector (Calc_CNo_PLD.m:62-66)."""
    si = np.abs(i_p).sum()
    sq = q_p.sum()
    nbp = si * si + sq * sq
    nbd = si * si - sq * sq
    return nbd / nbp if nbp > 0 else 0.0


def _pilot_iq(track, ch: int):
    """Pilot (I, Q) with power in I, per tracking mode
    (Calc_CNo_PLD.m:72-75 and the B1C variant's mode switch)."""
    o = track.outputs
    mode = track.settings.track_mode
    if track.settings.signal == Signal.B1C and mode == TrackMode.WIDEBAND:
        import numpy as _np

        w11 = float(_np.sqrt(29.0 / 33.0))
        w61 = float(_np.sqrt(4.0 / 33.0))
        pi = -w61 * o["p61_ip"][ch] + w11 * o["p11_qp"][ch]
        pq = -w61 * o["p61_qp"][ch] - w11 * o["p11_ip"][ch]
        return pi, pq
    # narrowband / B2a: pilot power in Q, so swap (reference :74-75)
    return o["p11_qp"][ch], o["p11_ip"][ch]


def channel_health(track, lock_threshold: float = 0.5,
                   cn0_floor_db: float = 28.0) -> list[dict]:
    """Per-channel tracking health summary for the pipeline.

    The reference surfaces C/N0 + the PLL lock detector live every
    CNoInterval epochs (`tracking.m:409-434`) but never acts on them;
    here the receiver driver consumes this summary to flag channels that
    lost lock (NBD/NBP below `lock_threshold`) in the status table and in
    `ReceiverResults.health` (PVT stays decode-gated for parity)."""
    out = []
    for ch in range(len(track.prns)):
        series = cn0_pld_series(track, ch)
        locks = series["data_lock"]
        cn0 = series["total_cn0"]
        finite = cn0[np.isfinite(cn0)]
        cn0_med = float(np.median(finite)) if len(finite) else float("nan")
        # lock requires the NBP/NBD detector AND a plausible VSM C/N0:
        # a channel pulled onto a code cross-correlation peak of a
        # strong satellite can phase-lock its carrier loop (NBP/NBD
        # near 1) while its VSM C/N0 is NaN (variance above mean power)
        # or far below any trackable signal (~24 dB-Hz measured for a
        # Weil cross-correlation channel) — the false-alarm signature.
        # The reference displays C/N0 live but never gates on it
        # (tracking.m:409-434); the floor here is this framework's
        # health-gate addition.
        out.append({
            "prn": int(track.prns[ch]),
            "cn0_db": cn0_med,
            "pll_lock": float(np.mean(locks)) if len(locks) else float("nan"),
            "lock_ok": bool(len(locks) and np.mean(locks) >= lock_threshold
                            and np.isfinite(cn0_med)
                            and cn0_med >= cn0_floor_db),
        })
    return out


def cn0_pld_series(track, ch: int, interval: int | None = None):
    """Per-interval (data C/N0 dB, pilot C/N0 dB, combined dB, data lock,
    pilot lock) arrays for one channel."""
    s = track.settings
    interval = interval or s.cn0_interval
    ip = track.outputs["d_ip"][ch]
    qp = track.outputs["d_qp"][ch]
    has_pilot = s.track_mode != TrackMode.DATA_ONLY
    if has_pilot:
        pi, pq = _pilot_iq(track, ch)
    n = len(ip) // interval
    out = {k: np.zeros(n) for k in
           ("data_cn0", "pilot_cn0", "total_cn0", "data_lock", "pilot_lock")}
    for w in range(n):
        sl = slice(w * interval, (w + 1) * interval)
        def db(x):
            return 10 * np.log10(x) if np.isfinite(x) and x > 0 else np.nan

        d = vsm_cn0(ip[sl], qp[sl], s.int_time)
        out["data_cn0"][w] = db(d)
        out["data_lock"][w] = pll_lock(ip[sl], qp[sl])
        p = 0.0
        if has_pilot:
            p = vsm_cn0(pi[sl], pq[sl], s.int_time)
            out["pilot_cn0"][w] = db(p)
            out["pilot_lock"][w] = pll_lock(pi[sl], pq[sl])
        total = d + (p if np.isfinite(p) else 0.0)
        out["total_cn0"][w] = db(total)
    return out
