"""B2a pilot secondary-code synchronization.

New capability with no reference counterpart: the reference tracker
ignores the B2a pilot secondary overlay entirely (its pure-PLL pilot
discriminator is sign-invariant, `BDS-3_B2a/tracking.m:355-376`), so it
can never align to the 100 ms secondary frame.  Here the archived pilot
prompt correlators are folded against the ICD Weil-100 secondary code
(signals.b2a.b2a_pilot_secondary — same generator the synthesizer uses)
to recover the frame phase and polarity, enabling pilot-aided epoch
counting and wipe-off.
"""
from __future__ import annotations

import numpy as np

from bds3_tpu_torch.signals import b2a_pilot_secondary


def b2a_pilot_secondary_sync(track, ch: int) -> dict:
    """Locate the pilot secondary-code phase for one tracked channel.

    Returns dict with:
      shift:    sec-code index of tracking epoch 0, i.e. the overlay at
                epoch e is ``polarity * overlay[(e + shift) % 100]``
                where ``overlay = -b2a_pilot_secondary(prn)`` (the
                synthesizer's sign convention, io/scenario.py).
      polarity: +1/-1 carrier-phase ambiguity of the pilot prompt.
      metric:   peak-to-next-peak ratio of the circular correlation
                (>2 is an unambiguous lock for spans >= 1 s).
      aligned_fraction: epochs whose wiped-off pilot prompt sign agrees
                with the majority (1.0 = perfect overlay recovery).
    """
    prn = int(track.prns[ch])
    overlay = -b2a_pilot_secondary(prn).astype(np.float64)
    n = len(overlay)
    q = np.asarray(track.outputs["p11_qp"][ch], dtype=np.float64)
    if len(q) < 2 * n:
        raise ValueError(
            f"need >= {2 * n} tracked epochs for secondary sync, "
            f"got {len(q)}")

    # fold epochs into the n residue bins, then one circular correlation
    # gives every cyclic shift at once
    e = np.arange(len(q))
    bins = np.bincount(e % n, weights=q, minlength=n)
    shifts = np.arange(n)
    # score[s] = sum_r bins[r] * overlay[(r + s) % n]
    score = np.array([
        np.dot(bins, np.roll(overlay, -s)) for s in shifts
    ])
    a = np.abs(score)
    best = int(np.argmax(a))
    runner = float(np.partition(a, -2)[-2])
    metric = float(a[best] / max(runner, 1e-12))
    polarity = int(np.sign(score[best])) or 1

    wiped = q * polarity * overlay[(e + best) % n]
    majority = np.sign(np.median(wiped)) or 1.0
    aligned = float(np.mean(np.sign(wiped) == majority))
    return {
        "shift": best,
        "polarity": polarity,
        "metric": metric,
        "aligned_fraction": aligned,
    }
