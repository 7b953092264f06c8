"""A sky drawn from the seed, and the channels a skipped acquisition starts
from.

Every seed draws the same amount of work: as many satellites as the
configuration has channels, on distinct PRNs, with Dopplers inside the
configuration's acquisition search band, code phases over the whole code,
carrier phases, C/N0 values from the traffic's range and random
navigation symbols.  `channel_starts` is a frozen copy of the program's
`bench.py:make_inits`: the channels start on the truth, as the upstream's
skipAcquisition workflow starts them from a stored acquisition.
"""
from __future__ import annotations

import numpy as np

from portbench.gen.render import Front, Sat, amplitude_for_cn0


def draw_sky(front: Front, rng: np.random.Generator, n_sats: int,
             doppler_hz: float, cn0_db: tuple[float, float],
             noise_std: float, n_bits: int = 64) -> list[Sat]:
    """n_sats satellites on distinct PRNs of 1-63; Dopplers uniform in
    (-doppler_hz, doppler_hz); C/N0 uniform in cn0_db [dB-Hz]."""
    prns = rng.choice(np.arange(1, 64), size=n_sats, replace=False)
    sats = []
    for prn in prns:
        cn0 = rng.uniform(*cn0_db)
        sats.append(Sat(
            prn=int(prn),
            doppler_hz=float(rng.uniform(-doppler_hz, doppler_hz)),
            code_phase_chips=float(rng.uniform(0.0, front.code_length)),
            carrier_phase=float(rng.uniform(-np.pi, np.pi)),
            amplitude=amplitude_for_cn0(front, cn0, noise_std),
            nav_bits=tuple(int(b) for b in
                           rng.choice(np.array([-1, 1]), size=n_bits))))
    return sats


def channel_starts(front: Front, sats: list[Sat]) -> list[dict]:
    """One channel per satellite from its truth: the carrier at IF + fd and
    the first code start, in samples (`bench.py:make_inits`)."""
    out = []
    for sat in sats:
        code_rate = front.code_freq * (1 + sat.doppler_hz / front.carr_freq)
        chi0 = sat.code_phase_chips % front.code_length
        start = ((front.code_length - chi0) % front.code_length) / code_rate
        out.append({"prn": sat.prn,
                    "acquired_freq": front.if_hz + sat.doppler_hz,
                    "code_phase": int(round(start * front.fs))})
    return out
