"""Tracking a whole recording held on the card, one request at a time.

Set-up renders the configuration's recording on the card from a sky drawn
from the seed (`gen/`), starts one channel on each satellite from its
truth (the upstream's skipAcquisition workflow) and runs one request
untimed.  A request is one `track.driver.track()` over the whole
recording from those channels, with the traffic's block length and
correlator, its outputs downloaded.  Its work is the seconds of signal
tracked.

The check takes one request drawn from the seed and holds it to the
reference (`reference/judge.py`); every other request must equal it bit
for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench import program
from portbench.counts import k1 as k1_count
from portbench.gen.render import Front, render
from portbench.gen.sky import channel_starts, draw_sky
from portbench.reference import judge
from portbench.reference import track as ref

FAMILY = "track"


def front_of(st: dict) -> Front:
    return Front(signal=st["signal"], fs=st["sampling_freq"],
                 if_hz=st["intermediate_freq"], code_length=st["code_length"],
                 code_freq=st["code_freq_basis"],
                 carr_freq=st["carr_freq_basis"])


@dataclasses.dataclass
class State:
    settings: object           # the program's Settings
    values: dict               # the configuration's settings, as written
    traffic: dict
    device: torch.device
    starts: list               # the channels' starts (gen.sky)
    capture: torch.Tensor
    inits: list                # the same starts, as the program takes them
    n_epochs: int              # the epochs a request asks for


def setup(cell, seed: int, device) -> State:
    from bds3_tpu_torch.track.state import ChannelInit

    tr = cell.traffic
    st = cell.config["settings"]
    s = program.settings(cell.config)
    front = front_of(st)
    rng = np.random.default_rng(seed)
    sats = draw_sky(front, rng, st["num_channels"],
                    tr["doppler_share"] * st["acq_search_band"],
                    tuple(tr["cn0_db"]), tr["noise_std"])
    n = int(round(st["ms_to_process"] * 1e-3 * st["sampling_freq"]))
    dev = torch.device(device)
    capture = render(front, sats, n, dev, tr["noise_std"], seed)
    starts = channel_starts(front, sats)
    inits = [ChannelInit(prn=c["prn"], acquired_freq=c["acquired_freq"],
                         code_phase=c["code_phase"], peak_metric=2.0)
             for c in starts]
    state = State(s, st, tr, dev, starts, capture, inits, s.int_epochs)
    request(state)                                  # warm: untimed
    return state


def request(state: State) -> tuple[float, tuple]:
    """One track() of the whole recording: (seconds of signal, answer)."""
    from bds3_tpu_torch.track.driver import track

    res = track(state.capture, state.settings, state.inits,
                n_epochs=state.n_epochs,
                epochs_per_block=state.traffic["epochs_per_block"],
                device=state.device,
                correlator=state.traffic["correlator"])
    return (res.n_epochs * state.settings.int_time,
            (res.outputs, res.absolute_sample))


def _loop(state: State) -> ref.Loop:
    return ref.make_loop(state.values)


def layer_inputs(state: State, window) -> dict:
    """What the per-layer readers need beyond the window and the trace:
    K1's bound summed over the window's requests (counts/k1.py), and the
    requests' wall time and signal."""
    lp = _loop(state)
    cursor0 = np.array([c["code_phase"] for c in state.starts], np.int64)
    ok = [r for r in window.requests if r.ok]
    return {
        "k1_bound_s": sum(k1_count.request_bound(
            lp, r.kept[0]["blksize"], cursor0,
            state.traffic["epochs_per_block"]) for r in ok),
        "request_wall_s": sum(r.wall_s for r in ok),
        "signal_s": sum(r.work for r in ok),
    }


def _same(a: tuple, b: tuple) -> bool:
    (oa, sa), (ob, sb) = a, b
    return (sorted(oa) == sorted(ob) and np.array_equal(sa, sb)
            and all(np.array_equal(np.asarray(oa[n]).view(np.uint32),
                                   np.asarray(ob[n]).view(np.uint32))
                    for n in oa))


def numbers(state: State, kept: tuple, rng: np.random.Generator,
            sum_dtype=torch.float64) -> dict:
    """The judge's numbers for one answer (`kept`)."""
    lp = _loop(state)
    ch = ref.make_channels(lp, state.starts, state.device)
    c = state.traffic["check"]
    outputs, absolute_sample = kept
    return judge.check(lp, ch, state.capture,
                       {n: np.asarray(v) for n, v in outputs.items()},
                       np.asarray(absolute_sample), rng, c["start_epochs"],
                       c["segments"], c["segment_epochs"], sum_dtype)


def check(state: State, window, rng: np.random.Generator) -> dict:
    """{name: (value, limit)}: the answer of a request drawn from the seed
    against the reference, and how many others differ from it."""
    limits = state.traffic["check"]["limits"]
    ok = [r.kept for r in window.requests if r.ok]
    if not ok:
        return {"answered": (0.0, -1.0)}
    pick = ok[int(rng.integers(len(ok)))]
    out = {"requests_differ": (float(sum(not _same(k, pick) for k in ok)),
                               limits["requests_differ"])}
    for name, value in numbers(state, pick, rng).items():
        out[name] = (value, limits[name])
    return out


def control(state: State, n_epochs: int) -> tuple:
    """The reference in the program's place over n_epochs epochs, its
    correlators summed in float32, the precision below the program's
    float64 sums: an answer as `request` keeps it."""
    lp = _loop(state)
    ch = ref.make_channels(lp, state.starts, state.device)
    out = ref.track(lp, ch, state.capture, n_epochs, torch.float32)
    return out, ch.cursor0[:, None] + np.cumsum(
        out["blksize"].astype(np.int64), 1)
