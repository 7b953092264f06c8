"""The check against its faults, on the CPU at a tiny size: the rest of a
run (set-up, window, metrics, check) is driven without the look for a
card, the timed path broken underneath, and `correct` must come out
false; sound, it must come out true.  The control, the reference put in
the program's place with its sums in float32, must fail too."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import run
from portbench.kinds import track_resident
from portbench.tests.tiny import tiny_cell

CELLS = ["b2a.track.resident", "b1c.track.resident"]
SEED = 2 ** 31 + 12345


def _run(cell: str) -> dict:
    return run.run_cell(tiny_cell(cell), SEED, 0.2, False, device="cpu")


def _broken(monkeypatch, fault):
    """Put `fault(cfg, capture, tables, consts, state, fn)` under the
    driver's block function of the timed path."""
    from bds3_tpu_torch.track import driver

    sound = driver.BLOCK_FNS["fused"]
    calls = {"n": 0}

    def block(cfg, capture, tables, consts, state):
        calls["n"] += 1
        return fault(cfg, capture, tables, consts, state, sound, calls["n"])

    monkeypatch.setitem(driver.BLOCK_FNS, "fused", block)


def state_unchanged(cfg, capture, tables, consts, state, fn, n):
    """A block that hands its input state on instead of its new one."""
    _, rows = fn(cfg, capture, tables, consts, state)
    return state, rows


def half_the_channels(cfg, capture, tables, consts, state, fn, n):
    """Only the first half of the channels tracked; the rest copy them."""
    new, rows = fn(cfg, capture, tables, consts, state)
    h = rows.shape[1] // 2
    rows = rows.clone()
    rows[:, h:] = rows[:, :h]
    return new, rows


def one_answer_altered(cfg, capture, tables, consts, state, fn, n):
    """One prompt correlator of one epoch of each block changed where the
    block produces it."""
    from bds3_tpu_torch.track.scan import slot_names

    new, rows = fn(cfg, capture, tables, consts, state)
    rows = rows.clone()
    rows[3, 0, slot_names(cfg).index("d_ip")] += 1.0
    return new, rows


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"setup_s", "track_rt"}
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("fault", [state_unchanged, half_the_channels,
                                   one_answer_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(monkeypatch, cell, fault):
    _broken(monkeypatch, fault)
    r = _run(cell)
    assert not r["correct"], (fault.__name__, r["checks"])


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """The reference with float32 sums, in the program's place, fails the
    cell's limits on three seeds."""
    c = tiny_cell(cell)
    limits = c.traffic["check"]["limits"]
    for seed in (1, 2, 3):
        state = track_resident.setup(c, seed, "cpu")
        n_ep = track_resident.request(state)[1][0]["blksize"].shape[1]
        got = track_resident.numbers(
            state, track_resident.control(state, n_ep),
            np.random.default_rng(seed))
        assert any(v > limits[k] for k, v in got.items()), got


def test_a_failed_request_is_not_correct(monkeypatch):
    def raises(cfg, capture, tables, consts, state, fn, n):
        if n == 3:               # the first block after the warm request
            raise RuntimeError("a launch that fails")
        return fn(cfg, capture, tables, consts, state)

    _broken(monkeypatch, raises)
    r = _run("b2a.track.resident")
    assert r["failed"] >= 1 and not r["correct"]


def test_traced_run_reports_the_per_layer_metrics():
    r = run.run_cell(tiny_cell("b2a.track.resident"), SEED, 0.2, True,
                     device="cpu")
    assert r["correct"]
    # no device on the CPU: only the host-side readers find something
    assert set(r["metrics"]) == {"device_idle.track",
                                 "track.nonk1_ms_per_signal_s"}
    assert r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert torch.get_num_threads() >= 1
