"""The frozen K1 count against chip_smoke.py's, on fixed epoch lengths."""
from __future__ import annotations

import json

import numpy as np
import pytest

from portbench import program, spec
from portbench.counts import k1
from portbench.reference import track as ref
from portbench.tests.tiny import tiny_cell

CASES = [("b2a.track.resident", {}),
         ("b2a.track.resident", {"track_mode": "DATA_ONLY"}),
         ("b1c.track.resident", {}),
         ("b1c.track.resident", {"track_mode": "NARROWBAND"})]


def _blksize(c: int, w: int, q0: int) -> np.ndarray:
    rng = np.random.default_rng(4)
    return q0 + rng.integers(0, 2, size=(w, c))


def _config(cell: str, over: dict, full: bool) -> dict:
    """The cell's configuration at its real size, or the tiny one."""
    if not full:
        return tiny_cell(cell, **over).config
    cfg = json.loads(json.dumps(spec.cell(cell).config))
    cfg["settings"].update(over)
    return cfg


@pytest.mark.parametrize("cell,over", CASES)
@pytest.mark.parametrize("full", [False, True])
def test_launch_bound_equals_chip_smokes(cell, over, full):
    import chip_smoke
    from bds3_tpu_torch.track.state import make_track_config

    config = _config(cell, over, full)
    cfg = make_track_config(program.settings(config), False, 200)
    lp = ref.make_loop(config["settings"])
    blk = _blksize(config["settings"]["num_channels"], 200, lp.q0_int)
    span = int(blk.sum(0).max()) + 17
    want = chip_smoke.track_fused_bound(cfg, blk, span, 1)
    got = k1.launch_bound(lp.use_pilot, lp.wideband, False, lp.code_length,
                          lp.m_data, lp.m_p61, len(lp.output_names()), blk,
                          span, 1)
    assert got["ops_per_sample"] == want["ops_per_sample"]
    assert got["samples"] == want["samples"]
    assert got["bound_s"] * 1e3 == pytest.approx(want["bound_ms"], rel=1e-12)
    ms, by = chip_smoke.roofline_ms(1e12, 1e9)
    s, by2 = k1.roofline_s(1e12, 1e9)
    assert s * 1e3 == pytest.approx(ms, rel=1e-12) and by == by2


def test_request_bound_sums_its_launches():
    lp = ref.make_loop(tiny_cell("b2a.track.resident").config["settings"])
    rng = np.random.default_rng(1)
    blk = (lp.q0_int + rng.integers(0, 2, size=(3, 45))).astype(np.float32)
    cursor0 = np.array([10, 500, 70], np.int64)
    want = 0.0
    start = cursor0.copy()
    for e0 in range(0, 45, 20):
        b = blk[:, e0:e0 + 20].astype(np.int64)
        end = start + b.sum(1)
        want += k1.launch_bound(lp.use_pilot, lp.wideband, False,
                                lp.code_length, lp.m_data, lp.m_p61,
                                len(lp.output_names()), b.T,
                                int(end.max() - start.min()), 1)["bound_s"]
        start = end
    assert k1.request_bound(lp, blk, cursor0, 20) == pytest.approx(want,
                                                                   rel=1e-12)
