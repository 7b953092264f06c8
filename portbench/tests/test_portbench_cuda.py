"""The cells on the card, at their real size, with a short window.

Marked `cuda` and skipped without an NVIDIA GPU; on a machine with one:

    python -m pytest -m cuda portbench/tests/test_portbench_cuda.py
"""
from __future__ import annotations

import pytest
import torch

from portbench import run, spec

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return "cuda"


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", ["b2a.track.resident", "b1c.track.resident"])
def test_cell_on_the_card(cuda, cell, traced):
    r = run.run_cell(spec.cell(cell), 2 ** 31 + 99, 2.0, traced, cuda)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"
    want = ({"k1_roofline", "track.nonk1_ms_per_signal_s",
             "device_idle.track"} if traced else {"setup_s", "track_rt"})
    assert set(r["metrics"]) == want
    if traced:
        assert 0 < r["metrics"]["k1_roofline"]["value"] < 100
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
