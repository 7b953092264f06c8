"""The port's drivers of the JAX paths (`bds3_tpu_torch/examples/` and
`bds3_tpu_torch/tools/`) on the CPU.

The LDPC demo runs on the host alone: its printed lines must equal the
original's (examples/ldpc_decode_demo.py) line for line.  The B2a demo's
ground truth is the port's own copy of tests/test_navmsg.py's
`sample_eph`, held equal to it field by field.  profile_trace runs in
these tests at 20 ms of capture and must write a Chrome trace.  The other
drivers run at their full lengths on the card only
(tests/test_torch_cuda_paths.py); in these tests each must default to the card and
raise, not run on the CPU, when there is none.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from bds3_tpu_torch.examples import (
    _truth,
    b1c_pipeline_demo,
    b2a_pipeline_demo,
    ldpc_decode_demo,
)
from bds3_tpu_torch.tools import (
    debug_pvt,
    profile_trace,
    streaming_demo,
    validate_b1c_chain,
)
from bds3_tpu_torch.utils.trace import counters
from test_navmsg import sample_eph

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD_DRIVERS = {"b2a_pipeline_demo": b2a_pipeline_demo,
                "b1c_pipeline_demo": b1c_pipeline_demo,
                "debug_pvt": debug_pvt,
                "validate_b1c_chain": validate_b1c_chain,
                "streaming_demo": streaming_demo,
                "profile_trace": profile_trace}


def test_ldpc_demo_prints_the_originals_lines(capsys):
    orig = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "ldpc_decode_demo.py")],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert orig.returncode == 0, orig.stderr[-3000:]
    assert ldpc_decode_demo.main([]) == 0
    port = capsys.readouterr().out
    assert port.splitlines() == orig.stdout.splitlines()
    assert port.splitlines()[-1] == "DEMO PASS"


@pytest.mark.parametrize("prn", [19, 30])
def test_sample_eph_copy_equals_the_tests(prn):
    """The B2a demo's satellites' ephemerides: every field equal."""
    got = dataclasses.asdict(_truth.sample_eph(prn))
    want = dataclasses.asdict(sample_eph(prn))
    assert got == want
    assert sorted(p for p, *_ in b2a_pipeline_demo.SATS) == [19, 30]


def _profile_trace_tables(out: list[str], first: str):
    """The profile_trace line that starts with `first`, then its table of
    spans {name: (count, total ms, self ms)} and of counters {name:
    value}."""
    line = next(i for i, r in enumerate(out) if r.startswith(first))
    assert out[line + 1].split() == ["span", "count", "total", "ms", "self",
                                     "ms"]
    end = next(i for i in range(line + 2, len(out))
               if out[i].split() == ["counter", "value"])
    spans = {r.split()[0]: (int(r.split()[1]), *map(float, r.split()[2:]))
             for r in out[line + 2:end]}
    values = {r.split()[0]: float(r.split()[1]) for r in out[end + 1:]}
    assert all(tot >= own >= 0 for _, tot, own in spans.values())
    return out[line], spans, values


def test_profile_trace_writes_a_trace(tmp_path, capsys):
    """20 ms of B2a at 99.375 Msps, 12 channels, 18 epochs through track()
    "auto" (the kernel's plain version on the CPU): a Chrome trace with
    the tracking and the driver's spans in it, the original's line, the
    table of the spans, then the counters, the warm-up included."""
    before = counters()
    assert profile_trace.main([str(tmp_path), "0.02", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    line, table, values = _profile_trace_tables(out, "traced ")
    assert line.startswith("traced 18 epochs x 12 ch in ")
    assert line.endswith(f"(correlator=reference); trace -> {tmp_path}")
    assert sorted(table) == ["track", "track.blocks", "track.setup"]
    assert all(n == 1 for n, _, _ in table.values())
    assert set(values) == set(counters())
    assert {k: values[k] - before.get(k, 0) for k in
            ("track.requests", "track.blocks", "track.signal_ms",
             "k1.launches")} == {"track.requests": 2, "track.blocks": 2,
                                 "track.signal_ms": 36, "k1.launches": 0}
    with open(tmp_path / "trace.json") as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names), sorted(names)[:20]
    assert set(table) <= names


def test_profile_trace_traces_the_receiver(tmp_path, capsys):
    """`--receiver`: the same capture through run_receiver, so that the
    receiver's and acquisition's stage spans are in the trace and its
    table, around the tracking's, and the download is counted."""
    before = counters()
    assert profile_trace.main([str(tmp_path), "0.02", "--device", "cpu",
                               "--receiver"]) == 0
    out = capsys.readouterr().out.splitlines()
    line, table, values = _profile_trace_tables(out, "traced the receiver")
    assert line.startswith("traced the receiver: 16 epochs x 2 ch in ")
    assert line.endswith(f"; trace -> {tmp_path}")
    assert set(table) == {
        "receiver.run", "receiver.acquire", "receiver.track",
        "receiver.navpvt", "acquire.coarse", "acquire.second_peak",
        "acquire.fine", "track", "track.setup", "track.blocks",
        "track.download", "track.assemble"}
    assert all(n == 1 for n, _, _ in table.values())
    assert table["receiver.run"][1] >= table["receiver.acquire"][1] \
        + table["receiver.track"][1]
    assert values["track.requests"] - before.get("track.requests", 0) == 2
    assert values["track.d2h_bytes"] > before.get("track.d2h_bytes", 0)
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert set(table) <= names


@pytest.mark.parametrize("name", sorted(CARD_DRIVERS))
def test_card_driver_defaults_to_the_card(name, monkeypatch):
    """Without a card, main() with no arguments raises before any work:
    it asked for the card and does not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="'cuda' requested"):
        CARD_DRIVERS[name].main([])
