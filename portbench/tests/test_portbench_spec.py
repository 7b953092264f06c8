"""The benchmark's files: each parses, each is found by its name, they
agree with BENCHMARK.json and keep to its contract's limits, and one more
configuration, traffic mix, cell and metric are each a new file and no
edit."""
from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import run, spec
from portbench.tests.tiny import TINY

REPO = spec.ROOT.parent
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_file_parses_and_is_found_by_name():
    for name in spec.names("workloads"):
        c = spec.cell(name)
        assert c.kind in spec.names("kinds", ".py")
        kind = spec.kind(c.kind)
        for f in ("setup", "request", "layer_inputs", "check", "control",
                  "numbers"):
            assert callable(getattr(kind, f)), (c.kind, f)
    for name in spec.names("configs"):
        cfg = spec.load_json("configs", name)
        assert {"source", "preset", "settings", "reduced", "assumed"} \
            <= set(cfg)
    readers = spec.metric_readers()
    assert set(readers) == set(spec.names("metrics", ".py"))
    for mod in readers.values():
        assert UNIT.match(mod.UNIT) and isinstance(mod.END_TO_END, bool)
    with pytest.raises(FileNotFoundError):
        spec.cell("no.such.cell")
    with pytest.raises(ValueError):
        spec.cell("../configs/b2a_nut4nt_99msps")


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "-m", "portbench"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + [c["name"] for c in
                                            BENCH["configs"]] \
        + [w["name"] for w in BENCH["workloads"]]
    assert len(set(names)) == len(names)
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_benchmark_json_agrees_with_the_files():
    readers = spec.metric_readers()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        mod = readers[m["name"]]
        assert mod.UNIT == m["unit"]
        assert mod.END_TO_END == (m in BENCH["end_to_end"])
    assert set(readers) == {m["name"] for m in BENCH["end_to_end"]
                            + BENCH["per_layer"]}
    for c in BENCH["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        cfg = spec.load_json("configs", c["name"])
        assert (c["source"], c["reduced"]) == (cfg["source"], cfg["reduced"])
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
    assert {c["name"] for c in BENCH["configs"]} == \
        {w["config"] for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        f = spec.load_json("workloads", w["name"])
        assert {k: f[k] for k in ("config", "traffic", "chips", "why")} == \
            {k: w[k] for k in ("config", "traffic", "chips", "why")}
        assert w["chips"] == 1 and _line(w["why"])
        reported = [m for m in BENCH["end_to_end"] + BENCH["per_layer"]
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in [m["name"] for m in reported]
        assert len([m for m in reported if m in BENCH["end_to_end"]]) >= 2
        assert any(m in BENCH["per_layer"] for m in reported)
    assert set(spec.names("workloads")) == {w["name"] for w in
                                            BENCH["workloads"]}


def test_one_more_of_each_is_a_new_file(tmp_path):
    """A copy of the benchmark's files with a dummy configuration, traffic
    mix, cell and metric added, and nothing else touched: the harness
    finds each by name and runs the new cell with the new metric."""
    root = tmp_path / "portbench"
    shutil.copytree(spec.ROOT, root, ignore=shutil.ignore_patterns(
        "__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cfg = spec.load_json("configs", "b2a_nut4nt_99msps")
    cfg["settings"].update(TINY["b2a.track.resident"], num_channels=3)
    (root / "configs" / "dummy_cfg.json").write_text(json.dumps(cfg))
    mix = spec.load_json("traffic", "track_resident")
    mix.update(cn0_db=[30.0, 35.0], epochs_per_block=20)
    (root / "traffic" / "dummy_mix.json").write_text(json.dumps(mix))
    (root / "workloads" / "dummy.cell.json").write_text(json.dumps(
        {"config": "dummy_cfg", "traffic": "dummy_mix", "chips": 1,
         "why": "a dummy"}))
    (root / "metrics" / "dummy.metric.py").write_text(
        'UNIT = "requests"\nEND_TO_END = True\n\n\n'
        'def read(ctx):\n    return ctx.window.attempted\n')
    assert all(p.read_bytes() == b for p, b in before.items())

    c = spec.cell("dummy.cell", root)
    assert (c.config_name, c.traffic_name) == ("dummy_cfg", "dummy_mix")
    assert c.traffic["cn0_db"] == [30.0, 35.0]
    readers = spec.metric_readers(root)
    assert "dummy.metric" in readers
    r = run.run_cell(c, 7, 0.1, False, device="cpu", readers=readers)
    assert r["correct"]
    assert r["metrics"]["dummy.metric"]["value"] == r["attempted"]
    assert {"setup_s", "track_rt"} <= set(r["metrics"])


def test_cell_files_hold_the_contracts_names():
    for folder in ("configs", "workloads", "traffic"):
        for name in spec.names(folder):
            assert NAME.match(name)
    for p in Path(spec.ROOT).rglob("*"):
        rel = p.relative_to(spec.ROOT.parent).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel

