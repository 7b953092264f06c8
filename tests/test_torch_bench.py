"""The port's bench harness (bds3_tpu_torch/bench.py) on the CPU: it
imports without side effects, runs bench.py's configurations under their
names and in their order, and keeps bench.py's transport choice and
channel inits.  bench.py itself is read with ast, never imported: its
import registers atexit and SIGTERM hooks."""
import ast
import atexit
import os
import pathlib
import signal
import subprocess
import sys

import pytest
import torch

import chip_smoke
from bds3_tpu_torch import bench
from bds3_tpu_torch.config import b1c_settings, b2a_settings

REPO = pathlib.Path(__file__).resolve().parents[1]
STAGE_FNS = ("bench_tracking", "bench_acquisition", "_stage",
             "_score_receiver", "gate")


def _config_names() -> list:
    """The string first arguments of bench.py's stage calls inside its
    main(), and the DETAIL["configs"][...] keys it writes, in source
    order; minus gate("tracking_b1c"), a gate over two configs."""
    tree = ast.parse((REPO / "bench.py").read_text())
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in STAGE_FNS and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            found.append((node.lineno, node.col_offset, node.args[0].value))
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                and n.name == "main")
    in_main = [(ln, c, v) for ln, c, v in found
               if main.lineno <= ln <= main.end_lineno]
    names = []
    for _, _, v in sorted(in_main):
        if v not in names and v != "tracking_b1c":
            names.append(v)
    return names


def test_imports_without_exit_hooks():
    """Importing the module registers no atexit hook of its own (torch,
    which it imports, registers some) and no SIGTERM handler, and prints
    nothing (a fresh interpreter with atexit.register wrapped)."""
    code = ("import atexit, signal, sys\n"
            "mods = []\n"
            "orig = atexit.register\n"
            "def reg(f, *a, **k):\n"
            "    mods.append(getattr(f, '__module__', None))\n"
            "    return orig(f, *a, **k)\n"
            "atexit.register = reg\n"
            "h = signal.getsignal(signal.SIGTERM)\n"
            "import bds3_tpu_torch.bench as b\n"
            "assert 'bds3_tpu_torch.bench' not in mods, mods\n"
            "assert signal.getsignal(signal.SIGTERM) is h, 'SIGTERM hook'\n"
            "assert 'jax' not in sys.modules\n"
            "print('ok', len(b.STAGES))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok 12"


def test_stage_names_are_bench_py_config_names():
    """The port runs bench.py's configurations under the same names, in
    the same order, then K3's stage just before the streaming one."""
    names = _config_names()
    assert len(names) == 11 and names[0] == "tracking_b2a_12ch"
    assert list(bench.CONFIGS) == names
    assert [n for n in bench.STAGES if n != "mxu_micro"] == names
    assert bench.STAGES[-2:] == ("mxu_micro", "streaming_49s")


@pytest.mark.parametrize("up_mbs,want", [
    (0.8, "int2"), (24.999, "int2"), (25.0, "int4"), (100.0, "int4"),
    (249.999, "int4"), (250.0, "none"), (12_000.0, "none")])
def test_pick_transport_matches_bench_py(up_mbs, want):
    """bench.py:306-315's thresholds (< 25 MB/s int2, < 250 int4)."""
    assert bench.pick_transport(up_mbs) == want


@pytest.mark.parametrize("preset,sats,n", [
    (b2a_settings, bench.B2A_SATS, 12), (b2a_settings, bench.B2A_SATS, 48),
    (b1c_settings, bench.B1C_SATS, 12)])
def test_make_inits_equals_chip_smoke(preset, sats, n):
    """The bench's inits (bench.py:121-134) are chip_smoke's."""
    s = preset()
    assert bench.make_inits(s, sats, n) == chip_smoke.make_inits(s, sats, n)


def test_gate_records_a_skip(monkeypatch):
    monkeypatch.setitem(bench.STATE, "budget_s", 10.0)
    monkeypatch.setitem(bench.STATE, "t_start", 0.0)      # long ago
    monkeypatch.setitem(bench.DETAIL, "skipped", [])
    assert not bench.gate("acquisition_b2a", 40)
    assert bench.DETAIL["skipped"][0]["config"] == "acquisition_b2a"


def test_failed_stage_is_recorded_not_retried(monkeypatch, capsys):
    """A stage that raises is noted and listed as failed; nothing else
    runs in its place, and the headline is emitted after it."""
    monkeypatch.setitem(bench.STATE, "t_start", 1e18)     # budget left
    for k in ("notes", "failed"):
        monkeypatch.setitem(bench.DETAIL, k, [])
    calls = []

    def boom():
        calls.append(1)
        raise RuntimeError("kernel refused")

    bench._stage("tracking_b2a_48ch", 45, boom)
    assert calls == [1]
    assert bench.DETAIL["failed"] == ["tracking_b2a_48ch"]
    assert "kernel refused" in bench.DETAIL["notes"][0]
    assert '"metric": "b2a_12ch_tracking_realtime_factor"' in \
        capsys.readouterr().out


def test_main_without_card_exits_nonzero(monkeypatch):
    """No card, no run: main() exits non-zero before any stage; its exit
    hooks are registered by main(), and undone here."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    registered = []
    monkeypatch.setattr(atexit, "register", registered.append)
    monkeypatch.setattr(signal, "signal", lambda *a: None)
    monkeypatch.setitem(bench.STATE, "emitted_final", True)
    assert bench.main() == 2
    assert registered == [bench._emit_final]
