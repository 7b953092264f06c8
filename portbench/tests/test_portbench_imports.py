"""What a run may not load, and what a run does without a card or
without the program."""
from __future__ import annotations

import os
import shutil
import subprocess
import sys

from portbench import importcheck, run, spec


def test_top_level_names_are_compared_whole():
    mods = {"bds3_tpu_torch": 1, "bds3_tpu_torch.track.driver": 1,
            "numpy": 1, "jaxtyping": 1, "flaxen": 1}
    assert importcheck.loaded_forbidden(mods) == []
    mods.update({"bds3_tpu.config": 1, "jax.numpy": 1, "jaxlib": 1,
                 "flax.linen": 1})
    assert importcheck.loaded_forbidden(mods) == [
        "bds3_tpu.config", "flax.linen", "jax.numpy", "jaxlib"]


def test_the_benchmark_imports_neither_jax_nor_the_jax_package():
    assert importcheck.static_violations() == []


def test_the_yardstick_imports_nothing_of_the_program(tmp_path):
    root = tmp_path / "portbench"
    shutil.copytree(spec.ROOT, root, ignore=shutil.ignore_patterns(
        "__pycache__"))
    (root / "reference" / "leak.py").write_text(
        "from bds3_tpu_torch.track import scan\n")
    (root / "kinds" / "fine.py").write_text(
        "import bds3_tpu_torch.track.driver\n")
    (root / "gen" / "bad.py").write_text("import jax.numpy as jnp\n")
    (root / "counts" / "bad.py").write_text("from bds3_tpu import config\n")
    assert importcheck.static_violations(root) == [
        "counts/bad.py: bds3_tpu", "gen/bad.py: jax.numpy",
        "reference/leak.py: bds3_tpu_torch.track"]


def test_a_run_loads_no_jax():
    """Everything a run imports, in a fresh process: the harness, every
    kind and reader, and the program modules the kinds drive."""
    code = ("import sys; from portbench import run, spec; "
            "[spec.kind(spec.cell(n).kind) for n in spec.names('workloads')];"
            " spec.metric_readers(); import bds3_tpu_torch.track.driver; "
            "from portbench import importcheck; "
            "print(importcheck.loaded_forbidden())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=spec.ROOT.parent, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_without_a_card_there_is_no_result(capsys):
    """Here there is no card: main() refuses before any set-up."""
    assert run.main(["--workload", "b2a.track.resident", "--seed",
                     str(2 ** 31 + 3), "--seconds", "1", "--trace",
                     "0"]) == run.EXIT_NO_CARD
    assert capsys.readouterr().out == ""


def test_without_the_program_there_is_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copy(spec.ROOT.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.ROOT, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload",
         "b2a.track.resident", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, cwd=tmp_path, env=env,
        timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
