"""The port's build (bds3_tpu_torch/_build.py) on the CPU, with a stand-in
nvcc that records its calls: one compile per CUDA source, all started
before any is waited on, then one link of every object into the
library."""
import json
import os
import pathlib
import stat
import sys
import time

import pytest

from bds3_tpu_torch import _build

FAKE_NVCC = """#!{python}
import json, os, sys, time
args = sys.argv[1:]
t0 = time.time()
if "-c" in args:
    time.sleep(0.5)
    if os.environ.get("FAKE_NVCC_FAIL", "") and \\
            args[-1].endswith(os.environ["FAKE_NVCC_FAIL"]):
        sys.stderr.write("error: refused\\n")
        sys.exit(1)
    print("ptxas info    : Used 1 registers")
open(args[args.index("-o") + 1], "w").write("object")
with open(os.environ["FAKE_NVCC_LOG"], "a") as f:
    f.write(json.dumps({{"args": args, "t0": t0, "t1": time.time()}}) + "\\n")
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    log = tmp_path / "calls.jsonl"
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    return log


def _calls(log):
    return [json.loads(line) for line in log.read_text().splitlines()]


def test_each_source_compiles_in_its_own_nvcc_in_parallel(fake_nvcc,
                                                          tmp_path):
    so = tmp_path / "lib.so"
    out = _build.build(so)
    sources = sorted(str(p) for p in _build.CSRC.glob("*.cu"))
    calls = _calls(fake_nvcc)
    compiles = [c for c in calls if "-c" in c["args"]]
    links = [c for c in calls if "-shared" in c["args"]]
    assert sorted(c["args"][-1] for c in compiles) == sources
    assert len(links) == 1 and len(calls) == len(sources) + 1
    for c in compiles:
        assert "-fmad=false" in c["args"] and "-shared" not in c["args"]
        assert "arch=compute_90a,code=sm_90a" in c["args"]
    # every compile started before the first one ended
    assert max(c["t0"] for c in compiles) < min(c["t1"] for c in compiles)
    objects = [c["args"][c["args"].index("-o") + 1] for c in compiles]
    assert sorted(links[0]["args"][-len(objects):]) == sorted(objects)
    assert links[0]["t0"] >= max(c["t1"] for c in compiles)
    assert so.read_text() == "object"
    assert out.count("ptxas info") == len(sources)
    assert not any(p.name.endswith(".objs") for p in tmp_path.iterdir())


def test_a_failed_compile_raises(fake_nvcc, tmp_path, monkeypatch):
    monkeypatch.setenv("FAKE_NVCC_FAIL", "mxu_micro.cu")
    so = tmp_path / "lib.so"
    with pytest.raises(RuntimeError, match="refused"):
        _build.build(so)
    assert not so.exists()


def test_processes_that_start_together_build_once(fake_nvcc, tmp_path):
    """Two processes (the ranks of a parallel run) ask for the library at
    once: one builds it under the file lock, the other waits and finds
    it built.  A gate file lines up their first calls."""
    import subprocess

    repo = pathlib.Path(__file__).resolve().parents[1]
    gate = tmp_path / "go"
    code = ("import pathlib, sys, time\n"
            "from bds3_tpu_torch import _build\n"
            "_build.BUILD_DIR = pathlib.Path(sys.argv[1])\n"
            "while not pathlib.Path(sys.argv[2]).exists():\n"
            "    time.sleep(0.005)\n"
            "print(_build.ensure_built())\n")
    env = dict(os.environ, PYTHONPATH=str(repo))
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(tmp_path / "build"), str(gate)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for _ in range(2)]
    time.sleep(1.0)      # both started and waiting at the gate
    gate.touch()
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1 and pathlib.Path(paths.pop()).exists()
    sources = list(_build.CSRC.glob("*.cu"))
    assert len(_calls(fake_nvcc)) == len(sources) + 1   # one build
