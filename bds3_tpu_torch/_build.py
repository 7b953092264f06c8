"""Builds the port's CUDA sources into one shared library at first use.

`nvcc` compiles every `csrc/*.cu` for sm_90a (Hopper), one process per
source, all started together, and links the objects into
`_build/libbds3_tpu_torch_<hash>.so`, keyed by a hash of the sources and
the flags.  Processes that start together (the ranks of a parallel run)
build it once: a file lock is held around the build, and whoever waited
on it finds the library built.  The library is loaded with ctypes: each kernel has a plain C
entry point that takes pointers, sizes and a stream and returns
`cudaGetLastError()`.  No PyTorch header is compiled, which keeps a build
to seconds.  The compiler's output (ptxas register and shared-memory
counts) is kept beside the library as `<name>.log`.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from bds3_tpu_torch.utils.trace import count

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    # round every a*b+c as written, as PyTorch's separate operations do:
    # the kernels must take the same ceil() branches as their plain
    # versions (see csrc/track_fused.cu, "Exactness")
    "-fmad=false",
    "-Xptxas", "-v",
)


def nvcc_path() -> str:
    """nvcc from PATH, else from $CUDA_HOME, $CUDA_PATH or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libbds3_tpu_torch_{h.hexdigest()[:16]}.so"


def build(so: Path) -> str:
    """Compiles every source into an object in parallel, links them into
    `so` and returns the compilers' output; raises on a failure.  Each
    nvcc process started is counted in `build.nvcc_runs`."""
    nvcc = nvcc_path()
    objs = so.with_name(f"{so.stem}.{os.getpid()}.objs")
    objs.mkdir(parents=True, exist_ok=True)
    cflags = [f for f in NVCC_FLAGS if f != "-shared"]
    try:
        jobs, objects = [], []
        for src in sorted(CSRC.glob("*.cu")):
            objects.append(str(objs / f"{src.stem}.o"))
            cmd = [nvcc, *cflags, "-c", "-o", objects[-1], str(src)]
            count("build.nvcc_runs")
            jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.PIPE,
                                               text=True)))
        outs = [proc.communicate() for _, proc in jobs]   # wait for all
        log = []
        for (cmd, proc), (out, err) in zip(jobs, outs):
            log.append(f"{' '.join(cmd)}\n{out}{err}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{err}")
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *objects]
        count("build.nvcc_runs")
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        log.append(f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    finally:
        shutil.rmtree(objs, ignore_errors=True)
    return "".join(log)


@contextlib.contextmanager
def _locked(path: Path):
    """An exclusive lock on `path` (released when its process ends too)."""
    with open(path, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def ensure_built() -> Path:
    """The library's path, compiled first if this source hash is new."""
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        with _locked(so.with_suffix(".lock")):
            if not so.exists():
                t0 = time.perf_counter()
                log = build(so)
                so.with_suffix(".log").write_text(
                    f"built in {time.perf_counter() - t0:.3f} s\n{log}")
    return so


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded library, compiled first if this source hash is new."""
    return ctypes.CDLL(str(ensure_built()))
