"""The port stands alone: nothing in bds3_tpu_torch/ (its drivers in
examples/ and tools/ included) or chip_smoke.py imports the JAX package,
JAX or jaxlib; every module imports with bds3_tpu blocked, and every one
but the plots copy with matplotlib blocked too; the host modules it copied (and the native IO runtime's
sources) equal their originals but for the import prefix; and its entry
points refuse the JAX package's Settings, whose enums are of other
classes."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from bds3_tpu.config import b1c_settings, b2a_settings
from bds3_tpu_torch import convert
from bds3_tpu_torch.acquire import pcps
from bds3_tpu_torch.receiver import run_receiver
from bds3_tpu_torch.track import driver, state

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "bds3_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("bds3_tpu", "jax", "jaxlib")

# the host modules copied from bds3_tpu/, at the same relative paths
COPIED = (
    ["config.py"]
    + [f"signals/{m}.py" for m in ("__init__", "b1c", "b2a", "icd_tables",
                                   "lfsr", "sampling", "user_tables",
                                   "weil")]
    + [f"navmsg/{m}.py" for m in ("__init__", "bch", "bcnav1", "bcnav2",
                                  "bits", "crc", "encode", "ephemeris",
                                  "ldpc")]
    + [f"pvt/{m}.py" for m in ("__init__", "geodesy", "lsq", "pseudorange",
                               "satpos", "solver")]
    + ["observe/__init__.py", "observe/cn0.py", "observe/secondary.py",
       "observe/plots.py"]
    + [f"io/{m}.py" for m in ("__init__", "ifdata", "synth", "scenario",
                              "stream")]
    + ["runtime/__init__.py", "runtime/src/ifio.cpp", "runtime/Makefile"]
)


def _imported(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(REPO)) for p in SOURCES])
def test_no_import_of_the_jax_package(path):
    tree = ast.parse(path.read_text(), str(path))
    bad = [m for m in _imported(tree) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_every_module_imports_with_bds3_tpu_blocked():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PORT.rglob("*.py"))
    code = ("import sys\n"
            "for m in ('bds3_tpu', 'jax', 'jaxlib'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {modules + ['chip_smoke']!r}:\n"
            "    importlib.import_module(m)\n"
            "print('imported', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "imported" in out.stdout


def test_card_path_imports_without_matplotlib():
    """The card's machine has no matplotlib: every module of the port but
    the plots copy, the drivers and chip_smoke.py import with it blocked,
    and the plots copy is the one that needs it."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PORT.rglob("*.py") if p != PORT / "observe" / "plots.py")
    code = ("import sys\n"
            "for m in ('bds3_tpu', 'jax', 'jaxlib', 'matplotlib'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {modules + ['chip_smoke']!r}:\n"
            "    importlib.import_module(m)\n"
            "try:\n"
            "    import bds3_tpu_torch.observe.plots\n"
            "except ImportError:\n"
            "    print('plots need matplotlib')\n"
            "print('imported', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "plots need matplotlib" in out.stdout
    assert "imported" in out.stdout
    assert any(m.startswith("bds3_tpu_torch.examples.") for m in modules)
    assert any(m.startswith("bds3_tpu_torch.tools.") for m in modules)


@pytest.mark.parametrize("rel", COPIED)
def test_host_copy_equals_original(rel):
    original = (REPO / "bds3_tpu" / rel).read_text()
    copy = (PORT / rel).read_text()
    assert copy == original.replace("bds3_tpu.", "bds3_tpu_torch.").replace(
        "from bds3_tpu import", "from bds3_tpu_torch import")


def _init():
    return state.ChannelInit(prn=19, acquired_freq=1e6, code_phase=5,
                             peak_metric=2.0)


ENTRY_POINTS = {
    "make_track_config": lambda s: state.make_track_config(s),
    "require_ported": lambda s: driver.require_ported(s),
    "track": lambda s: driver.track(np.zeros(1000, np.int8), s, [_init()],
                                    device="cpu"),
    "acquire": lambda s: pcps.acquire(np.zeros(1000, np.int8), s,
                                      device="cpu"),
    "run_receiver": lambda s: run_receiver(np.zeros(1000, np.int8), s,
                                           verbose=False, device="cpu"),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
@pytest.mark.parametrize("preset", [b1c_settings, b2a_settings],
                         ids=["b1c", "b2a"])
def test_foreign_settings_raise_type_error(entry, preset):
    """The JAX package's Settings is refused before any work: its
    Signal.B2A is not the port's, and would take the port's B1C branches.
    Converted, the same settings pass the checks."""
    with pytest.raises(TypeError, match="settings_from_reference"):
        ENTRY_POINTS[entry](preset())
    own = convert.settings_from_reference(preset())
    assert own.signal.name == preset().signal.name
    assert state.make_track_config(own).signal is own.signal
