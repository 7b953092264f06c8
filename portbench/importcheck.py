"""What a run may not load: JAX, its relatives, and the JAX package the
program was ported from.

Module names are compared by their top-level name, the part before the
first dot, whole: the program's own package, `bds3_tpu_torch`, begins with
the JAX package's name, `bds3_tpu`, and must not match it.
"""
from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "bds3_tpu"})
PROGRAM = "bds3_tpu_torch"
ROOT = Path(__file__).resolve().parent
# the yardstick: these folders import nothing of the program either
STANDALONE = ("gen", "reference", "counts")


def top(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_forbidden(modules=None) -> list[str]:
    """The loaded modules whose top-level name is forbidden."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if top(m) in FORBIDDEN)


def imported_names(path: Path) -> list[str]:
    """Every module name an `import` or `from ... import` of a file names
    (relative imports are within the package and skipped)."""
    tree = ast.parse(path.read_text(encoding="utf-8"), str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module)
    return out


def static_violations(root: Path = ROOT) -> list[str]:
    """'file: module' for each import of a forbidden module in the
    benchmark's files, and of the program in its yardstick folders."""
    bad = []
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root)
        banned = set(FORBIDDEN)
        if rel.parts[0] in STANDALONE:
            banned.add(PROGRAM)
        bad += [f"{rel}: {m}" for m in imported_names(path)
                if top(m) in banned]
    return bad
