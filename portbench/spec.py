"""The benchmark's files, found by name.

    configs/<config>.json     a deployment: the program's preset, its
                              settings, source, reduced, assumed
    workloads/<cell>.json     a cell: its config, its traffic, why
    traffic/<traffic>.json    a mix: its kind and the kind's parameters
    kinds/<kind>.py           the set-up, request and check of a kind
    metrics/<metric>.py       the reader of one metric

Adding one more of any of these is adding a file: nothing here lists
them.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _checked(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_json(folder: str, name: str, root: Path = ROOT) -> dict:
    """<root>/<folder>/<name>.json; a clear error where there is none."""
    path = root / folder / f"{_checked(name)}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder[:-1]} named {name!r} "
                                f"({path.relative_to(root.parent)})")
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def names(folder: str, suffix: str = ".json", root: Path = ROOT) -> list[str]:
    """The names of the files of `folder`, sorted."""
    return sorted(p.name[:-len(suffix)] for p in (root / folder).iterdir()
                  if p.name.endswith(suffix) and not p.name.startswith("_"))


@dataclasses.dataclass(frozen=True)
class Cell:
    """A cell with its configuration and traffic files read."""

    name: str
    config_name: str
    traffic_name: str
    why: str
    chips: int
    config: dict
    traffic: dict

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def cell(name: str, root: Path = ROOT) -> Cell:
    w = load_json("workloads", name, root)
    return Cell(name=name, config_name=w["config"], traffic_name=w["traffic"],
                why=w["why"], chips=w["chips"],
                config=load_json("configs", w["config"], root),
                traffic=load_json("traffic", w["traffic"], root))


def kind(name: str):
    """The module of a traffic kind, kinds/<name>.py."""
    return importlib.import_module(f"portbench.kinds.{_checked(name)}")


def metric_readers(root: Path = ROOT) -> dict:
    """{metric name: its reader module}, one for each metrics/<name>.py.
    Metric names may hold dots, so each file is loaded by its path."""
    out = {}
    for name in names("metrics", ".py", root):
        spec = importlib.util.spec_from_file_location(
            f"portbench.metrics.{name.replace('.', '__')}",
            root / "metrics" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[_checked(name)] = mod
    return out
