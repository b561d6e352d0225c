"""Finding a cell's files by name.

``BENCHMARK.json`` (at the checkout's root) lists the cells and the
metrics; each cell, configuration and per-layer metric is a file of its
own under ``portbench/``.  Nothing here knows a cell by name: a later
change adds a cell, a configuration or a metric by adding files and
entries.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

PKG = Path(__file__).resolve().parent.parent      # portbench/
ROOT = PKG.parent                                  # the checkout
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def check_name(name: str) -> str:
    """A name of a cell, configuration, traffic kind or metric, which also
    names its file: letters, digits, ``_``, ``.``, ``-``; no path."""
    if not NAME_RE.match(name):
        raise ValueError(f"not a valid name: {name!r}")
    return name


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    """``BENCHMARK.json`` of the checkout."""
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing")
    return load_json(path)


def workload(name: str, pkg: Path = PKG) -> dict:
    """``workloads/<name>.json``: config, traffic kind, chips, parameters
    and the correctness limits of one cell."""
    spec = load_json(pkg / "workloads" / f"{check_name(name)}.json")
    spec.setdefault("name", name)
    return spec


def config(name: str, pkg: Path = PKG) -> dict:
    """``configs/<name>.json``: the model configuration as it is run."""
    spec = load_json(pkg / "configs" / f"{check_name(name)}.json")
    spec.setdefault("name", name)
    return spec


def _module(path: Path, qualname: str) -> ModuleType:
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(qualname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic(kind: str, pkg: Path = PKG) -> ModuleType:
    """``traffic/<kind>.py``: ``run(ctx)`` of one traffic kind."""
    return _module(pkg / "traffic" / f"{check_name(kind)}.py",
                   f"portbench_traffic_{kind.replace('.', '_')}")


def metric_reader(name: str, pkg: Path = PKG) -> ModuleType:
    """``metrics/<name>.py``: ``read(readings)`` of one per-layer metric."""
    return _module(pkg / "metrics" / f"{check_name(name)}.py",
                   "portbench_metric_" + re.sub(r"[.-]", "_", name))


def quantity(metric: str) -> str:
    """The quantity an end-to-end metric reports: its name up to the first
    ``.``.  Cells whose runs spread alike share a metric and its bound;
    a cell that spreads otherwise reports the same quantity under a name
    of its own (``train_cells_per_s.zinb``) with a bound of its own."""
    return metric.split(".", 1)[0]


def cell_entry(bench: dict, cell: str) -> dict:
    for w in bench.get("workloads", []):
        if w["name"] == cell:
            return w
    raise KeyError(f"cell {cell!r} is not in BENCHMARK.json")


def end_to_end_for(bench: dict, cell: str) -> list:
    """The end-to-end metrics a cell reports: those that list it, and
    those that list no cells."""
    return [m for m in bench.get("end_to_end", [])
            if "workloads" not in m or cell in m["workloads"]]


def per_layer_for(bench: dict, cell: str) -> list:
    """The per-layer metrics a cell reports: those that list it, and those
    without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_for(bench, cell)}
    out = []
    for m in bench.get("per_layer", []):
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif m["moves"] in e2e:
            out.append(m)
    return out
