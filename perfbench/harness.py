"""Finds the benchmark's parts by name and loads them.

Everything that belongs to one configuration, one cell or one metric
sits in a file of its own, found from the names in ``BENCHMARK.json``:

- ``perfbench/configs/<config>.json``: a model configuration;
- ``perfbench/workloads/<cell>.json``: a cell: its configuration, the
  entry that drives it and its traffic's parameters, and its limits;
- ``perfbench/entries/<entry>.py``: a driver of the program (``run``);
- ``perfbench/metrics/<metric>.py``: a per-layer metric's reader
  (``read(run)``, which returns None where it finds nothing to read);
- ``perfbench/reference/<family>.py``: a family's plain reference;
- ``perfbench/work/<family>.py``: a family's operation and byte counts.

``root`` is the directory that holds ``BENCHMARK.json`` and
``perfbench/``: the checkout, or a copy a test builds.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from types import ModuleType
from typing import Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def bench(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cells(root: str = ROOT) -> List[str]:
    """The cells ``BENCHMARK.json`` names, in its order."""
    return [w["name"] for w in bench(root)["workloads"]]


def workload(name: str, root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "perfbench", "workloads", f"{name}.json"))


def config(name: str, root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "perfbench", "configs", f"{name}.json"))


def module(kind: str, name: str, root: str = ROOT) -> ModuleType:
    """``perfbench/<kind>/<name>.py`` loaded from its file (a metric's
    name may hold dots), once per process."""
    path = os.path.join(root, "perfbench", kind, f"{name}.py")
    key = f"perfbench_{kind}_{abs(hash(os.path.abspath(path)))}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        if spec is None or not os.path.isfile(path):
            raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def metrics_of(cell: str, root: str = ROOT) -> Dict[str, List[dict]]:
    """The metric entries of ``BENCHMARK.json`` that ``cell`` reports:
    ``{'end_to_end': [...], 'per_layer': [...]}``; an entry without a
    ``workloads`` list is reported in every cell."""
    b = bench(root)
    return {kind: [m for m in b[kind] if cell in m.get("workloads", [cell])]
            for kind in ("end_to_end", "per_layer")}


def cell_entry(cell: str, root: str = ROOT) -> dict:
    """The cell's entry of ``BENCHMARK.json``'s ``workloads``."""
    for w in bench(root)["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"BENCHMARK.json names no cell {cell!r}; cells: {cells(root)}")
