"""What a run measures, found by name.

`BENCHMARK.json` at the root of the checkout names the cells, their
configurations and their metrics. Everything that belongs to one of them
sits in a file of its own, which this module finds by the name alone:

- `portbench/configs/<config>.json`: the configuration as it is run
  (`config`: the port's Config fields), its source, cuts and assumptions;
- `portbench/cells/<cell>.json`: the traffic mix or training job of one
  cell (`driver` names `portbench/drivers/<driver>.py`, `params` its
  parameters) and why the cell exists;
- `portbench/metrics/<metric>.py`: a reader of one per-layer metric,
  `read(window) -> float or None`, over the traced window's records;
- `portbench/drivers/<driver>.py`: one kind of window (`run(ctx)`).

A later cell, configuration or metric is added as files and entries,
with no edit to a file that exists.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]
PACKAGE = "portbench"


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def by_name(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> dict:
    return load_json(root / PACKAGE / "cells" / f"{name}.json")


def load_config(entry: dict, root: Path = ROOT) -> dict:
    return load_json(root / entry["file"])


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end_of(bench: dict, cell: str) -> List[dict]:
    """The end-to-end metrics this cell reports."""
    return [m for m in bench["end_to_end"] if applies(m, cell)]


def per_layer_of(bench: dict, cell: str) -> List[dict]:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_of(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def _load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(metric: str, root: Path = ROOT):
    """The reader of a per-layer metric: `read(window)`."""
    path = root / PACKAGE / "metrics" / f"{metric}.py"
    return _load_module(path, "portbench_metric_" + metric.replace(
        ".", "_").replace("-", "_")).read


def load_driver(kind: str, root: Path = ROOT) -> ModuleType:
    return _load_module(root / PACKAGE / "drivers" / f"{kind}.py",
                        f"portbench_driver_{kind}")


def read_per_layer(metrics: List[dict], window, root: Path = ROOT
                   ) -> Dict[str, dict]:
    """Each metric's reading over the traced window; a reader that finds
    nothing to read returns None, and the metric is left out."""
    out: Dict[str, dict] = {}
    for m in metrics:
        value: Optional[float] = load_reader(m["name"], root)(window)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
