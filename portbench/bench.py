"""The benchmark's data, found by name.

`BENCHMARK.json` at the root names the cells and the metrics.  A cell's
configuration is the file that its `configs` entry names, its traffic
mix `portbench/traffic/<traffic>.json`, the mix's driver
`portbench/drivers/<driver>.py`, and each per-layer metric's reader
`portbench/metrics/<metric>.py`.  Every path is taken under one root, so
that a cell, a mix or a metric is added by adding files and entries.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path


def load_benchmark(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _for_cell(metrics: List[dict], cell: str) -> List[dict]:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` with its configuration, traffic and metrics."""
    root = Path(root)
    bench = load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    w = work[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root / cfg["file"]) as f:
        config = json.load(f)
    with open(root / "portbench" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(name, w["config"], config, w["traffic"], traffic,
                int(w["chips"]), _for_cell(bench["end_to_end"], name),
                _for_cell(bench["per_layer"], name), root)


def _load_file(path: Path, tag: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(tag, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[tag] = mod
    spec.loader.exec_module(mod)
    return mod


def driver(c: Cell) -> ModuleType:
    """The traffic mix's driver module (`run(run: Run) -> Outcome`)."""
    name = c.traffic["driver"]
    return _load_file(c.root / "portbench" / "drivers" / f"{name}.py",
                      f"portbench_driver_{name}")


def readers(c: Cell) -> Dict[str, ModuleType]:
    """One reader module (`read(ctx) -> value or None`) per per-layer
    metric of the cell."""
    return {m["name"]: _load_file(
        c.root / "portbench" / "metrics" / f"{m['name']}.py",
        "portbench_metric_" + m["name"].replace(".", "_").replace("-", "_"))
        for m in c.per_layer}


def unit_of(c: Cell, metric: str) -> Optional[str]:
    for m in c.end_to_end + c.per_layer:
        if m["name"] == metric:
            return m["unit"]
    return None
