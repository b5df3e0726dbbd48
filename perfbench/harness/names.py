"""Find a cell's files by the names in ``BENCHMARK.json``.

- ``perfbench/workloads/<cell>.json``: the ``drivers/`` module that runs
  the cell, its settings and the limits of its correctness check;
- ``perfbench/configs/<config>.json``: the configuration as it is run;
- ``perfbench/traffic/<traffic>.json``: the traffic mix's parameters;
- ``perfbench/drivers/<driver>.py``: one per program entry a window drives;
- ``perfbench/metrics/<metric>.py``: one reader per metric, its ``read``.

A later cell or metric adds files and entries; nothing here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One cell with everything its files say."""

    name: str
    chips: int
    config_name: str
    traffic_name: str
    workload: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]] = field(default_factory=list)
    per_layer: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def driver(self) -> str:
        return self.workload["driver"]

    def limits(self) -> Dict[str, float]:
        return dict(self.workload.get("limits", {}))


def _for_cell(metrics: List[Dict[str, Any]], cell: str,
              moved: Optional[set] = None) -> List[Dict[str, Any]]:
    """The metrics a cell reports: those that list it, or list no cells
    (a per-layer metric without a list goes with the end-to-end metric it
    moves, where the cell reports that)."""
    out = []
    for m in metrics:
        cells = m.get("workloads")
        if cells is not None:
            if cell in cells:
                out.append(m)
        elif moved is None or m.get("moves") in moved:
            out.append(m)
    return out


def load_cell(name: str, bench_path: Optional[str] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``; KeyError if it has none."""
    bench = _json(bench_path or os.path.join(ROOT, "BENCHMARK.json"))
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    e2e = _for_cell(bench["end_to_end"], name)
    moved = {m["name"] for m in e2e}
    return Cell(
        name=name, chips=int(entry["chips"]), config_name=entry["config"],
        traffic_name=entry["traffic"],
        workload=_json(os.path.join(BENCH_DIR, "workloads", f"{name}.json")),
        config=_json(os.path.join(BENCH_DIR, "configs",
                                  f"{entry['config']}.json")),
        traffic=_json(os.path.join(BENCH_DIR, "traffic",
                                   f"{entry['traffic']}.json")),
        end_to_end=e2e, per_layer=_for_cell(bench["per_layer"], name, moved))


def driver_module(name: str):
    """``perfbench/drivers/<name>.py``."""
    return importlib.import_module(f"perfbench.drivers.{name}")


def metric_reader(name: str):
    """The ``read`` function of ``perfbench/metrics/<name>.py`` (a name may
    hold dots, so the file is loaded by its path)."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
