"""Finding a cell's pieces by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
harness reads ``configs/<config>.json`` and ``traffic/<mix>.json``, and for
each per-layer metric that lists the cell (or lists none) the reader
``metrics/<metric>.py``.  Adding a configuration, a mix or a metric is
adding its file and its entry: nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from types import ModuleType
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Cell:
    name: str
    config: Dict
    mix: Dict
    chips: int
    end_to_end: List[Dict]
    per_layer: List[Dict]
    readers: Dict[str, ModuleType] = field(default_factory=dict)


def load_benchmark() -> Dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _load_json(kind: str, name: str, bench_dir: str) -> Dict:
    path = os.path.join(bench_dir, kind, name + ".json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    with open(path) as f:
        return json.load(f)


def load_config(name: str, bench_dir: str = BENCH_DIR) -> Dict:
    return _load_json("configs", name, bench_dir)


def load_mix(name: str, bench_dir: str = BENCH_DIR) -> Dict:
    return _load_json("traffic", name, bench_dir)


def load_reader(name: str, bench_dir: str = BENCH_DIR) -> ModuleType:
    """``metrics/<name>.py`` as a module (metric names hold dots, so the
    file is loaded by path, not imported by name)."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no reader for metric {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not callable(getattr(mod, "read", None)):
        raise TypeError(f"{path} has no read(obs) function")
    return mod


def _applies(metric: Dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported


def find_cell(name: str, bench: Optional[Dict] = None,
              bench_dir: str = BENCH_DIR) -> Cell:
    bench = load_benchmark() if bench is None else bench
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(by_name)}")
    w = by_name[name]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    cell = Cell(name, load_config(w["config"], bench_dir),
                load_mix(w["traffic"], bench_dir), int(w["chips"]), e2e, layer)
    cell.readers = {m["name"]: load_reader(m["name"], bench_dir)
                    for m in layer}
    return cell
