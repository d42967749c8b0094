"""Finding a cell's pieces by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
harness reads ``configs/<config>.json`` and ``traffic/<mix>.json``, and for
each per-layer metric that lists the cell (or lists none) the reader
``metrics/<metric>.py``.  The configuration names its store stack
(``"stack"``, :data:`DEFAULT_STACK` where it names none), found as
``stacks/<stack>.py``; the mix names its traffic kind (``"kind"``), found as
``kinds/<kind>.py``.  Adding a configuration, a mix, a metric, a stack or a
kind is adding its file and its entry: nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from types import ModuleType
from typing import Dict, List, Optional, Sequence

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)


# the stack of a configuration that names none: KV tables behind a router
DEFAULT_STACK = "sharded"


@dataclass
class Cell:
    name: str
    config: Dict
    mix: Dict
    chips: int
    end_to_end: List[Dict]
    per_layer: List[Dict]
    readers: Dict[str, ModuleType] = field(default_factory=dict)
    stack: Optional[ModuleType] = None
    kind: Optional[ModuleType] = None


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


def _load_module(folder: str, what: str, name: str, bench_dir: str,
                 needs: Sequence[str]) -> ModuleType:
    """``<folder>/<name>.py`` as a module (names hold dots and dashes, so
    the file is loaded by path, not imported by name), refused unless it
    defines each function in ``needs``."""
    path = os.path.join(bench_dir, folder, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {what} {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    missing = [f for f in needs if not callable(getattr(mod, f, None))]
    if missing:
        raise TypeError(f"{path} has no {', '.join(missing)} function")
    return mod


def load_reader(name: str, bench_dir: str = BENCH_DIR) -> ModuleType:
    """``metrics/<name>.py``: ``read(obs)``."""
    return _load_module("metrics", "reader for metric", name, bench_dir,
                        ("read",))


def load_stack(name: str, bench_dir: str = BENCH_DIR) -> ModuleType:
    """``stacks/<name>.py``: ``build(T, config, device)`` gives ``(rs,
    kvs)``; ``copies(kvs)`` is how many copies of each value the stack
    keeps, and ``reading_from(kvs, i)`` a context in which reads are served
    by copy ``i`` alone."""
    return _load_module("stacks", "stack", name, bench_dir,
                        ("build", "copies", "reading_from"))


def load_kind(name: str, bench_dir: str = BENCH_DIR) -> ModuleType:
    """``kinds/<name>.py``, a traffic kind (``harness/context.py`` says what
    each function does)."""
    return _load_module("kinds", "traffic kind", name, bench_dir,
                        ("plan", "prepare", "window", "written", "readback",
                         "measure"))


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
    cell.stack = load_stack(cell.config.get("stack", DEFAULT_STACK),
                            bench_dir)
    cell.kind = load_kind(cell.mix["kind"], bench_dir)
    return cell
