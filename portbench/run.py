#!/usr/bin/env python3
"""The port's benchmark: one run of one cell on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1> [--fault stale|unchanged|half|altered]

Run from the root of a checkout.  The cell is an entry of ``workloads`` in
``BENCHMARK.json``; its configuration, traffic mix and per-layer readers are
found by name under ``portbench/``.  The program under test is the
PyTorch/CUDA package ``repro_torch`` (``src/``); nothing here imports JAX or
the JAX package.  The run makes its data from ``--seed``, warms up, measures
for ``--seconds``, checks every answer against the plain reference, and
prints one JSON object as the last line of standard output: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics from spans, counters and the device trace.  The numbers
compared, each with its limit, are the last lines of standard error and the
last key of that object.

``--fault`` installs the control or a planted fault (``harness/faults.py``)
to show that the check fails; the benchmark's own runs never pass it.

The run exits non-zero and prints no result without a CUDA card, when the
card count is below the cell's, or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# every build and kernel cache of the program stays inside the checkout,
# at fixed paths, so that only a cell's first run there builds
CACHES = {"TORCH_EXTENSIONS_DIR": os.path.join(ROOT, "build", "torch_extensions"),
          "TRITON_CACHE_DIR": os.path.join(ROOT, "build", "triton"),
          "CUDA_CACHE_PATH": os.path.join(ROOT, "build", "cuda_cache")}
# top-level module names that must not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names) -> list:
    """The loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def fail(msg: str) -> int:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        return fail(f"the program under test is not here: no "
                    f"{os.path.join(ROOT, 'src', 'repro_torch')}")
    for k, v in CACHES.items():
        os.environ[k] = v
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from portbench.harness import registry, runner

    try:
        cell = registry.find_cell(args.workload)
    except (KeyError, FileNotFoundError) as e:
        return fail(str(e))
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false; the benchmark runs "
                    "on the card only")
    if torch.cuda.device_count() < cell.chips:
        return fail(f"{torch.cuda.device_count()} cards, the cell asks for "
                    f"{cell.chips}")
    out = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          device="cuda", fault=args.fault,
                          t_process=T_PROCESS)
    found = forbidden_modules(sys.modules)
    if found:
        return fail(f"modules that must not load were loaded: {found}")
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} ({c['is']} {c['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
