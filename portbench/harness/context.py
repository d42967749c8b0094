"""What a traffic kind is handed, and what it hands back.

A traffic kind is a module ``kinds/<kind>.py``, named by a mix's ``kind``.
The runner keeps the parts every kind shares (set-up timing, the profiler
window, spans, launches and counters, the check against the reference, the
result line) and calls the kind for the rest, in this order:

- ``plan(config, mix, seconds)`` → ``(parents, loaded)``: the op log's
  version tree, as the parent of each version after the root (each below
  its child; ``gen.chain(n)`` for a chain), and how many versions, from the
  root on, set-up loads (``store.load``) before the window;
- ``prepare(run)``: the rest of the kind's set-up (sessions, requests,
  warm-up), counted in ``setup_s``;
- ``window(run, win, seconds)``: the measured loop, filling ``win``;
- ``written(run, win)`` → ``n``: versions ``0..n-1`` are the ones written
  and acknowledged by the window's close, which the reference replays;
- ``readback(run, win)`` → ``[(request, values)]``: what the kind reads back
  after the window (``read_every_copy`` reads it from each copy the stack
  keeps), checked with the window's own answers;
- ``measure(win)`` → ``{metric: value}``: the kind's end-to-end metrics.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass, field
from types import ModuleType
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import gen


def log(*a) -> None:
    print("[portbench]", *a, file=sys.stderr, flush=True)


@dataclass
class Window:
    """What the window produced and what it took."""

    attempted: int = 0
    failed: int = 0
    seconds: float = 0.0
    latencies: List[float] = field(default_factory=list)
    records: int = 0             # records returned (reads), acknowledged
    units: int = 0               # requests (reads), versions (ingest)
    answers: List[Tuple[Tuple, list]] = field(default_factory=list)


@dataclass
class Run:
    """One run's pieces: ``T`` is ``repro_torch.core``; ``versions`` the op
    log's versions in the form ``WriteSession.commit`` takes (a kind may drop
    them once it needs them no more); ``stale`` the versions by which the
    control asks each read early; ``state`` the kind's own."""

    T: Any
    config: Dict
    mix: Dict
    seed: int
    log: gen.OpLog
    versions: Optional[list]
    loaded: int
    rs: Any
    kvs: Any
    stack: ModuleType
    sync: Callable[[], None]
    stale: int
    state: Dict[str, Any] = field(default_factory=dict)


def read_every_copy(run: Run, request: Tuple) -> List[Tuple[Tuple, list]]:
    """``request`` served through the read path once from each copy the
    stack keeps (a copy that fails gives None: every answer is then
    wrong)."""
    from repro_torch.serve.engine import StoreQueryEngine
    out = []
    for i in range(run.stack.copies(run.kvs)):
        try:
            with run.stack.reading_from(run.kvs, i):
                got = StoreQueryEngine(run.rs).serve(
                    gen.to_queries(run.T.Q, request, run.stale))
            out.append((request, [r.value for r in got]))
        except Exception as e:        # every read-back answer is then wrong
            log(f"the read-back from copy {i} failed: {e!r}")
            out.append((request, None))
    return out
