"""The program's own spans and counters (``repro_torch.trace``) in a traced
window, for the per-layer readers that read them.

The runner installs, for the window of a ``--trace 1`` run, the outside
spans, launch recorders and counters its readers declare; it does not know
the program's tracer.  A reader of the program's records declares the two
hooks below (``LAUNCHES = program.LAUNCHES``, ``COUNTERS =
program.COUNTERS``), and they turn the tracer on and off around the window:

- a launch recorder runs only inside the window, before each call of its
  target.  On a request's entry (``StoreQueryEngine.serve`` for a read,
  ``RStore.writer`` for an ingest session) the first such call clears the
  tracer and turns it on, so that every request of the window is recorded
  whole;
- a counter is read just before the window and just after it.  The tracer is
  off at the first reading, and nothing happens; at the second, it is turned
  off and what it recorded is kept here.  The ingest read-back that follows
  the window is not recorded.

``span_ms(obs, name)`` is the self time of the program's spans ``name`` per
unit of work, ``counter(obs, name, within)`` a counter's total over the
window.  A program without the tracer (an older commit) records nothing, and
every reader of its records returns None; untraced runs load no reader and
leave the tracer off.
"""
from __future__ import annotations

from typing import Dict, List, Optional

try:
    from repro_torch import trace as _ptrace
except ImportError:                    # a program without its own tracer
    _ptrace = None


class _Record:
    """What the program recorded in the last traced window."""

    def __init__(self, spans: List, counters: Dict[str, int]) -> None:
        self.spans = spans
        self.counters = counters
        self.self_s = _ptrace.self_times(spans)


_last: Optional[_Record] = None


def _request(*args, **kwargs) -> None:
    """Launch-recorder cost function on a request's entry: the window's first
    request turns the tracer on (it records no launch)."""
    global _last
    if _ptrace is not None and _ptrace.ACTIVE is None:
        _ptrace.collect()             # nothing from before the window
        _last = None
        _ptrace.enable()


class _Window:
    @property
    def end(self) -> float:
        """Read as a counter: after the window, turns the tracer off and
        keeps what it recorded."""
        global _last
        if _ptrace is not None and _ptrace.ACTIVE is not None:
            _ptrace.disable()
            _last = _Record(*_ptrace.collect())
        return 0.0


WINDOW = _Window()
LAUNCHES = {"repro_torch.serve.engine:StoreQueryEngine.serve": _request,
            "repro_torch.core.ingest:RStore.writer": _request}
COUNTERS = {"program_trace": "portbench.harness.program:WINDOW.end"}


def last() -> Optional[_Record]:
    """The record of the last traced window, None before the first."""
    return _last


def span_ms(obs, name: str, within: Optional[str] = None) -> Optional[float]:
    """Self ms per unit of work of the program's spans ``name``; 0 where none
    ran but a span ``within`` did (the work it would time did not happen
    there)."""
    rec = _last
    if rec is None or obs.units <= 0:
        return None
    if name in rec.self_s:
        return 1e3 * rec.self_s[name] / obs.units
    return 0.0 if within in rec.self_s else None


def counter(obs, name: str, within: str) -> Optional[float]:
    """The program's counter ``name`` over the window: 0 where it was never
    added to but the span ``within``, which counts it, ran."""
    rec = _last
    if rec is None or obs.units <= 0:
        return None
    if name in rec.counters:
        return float(rec.counters[name])
    return 0.0 if within in rec.self_s else None
