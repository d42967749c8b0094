"""Spans from outside the program: host-clock time inside named calls.

A span is installed by replacing a module or class attribute with a timing
wrapper for the length of a run (``chip_smoke.py``'s ``Timers``, frozen
here).  Spans nest: a span's self time is its duration less the durations
of the spans opened inside it, so ``answer`` excludes the ``decode`` it
calls.  With ``keep_timeline`` every opening and closing of a span is kept
as (time, the innermost span open from then on), which the trace reader
uses to say what the host was doing in each idle gap of the device.

Launch recorders wrap a kernel entry the same way and keep what a cost
function computes from each call's arguments (bytes and word operations).
"""
from __future__ import annotations

import importlib
import time
from typing import Callable, Dict, List, Optional, Tuple

clock = time.perf_counter
OUTSIDE = "outside the spanned layers"


def resolve(target: str) -> Tuple[object, str]:
    """``"pkg.mod:Class.attr"`` or ``"pkg.mod:attr"`` → (owner, attr)."""
    mod_name, _, path = target.partition(":")
    owner: object = importlib.import_module(mod_name)
    *outer, attr = path.split(".")
    for part in outer:
        owner = getattr(owner, part)
    if not hasattr(owner, attr):
        raise AttributeError(f"{target}: no attribute {attr!r}")
    return owner, attr


class Patches:
    """Attribute replacements undone in reverse order by ``close``."""

    def __init__(self) -> None:
        self._undo: List[Callable[[], None]] = []

    def replace(self, target: str, make: Callable[[Callable], Callable]
                ) -> None:
        owner, attr = resolve(target)
        had, old = attr in vars(owner), vars(owner).get(attr)
        new = make(getattr(owner, attr))
        if isinstance(old, staticmethod):
            new = staticmethod(new)
        setattr(owner, attr, new)

        def undo() -> None:
            if had:
                setattr(owner, attr, old)
            else:
                delattr(owner, attr)
        self._undo.append(undo)

    def close(self) -> None:
        while self._undo:
            self._undo.pop()()


class Spans(Patches):
    def __init__(self, keep_timeline: bool = False) -> None:
        super().__init__()
        self.self_s: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}
        self.timeline: List[Tuple[float, str]] = []
        self.keep = keep_timeline
        self.active = False
        self._stack: List[float] = []         # child seconds of open spans
        self._open: List[str] = []            # labels of open spans
        self.labels: Dict[str, str] = {}      # target -> label

    def wrap(self, target: str, label: str) -> None:
        """Install a span named ``label`` around ``target`` (once; two
        readers may ask for the same span)."""
        if target in self.labels:
            if self.labels[target] != label:
                raise ValueError(f"{target} is spanned as "
                                 f"{self.labels[target]!r} and as {label!r}")
            return
        self.labels[target] = label
        def make(fn):
            def timed(*a, **k):
                if not self.active:
                    return fn(*a, **k)
                stack = self._stack
                stack.append(0.0)
                self._open.append(label)
                t0 = clock()
                if self.keep:
                    self.timeline.append((t0, label))
                try:
                    return fn(*a, **k)
                finally:
                    t1 = clock()
                    dt = t1 - t0
                    child = stack.pop()
                    self._open.pop()
                    self.self_s[label] = self.self_s.get(label, 0.0) \
                        + dt - child
                    self.calls[label] = self.calls.get(label, 0) + 1
                    if stack:
                        stack[-1] += dt
                    if self.keep:
                        self.timeline.append(
                            (t1, self._open[-1] if self._open else OUTSIDE))
            return timed
        self.replace(target, make)

    def start(self) -> None:
        self.self_s, self.calls, self.timeline = {}, {}, []
        self.active = True

    def stop(self) -> None:
        self.active = False


class Launches(Patches):
    """Per kernel entry, the (bytes, word operations) of every call whose
    cost function returns one (a call that launches nothing returns None)."""

    def __init__(self) -> None:
        super().__init__()
        self.costs: Dict[str, List[Tuple[float, float]]] = {}
        self.active = False

    def wrap(self, target: str, cost: Callable[..., Optional[Tuple]]
             ) -> None:
        if target in self.costs:
            return
        self.costs[target] = []

        def make(fn):
            def counted(*a, **k):
                if self.active:
                    c = cost(*a, **k)
                    if c is not None:
                        self.costs[target].append(c)
                return fn(*a, **k)
            return counted
        self.replace(target, make)

    def start(self) -> None:
        for v in self.costs.values():
            v.clear()
        self.active = True

    def stop(self) -> None:
        self.active = False
