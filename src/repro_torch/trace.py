"""Spans and counters recorded inside the program, kept in memory.

The one tracing system of the port.  A *span* is a named interval of host
time at a layer boundary: its name, start, end, the id of the span open
around it (its parent) and a request id shared by every span of one
request.  A read request is one ``StoreQueryEngine.serve`` call, or one
``Snapshot.execute`` called directly; an ingest request is one
``WriteSession``, from its first commit to its ``close()``.  A *counter* is
a named integer added to where the work happens (once a chunk, never once a
record).

Nothing leaves the process but through :func:`collect`: there is no
exporter and no file.  ``enable()`` starts recording, ``disable()`` stops
it, ``collect()`` returns what was recorded and clears it.

**Clock.**  Every time is ``time.perf_counter()``, the host clock a caller
that also runs ``torch.profiler`` maps onto the profiler's timeline through
one marker event recorded at a known ``perf_counter`` time.  Program spans
and device events then share one timeline, and a gap in which the device
idles can be charged to the innermost span open during it
(:func:`timeline`).

**Cost when off.**  A span site reads :data:`ACTIVE` and branches on it:
while disabled it reads no clock and allocates nothing.  The pattern at a
site is one of::

    tr = trace.ACTIVE
    out = f(x) if tr is None else tr.call("read.gather", f, x)

    tr = trace.ACTIVE
    if tr is not None:
        tr.open("read.decode")
    try:
        ...
    finally:
        if tr is not None:
            tr.close()

Spans nest by a stack, so they are recorded from one thread (the store's
read and write paths run on the caller's thread).
"""
from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional, Tuple

clock = time.perf_counter


class Span(NamedTuple):
    name: str
    start: float                 # clock() seconds
    end: float
    id: int
    parent: Optional[int]        # id of the span open around it
    request: int


class Tracer:
    """Spans and counters of one enabled stretch; see the module doc."""

    def __init__(self) -> None:
        self.spans: List[tuple] = []     # closed, as Span's fields
        self.counters: Dict[str, int] = {}
        # the open spans: [name, start, id, parent, request]
        self.stack: List[list] = []
        self._ids = 0
        self._requests = 0

    def new_request(self) -> int:
        self._requests += 1
        return self._requests

    def open(self, name: str, request: Optional[int] = None) -> None:
        """Open ``name`` inside the innermost open span, in its request; a
        span opened with none open starts ``request`` (a new one if
        None)."""
        self._ids += 1
        st = self.stack
        if st:
            parent, req = st[-1][2], st[-1][4]
        else:
            parent = None
            req = self.new_request() if request is None else request
        st.append([name, clock(), self._ids, parent, req])

    def close(self) -> None:
        name, t0, sid, parent, req = self.stack.pop()
        # a plain tuple (half the cost of a Span); collect() makes the Span
        self.spans.append((name, t0, clock(), sid, parent, req))

    def call(self, name: str, fn, *args, request: Optional[int] = None):
        """``fn(*args)`` inside a span ``name``."""
        self.open(name, request)
        try:
            return fn(*args)
        finally:
            self.close()

    def add(self, name: str, n: int) -> None:
        self.counters[name] = self.counters.get(name, 0) + int(n)


# The tracer recording now, or None while tracing is off.
ACTIVE: Optional[Tracer] = None
_tracer = Tracer()


def enable() -> None:
    global ACTIVE
    ACTIVE = _tracer


def disable() -> None:
    global ACTIVE
    ACTIVE = None


def collect() -> Tuple[List[Span], Dict[str, int]]:
    """The spans closed and the counters added since the last collect (the
    spans by start time), which are then cleared.  Spans still open stay
    open."""
    spans = sorted(map(Span._make, _tracer.spans), key=lambda s: s.start)
    counters = dict(_tracer.counters)
    _tracer.spans = []
    _tracer.counters = {}
    return spans, counters


def self_times(spans: List[Span]) -> Dict[str, float]:
    """Seconds by span name of each span's duration less the part its
    child spans cover."""
    child: Dict[int, float] = {}
    for s in spans:
        if s.parent is not None:
            child[s.parent] = child.get(s.parent, 0.0) + (s.end - s.start)
    out: Dict[str, float] = {}
    for s in spans:
        out[s.name] = out.get(s.name, 0.0) + (s.end - s.start) \
            - child.get(s.id, 0.0)
    return out


def timeline(spans: List[Span], outside: str) -> List[Tuple[float, str]]:
    """(time, name of the innermost span open from then on) at every
    opening and closing, ``outside`` where no span is open."""
    name_of = {s.id: s.name for s in spans}
    events = sorted([(s.start, 1, s.name) for s in spans]
                    + [(s.end, 0, name_of.get(s.parent, outside))
                       for s in spans])
    return [(t, name) for t, _, name in events]
