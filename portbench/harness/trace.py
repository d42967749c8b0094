"""Reading the device trace of a window (``torch.profiler``, CUDA activity).

``device_busy`` of ``chip_smoke.py``, frozen here: the device is busy where
any device event (kernel, copy, set) runs, and its busy time is the union of
their intervals over the window.  Kernel time is summed per name pattern,
for the roofline shares.  Each idle gap of the device is charged to what the
host was doing during it: the innermost span open then (the spans'
timeline, ``spans.py``), found by aligning the host clock to the trace's
through one marker recorded as the window opens.
"""
from __future__ import annotations

import bisect
import re
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from . import arith
from .spans import OUTSIDE, clock

MARKER = "portbench.window"


@dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0
    device_events: List[Tuple[str, float, float]] = field(default_factory=list)
    gaps: List[Tuple[float, float]] = field(default_factory=list)  # host clock
    n_device_events: int = 0

    def kernel_s(self, pattern: str) -> Tuple[float, int]:
        """Device seconds and count of the kernels whose name matches."""
        rx = re.compile(pattern)
        hits = [b - a for name, a, b in self.device_events if rx.search(name)]
        return sum(hits), len(hits)

    def top_ops(self, n: int = 10) -> List[List]:
        per: Dict[str, float] = {}
        for name, a, b in self.device_events:
            per[name] = per.get(name, 0.0) + (b - a)
        return [[k, v] for k, v in
                sorted(per.items(), key=lambda kv: -kv[1])[:n]]


class Profiler:
    """The profiler over one window; ``None`` device means a CPU run, which
    traces nothing (no device time is ever read from a CPU run)."""

    def __init__(self, torch, on_device: bool) -> None:
        self.torch = torch
        self.on_device = on_device
        self.prof = None
        self.t_open = self.t_close = 0.0
        self.mark_host = 0.0

    @contextmanager
    def window(self):
        torch = self.torch
        if not self.on_device:
            self.t_open = clock()
            yield
            self.t_close = clock()
            return
        from torch.profiler import ProfilerActivity, profile, record_function
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            with record_function(MARKER):
                self.mark_host = clock()
            self.t_open = clock()
            yield
            torch.cuda.synchronize()
            self.t_close = clock()
        self.prof = prof

    def read(self) -> Trace:
        tr = Trace(window_s=self.t_close - self.t_open)
        if self.prof is None:
            return tr
        cuda = self.torch.autograd.DeviceType.CUDA
        mark = None
        raw: List[Tuple[str, int, int]] = []
        for name, dtype, a, b in _events(self.prof):
            if dtype == cuda:
                raw.append((name, a, b))
            elif name == MARKER and mark is None:
                mark = a
        if mark is None:
            raise RuntimeError("the profiler lost the window's marker")
        # trace nanoseconds -> host clock seconds, through the marker (the
        # difference is taken in integers: the trace's clock is absolute)
        dev = [(n, self.mark_host + (a - mark) * 1e-9,
                self.mark_host + (b - mark) * 1e-9) for n, a, b in raw]
        lo, hi = self.t_open, self.t_close
        ivs = [(max(a, lo), min(b, hi)) for _, a, b in dev if b > lo and a < hi]
        tr.device_events = dev
        tr.n_device_events = len(dev)
        tr.busy_s = arith.union_s(ivs)
        tr.gaps = arith.gaps(ivs, lo, hi)
        return tr


def _events(prof):
    """(name, device type, start ns, end ns) of every event in the trace,
    from the profiler's raw events (reading those is far quicker than
    building its event list)."""
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns()
        yield e.name(), e.device_type(), a, a + e.duration_ns()


def idle_by_host(tr: Trace, timeline: List[Tuple[float, str]], n: int = 10
                 ) -> List[List]:
    """Idle seconds of the device summed by what the host was doing: the
    innermost span open, by the spans' timeline of (time, innermost span
    from then on), ``OUTSIDE`` before its first entry; largest first."""
    times = [t for t, _ in timeline]
    per: Dict[str, float] = {}
    for a, b in tr.gaps:
        i = bisect.bisect_right(times, a) - 1
        while a < b:
            label = timeline[i][1] if i >= 0 else OUTSIDE
            end = min(b, times[i + 1]) if i + 1 < len(times) else b
            per[label] = per.get(label, 0.0) + (end - a)
            a, i = end, i + 1
    return [[k, v] for k, v in sorted(per.items(), key=lambda kv: -kv[1])[:n]]
