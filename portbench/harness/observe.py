"""What a per-layer metric's reader sees of one traced window.

A reader (``metrics/<name>.py``) declares what it needs and reads it back:

- ``SPANS``: ``{"module:Owner.attr": label}``, host-clock spans installed
  around those calls for the window (``spans.py``); ``obs.span_ms(label)``
  is the label's self time per unit of work;
- ``COUNTERS``: ``{name: "module:attr"}`` (or ``"kvs:attr.path"`` on the
  store's router), read before and after the window; ``obs.counter(name)``
  is the difference;
- ``LAUNCHES``: ``{"module:entry": cost}``, each launch's (bytes, word
  operations) from ``arith``'s cost functions; ``obs.roofline_pct(...)``
  divides their least time by the matching kernels' device time.

A unit of work is a request in a read cell and an acknowledged version in
an ingest cell.  A reader returns None where it finds nothing to read.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from . import arith
from .trace import Trace


@dataclass
class Observation:
    units: int
    spans_s: Dict[str, float] = field(default_factory=dict)
    span_calls: Dict[str, int] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)
    launches: Dict[str, List[Tuple[float, float]]] = field(default_factory=dict)
    trace: Optional[Trace] = None

    def span_ms(self, label: str) -> Optional[float]:
        if self.units <= 0 or label not in self.span_calls:
            return None
        return 1e3 * self.spans_s[label] / self.units

    def counter(self, name: str) -> Optional[float]:
        return self.counters.get(name)

    def per_unit(self, value: Optional[float]) -> Optional[float]:
        return None if value is None or self.units <= 0 \
            else value / self.units

    def device_idle_pct(self) -> Optional[float]:
        tr = self.trace
        if tr is None or tr.n_device_events == 0 or tr.window_s <= 0:
            return None
        return 100.0 * (1.0 - tr.busy_s / tr.window_s)

    def roofline_pct(self, launches: Dict[str, Callable],
                     kernel_pattern: str) -> Optional[float]:
        """Sum of the launches' least times over the device time of the
        kernels whose name matches; None when either is missing or the
        launch and kernel counts differ."""
        costs = [c for t in launches for c in self.launches.get(t, [])]
        if self.trace is None or not costs:
            return None
        dev_s, n = self.trace.kernel_s(kernel_pattern)
        if n != len(costs) or dev_s <= 0:
            return None
        return 100.0 * sum(arith.least_s(b, o) for b, o in costs) / dev_s
