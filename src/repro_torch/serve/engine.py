"""Serving engine: the store's query front-end.

:class:`StoreQueryEngine` is the RStore serving surface: it pins a snapshot
per wave of queries and routes every wave through the unified planner
(:mod:`repro_torch.core.plan` via ``Snapshot.execute`` — the same
one-launch / one-multiget pipeline the session API uses), re-snapshotting
when a full rebuild invalidates the pin.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence


class StoreQueryEngine:
    """Store-serving front-end: waves of queries over pinned snapshots.

    Holds one snapshot at a time and executes whole waves against it —
    planning, kernel launches and the KVS multiget are batched per wave by
    the planner, not per query.  A full ``build()`` under the engine
    invalidates the pin and the next wave re-snapshots; a layout change
    that keeps content just re-pins via ``snapshot.refresh()``.
    """

    def __init__(self, rs) -> None:
        self.rs = rs
        self._snap = None
        self.waves_served = 0
        self.repins = 0

    def snapshot(self):
        """The current pinned snapshot (taken lazily, kept across waves)."""
        if self._snap is None:
            self._snap = self.rs.snapshot()
        return self._snap

    def _fresh_snapshot(self):
        snap = self.snapshot()
        try:
            snap._check_fresh()
        except RuntimeError:
            try:
                snap = snap.refresh()          # layout change: re-pin in place
            except RuntimeError:
                snap = self.rs.snapshot()      # full rebuild: new snapshot
            self._snap = snap
            self.repins += 1
        return snap

    def serve(self, queries: Sequence[Any]):
        """Execute one wave → :class:`~repro_torch.core.plan.BatchResult`."""
        batch = self._fresh_snapshot().execute(list(queries))
        self.waves_served += 1
        return batch

    def explain(self, queries: Sequence[Any]) -> List[Dict[str, Any]]:
        """Rendered plans + predicted costs for a wave (no execution)."""
        return self._fresh_snapshot().explain(list(queries))

    def warm(self, queries: Sequence[Any]) -> Dict[str, int]:
        """Prefetch a wave's chunks into the cache layer, if one is on."""
        return self._fresh_snapshot().prefetch(list(queries))
