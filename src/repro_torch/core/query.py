"""Single-query compatibility layer over the plan/execute engine (§2.4).

.. deprecated::
    ``QueryProcessor`` is the seed API's one-query-at-a-time shape, kept for
    back-compat only.  New code should use the session API — ``rs.snapshot()``
    + ``snap.execute([...])`` — which batches kernel launches and KVS round
    trips across queries and supports the full planner algebra
    (``Q.and_/or_/not_``, ``Q.count/exists/distinct``, ``snap.explain``).

The query path lives in :mod:`repro_torch.core.plan` (logical IR + planner +
answer layer) and :mod:`repro_torch.core.api` (the fetch layer): a
:class:`~repro_torch.core.api.Snapshot` compiles a whole batch into one fused
bitmap-program launch and fetches every candidate chunk *and* chunk map in
ONE interleaved ``multiget`` round trip.  :class:`QueryProcessor` is
implemented as single-query batches on that engine, so each ``get_*`` costs
exactly one KVS round trip (the seed paid two: chunks, then maps).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..device import DeviceLike
from .api import BatchResult, Q, Query, QueryResult, QueryStats, Snapshot
from .index import Projections
from .kvs import KVS
from .version_graph import VersionGraph

__all__ = ["QueryProcessor", "QueryStats", "Q", "Query", "QueryResult",
           "BatchResult", "Snapshot"]


class QueryProcessor:
    """One-query-at-a-time facade over :class:`Snapshot` (back-compat).
    Its bitmap programs run on ``device`` (``None`` = the card)."""

    def __init__(self, graph: VersionGraph, projections: Projections,
                 kvs: KVS, device: DeviceLike = None) -> None:
        self.graph = graph
        self.proj = projections
        self.kvs = kvs
        self._snap = Snapshot(graph, projections, kvs, device=device)

    def _one(self, q: Query) -> QueryResult:
        return self._snap.execute([q])[0]

    def get_version(self, vid: int) -> Tuple[Dict[int, bytes], QueryStats]:
        r = self._one(Q.version(vid))
        return r.value, r.stats

    def get_range(self, vid: int, key_lo: int,
                  key_hi: int) -> Tuple[Dict[int, bytes], QueryStats]:
        r = self._one(Q.range(vid, key_lo, key_hi))
        return r.value, r.stats

    def get_record(self, vid: int, pk: int) -> Tuple[Optional[bytes], QueryStats]:
        r = self._one(Q.record(vid, pk))
        return r.value, r.stats

    def get_evolution(self, pk: int) -> Tuple[List[Tuple[int, bytes]], QueryStats]:
        r = self._one(Q.evolution(pk))
        return r.value, r.stats
