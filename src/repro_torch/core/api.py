"""Snapshot sessions: the fetch layer of the unified query planner.

RStore's core insight (§2.3–§2.4) is that few large batched fetches beat many
small ones, and that retrieval cost is governed by which chunks a plan
touches.  The logical plan IR, the physical bitmap-program compiler, and the
answer layer all live in :mod:`repro_torch.core.plan`; this module owns the one
thing that talks to the KVS — the session pipeline:

1. **Plan** — :class:`~repro_torch.core.plan.Planner` compiles the whole batch:
   every distinct leaf predicate contributes one bitmap row (shared across
   queries), each predicate tree becomes AND/OR instructions, and the batch
   executes ONE fused ``bitmap_vm_batch`` kernel launch.
2. **Dedupe** — candidate chunk ids are unioned across the batch; a chunk
   needed by ten queries is fetched once.  Index-only plans (``Q.count`` /
   ``Q.exists`` / ``Q.distinct``) contribute their chunk *maps* only — their
   payload blobs are never requested.
3. **Fetch** — ONE combined ``multiget`` for payloads *and* chunk maps
   (interleaved ``chunk/i``, ``map/i`` keys, then the map-only tail): a
   single backend round trip for the whole session.
4. **Answer** — :func:`repro_torch.core.plan.answer` (the single per-kind switch)
   materializes each result from the shared fetch, post-filtering exactly
   per record; metadata-mode aggregates never touch the KVS at all.

Usage::

    snap = rs.snapshot()                 # immutable read view (no flush)
    results = snap.execute([
        Q.version(v3),
        Q.record(v3, pk=7),
        Q.range(v3, 10, 19),
        Q.evolution(7),
        Q.where(v3, "color", 2),         # needs rs.create_index("color", ...)
        Q.and_(Q.where(v3, "color", 2),  # composite: ONE kernel launch,
               Q.where_range(v3, "size", 10, 20)),   # ONE multiget
        Q.count(Q.where(v3, "color", 2)),    # index-only: zero payload fetch
        Q.distinct(v3, "color"),             # index-only
    ])
    results[0].value                     # {pk: payload, ...}
    results[0].stats                     # per-query QueryStats
    results.batch                        # batch-level QueryStats
    print(snap.explain([Q.version(v3)])[0]["plan"])   # rendered plan tree

Reads never mutate the store: ``Snapshot`` holds the flushed state and
``execute`` only touches the KVS.  ``RStore.get_*`` remain as thin wrappers
over single-query batches.

The write side mirrors this design: :class:`repro_torch.core.ingest.WriteSession`
(``rs.writer()``) stages a wave of commits and group-flushes them through
one ``Backend.multiput`` — under :class:`repro_torch.core.kvs.ShardedKVS`
both directions cost one round trip per shard touched, however many queries
or chunks the session carries.

Fault tolerance is below this layer: with replicated shards
(:class:`repro_torch.core.replica.ReplicatedKVS`, via
``make_sharded_backend(..., replication_factor=R)``) the session
``multiget`` survives a replica death mid-workload unchanged — the group
fails the batch over to a surviving replica (at most one extra read round
trip per failed-over shard batch) and returns byte-identical results.  Only
a whole shard group going down surfaces here, as
:class:`repro_torch.core.replica.BackendUnavailable`.

The bitmap program runs on the snapshot's device (the store's), and so do
the sub-chunk decodes of a ``k>1`` store.
"""
from __future__ import annotations

from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

import numpy as np

from .. import trace
from . import costmodel
from . import plan as plan_mod
from .chunkstore import ChunkMap, StoredChunk
from .index import Projections
from .kvs import Backend
from .plan import (BatchResult, ExecContext, PlannedQuery, Q, Query,
                   QueryResult, QueryStats, render_plan)
from .secondary import SecondaryIndex
from .version_graph import VersionGraph

__all__ = ["Q", "Query", "QueryStats", "QueryResult", "BatchResult",
           "Snapshot"]


# ------------------------------------------------------------------- snapshot
class Snapshot:
    """Immutable read view over the flushed store state.

    Obtained via :meth:`RStore.snapshot`.  Holds the version graph,
    projections and KVS handle as of the last flush; ``execute`` plans and
    runs a whole batch of queries against it with one KVS round trip.
    Reads never mutate the store (the seed API's implicit flush-on-read is
    gone; ``RStoreConfig.auto_flush`` keeps it for back-compat at the
    ``RStore`` facade).

    Online (k=1) flushes after the snapshot only append chunks, so the
    snapshot keeps serving its versions; a full ``build()`` (including any
    k>1 flush) repartitions storage and *invalidates* the snapshot —
    ``execute`` then raises rather than silently reading rewritten chunks.
    """

    def __init__(self, graph: VersionGraph, proj: Projections,
                 kvs: Backend, epoch: Optional[int] = None,
                 current_epoch: Optional[Callable[[], int]] = None,
                 layout_epoch: Optional[int] = None,
                 current_layout_epoch: Optional[Callable[[], int]] = None,
                 indexes: Optional[Dict[str, SecondaryIndex]] = None,
                 repin: Optional[Callable[[], tuple]] = None,
                 staleness_lag: int = 0,
                 chunk_bytes: int = 1 << 16,
                 device=None,
                 ) -> None:
        self.graph = graph
        self.device = device
        self.proj = proj
        self.kvs = kvs
        # async ingest (core/flusher.py): committed-but-not-durable versions
        # at snapshot time.  0 for fresh (read-your-writes) snapshots; a
        # pinned snapshot reports how far behind the durable state it runs.
        # Staged versions are invisible to it — querying one fails loudly.
        self.staleness_lag = int(staleness_lag)
        # attr -> SecondaryIndex serving Q.where / Q.where_range plans
        self.indexes: Dict[str, SecondaryIndex] = indexes or {}
        self._vidx = {v: i for i, v in enumerate(graph.versions)}
        # target chunk payload size (ingest config) — explain()'s byte model
        self._chunk_bytes = int(chunk_bytes)
        # rebuild-epoch guard: a full build() repartitions and rewrites the
        # chunk/* and map/* keys, so chunk ids planned from this snapshot's
        # projections would dereference to unrelated data.  Online (k=1)
        # flushes only append chunks and extend maps, so they don't
        # invalidate snapshots and don't bump the epoch.
        self._epoch = epoch
        self._current_epoch = current_epoch
        # layout-epoch guard: a compaction pass rewrites *some* chunks and
        # deletes their old keys, but preserves the logical content of every
        # retained version — so a stale snapshot is re-pinnable via
        # :meth:`refresh` instead of dead like after a build()
        self._layout_epoch = layout_epoch
        self._current_layout_epoch = current_layout_epoch
        self._repin = repin

    def _check_fresh(self) -> None:
        if (self._epoch is not None and self._current_epoch is not None
                and self._current_epoch() != self._epoch):
            raise RuntimeError(
                "snapshot invalidated by a full rebuild (build() or a k>1 "
                "flush repartitions chunk storage); take a new snapshot()")
        if (self._layout_epoch is not None
                and self._current_layout_epoch is not None
                and self._current_layout_epoch() != self._layout_epoch):
            raise RuntimeError(
                "a compaction pass re-partitioned chunk storage under this "
                "snapshot; call snapshot.refresh() to re-pin (compaction "
                "preserves the logical content of retained versions)")

    def refresh(self) -> "Snapshot":
        """Re-pin to the store's current physical layout after a compaction
        pass.  Compaction never changes what a retained version contains,
        so this is safe and cheap — unlike a full ``build()``, after which
        only a new ``snapshot()`` helps (and this raises)."""
        if (self._epoch is not None and self._current_epoch is not None
                and self._current_epoch() != self._epoch):
            raise RuntimeError(
                "snapshot invalidated by a full rebuild (build() or a k>1 "
                "flush repartitions chunk storage); take a new snapshot()")
        if self._repin is None:
            raise RuntimeError("snapshot is not attached to a store; "
                               "take a new snapshot()")
        self.proj, self.indexes, self._layout_epoch = self._repin()
        self._vidx = {v: i for i, v in enumerate(self.graph.versions)}
        return self

    # ---------------------------------------------------------------- plan
    def _planner(self) -> plan_mod.Planner:
        # planners are batch-scoped: leaf-row dedupe and the instruction
        # stream accumulate per plan_batch call
        return plan_mod.Planner(self.graph, self.proj, self.indexes,
                                self._vidx, device=self.device)

    def plan_batch(self, queries: Sequence[Query]) -> List[PlannedQuery]:
        """Physical plans (mode + candidate chunks) for a batch — every
        launch-needing query shares ONE fused bitmap-program launch."""
        tr = trace.ACTIVE
        if tr is not None:
            tr.open("read.plan")
        try:
            return self._planner().plan_batch(list(queries))
        finally:
            if tr is not None:
                tr.close()

    def plan(self, queries: Sequence[Query]) -> List[np.ndarray]:
        """Candidate chunk ids per query (the legacy entry point — now a
        thin view over :meth:`plan_batch`)."""
        return [pq.cand for pq in self.plan_batch(queries)]

    # ------------------------------------------------------------ prefetch
    @staticmethod
    def _fetch_keys(payload_ids: Iterable[int],
                    map_only_ids: Iterable[int]) -> List[str]:
        """The session's one multiget key list: interleaved payload+map keys
        first (the legacy layout, byte-compatible with existing cache
        admission), then the map-only tail for index-only plans."""
        keys = [k for c in payload_ids for k in (f"chunk/{c}", f"map/{c}")]
        keys.extend(f"map/{c}" for c in map_only_ids)
        return keys

    @staticmethod
    def _split_ids(planned: Sequence[PlannedQuery]
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Dedupe candidates across the batch into (payload ids, map-only
        ids): a chunk wanted by any fetch-mode plan gets its payload; one
        wanted only by index-only plans gets its map alone."""
        pay = [pq.cand for pq in planned if pq.needs_payload and len(pq.cand)]
        maps = [pq.cand for pq in planned
                if pq.mode == "index_only" and len(pq.cand)]
        payload_ids = (np.unique(np.concatenate(pay)) if pay
                       else np.empty(0, np.int64))
        map_ids = (np.unique(np.concatenate(maps)) if maps
                   else np.empty(0, np.int64))
        map_only = np.setdiff1d(map_ids, payload_ids, assume_unique=True)
        return payload_ids, map_only

    def prefetch(self, queries: Sequence[Query]) -> Dict[str, int]:
        """Warm the chunk cache with everything ``queries`` would fetch.

        A no-op (``{"warmed_keys": 0, ...}``) unless the snapshot's KVS is a
        :class:`~repro_torch.core.cache.CachingKVS` layer.  The fill is a
        normal read-through ``multiget`` — already-cached keys cost nothing,
        misses arrive in ONE round trip (per shard) and pass the admission
        rule — so a subsequent ``execute`` of the same queries takes 0
        backend read round trips.  Index-only plans warm their chunk maps
        only.
        """
        self._check_fresh()
        if not getattr(self.kvs, "is_cache", False):
            return {"warmed_keys": 0, "round_trips": 0, "cache": 0}
        payload_ids, map_only = self._split_ids(self.plan_batch(queries))
        return self._warm(self._fetch_keys(
            (int(c) for c in payload_ids), (int(c) for c in map_only)))

    def prefetch_evolution(self, pk: int, lineage_versions: int = 4
                           ) -> Dict[str, int]:
        """Warm the cache for ``Q.evolution(pk)`` by walking VersionGraph
        paths.

        The base warm set is the evolution query's *planned* candidates
        (pk's key posting list, minus retention-pruned dead chunks) —
        exactly what the query fetches, so it runs with 0 backend read
        round trips afterwards.  On top, the version-tree paths root→leaf
        are walked to recover the lineage of versions where ``pk`` actually
        changed (its record copies name their origin versions), and the
        newest ``lineage_versions`` of those get their version posting
        lists warmed too — an evolution read is typically followed by
        version/record reads at the versions where the record changed.
        """
        self._check_fresh()
        if not getattr(self.kvs, "is_cache", False):
            return {"warmed_keys": 0, "round_trips": 0, "cache": 0}
        (pq,) = self.plan_batch([Q.evolution(pk)])
        cids = {int(c) for c in pq.cand}

        # lineage walk: origins of pk's copies, ordered along tree paths
        store = self.graph.store
        rids = np.flatnonzero(store.keys() == pk)
        origin_set = {int(o) for o in store.origin_versions()[rids]}
        lineage: List[int] = []
        seen: set = set()
        for leaf in self.graph.leaves():
            if self.graph.is_retired(leaf):
                continue
            # path_to_root is leaf→root; reverse for chronological order
            for v in reversed(self.graph.path_to_root(leaf)):
                if v in origin_set and v not in seen:
                    seen.add(v)
                    lineage.append(v)
        for v in lineage[-lineage_versions:]:
            vc = self.proj.version_chunks.get(v)
            if vc is not None:
                cids.update(int(c) for c in vc)
        return self._warm(self._fetch_keys(sorted(cids), ()))

    def _warm(self, keys: List[str]) -> Dict[str, int]:
        s = self.kvs.stats
        q0, h0 = s.n_queries, s.n_cache_hits
        if keys:
            self.kvs.multiget(keys)
        return {"warmed_keys": len(keys),
                "round_trips": s.n_queries - q0,
                "already_cached": s.n_cache_hits - h0,
                "cache": 1}

    # ------------------------------------------------------------- execute
    def execute(self, queries: Sequence[Query]) -> BatchResult:
        """Plan → dedupe → ONE interleaved multiget → answer.

        Traced as a ``read.request`` unless a span is open already
        (``StoreQueryEngine.serve`` opens the request)."""
        tr = trace.ACTIVE
        if tr is None or tr.stack:
            return self._execute(queries, tr)
        return tr.call("read.request", self._execute, queries, tr)

    def _execute(self, queries: Sequence[Query],
                 tr: Optional[trace.Tracer]) -> BatchResult:
        self._check_fresh()
        planned = self.plan_batch(queries)

        payload_ids, map_only = self._split_ids(planned)
        batch = QueryStats()
        batch.chunks_fetched = len(payload_ids) + len(map_only)
        batch.payload_chunks_fetched = len(payload_ids)
        fetched: Dict[int, Tuple[Optional[StoredChunk], ChunkMap, int]] = {}
        keys = self._fetch_keys((int(c) for c in payload_ids),
                                (int(c) for c in map_only))
        if keys:
            q0 = self.kvs.stats.n_queries
            b0 = self.kvs.stats.bytes_fetched
            h0 = self.kvs.stats.n_cache_hits
            c0 = self.kvs.stats.bytes_served_from_cache
            # interleaved chunk/map keys: payloads + maps in ONE round trip.
            # Under a CachingKVS the hit/miss partition happens inside this
            # multiget — cached keys are served from memory and ONE inner
            # fetch covers the misses, so kvs_queries is 0 on a warm cache.
            blobs = (self.kvs.multiget(keys) if tr is None else
                     tr.call("read.gather", self.kvs.multiget, keys))
            batch.kvs_queries = self.kvs.stats.n_queries - q0
            batch.bytes_fetched = self.kvs.stats.bytes_fetched - b0
            batch.cache_hits = self.kvs.stats.n_cache_hits - h0
            batch.bytes_from_cache = self.kvs.stats.bytes_served_from_cache - c0
            # payload round trips: the multiget carried chunk/* keys iff any
            # fetch-mode plan had candidates — index-only/metadata batches
            # report 0 here even though their maps cost a round trip
            batch.payload_round_trips = (batch.kvs_queries
                                         if len(payload_ids) else 0)
            for j, cid in enumerate(payload_ids):
                cb, mb = blobs[2 * j], blobs[2 * j + 1]
                fetched[int(cid)] = (StoredChunk.from_bytes(cb),
                                     ChunkMap.from_bytes(mb),
                                     len(cb) + len(mb))
            base = 2 * len(payload_ids)
            for j, cid in enumerate(map_only):
                mb = blobs[base + j]
                fetched[int(cid)] = (None, ChunkMap.from_bytes(mb), len(mb))

        ctx = self._exec_context(fetched)
        results: List[QueryResult] = []
        for pq in planned:
            stats = QueryStats(
                chunks_fetched=len(pq.cand),
                bytes_fetched=sum(fetched[int(c)][2] for c in pq.cand),
                kvs_queries=batch.kvs_queries if len(pq.cand) else 0,
                payload_chunks_fetched=(len(pq.cand) if pq.needs_payload
                                        else 0),
                payload_round_trips=(batch.payload_round_trips
                                     if pq.needs_payload and len(pq.cand)
                                     else 0),
            )
            value = (plan_mod.answer(pq, ctx, stats) if tr is None else
                     tr.call("read.answer", plan_mod.answer, pq, ctx, stats))
            batch.records_returned += stats.records_returned
            batch.irrelevant_chunks += stats.irrelevant_chunks
            results.append(QueryResult(query=pq.query, value=value,
                                       stats=stats))
        if tr is not None:
            tr.add("records_returned", batch.records_returned)
        return BatchResult(results, batch)

    def _exec_context(self, fetched: Dict[int, Tuple[Optional[StoredChunk],
                                                     ChunkMap, int]]
                      ) -> ExecContext:
        # retention-aware evolution: with retired versions around, a kept
        # chunk may still hold record copies reachable from no retained
        # version; their chunk-map bitmap rows tell us (no retained bit set)
        # and they are filtered out of Q3 results
        self._retained_bits = None
        if self.graph.has_retired():
            order = self.graph.versions
            idx = np.asarray([i for i, v in enumerate(order)
                              if not self.graph.is_retired(v)], dtype=np.int64)
            bits = np.zeros((len(order) + 31) // 32, dtype=np.uint32)
            if len(idx):
                np.bitwise_or.at(bits, idx // 32,
                                 np.uint32(1) << (idx % 32).astype(np.uint32))
            self._retained_bits = bits

        # shared extraction caches: decode each chunk's payloads once and
        # slice each (chunk, version) membership once, however many queries
        # in the session touch them
        payloads: Dict[int, Dict[int, bytes]] = {}
        members: Dict[Tuple[int, int], np.ndarray] = {}

        def _payloads(cid: int) -> Dict[int, bytes]:
            if cid not in payloads:
                payloads[cid] = fetched[cid][0].payloads(self.device)
            return payloads[cid]

        def _members(cid: int, vidx: int) -> np.ndarray:
            key = (cid, vidx)
            if key not in members:
                members[key] = fetched[cid][1].records_in_version(vidx)
            return members[key]

        return ExecContext(graph=self.graph, vidx=self._vidx,
                           indexes=self.indexes, fetched=fetched,
                           payloads=_payloads, members=_members,
                           retained_bits=self._retained_bits)

    # ------------------------------------------------------------- explain
    def explain(self, queries: Sequence[Query]) -> List[Dict[str, Any]]:
        """Render each query's chosen plan with predicted costs.

        Predictions come from :mod:`repro_torch.core.costmodel` at the store's
        configured chunk size: a fetch-mode plan pays payload+map per
        candidate chunk, an index-only plan pays maps alone, a metadata
        plan pays nothing.  Compare ``predicted_chunks`` against the
        measured ``stats.chunks_fetched`` of an ``execute`` run to see how
        lossy the projections were for the workload.
        """
        self._check_fresh()
        out: List[Dict[str, Any]] = []
        for pq in self.plan_batch(queries):
            n = len(pq.cand)
            # maps are tiny next to payloads: model them at 1/16 chunk size
            map_b = max(self._chunk_bytes // 16, 1)
            if pq.mode == "fetch":
                n_keys, n_bytes = 2 * n, n * (self._chunk_bytes + map_b)
            elif pq.mode == "index_only":
                n_keys, n_bytes = n, n * map_b
            else:  # metadata — answered from the version graph
                n_keys = n_bytes = 0
            rts = 1 if n_keys else 0
            out.append({
                "plan": render_plan(pq),
                "mode": pq.mode,
                "predicted_chunks": n,
                "predicted_payload_chunks": n if pq.mode == "fetch" else 0,
                "predicted_round_trips": rts,
                "predicted_bytes": n_bytes,
                "predicted_seconds": costmodel.fetch_seconds(rts, n_bytes),
            })
        return out
