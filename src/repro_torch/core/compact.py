"""Background compaction & retention GC — the maintenance path.

RStore's online algorithm (§4) only ever appends: each commit batch becomes
fresh chunks and old ones are never revisited (the paper defers
re-partitioning to future work).  Under a long-running workload the layout
therefore degrades into many small, low-span chunks, and storage for
versions nobody needs anymore is never reclaimed.  Byde & Twigg's versioned
external-memory dictionaries show the missing lever: *amortized background
rewriting* trades a bounded amount of write cost back into query cost.
This module is that lever, split into two layers:

**Retention** (:func:`keep_all` / :func:`keep_last` / :func:`keep_tagged`,
applied via ``RStore.retain(policy)``) prunes versions from the
:class:`~repro_torch.core.version_graph.VersionGraph`.  Retired versions keep
their tree structure (stable version indices for stored chunk-map bitmaps)
but lose their membership; records reachable from no retained version
become *garbage*.

**Compaction** (:class:`Compactor`, applied via ``RStore.compact()``)
(a) *measures* layout health from the in-memory index alone — per-chunk
liveness, a chunk-size histogram, and a fragmentation score that prices the
current layout against an ideally-packed one with the Table-1
:mod:`~repro_torch.core.costmodel` query-cost formulas; (b) *selects* candidate
chunk groups (small online-batch chunks plus chunks below a liveness
threshold) and rewrites their live records through the store's configured
partition algorithm (the same §4 restricted adaptation the online flush
uses), staging every new chunk and rebuilt chunk map into ONE group commit
— one ``multiput`` round trip per backend shard touched, exactly like a
:class:`~repro_torch.core.ingest.WriteSession` flush; and (c) *deletes* the
superseded chunk/map keys through the :class:`~repro_torch.core.kvs.Backend`
protocol's ``multidelete`` — one delete round trip per shard touched, with
:class:`~repro_torch.core.kvs.ShardedDeviceKVS` returning the freed extents to
its slot free list.  Under replicated shards
(:class:`~repro_torch.core.replica.ReplicatedKVS`) both the rewrite multiput and
the GC multidelete fan out across every live replica of each group; a
replica that is down records the missed deletes in its repair log, so
recovery never resurrects reclaimed chunks.

Snapshot coherence is epoch-based: a pass bumps the store's *layout epoch*.
Open :class:`~repro_torch.core.api.Snapshot`\\ s notice on their next ``execute``
and raise, but — because compaction preserves the logical content of every
retained version — they re-pin with ``snapshot.refresh()`` instead of being
hard-invalidated the way a full ``build()`` invalidates them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, Iterable, List, Optional, Tuple

import numpy as np

from . import costmodel
from .index import Projections
from .online import partition_batch

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .ingest import RStore
    from .version_graph import VersionGraph

# same constants as KVSStats.simulated_seconds — the §2.3 Cassandra-like
# model, now owned by costmodel so the chunk cache prices with them too
PER_QUERY_S = costmodel.PER_QUERY_S
BANDWIDTH_BPS = costmodel.BANDWIDTH_BPS


# ---------------------------------------------------------- retention policies
@dataclass(frozen=True)
class RetentionPolicy:
    """Which versions to keep.  Build via :func:`keep_all` /
    :func:`keep_last` / :func:`keep_tagged`."""

    kind: str                        # all | last | tagged
    k: int = 0
    vids: Tuple[int, ...] = ()

    def resolve(self, graph: "VersionGraph") -> List[int]:
        """The retained version ids under this policy (insertion order)."""
        current = graph.retained_versions()
        if self.kind == "all":
            return current
        if self.kind == "last":
            if self.k < 1:
                raise ValueError("keep_last needs k >= 1")
            return current[-self.k:]
        if self.kind == "tagged":
            keep = set(self.vids)
            if not keep:
                raise ValueError("keep_tagged needs at least one version")
            missing = keep - set(current)
            if missing:
                raise ValueError(
                    f"keep_tagged: unknown or already-retired version(s) "
                    f"{sorted(missing)}")
            return [v for v in current if v in keep]
        raise ValueError(f"unknown retention policy {self.kind!r}")


def keep_all() -> RetentionPolicy:
    """Retain everything (the no-op policy)."""
    return RetentionPolicy(kind="all")


def keep_last(k: int) -> RetentionPolicy:
    """Retain only the most recent ``k`` versions in commit order — the
    training-loop policy (cap checkpoint storage at a window)."""
    return RetentionPolicy(kind="last", k=int(k))


def keep_tagged(vids: Iterable[int]) -> RetentionPolicy:
    """Retain exactly the listed versions (pinned releases, milestones)."""
    return RetentionPolicy(kind="tagged", vids=tuple(int(v) for v in vids))


# -------------------------------------------------------------- layout health
@dataclass
class LayoutHealth:
    """What the maintenance path knows about the physical layout — computed
    entirely from the in-memory index (no KVS traffic)."""

    n_chunks: int
    stored_bytes: int                   # encoded chunk blob bytes in the KVS
    n_records_stored: int
    n_live_records: int
    n_dead_records: int                 # stored but reachable from no retained version
    live_payload_bytes: int
    dead_payload_bytes: int
    dead_frac: float                    # dead / stored payload bytes
    chunk_liveness: Dict[int, float]    # cid -> live fraction of its records
    chunk_bytes: Dict[int, int]         # cid -> stored blob size
    size_histogram: Tuple[np.ndarray, np.ndarray]  # (counts, edges/capacity)
    span_factor: float                  # Σ span(v) / Σ ideal_chunks(v)
    frag_score: float                   # cost-model $ of layout vs ideal (≥~1)
    est_read_seconds: float             # mean simulated Q1 seconds, current layout
    est_read_seconds_ideal: float       # same under a perfectly packed layout
    model: Dict[str, float] = field(default_factory=dict)  # calibrated Table-1


def measure_layout(rs: "RStore", per_query_s: float = PER_QUERY_S,
                   bandwidth_Bps: float = BANDWIDTH_BPS) -> LayoutHealth:
    """Measure layout health for ``rs``'s flushed state.

    The fragmentation score prices full-version retrieval with the Table-1
    cost formulas (per-request overhead + transfer, the §2.3 model): the
    current layout pays ``span(v)`` requests and fetches every byte of every
    touched chunk (dead records included), the ideal layout pays
    ``ceil(live_bytes(v)/C)`` requests for exactly the live bytes.  Their
    ratio is the score — 1.0 is the information-theoretic floor, and growth
    over time is precisely the §4 online-appending degradation.
    """
    graph = rs.graph
    cap = rs.config.capacity
    live_mask = graph.live_record_mask()
    sizes = graph.store.sizes

    chunk_liveness: Dict[int, float] = {}
    n_stored = n_live = 0
    live_pay = dead_pay = 0
    for cid, rids in rs._chunk_records.items():
        lm = live_mask[rids]
        chunk_liveness[cid] = float(lm.mean()) if len(rids) else 0.0
        n_stored += len(rids)
        n_live += int(lm.sum())
        live_pay += int(sizes[rids[lm]].sum())
        dead_pay += int(sizes[rids[~lm]].sum())

    chunk_bytes = dict(rs._chunk_bytes)
    stored = int(sum(chunk_bytes.values()))
    edges = np.array([0, 0.25, 0.5, 0.75, 1.0, 1.25, np.inf])
    counts, _ = np.histogram(
        np.asarray(list(chunk_bytes.values()), dtype=np.float64) / max(cap, 1),
        bins=edges)

    # cost-model pricing of Q1 over every retained version
    retained = [v for v in graph.retained_versions()
                if rs.proj is not None and v in rs.proj.version_chunks]
    span_sum = ideal_sum = 0
    act_s = ideal_s = 0.0
    member_counts: List[int] = []
    for v in retained:
        vchunks = rs.proj.version_chunks[v]
        m = graph.members(v)
        member_counts.append(len(m))
        vbytes = int(sizes[m].sum())
        span = len(vchunks)
        ideal = max(1, math.ceil(vbytes / max(cap, 1)))
        span_sum += span
        ideal_sum += ideal
        fetched = int(sum(chunk_bytes.get(int(c), 0) for c in vchunks))
        act_s += span * per_query_s + fetched / bandwidth_Bps
        ideal_s += ideal * per_query_s + vbytes / bandwidth_Bps
    nv = max(1, len(retained))
    span_factor = span_sum / max(1, ideal_sum)
    frag = act_s / ideal_s if ideal_s > 0 else 1.0

    # calibrated Table-1 estimate: back out the workload parameters from the
    # measured aggregates and price the layout with costmodel.rstore
    model: Dict[str, float] = {}
    if retained and member_counts:
        m_v = float(np.mean(member_counts))
        s = live_pay / max(1, n_live) if n_live else 1.0
        if len(retained) > 1 and m_v > 0 and s > 0:
            d = (live_pay / (m_v * s) - 1.0) / (len(retained) - 1)
        else:
            d = 0.0
        w = costmodel.Workload(n=len(retained), m_v=m_v,
                               d=float(np.clip(d, 0.0, 1.0)), c=1.0, s=s,
                               s_c=float(max(cap, 1)))
        model = costmodel.rstore(w, span_factor=span_factor)

    return LayoutHealth(
        n_chunks=len(rs._chunk_records), stored_bytes=stored,
        n_records_stored=n_stored, n_live_records=n_live,
        n_dead_records=n_stored - n_live, live_payload_bytes=live_pay,
        dead_payload_bytes=dead_pay,
        dead_frac=dead_pay / max(1, live_pay + dead_pay),
        chunk_liveness=chunk_liveness, chunk_bytes=chunk_bytes,
        size_histogram=(counts, edges), span_factor=span_factor,
        frag_score=frag, est_read_seconds=act_s / nv,
        est_read_seconds_ideal=ideal_s / nv, model=model)


# ------------------------------------------------------------------- reports
@dataclass
class CompactionReport:
    mode: str                       # "pass" | "noop" | "rebuild"
    candidates: int = 0
    chunks_written: int = 0
    chunks_deleted: int = 0
    records_rewritten: int = 0
    records_dropped: int = 0        # dead copies physically reclaimed
    bytes_written: int = 0
    bytes_deleted: int = 0
    stored_bytes_before: int = 0
    stored_bytes_after: int = 0
    write_round_trips: int = 0
    delete_round_trips: int = 0
    frag_before: float = 1.0
    frag_after: float = 1.0
    layout_epoch: int = 0

    @property
    def reclaimed_frac(self) -> float:
        if self.stored_bytes_before <= 0:
            return 0.0
        return 1.0 - self.stored_bytes_after / self.stored_bytes_before


# ----------------------------------------------------------------- compactor
class Compactor:
    """One background maintenance pass over an :class:`RStore`.

    ``liveness_threshold`` — chunks whose live-record fraction is below this
    are rewritten (1.0 would rewrite on a single dead record; the default
    0.75 lets mostly-live chunks amortize until enough of them has died).
    ``small_chunk_frac`` — chunks smaller than this fraction of the
    configured capacity are the §4 online-batch fragments; two or more of
    them get merged (a lone small chunk has no merge partner and is left
    alone).  ``min_dead_frac`` / ``frag_trigger`` drive :meth:`should_run`,
    the cost-model trigger a background loop polls.
    """

    def __init__(self, rs: "RStore", liveness_threshold: float = 0.75,
                 small_chunk_frac: float = 0.5, min_dead_frac: float = 0.10,
                 frag_trigger: float = 1.5) -> None:
        self.rs = rs
        self.liveness_threshold = float(liveness_threshold)
        self.small_chunk_frac = float(small_chunk_frac)
        self.min_dead_frac = float(min_dead_frac)
        self.frag_trigger = float(frag_trigger)

    # ------------------------------------------------------------- measure
    def health(self) -> LayoutHealth:
        return measure_layout(self.rs)

    def should_run(self, health: Optional[LayoutHealth] = None) -> bool:
        """Cost-model trigger: compact once enough stored bytes are dead or
        the fragmentation score says queries overpay by ``frag_trigger``×."""
        h = health or self.health()
        return (h.dead_frac >= self.min_dead_frac
                or h.frag_score >= self.frag_trigger)

    # -------------------------------------------------------------- select
    def select(self, health: LayoutHealth) -> np.ndarray:
        """Candidate chunk ids: below the liveness threshold, plus small
        online-batch fragments (only if they have a merge partner)."""
        low_live = {cid for cid, lv in health.chunk_liveness.items()
                    if lv < self.liveness_threshold}
        cut = self.small_chunk_frac * self.rs.config.capacity
        small = [cid for cid, b in health.chunk_bytes.items()
                 if b < cut and cid not in low_live]
        if len(small) < 2:
            small = []
        return np.asarray(sorted(low_live | set(small)), dtype=np.int64)

    # ---------------------------------------------------------------- pass
    def run_pass(self) -> CompactionReport:
        """Measure → select → rewrite (ONE multiput) → GC (ONE multidelete).

        Round-trip contract (the ci.sh gate): a pass costs exactly one write
        round trip per backend shard its new chunks touch plus one delete
        round trip per shard its superseded keys touch — however many chunks
        move.  A pass with nothing to do costs zero round trips.
        """
        rs = self.rs
        rs._check_no_open_writer("compact()")
        if rs._flusher is not None:
            # drain barrier (async ingest): staged versions — and any
            # replay held from a failed drain — land in the OLD layout
            # before the pass rewrites it, so a later replay can never
            # resurrect keys this pass deletes
            rs._flusher.drain()
        elif rs.pending:
            if rs.config.auto_flush:
                rs.flush()
            else:
                raise RuntimeError(
                    f"{len(rs.pending)} unflushed version(s); compaction "
                    "works on the flushed layout — call flush() first")
        if rs.proj is None or not rs._chunk_records:
            return CompactionReport(mode="noop", layout_epoch=rs._layout_epoch)
        if rs.config.k > 1:
            return self._rebuild_pass()

        before = self.health()
        cands = self.select(before)
        if not len(cands):
            return CompactionReport(
                mode="noop", stored_bytes_before=before.stored_bytes,
                stored_bytes_after=before.stored_bytes,
                frag_before=before.frag_score, frag_after=before.frag_score,
                layout_epoch=rs._layout_epoch)

        graph = rs.graph
        live_mask = graph.live_record_mask()
        cand_rids = np.concatenate([rs._chunk_records[int(c)] for c in cands])
        rewrite = cand_rids[live_mask[cand_rids]]
        dead = cand_rids[~live_mask[cand_rids]]

        # rewrite through the configured algorithm, restricted to the live
        # records of the candidates (the same §4 adaptation the online flush
        # uses; batch = the whole tree so every record finds its origin)
        placed = np.ones(len(graph.store), dtype=bool)
        placed[rewrite] = False
        part = partition_batch(graph, graph.versions, placed,
                               rs.config.algorithm, rs.config.capacity,
                               chunk_id_base=rs.n_chunks, records=rewrite,
                               **rs.config.algo_kwargs())
        mask = part.record_to_chunk >= 0
        rs.r2c[:len(mask)][mask] = part.record_to_chunk[mask]
        rs.r2c[dead] = -1
        rs.n_chunks += part.num_chunks

        # stage every new chunk + chunk map, commit in ONE multiput (the
        # WriteSession group-commit machinery), then GC the superseded keys
        # in ONE multidelete — new data lands before old data goes away
        csr = graph.record_version_index_csr()
        nv = graph.num_versions
        vidx_of = {v: i for i, v in enumerate(graph.versions)}
        writes = rs._stage_chunk_writes(part.chunks, vidx_of, nv, csr)
        bytes_written = sum(rs._chunk_bytes[c.chunk_id] for c in part.chunks)

        del_keys = [k for c in cands
                    for k in (f"chunk/{int(c)}", f"map/{int(c)}")]
        # secondary indexes: retire the candidates' postings, extend for the
        # rewritten chunks — dirty idx2/ buckets ride the same multiput, and
        # buckets emptied by the pass join the same multidelete (no orphans)
        if rs._indexes:
            new_chunks = [(c.chunk_id, c.record_ids) for c in part.chunks]
            for idx in rs._indexes.values():
                idx.remove_chunks(int(c) for c in cands)
                idx.add_chunks(new_chunks, graph.store.payload)
                iw, idel = idx.stage_writes()
                writes.extend(iw)
                del_keys.extend(idel)

        s0 = rs.kvs.stats.snapshot()
        rs.kvs.multiput(writes)
        rs.kvs.multidelete(del_keys)
        write_rts = rs.kvs.stats.n_put_queries - s0.n_put_queries
        delete_rts = rs.kvs.stats.n_delete_queries - s0.n_delete_queries

        bytes_deleted = 0
        for c in cands:
            bytes_deleted += rs._chunk_bytes.pop(int(c))
            del rs._chunk_records[int(c)]

        # new layout epoch: open snapshots re-pin via snapshot.refresh(),
        # and the chunk cache flushes the superseded keys at the same moment
        rs.proj = Projections.build_from_r2c(graph, rs.r2c, rs.n_chunks)
        rs._layout_epoch += 1
        rs._notify_layout_change(del_keys)
        after = self.health()
        return CompactionReport(
            mode="pass", candidates=len(cands),
            chunks_written=part.num_chunks, chunks_deleted=len(cands),
            records_rewritten=len(rewrite), records_dropped=len(dead),
            bytes_written=bytes_written, bytes_deleted=bytes_deleted,
            stored_bytes_before=before.stored_bytes,
            stored_bytes_after=after.stored_bytes,
            write_round_trips=write_rts, delete_round_trips=delete_rts,
            frag_before=before.frag_score, frag_after=after.frag_score,
            layout_epoch=rs._layout_epoch)

    def _rebuild_pass(self) -> CompactionReport:
        """k>1 (sub-chunk compression) fallback: the online algorithm cannot
        re-group sub-chunks, so — exactly like flush() — the pass is a full
        retention-aware build().  build() now GCs stale chunk keys itself;
        this still hard-invalidates snapshots (documented: rebuilds always
        have)."""
        rs = self.rs
        before = self.health()
        s0 = rs.kvs.stats.snapshot()
        rs.build()
        after = self.health()
        return CompactionReport(
            mode="rebuild", candidates=before.n_chunks,
            chunks_written=after.n_chunks, chunks_deleted=before.n_chunks,
            records_rewritten=after.n_records_stored,
            records_dropped=before.n_records_stored - after.n_records_stored,
            bytes_written=after.stored_bytes, bytes_deleted=before.stored_bytes,
            stored_bytes_before=before.stored_bytes,
            stored_bytes_after=after.stored_bytes,
            write_round_trips=rs.kvs.stats.n_put_queries - s0.n_put_queries,
            delete_round_trips=(rs.kvs.stats.n_delete_queries
                                - s0.n_delete_queries),
            frag_before=before.frag_score, frag_after=after.frag_score,
            layout_epoch=rs._layout_epoch)
