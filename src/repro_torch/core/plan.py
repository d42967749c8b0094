"""Unified query planner: logical plan IR → bitmap program → answer layer.

The read path used to be a flat ``kind``-string switch duplicated across
``Snapshot.plan`` / ``execute`` / ``_extract`` / ``prefetch``.  This module
is the refactor of that path into three explicit layers (the plan-time
query/storage trade-off the versioned-dictionary literature — Byde & Twigg —
argues is where such systems are won or lost):

1. **Logical plan IR.**  :class:`Query` (built via :class:`Q`) now forms
   *trees*: the leaf retrieval classes (§2.4) plus composable predicates
   ``Q.and_ / Q.or_ / Q.not_`` over ``where``/``where_range``/``range``/
   ``records``/``record`` and aggregates ``Q.count / Q.exists /
   Q.distinct``.  :func:`normalize` flattens nested same-op nodes, drops
   duplicate children, and cancels double negation; the planner refuses
   retired versions and unindexed attributes at plan time.

2. **Physical bitmap program.**  Per batch, every distinct leaf predicate
   contributes ONE bitmap row (duplicate leaves across the batch share it),
   and each query's predicate tree compiles to AND/OR instructions over
   those rows — constant-folded against the two lattice extremes (a leaf
   with no postings is ``EMPTY``; a ``not_`` node is ``UNIVERSE`` at chunk
   granularity, because a record-level complement says nothing about which
   *chunks* to skip).  The whole batch then executes as ONE fused
   ``bitmap_vm_batch`` launch (``kernels/bitmap.py``), roots AND'd with
   their version bitmaps.  Version/evolution posting lists stay host-side
   (no kernel needed), except evolution under retention, which joins the
   launch to AND away chunks no retained version keeps.

3. **Fetch/answer layer.**  Each planned query carries a *mode*:
   ``"metadata"`` (aggregates over primary-key predicates — answered from
   the version graph, zero KVS traffic), ``"index_only"`` (aggregates
   touching indexed attributes — fetch chunk *maps* only, never payload
   blobs: exactness comes from the per-record attribute values the
   :class:`~repro_torch.core.secondary.SecondaryIndex` keeps per chunk), or
   ``"fetch"`` (everything returning records — payloads + maps in the
   session's single interleaved multiget, post-filtered exactly per
   record).  :func:`answer` is the ONE per-kind switch left in the system.

``Snapshot`` (:mod:`repro_torch.core.api`) wires these layers to the KVS and is
re-exported unchanged; ``Snapshot.explain`` renders the chosen plans with
predicted chunk/round-trip costs from :mod:`repro_torch.core.costmodel`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np

from ..kernels import bitmap as kbitmap
from ..kernels import ops as kops
from .index import Projections, _bitmap_to_ids
from .types import unpack_ck

# Query-kind families.  Predicates return record sets and may nest under
# and/or/not; aggregates wrap a predicate (or stand alone, for distinct).
LEAF_KINDS = frozenset({"version", "record", "records", "range", "evolution",
                        "where", "where_range"})
COMPOSITE_KINDS = frozenset({"and", "or", "not"})
AGGREGATE_KINDS = frozenset({"count", "exists", "distinct"})
PREDICATE_KINDS = (LEAF_KINDS - {"evolution"}) | COMPOSITE_KINDS


# ------------------------------------------------------------------- algebra
@dataclass(frozen=True)
class Query:
    """One retrieval request — a node of the logical plan tree.  Build via
    the :class:`Q` factory."""

    kind: str          # version | record | records | range | evolution |
    #                    where | where_range | and | or | not |
    #                    count | exists | distinct
    vid: Optional[int] = None
    pk: Optional[int] = None
    pks: Optional[Tuple[int, ...]] = None
    key_lo: Optional[int] = None         # pk bound (range) / value bound (where_range)
    key_hi: Optional[int] = None
    attr: Optional[str] = None           # secondary-index attribute (where*, distinct)
    value: Optional[int] = None          # exact attribute value (where)
    children: Optional[Tuple["Query", ...]] = None   # and/or/not/count/exists


class Q:
    """Query constructors: the session API's algebra (§2.4 query classes,
    grown into a composable predicate/aggregate tree language)."""

    @staticmethod
    def version(vid: int) -> Query:
        """Q1: every record live in version ``vid`` → Dict[pk, bytes]."""
        return Query(kind="version", vid=int(vid))

    @staticmethod
    def record(vid: int, pk: int) -> Query:
        """Point lookup of ``pk`` in ``vid`` → Optional[bytes]."""
        return Query(kind="record", vid=int(vid), pk=int(pk))

    @staticmethod
    def records(vid: int, pks: Iterable[int]) -> Query:
        """Multi-point lookup in ``vid`` → Dict[pk, bytes] (absent keys
        omitted)."""
        return Query(kind="records", vid=int(vid),
                     pks=tuple(int(p) for p in pks))

    @staticmethod
    def range(vid: int, key_lo: int, key_hi: int) -> Query:
        """Q2: records of ``vid`` with pk in [key_lo, key_hi] → Dict."""
        return Query(kind="range", vid=int(vid), key_lo=int(key_lo),
                     key_hi=int(key_hi))

    @staticmethod
    def evolution(pk: int) -> Query:
        """Q3: every distinct record ever stored under ``pk`` →
        List[(origin_vid, bytes)] in origin order."""
        return Query(kind="evolution", pk=int(pk))

    @staticmethod
    def where(vid: int, attr: str, value: int) -> Query:
        """Filtered scan: records of ``vid`` whose extracted ``attr`` equals
        ``value`` → Dict[pk, bytes].  Needs a secondary index on ``attr``
        (``rs.create_index``); results are exact — lossy chunk-granularity
        postings are post-filtered per record."""
        return Query(kind="where", vid=int(vid), attr=str(attr),
                     value=int(value))

    @staticmethod
    def where_range(vid: int, attr: str, lo: int, hi: int) -> Query:
        """Filtered scan: records of ``vid`` with extracted ``attr`` in
        ``[lo, hi]`` → Dict[pk, bytes].  Same index + exactness contract as
        :meth:`where`."""
        return Query(kind="where_range", vid=int(vid), attr=str(attr),
                     key_lo=int(lo), key_hi=int(hi))

    # -------------------------------------------------- composite predicates
    @staticmethod
    def _check_predicate(q: Query, op: str) -> Query:
        if not isinstance(q, Query) or q.kind not in PREDICATE_KINDS:
            raise ValueError(
                f"Q.{op} composes predicate queries "
                f"(where/where_range/range/records/record/version or nested "
                f"and_/or_/not_); got "
                f"{q.kind if isinstance(q, Query) else type(q).__name__!r}")
        return q

    @staticmethod
    def _composite(op: str, queries: Tuple[Query, ...]) -> Query:
        if len(queries) < 2:
            raise ValueError(f"Q.{op}_ needs at least 2 sub-queries")
        vids = set()
        for q in queries:
            Q._check_predicate(q, f"{op}_")
            vids.add(q.vid)
        if len(vids) != 1:
            raise ValueError(
                f"Q.{op}_ sub-queries must share one version; got {sorted(vids)}")
        return Query(kind=op, vid=vids.pop(), children=tuple(queries))

    @staticmethod
    def and_(*queries: Query) -> Query:
        """Records of the shared version satisfying EVERY sub-predicate →
        Dict[pk, bytes]."""
        return Q._composite("and", queries)

    @staticmethod
    def or_(*queries: Query) -> Query:
        """Records of the shared version satisfying ANY sub-predicate →
        Dict[pk, bytes]."""
        return Q._composite("or", queries)

    @staticmethod
    def not_(query: Query) -> Query:
        """Records of the version NOT satisfying ``query`` → Dict[pk,
        bytes] (complement within the version's live records)."""
        Q._check_predicate(query, "not_")
        return Query(kind="not", vid=query.vid, children=(query,))

    # ------------------------------------------------------------ aggregates
    @staticmethod
    def count(query: Query) -> Query:
        """Number of records ``query`` would return → int.  Index-only or
        metadata-only: never fetches a chunk payload."""
        Q._check_predicate(query, "count")
        return Query(kind="count", vid=query.vid, children=(query,))

    @staticmethod
    def exists(query: Query) -> Query:
        """Does ``query`` match at least one record? → bool.  Same
        zero-payload execution as :meth:`count`."""
        Q._check_predicate(query, "exists")
        return Query(kind="exists", vid=query.vid, children=(query,))

    @staticmethod
    def distinct(vid: int, attr: str) -> Query:
        """Sorted distinct values of indexed ``attr`` over the records live
        in ``vid`` → List[int].  Answered from chunk maps + the index's
        per-record values: zero chunk-payload fetches."""
        return Query(kind="distinct", vid=int(vid), attr=str(attr))


# -------------------------------------------------------------------- results
@dataclass
class QueryStats:
    """Per-query (and, via :class:`BatchResult`, batch-level) fetch stats."""

    chunks_fetched: int = 0        # chunks touched (payloads and/or maps)
    irrelevant_chunks: int = 0     # lossy-projection artifacts (§2.4)
    bytes_fetched: int = 0
    kvs_queries: int = 0           # backend round trips
    records_returned: int = 0
    cache_hits: int = 0            # batch-level: keys a CachingKVS served
    bytes_from_cache: int = 0      # batch-level: payload served at memory speed
    payload_chunks_fetched: int = 0  # chunks whose payload blob was fetched
    payload_round_trips: int = 0   # round trips that carried payload keys
    #                                (0 for index-only/metadata plans)


@dataclass
class QueryResult:
    query: Query
    value: Any                     # Dict / Optional[bytes] / List / int / bool
    stats: QueryStats


class BatchResult(List[QueryResult]):
    """``Snapshot.execute``'s return: a List[QueryResult] carrying the
    batch-level stats.  ``batch.bytes_fetched`` counts every fetched chunk
    once, no matter how many queries shared it; per-query stats attribute a
    chunk to every query that planned it."""

    batch: QueryStats

    def __init__(self, results: Iterable[QueryResult], batch: QueryStats):
        super().__init__(results)
        self.batch = batch


# -------------------------------------------------------------- normalization
def normalize(q: Query) -> Query:
    """Structural simplification, semantics-preserving:

    - flatten nested same-op ``and``/``or`` nodes,
    - drop duplicate children (Query is frozen/hashable),
    - cancel double negation,
    - collapse single-child composites.
    """
    if q.kind in ("and", "or"):
        flat: List[Query] = []
        seen = set()
        for c in q.children:
            c = normalize(c)
            parts = c.children if c.kind == q.kind else (c,)
            for p in parts:
                if p not in seen:
                    seen.add(p)
                    flat.append(p)
        if len(flat) == 1:
            return flat[0]
        return Query(kind=q.kind, vid=q.vid, children=tuple(flat))
    if q.kind == "not":
        c = normalize(q.children[0])
        if c.kind == "not":
            return c.children[0]
        return Query(kind="not", vid=q.vid, children=(c,))
    if q.kind in ("count", "exists"):
        return Query(kind=q.kind, vid=q.vid,
                     children=(normalize(q.children[0]),))
    return q


def _walk(q: Query):
    yield q
    for c in q.children or ():
        yield from _walk(c)


# ------------------------------------------------------------- physical plans
@dataclass
class PlannedQuery:
    """One query's physical plan: its mode, candidate chunks, and whether
    those candidates need payload blobs or chunk maps only."""

    query: Query                   # normalized tree
    mode: str                      # "metadata" | "index_only" | "fetch"
    cand: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))

    @property
    def needs_payload(self) -> bool:
        return self.mode == "fetch"

    @property
    def needs_maps(self) -> bool:
        return self.mode in ("fetch", "index_only") and len(self.cand) > 0


# constant-folded compilation results (chunk-candidate lattice extremes)
_EMPTY = "EMPTY"        # provably no candidate chunks
_UNIVERSE = "UNIVERSE"  # no chunk-level restriction (≡ the version bitmap)


class Planner:
    """Compiles a batch of logical plans into physical plans with ONE fused
    bitmap-program launch for every query that needs index-ANDing."""

    def __init__(self, graph, proj: Projections,
                 indexes: Dict[str, Any], vidx: Dict[int, int],
                 device=None) -> None:
        self.graph = graph
        self.device = device            # where the bitmap program runs
        self.proj = proj
        self.indexes = indexes
        self.vidx = vidx
        # batch-wide leaf-row dedupe: identical predicates across queries
        # share one register row (the "duplicate-posting reuse" rule)
        self._rows: List[np.ndarray] = []
        self._row_of: Dict[Any, int] = {}
        self._prog: List[Tuple[int, int, int, int]] = []
        self._W = max((proj.n_chunks + 31) // 32, 1)

    # ------------------------------------------------------------ validation
    def _validate(self, q: Query) -> None:
        for node in _walk(q):
            if node.vid is not None and self.graph.is_retired(node.vid):
                raise KeyError(
                    f"version {node.vid} was retired by a retention policy; "
                    "its content is no longer queryable")
            if node.kind in ("where", "where_range", "distinct"):
                if self.indexes.get(node.attr) is None:
                    raise KeyError(
                        f"no secondary index on attribute {node.attr!r}; "
                        "register one with rs.create_index(attr, extractor)")
            if node.kind not in LEAF_KINDS | COMPOSITE_KINDS | AGGREGATE_KINDS:
                raise ValueError(f"unknown query kind {node.kind!r}")

    # ------------------------------------------------------------- leaf rows
    def _reg_of_row(self, key: Any, build: Callable[[], np.ndarray]) -> int:
        r = self._row_of.get(key)
        if r is None:
            r = len(self._rows)
            self._rows.append(build())
            self._row_of[key] = r
        return r

    def _version_reg(self, vid: int) -> int:
        return self._reg_of_row(
            ("ver", vid),
            lambda: self.proj._bitmap_of(self.proj.chunks_for_version(vid)))

    def _live_reg(self) -> int:
        """Union of every retained version's chunk list: chunks outside it
        hold only retired record copies (evolution's dead-chunk pruning)."""
        def build() -> np.ndarray:
            row = np.zeros(self._W, dtype=np.uint32)
            for ids in self.proj.version_chunks.values():
                if len(ids):
                    np.bitwise_or.at(row, ids // 32,
                                     np.uint32(1) << (ids % 32).astype(np.uint32))
            return row
        return self._reg_of_row(("live",), build)

    def _leaf_postings(self, q: Query) -> List[Optional[np.ndarray]]:
        if q.kind == "where":
            return [self.indexes[q.attr].postings_for(q.value)]
        if q.kind == "where_range":
            return self.indexes[q.attr].postings_in_range(q.key_lo, q.key_hi)
        if q.kind == "record":
            pks: Iterable[int] = [q.pk]
        elif q.kind == "records":
            pks = q.pks
        else:  # range
            pks = self.proj.keys_in_range(q.key_lo, q.key_hi)
        return [self.proj.key_chunks.get(int(p)) for p in pks]

    def _leaf_reg(self, q: Query) -> Union[str, int]:
        """Register of a leaf predicate's OR'd posting row, or ``_EMPTY``."""
        key = (q.kind, q.pk, q.pks, q.key_lo, q.key_hi, q.attr, q.value)
        if key in self._row_of:
            return self._row_of[key]
        postings = self._leaf_postings(q)
        if not any(p is not None and len(p) for p in postings):
            return _EMPTY
        row = np.zeros(self._W, dtype=np.uint32)
        for ids in postings:
            if ids is not None and len(ids):
                np.bitwise_or.at(row, ids // 32,
                                 np.uint32(1) << (ids % 32).astype(np.uint32))
        return self._reg_of_row(key, lambda: row)

    # ------------------------------------------------------- tree compilation
    def _emit(self, op: int, lhs: int, rhs: int) -> int:
        dst = -len(self._prog) - 1          # placeholder: patched after rows
        self._prog.append((op, dst, lhs, rhs))
        return dst

    def _compile(self, q: Query) -> Union[str, int]:
        """Compile a predicate tree to a register holding its candidate
        bitmap (chunk-granularity superset), or a lattice extreme.

        ``not_`` compiles to ``_UNIVERSE``: chunk-level complement of a
        record-level predicate is unsound (the chunk can hold non-matching
        live records), so its candidates are the whole version — exactness
        is restored by the per-record filter in the answer layer."""
        if q.kind == "version":
            return _UNIVERSE
        if q.kind == "not":
            return _UNIVERSE
        if q.kind in ("and", "or"):
            regs: List[int] = []
            for c in q.children:
                r = self._compile(c)
                if q.kind == "and":
                    if r is _EMPTY:
                        return _EMPTY
                    if r is _UNIVERSE:
                        continue            # no restriction to intersect
                else:
                    if r is _UNIVERSE:
                        return _UNIVERSE
                    if r is _EMPTY:
                        continue            # contributes nothing to the union
                regs.append(r)
            if not regs:
                return _UNIVERSE if q.kind == "and" else _EMPTY
            acc = regs[0]
            op = kbitmap.OP_AND if q.kind == "and" else kbitmap.OP_OR
            for r in regs[1:]:
                acc = self._emit(op, acc, r)
            return acc
        return self._leaf_reg(q)

    # ------------------------------------------------------------ batch plan
    def plan_batch(self, queries: Sequence[Query]) -> List[PlannedQuery]:
        """One-shot: compile the whole batch, run (at most) ONE fused
        bitmap-program launch, return the physical plans."""
        planned: List[PlannedQuery] = []
        # (position in `planned`, root register) per launch-dependent query
        pending_roots: List[Tuple[int, int]] = []
        for pos, q in enumerate(queries):
            q = normalize(q)
            self._validate(q)
            if q.kind in AGGREGATE_KINDS:
                pq = self._plan_aggregate(q, pending_roots, pos)
            elif q.kind == "evolution":
                pq = self._plan_evolution(q, pending_roots, pos)
            elif q.kind == "version":
                pq = PlannedQuery(q, "fetch",
                                  np.asarray(self.proj.chunks_for_version(q.vid)))
            else:
                pq = PlannedQuery(q, "fetch")
                self._root(q, pq, pending_roots, pos)
            planned.append(pq)
        self._run_program(planned, pending_roots)
        return planned

    def _root(self, tree: Query, pq: PlannedQuery,
              pending: List[Tuple[int, int]], pos: int) -> None:
        """Resolve a predicate tree's candidates: fold with the version
        bitmap, either statically or as the tree's final AND instruction."""
        r = self._compile(tree)
        if r is _EMPTY:
            pq.cand = np.empty(0, np.int64)
        elif r is _UNIVERSE:
            pq.cand = np.asarray(self.proj.chunks_for_version(tree.vid))
        else:
            root = self._emit(kbitmap.OP_AND, r, self._version_reg(tree.vid))
            pending.append((pos, root))

    def _plan_evolution(self, q: Query, pending: List[Tuple[int, int]],
                        pos: int) -> PlannedQuery:
        cand = self.proj.chunks_for_key(q.pk)
        if len(cand) and self.graph.has_retired():
            # retention: AND away chunks in no retained version's list —
            # they hold only dead copies and would be fetched for nothing
            pq = PlannedQuery(q, "fetch")
            key_reg = self._reg_of_row(("key", q.pk),
                                       lambda: self.proj._bitmap_of(cand))
            root = self._emit(kbitmap.OP_AND, key_reg, self._live_reg())
            pending.append((pos, root))
            return pq
        return PlannedQuery(q, "fetch", np.asarray(cand))

    def _plan_aggregate(self, q: Query, pending: List[Tuple[int, int]],
                        pos: int) -> PlannedQuery:
        if q.kind == "distinct":
            return PlannedQuery(q, "index_only",
                                np.asarray(self.proj.chunks_for_version(q.vid)))
        base = q.children[0]
        needs_index = any(n.kind in ("where", "where_range")
                          for n in _walk(base))
        if not needs_index:
            # pure primary-key predicate: version membership + record keys
            # answer it from the graph — zero KVS traffic of any kind
            return PlannedQuery(q, "metadata")
        pq = PlannedQuery(q, "index_only")
        self._root(base, pq, pending, pos)
        return pq

    def _run_program(self, planned: List[PlannedQuery],
                     pending: List[Tuple[int, int]]) -> None:
        if not self._prog:
            return
        L = len(self._rows)
        regs = np.zeros((L + len(self._prog), self._W), dtype=np.uint32)
        for i, row in enumerate(self._rows):
            regs[i] = row
        # patch placeholder dsts (emitted as -k-1 before L was known)
        prog = np.asarray(
            [(op, L - dst - 1, self._fix(lhs, L), self._fix(rhs, L))
             for op, dst, lhs, rhs in self._prog], dtype=np.int32)
        out, _ = kops.bitmap_vm_batch(regs, prog, device=self.device)
        for pos, root in pending:
            planned[pos].cand = _bitmap_to_ids(out[self._fix(root, L)],
                                               self.proj.n_chunks)

    @staticmethod
    def _fix(reg: int, n_leaf_rows: int) -> int:
        """Map a register handle to its row: leaf registers are direct
        indices; instruction outputs were emitted as ``-k-1`` placeholders
        and live after the leaf rows."""
        return reg if reg >= 0 else n_leaf_rows - reg - 1


# --------------------------------------------------------------- answer layer
@dataclass
class ExecContext:
    """Everything the answer layer needs from the fetch layer: the decoded
    chunk state plus shared per-chunk caches (payload decode and (chunk,
    version) membership each happen once per batch, however many queries
    share them)."""

    graph: Any
    vidx: Dict[int, int]
    indexes: Dict[str, Any]
    fetched: Dict[int, Tuple[Any, Any, int]]   # cid -> (chunk|None, cmap, nbytes)
    payloads: Callable[[int], Dict[int, bytes]]
    members: Callable[[int, int], np.ndarray]
    retained_bits: Optional[np.ndarray] = None


def _keys_mask(node: Query, keys: np.ndarray) -> np.ndarray:
    """Evaluate a primary-key-only predicate tree over an array of record
    keys (the metadata path — where-leaves never reach here)."""
    if node.kind == "version":
        return np.ones(len(keys), dtype=bool)
    if node.kind == "record":
        return keys == node.pk
    if node.kind == "records":
        return np.isin(keys, np.asarray(node.pks, dtype=np.int64))
    if node.kind == "range":
        return (keys >= node.key_lo) & (keys <= node.key_hi)
    if node.kind == "not":
        return ~_keys_mask(node.children[0], keys)
    masks = [_keys_mask(c, keys) for c in node.children]
    return (np.logical_and.reduce(masks) if node.kind == "and"
            else np.logical_or.reduce(masks))


def _predicate_mask(node: Query, cid: int, cmap, locs: np.ndarray,
                    ctx: ExecContext) -> np.ndarray:
    """Exact per-record predicate over the chunk-local rows ``locs`` (the
    records of ``cid`` live in the query's version).  ``where`` leaves read
    the secondary index's per-record value arrays — extracted from the same
    payloads at index-maintenance time, so this matches re-extraction
    bit-for-bit without touching the payload blob."""
    if node.kind in ("where", "where_range"):
        vals, present = ctx.indexes[node.attr].record_values(cid)
        v, p = vals[locs], present[locs]
        if node.kind == "where":
            return p & (v == node.value)
        return p & (v >= node.key_lo) & (v <= node.key_hi)
    if node.kind == "not":
        return ~_predicate_mask(node.children[0], cid, cmap, locs, ctx)
    if node.kind in ("and", "or"):
        masks = [_predicate_mask(c, cid, cmap, locs, ctx)
                 for c in node.children]
        return (np.logical_and.reduce(masks) if node.kind == "and"
                else np.logical_or.reduce(masks))
    return _keys_mask(node, cmap.cks[locs] >> 32)


def _pks(cmap, locs: np.ndarray) -> List[int]:
    """Primary keys of the chunk-local rows ``locs``."""
    return (cmap.cks[locs] >> 32).tolist()


def answer(pq: PlannedQuery, ctx: ExecContext, stats: QueryStats):
    """THE per-kind switch: materialize one planned query's value from the
    shared fetch state.  Every read path — ``Snapshot.execute`` and
    the serve engine — lands here."""
    q = pq.query

    # ---------------------------------------------------------- aggregates
    if q.kind in ("count", "exists"):
        if pq.mode == "metadata":
            rids = ctx.graph.members(q.vid)
            keys = ctx.graph.store.keys()[rids]
            n = int(_keys_mask(q.children[0], keys).sum())
        else:
            vidx = ctx.vidx[q.vid]
            n = 0
            for c in pq.cand:
                cid = int(c)
                cmap = ctx.fetched[cid][1]
                locs = ctx.members(cid, vidx)
                hits = (int(_predicate_mask(q.children[0], cid, cmap, locs,
                                            ctx).sum())
                        if len(locs) else 0)
                if hits == 0:
                    stats.irrelevant_chunks += 1
                n += hits
        stats.records_returned = n
        return n if q.kind == "count" else bool(n)

    if q.kind == "distinct":
        idx = ctx.indexes[q.attr]
        vidx = ctx.vidx[q.vid]
        out_vals: set = set()
        for c in pq.cand:
            cid = int(c)
            locs = ctx.members(cid, vidx)
            if len(locs) == 0:
                stats.irrelevant_chunks += 1
                continue
            vals, present = idx.record_values(cid)
            sel = vals[locs][present[locs]]
            if len(sel) == 0:
                stats.irrelevant_chunks += 1
                continue
            out_vals.update(int(v) for v in np.unique(sel))
        stats.records_returned = len(out_vals)
        return sorted(out_vals)

    # ------------------------------------------------------------ retrieval
    if q.kind == "version":
        out: Dict[int, bytes] = {}
        vidx = ctx.vidx[q.vid]
        for c in pq.cand:
            cid = int(c)
            cmap = ctx.fetched[cid][1]
            locs = ctx.members(cid, vidx)
            if len(locs) == 0:
                stats.irrelevant_chunks += 1
                continue
            pay = ctx.payloads(cid)
            out.update(zip(_pks(cmap, locs), map(pay.__getitem__,
                                                 locs.tolist())))
        stats.records_returned = len(out)
        return out

    if q.kind in ("record", "records", "range"):
        vidx = ctx.vidx[q.vid]
        out = {}
        for c in pq.cand:
            cid = int(c)
            cmap = ctx.fetched[cid][1]
            locs = ctx.members(cid, vidx)
            keys = cmap.cks[locs] >> 32
            if q.kind == "record":
                sel = locs[keys == q.pk]
            elif q.kind == "records":
                sel = locs[np.isin(keys, np.asarray(q.pks, dtype=np.int64))]
            else:
                sel = locs[(keys >= q.key_lo) & (keys <= q.key_hi)]
            if len(sel) == 0:
                stats.irrelevant_chunks += 1
                continue
            pay = ctx.payloads(cid)
            out.update(zip(_pks(cmap, sel), map(pay.__getitem__,
                                                sel.tolist())))
        stats.records_returned = len(out)
        if q.kind == "record":
            return out.get(q.pk)
        return out

    if q.kind in ("where", "where_range", "and", "or", "not"):
        # exact post-filter: the lossy candidates only say a chunk *may*
        # hold a match — the predicate tree is re-evaluated per record
        # (attribute leaves via the index's record values, key leaves via
        # the chunk map) so lossiness never leaks
        vidx = ctx.vidx[q.vid]
        out = {}
        for c in pq.cand:
            cid = int(c)
            cmap = ctx.fetched[cid][1]
            locs = ctx.members(cid, vidx)
            sel = (locs[_predicate_mask(q, cid, cmap, locs, ctx)]
                   if len(locs) else locs)
            if len(sel) == 0:
                stats.irrelevant_chunks += 1
                continue
            pay = ctx.payloads(cid)
            out.update(zip(_pks(cmap, sel), map(pay.__getitem__,
                                                sel.tolist())))
        stats.records_returned = len(out)
        return out

    if q.kind == "evolution":
        evo: List[Tuple[int, bytes]] = []
        for c in pq.cand:
            cid = int(c)
            cmap = ctx.fetched[cid][1]
            sel = np.flatnonzero((cmap.cks >> 32) == q.pk)
            if ctx.retained_bits is not None and len(sel):
                w = min(cmap.bitmap.shape[1], len(ctx.retained_bits))
                alive = (cmap.bitmap[sel, :w]
                         & ctx.retained_bits[:w]).any(axis=1)
                sel = sel[alive]
            if len(sel) == 0:
                stats.irrelevant_chunks += 1
                continue
            pay = ctx.payloads(cid)
            for li in sel:
                _, origin = unpack_ck(int(cmap.cks[li]))
                evo.append((origin, pay[int(li)]))
        evo.sort(key=lambda t: ctx.vidx.get(t[0], 1 << 30))
        stats.records_returned = len(evo)
        return evo

    raise ValueError(f"unknown query kind {q.kind!r}")


# ------------------------------------------------------------------ rendering
def _label(q: Query) -> str:
    if q.kind == "version":
        return f"version v={q.vid}"
    if q.kind == "record":
        return f"record pk={q.pk} @v{q.vid}"
    if q.kind == "records":
        return f"records pks={list(q.pks)} @v{q.vid}"
    if q.kind == "range":
        return f"range pk∈[{q.key_lo}, {q.key_hi}] @v{q.vid}"
    if q.kind == "evolution":
        return f"evolution pk={q.pk}"
    if q.kind == "where":
        return f"where {q.attr} == {q.value} @v{q.vid}"
    if q.kind == "where_range":
        return f"where {q.attr} ∈ [{q.key_lo}, {q.key_hi}] @v{q.vid}"
    if q.kind == "distinct":
        return f"distinct({q.attr}) @v{q.vid}"
    return q.kind  # and | or | not | count | exists


def _render(q: Query) -> List[str]:
    lines = [_label(q)]
    kids = q.children or ()
    for i, c in enumerate(kids):
        sub = _render(c)
        last = i == len(kids) - 1
        lines.append(("└─ " if last else "├─ ") + sub[0])
        lines.extend(("   " if last else "│  ") + s for s in sub[1:])
    return lines


def render_plan(pq: PlannedQuery) -> str:
    """Human-readable plan tree for ``Snapshot.explain``."""
    head = f"[{pq.mode}] candidates={len(pq.cand)}"
    return "\n".join([head] + _render(pq.query))
