"""RStore facade: ingest (commit), build, flush, and query/write sessions
(§2.4).

The user-facing API mirrors the paper's application server, with *both*
directions redesigned around a plan/execute split: retrieval through
:mod:`repro_torch.core.api`'s batched read sessions, and ingest through
group-committing write sessions:

    rs = RStore(RStoreConfig(algorithm="bottom_up", capacity=1<<20, k=3))

    # Write session — the native ingest path: stage a wave of commits,
    # flush once.  All new chunks and rebuilt chunk maps of the whole
    # session are committed via ONE multiput (one backend round trip per
    # shard under ShardedKVS).
    with rs.writer() as w:
        v0 = w.init_root({pk: payload, ...})
        v1 = w.commit([v0], adds={pk: new_payload}, dels=[pk2])
    # <- one group flush happened here

    # Back-compat wrappers — one-commit sessions that keep the seed's
    # delta-store batching (flush every `batch_size` versions):
    v2 = rs.commit([v1], adds={...})

    # Session reads (see api.py): plan a wave, fetch in one round trip/shard
    snap = rs.snapshot()
    res = snap.execute([Q.version(v1), Q.record(v1, pk), ...])

Commits only carry the delta ("the system requests only those records from
the client that have changed").  Deltas accumulate in the delta store and are
chunked in batches (§4); commit staging is columnar (one ``add_batch`` per
commit) and parent-key resolution uses cached sorted key arrays +
``searchsorted`` instead of rebuilding an O(|version|) Python dict per delta.
``flush()`` is explicit; with the default ``RStoreConfig.auto_flush=True``
the facade keeps the seed behaviour of flushing before a read, while
``auto_flush=False`` makes reads strictly side-effect free (``snapshot()``
then refuses to observe unflushed deltas).  ``build()`` runs the full offline
pipeline (sub-chunking when k>1 → partitioning → chunk/map writes →
projections).

With replicated shards (:class:`repro_torch.core.replica.ReplicatedKVS`)
the group flush survives a replica death mid-workload unchanged: the one
``multiput`` per shard lands on every live replica with a write-ack quorum,
and replicas that missed it are backfilled by read-repair or a
:class:`repro_torch.core.replica.RecoveryManager` rebuild.

Every device step of both paths — the bitmap program of a read wave and the
XOR deltas of a ``k>1`` build — runs on the store's ``device`` (the card
unless the caller asks for the CPU).
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..device import DeviceLike, resolve_device
from .chunkstore import build_chunk, build_chunk_map
from .compact import CompactionReport, Compactor, RetentionPolicy
from .index import Projections
from .kvs import Backend, InMemoryKVS
from .online import affected_old_chunks, partition_batch
from .partition import ALGORITHMS
from .secondary import AttributeExtractor, SecondaryIndex
from .api import BatchResult, Q, Snapshot
from .subchunk import (build_subchunks, build_transformed,
                       compressed_subchunk_sizes)
from .types import _MAX_PART, Chunk, Partitioning, pack_ck_array
from .version_graph import VersionGraph


@dataclass
class RStoreConfig:
    algorithm: str = "bottom_up"
    capacity: int = 1 << 16          # chunk size C in bytes
    k: int = 1                       # max records per sub-chunk (§3.4)
    batch_size: int = 64             # online batch (§4)
    beta: int = 64                   # BOTTOM-UP subtree bound (§3.2.1)
    shingle_hashes: int = 8
    store_payloads: bool = True
    auto_flush: bool = True          # seed behaviour: reads flush pending work

    def algo_kwargs(self) -> dict:
        if self.algorithm == "bottom_up":
            return {"beta": self.beta}
        if self.algorithm == "shingle":
            return {"n_hashes": self.shingle_hashes}
        return {}


class WriteSession:
    """Staged ingest — the write-side mirror of :class:`~repro_torch.core.api.Snapshot`.

    Obtained via :meth:`RStore.writer`.  ``init_root``/``commit`` stage
    versions in the delta store without flushing; ``close()`` (or context-
    manager exit) performs ONE group flush: the session's versions are
    chunked as a single batch and every new chunk + rebuilt chunk map is
    committed via a single ``multiput`` — one backend write round trip per
    shard under :class:`~repro_torch.core.kvs.ShardedKVS`.

    Misuse is loud: only one session may be open per store (the facade
    wrappers count), and committing after ``close()`` raises.  If the
    ``with`` body raises, the flush is skipped — staged versions stay in
    the delta store and the next flush picks them up.

    With a :class:`~repro_torch.core.flusher.BackgroundFlusher` attached
    (async ingest) the rules change: any number of sessions may be open
    concurrently, every ``commit()`` stages at zero round trips into the
    flusher's active buffer, and durability is the flusher's job
    (watermarks / ``rs.barrier()``) — ``close()`` does not flush, and an
    exception in the ``with`` body just closes the session (staged
    commits may already be durable; there is no per-session abort).
    """

    def __init__(self, rs: "RStore", flush_on_close: bool = True,
                 async_mode: bool = False) -> None:
        self._rs = rs
        self._flush_on_close = flush_on_close
        self._async = async_mode
        self._closed = False
        self.staged: List[int] = []        # vids committed through this session

    # ------------------------------------------------------------- staging
    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("WriteSession is closed; open a new writer()")

    def init_root(self, records: Dict[int, bytes]) -> int:
        self._check_open()
        vid = self._rs._stage_root(records)
        self.staged.append(vid)
        return vid

    def commit(self, parents: Sequence[int], adds: Dict[int, bytes],
               dels: Iterable[int] = ()) -> int:
        """Stage a new version as a delta from ``parents[0]`` (extra parents
        form a merge; their exclusive keys are pulled in per Fig. 4)."""
        self._check_open()
        vid = self._rs._stage_commit(parents, adds, dels)
        self.staged.append(vid)
        return vid

    # --------------------------------------------------------------- flush
    def flush(self) -> None:
        """Explicit early group flush of everything the store has staged.

        On a closed session, or with nothing staged, this is a cheap
        no-op — zero round trips, no stats noise.  In async mode it is a
        durability barrier (``rs.barrier()``); in sync mode it flushes the
        delta store mid-session (the staged-so-far versions become one
        group commit, the rest of the session a second one)."""
        if self._closed:
            return
        rs = self._rs
        if self._async:
            if rs._flusher is not None:
                rs._flusher.drain()
            return
        if not rs.pending:
            return
        # bypass the open-writer guard for this deliberate mid-session
        # flush; the guard exists to catch *implicit* splits of the
        # session's group commit, not an explicit request
        saved, rs._writer = rs._writer, None
        try:
            rs.flush()
        finally:
            rs._writer = saved

    def close(self) -> None:
        """Group-flush the session (idempotent).  Async sessions just
        deregister — drains belong to the flusher's watermarks."""
        if self._closed:
            return
        self._closed = True
        if self._async:
            self._rs._async_writers.discard(self)
            if self._rs._flusher is not None:
                self._rs._flusher.tick()   # close is a clock event
            return
        self._rs._writer = None
        if self._flush_on_close:
            self._rs.flush()
        else:
            self._rs._maybe_flush()

    def __enter__(self) -> "WriteSession":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None and not self._async:
            # abort: skip the flush, leave staged versions pending
            self._closed = True
            self._rs._writer = None
            return
        self.close()


class RStore:
    """The store facade.  ``device`` is where its device steps run: the
    card when ``None``; pass ``"cpu"`` to run the plain versions."""

    def __init__(self, config: Optional[RStoreConfig] = None,
                 kvs: Optional[Backend] = None,
                 device: DeviceLike = None) -> None:
        self.config = config or RStoreConfig()
        self.device = resolve_device(device)
        self.kvs: Backend = kvs if kvs is not None else InMemoryKVS()
        self.graph = VersionGraph()
        self._next_vid = 0
        self.pending: List[int] = []          # delta store (§4): unchunked vids
        self.r2c = np.empty(0, dtype=np.int64)  # record -> chunk (global)
        self.n_chunks = 0
        self.proj: Optional[Projections] = None
        self._subchunk_groups: Optional[List[np.ndarray]] = None
        self._flushed_versions = 0
        # bumped on every full build(): existing snapshots' chunk ids then
        # point at repartitioned storage, so they must fail loudly
        self._build_epoch = 0
        # bumped by every compaction pass: content is preserved, so open
        # snapshots re-pin via snapshot.refresh() instead of dying
        self._layout_epoch = 0
        # chunk id -> record ids in *stored order* (chunk maps must preserve
        # the chunk's local record indexing when rebuilt)
        self._chunk_records: Dict[int, np.ndarray] = {}
        # chunk id -> stored blob size, tracked at write time so
        # storage_stats() never has to fetch blobs just to size them
        self._chunk_bytes: Dict[int, int] = {}
        # version id -> (sorted primary keys, record ids in that order);
        # memberships are immutable once committed, so entries never go
        # stale (memory is bounded by total membership size, same order as
        # the graph's own materialized memberships)
        self._pk_arrays: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        # attr -> SecondaryIndex (see core/secondary.py); every mutation
        # path below keeps postings coherent inside its own round trips
        self._indexes: Dict[str, SecondaryIndex] = {}
        self._writer: Optional[WriteSession] = None
        # async ingest (core/flusher.py): when attached, any number of
        # sessions may stage concurrently and the flusher owns durability
        self._flusher = None
        self._async_writers: set = set()

    # ------------------------------------------------------------- sessions
    def writer(self, flush_on_close: bool = True) -> WriteSession:
        """Open a :class:`WriteSession`.  With the default
        ``flush_on_close=True`` the session group-flushes everything it
        staged on close; ``flush_on_close=False`` keeps the delta-store
        batching (flush only once ``batch_size`` versions accumulated) —
        the facade wrappers use that to preserve the seed behaviour.

        With a :class:`~repro_torch.core.flusher.BackgroundFlusher`
        attached, sessions are concurrent: commits stage at zero round trips
        and drain together on the flusher's watermarks (``flush_on_close``
        is moot — close never flushes in async mode)."""
        if self._flusher is not None:
            ws = WriteSession(self, flush_on_close=False, async_mode=True)
            self._async_writers.add(ws)
            return ws
        if self._writer is not None and not self._writer._closed:
            raise RuntimeError(
                "another WriteSession is already open on this store; close "
                "it first (one writer per store — commits are serialized)")
        ws = WriteSession(self, flush_on_close=flush_on_close)
        self._writer = ws
        return ws

    # --------------------------------------------------------- async ingest
    @property
    def flusher(self):
        """The attached :class:`~repro_torch.core.flusher.BackgroundFlusher`,
        or ``None`` (synchronous ingest)."""
        return self._flusher

    def attach_flusher(self, **flusher_kw):
        """Switch to async ingest: attach a
        :class:`~repro_torch.core.flusher.BackgroundFlusher` (kwargs:
        ``max_staged_versions`` / ``max_staged_bytes`` /
        ``max_staged_age`` / ``retry``).  Versions already pending in the
        delta store are adopted into the active buffer.  Raises if a
        flusher is already attached or a sync WriteSession is open.
        Detach with ``flusher.close()`` (drains first)."""
        from .flusher import BackgroundFlusher
        if self._flusher is not None:
            raise RuntimeError("a BackgroundFlusher is already attached")
        if self._writer is not None and not self._writer._closed:
            raise RuntimeError(
                "close the open WriteSession before attaching a "
                "BackgroundFlusher (its group commit must not be split)")
        self._flusher = BackgroundFlusher(self, **flusher_kw)
        return self._flusher

    def barrier(self):
        """Durability barrier: everything committed before the call is
        durable when it returns.  With a flusher attached this drains
        both buffers (returns the
        :class:`~repro_torch.core.flusher.DrainReport`); without one it
        flushes the delta store.  With nothing staged it is a cheap no-op —
        zero round trips, no stats noise."""
        if self._flusher is not None:
            return self._flusher.drain()
        if self.pending:
            self._check_no_open_writer("barrier()")
            self.flush()

    # ------------------------------------------------------------- ingest
    def _parent_key_arrays(self, vid: int) -> Tuple[np.ndarray, np.ndarray]:
        """(sorted primary keys, record ids aligned) of ``vid``'s live set —
        the searchsorted-friendly replacement for the seed's per-commit
        O(|version|) dict rebuild.  Cached per version (immutable)."""
        hit = self._pk_arrays.get(vid)
        if hit is None:
            rids = self.graph.members(vid)
            keys = self.graph.store.keys()[rids]
            order = np.argsort(keys, kind="stable")
            hit = (keys[order], rids[order])
            self._pk_arrays[vid] = hit
        return hit

    def _key_map(self, vid: int) -> Dict[int, int]:
        """pk -> record id of ``vid``'s live set (back-compat; hot paths use
        :meth:`_parent_key_arrays` directly)."""
        skeys, srids = self._parent_key_arrays(vid)
        return dict(zip(skeys.tolist(), srids.tolist()))

    @staticmethod
    def _find_in_sorted(sorted_keys: np.ndarray, pks: np.ndarray) -> np.ndarray:
        """Positions of ``pks`` in ``sorted_keys`` (-1 where absent)."""
        if len(pks) == 0:
            return np.empty(0, dtype=np.int64)
        pos = np.searchsorted(sorted_keys, pks)
        out = np.full(len(pks), -1, dtype=np.int64)
        in_range = pos < len(sorted_keys)
        hit = np.zeros(len(pks), dtype=bool)
        hit[in_range] = sorted_keys[pos[in_range]] == pks[in_range]
        out[hit] = pos[hit]
        return out

    @staticmethod
    def _check_pk_range(pks: np.ndarray, vid: int) -> None:
        if len(pks) and (int(pks.min()) < 0 or int(pks.max()) > _MAX_PART):
            bad = int(pks.min()) if int(pks.min()) < 0 else int(pks.max())
            raise ValueError(f"composite key out of range: ({bad}, {vid})")

    def _stage_root(self, records: Dict[int, bytes]) -> int:
        vid = self._next_vid
        self._next_vid += 1
        pks = np.fromiter(records.keys(), dtype=np.int64, count=len(records))
        self._check_pk_range(pks, vid)
        cks = pack_ck_array(pks, np.full(len(pks), vid, dtype=np.int64))
        sizes = np.fromiter((len(p) for p in records.values()),
                            dtype=np.int64, count=len(records))
        payloads = list(records.values()) if self.config.store_payloads else None
        rids = self.graph.store.add_batch(cks, sizes, payloads)
        self.graph.add_root(vid, rids)
        self._grow_r2c()
        self.pending.append(vid)
        if self._flusher is not None:
            self._flusher.on_stage(vid, int(sizes.sum()))
        return vid

    def _stage_commit(self, parents: Sequence[int], adds: Dict[int, bytes],
                      dels: Iterable[int] = ()) -> int:
        vid = self._next_vid
        self._next_vid += 1
        store = self.graph.store
        skeys, srids = self._parent_key_arrays(parents[0])

        dels = set(dels)
        del_pks = np.fromiter(dels, dtype=np.int64, count=len(dels))
        pos = self._find_in_sorted(skeys, del_pks)
        if (pos < 0).any():
            missing = int(del_pks[int(np.flatnonzero(pos < 0)[0])])
            raise KeyError(f"delete of absent key {missing}")
        del_rid_parts: List[np.ndarray] = [srids[pos]]

        both = dels.intersection(adds)
        if both:
            raise ValueError(f"key {next(iter(both))} both added and deleted")

        add_pks = np.fromiter(adds.keys(), dtype=np.int64, count=len(adds))
        self._check_pk_range(add_pks, vid)
        cks = pack_ck_array(add_pks, np.full(len(add_pks), vid, dtype=np.int64))
        sizes = np.fromiter((len(p) for p in adds.values()),
                            dtype=np.int64, count=len(adds))
        payloads = (list(adds.values())
                    if self.config.store_payloads else None)
        add_rid_parts: List[np.ndarray] = [store.add_batch(cks, sizes, payloads)]
        superseded = self._find_in_sorted(skeys, add_pks)
        del_rid_parts.append(srids[superseded[superseded >= 0]])

        # merge parents: pull exclusive keys (Fig. 4 tree conversion).
        # Earlier merge parents win: a key exclusive to two later parents is
        # pulled once (the seed silently admitted duplicate live records for
        # the same pk, leaving phantom records that dels could not remove).
        pulled_pks = np.empty(0, dtype=np.int64)
        for other in parents[1:]:
            okeys, orids = self._parent_key_arrays(other)
            pull = self._find_in_sorted(skeys, okeys) < 0
            if len(add_pks):
                pull &= ~np.isin(okeys, add_pks)
            if len(del_pks):
                pull &= ~np.isin(okeys, del_pks)
            if len(pulled_pks):
                pull &= ~np.isin(okeys, pulled_pks)
            add_rid_parts.append(orids[pull])
            pulled_pks = np.concatenate([pulled_pks, okeys[pull]])

        self.graph.add_version(vid, list(parents),
                               np.concatenate(add_rid_parts),
                               np.concatenate(del_rid_parts))
        self._grow_r2c()
        self.pending.append(vid)
        if self._flusher is not None:
            self._flusher.on_stage(vid, int(sizes.sum()))
        return vid

    # Back-compat wrappers: each is a one-commit write session that keeps
    # the seed's delta-store batching (flush at batch_size, not per commit).
    def init_root(self, records: Dict[int, bytes]) -> int:
        with self.writer(flush_on_close=False) as w:
            return w.init_root(records)

    def commit(self, parents: Sequence[int], adds: Dict[int, bytes],
               dels: Iterable[int] = ()) -> int:
        """Commit a new version as a delta from ``parents[0]`` (extra parents
        form a merge; their exclusive keys are pulled in per Fig. 4)."""
        with self.writer(flush_on_close=False) as w:
            return w.commit(parents, adds, dels)

    def _grow_r2c(self) -> None:
        n = len(self.graph.store)
        if n > len(self.r2c):
            grown = np.full(n, -1, dtype=np.int64)
            grown[:len(self.r2c)] = self.r2c
            self.r2c = grown

    # ------------------------------------------------------------ chunking
    def _check_no_open_writer(self, what: str) -> None:
        """Misuse is loud: chunking mid-session would split the open
        session's one group commit into several multiputs.  close() clears
        the writer slot before its own flush, so session closes pass.
        Async mode has no per-session group commit to protect — drains
        batch across open sessions by design, so the guard is moot."""
        if self._flusher is not None:
            return
        if self._writer is not None and not self._writer._closed:
            raise RuntimeError(
                f"{what} during an open WriteSession would split its group "
                "commit; close the session instead")

    def _maybe_flush(self) -> None:
        if self._flusher is not None:
            return                    # watermarks own the drain schedule
        if self._writer is not None and not self._writer._closed:
            return                    # an open session group-flushes on close
        if len(self.pending) >= self.config.batch_size:
            self.flush()

    def _stage_chunk_writes(self, chunks, vidx_of: Dict[int, int], nv: int,
                            csr, sub_groups_of: Optional[Dict] = None,
                            ) -> List[Tuple[str, bytes]]:
        """Build the physical blobs for ``chunks``, record them in the
        chunk bookkeeping, and return the staged ``(key, blob)`` write list
        — shared by flush(), build(), and the compactor so the key layout
        and size accounting can never diverge between the three paths."""
        writes: List[Tuple[str, bytes]] = []
        for c in chunks:
            chunk, cmap = build_chunk(
                self.graph, c.record_ids, c.chunk_id, vidx_of, nv, csr,
                subchunk_groups=(sub_groups_of or {}).get(c.chunk_id),
                device=self.device)
            self._chunk_records[c.chunk_id] = c.record_ids
            blob = chunk.to_bytes()
            self._chunk_bytes[c.chunk_id] = len(blob)
            writes.append((f"chunk/{c.chunk_id}", blob))
            writes.append((f"map/{c.chunk_id}", cmap.to_bytes()))
        return writes

    def flush(self) -> None:
        """Chunk the pending batch (§4 online path; k=1 only — the paper's
        online algorithm does not cover re-grouping sub-chunks) and commit
        every new chunk + rebuilt map in ONE ``multiput`` (the group
        commit: one backend write round trip per shard).  With a
        :class:`~repro_torch.core.flusher.BackgroundFlusher` attached this
        is a drain barrier instead (same durability, flusher bookkeeping)."""
        if self._flusher is not None:
            self._flusher.drain()
            return
        self._check_no_open_writer("flush()")
        if not self.pending:
            return
        if self.config.k > 1:
            # compression mode: fall back to a full rebuild (documented)
            self.build()
            return
        batch = self.pending
        self.pending = []
        writes = self._prepare_flush_writes(batch)
        self.kvs.multiput(writes)
        self._flushed_versions = self.graph.num_versions

    def _prepare_flush_writes(self, batch: List[int]) -> List[Tuple[str, bytes]]:
        """Online-chunk ``batch`` and stage its physical writes — new
        chunks, rebuilt old chunk maps, extended index postings — WITHOUT
        touching the backend.  All in-memory layout state (r2c, proj,
        chunk bookkeeping) is advanced here; the caller owns the one
        ``multiput`` that makes it durable (flush() immediately, the
        BackgroundFlusher on its own drain schedule)."""
        placed = self.r2c >= 0
        part = partition_batch(self.graph, batch, placed,
                               self.config.algorithm, self.config.capacity,
                               chunk_id_base=self.n_chunks,
                               **self.config.algo_kwargs())
        mask = part.record_to_chunk >= 0
        self.r2c[:len(mask)][mask] = part.record_to_chunk[mask]
        first_new = self.n_chunks
        self.n_chunks += part.num_chunks

        # projections: new versions + affected old chunks
        if self.proj is None:
            self.proj = Projections(version_chunks={}, key_chunks={},
                                    n_chunks=self.n_chunks)
        self.proj.grow(self.n_chunks)
        keys = self.graph.store.keys()
        batch_vchunks: List[np.ndarray] = []
        for v in batch:
            vchunks = np.unique(self.r2c[self.graph.members(v)])
            assert (vchunks >= 0).all(), "unplaced record in flushed version"
            self.proj.extend_version(v, vchunks)
            batch_vchunks.append(vchunks)
        affected_old = affected_old_chunks(batch_vchunks, first_new)
        new_rids = (np.concatenate([c.record_ids for c in part.chunks])
                    if part.chunks else np.empty(0, np.int64))
        self.proj.extend_keys(keys[new_rids], self.r2c[new_rids])

        # stage new chunks + rebuilt old chunk maps, commit in ONE multiput
        csr = self.graph.record_version_index_csr()
        nv = self.graph.num_versions
        vidx_of = {v: i for i, v in enumerate(self.graph.versions)}
        writes = self._stage_chunk_writes(part.chunks, vidx_of, nv, csr)
        for cid in affected_old:
            cid = int(cid)
            cmap = build_chunk_map(self.graph, self._chunk_records[cid], nv,
                                   csr)
            writes.append((f"map/{cid}", cmap.to_bytes()))
        # secondary indexes: extend postings for the batch's new chunks —
        # dirty idx2/ buckets ride the same group commit
        if self._indexes:
            new_chunks = [(c.chunk_id, c.record_ids) for c in part.chunks]
            for idx in self._indexes.values():
                idx.add_chunks(new_chunks, self.graph.store.payload)
                iw, idel = idx.stage_writes()
                writes.extend(iw)
                assert not idel, "appending chunks never empties a bucket"
        return writes

    def _partitioner(self):
        """The configured offline partitioner; one that runs a kernel
        (SHINGLE's min-hash) runs it on the store's device."""
        cls = ALGORITHMS[self.config.algorithm]
        kw = self.config.algo_kwargs()
        if "device" in {f.name for f in fields(cls)}:
            kw["device"] = self.device
        return cls(**kw)

    def build(self) -> Partitioning:
        """Full offline build (also the k>1 path)."""
        self._check_no_open_writer("build()")
        if self._flusher is not None:
            # drain barrier: staged work lands in the OLD layout first, so
            # a replay from a failed drain can never cross the rebuild and
            # resurrect superseded keys (a failed drain aborts the build)
            self._flusher.drain()
        self._build_epoch += 1
        self.pending = []
        cfg = self.config
        graph = self.graph
        if cfg.k > 1:
            groups = build_subchunks(graph, cfg.k)
            sub_sizes = (compressed_subchunk_sizes(graph, groups, self.device)
                         if graph.store.has_payloads() else None)
            tds = build_transformed(graph, groups, sub_sizes)
            tpart = self._partitioner().partition(tds.tgraph, cfg.capacity)
            self._subchunk_groups = groups
            # compose record -> chunk
            self.r2c = tpart.record_to_chunk[tds.rec_to_sub]
            chunks = []
            for c in tpart.chunks:
                rec_ids = np.concatenate([groups[s] for s in c.record_ids])
                chunks.append(Chunk(c.chunk_id, np.sort(rec_ids), c.nbytes))
            part = Partitioning(chunks=chunks, record_to_chunk=self.r2c,
                                algorithm=f"{cfg.algorithm}_k{cfg.k}")
            sub_groups_of = {c.chunk_id: [groups[s] for s in tc.record_ids]
                             for c, tc in zip(chunks, tpart.chunks)}
        else:
            part = self._partitioner().partition(graph, cfg.capacity)
            self.r2c = part.record_to_chunk.copy()
            sub_groups_of = {}

        self.n_chunks = part.num_chunks
        self.proj = Projections.build_from_r2c(graph, self.r2c, self.n_chunks)

        csr = graph.record_version_index_csr()
        nv = graph.num_versions
        vidx_of = {v: i for i, v in enumerate(graph.versions)}
        old_ids = set(self._chunk_records)
        self._chunk_records = {}
        self._chunk_bytes = {}
        writes = self._stage_chunk_writes(part.chunks, vidx_of, nv, csr,
                                          sub_groups_of)
        # GC: chunk ids of the previous layout that the rebuild did not
        # reuse would otherwise stay in the KVS forever (a rebuild can
        # shrink the chunk count — especially after retention pruning)
        stale = sorted(old_ids - set(self._chunk_records))
        stale_keys = [k for c in stale for k in (f"chunk/{c}", f"map/{c}")]
        # secondary indexes: recompute postings over the new layout inside
        # the same group commit; buckets that emptied out (all their values
        # lived only in retired versions) join the stale-key GC
        for idx in self._indexes.values():
            idx.rebuild(self._chunk_records, graph.store.payload)
            iw, idel = idx.stage_writes()
            writes.extend(iw)
            stale_keys.extend(idel)
        self.kvs.multiput(writes)      # one group commit, even for rebuilds
        self.kvs.multidelete(stale_keys)
        self._notify_layout_change(stale_keys)
        self._flushed_versions = graph.num_versions
        return part

    # -------------------------------------------------- retention/compaction
    def retain(self, policy: RetentionPolicy) -> List[int]:
        """Apply a retention policy: versions outside it are *retired* —
        pruned from the version graph and the version→chunks projection, so
        queries against them fail loudly.  Their record copies stay in
        storage as garbage until the next :meth:`compact` pass physically
        reclaims them.  Returns the newly retired version ids.
        """
        self._check_no_open_writer("retain()")
        if self._flusher is not None:
            # drain barrier — even with nothing pending a failed drain may
            # hold prepared writes whose replay must land before retirement
            self._flusher.drain()
        elif self.pending:
            if self.config.auto_flush:
                self.flush()
            else:
                raise RuntimeError(
                    f"{len(self.pending)} unflushed version(s); retention "
                    "works on the flushed graph — call flush() first")
        retained = set(policy.resolve(self.graph))
        to_retire = [v for v in self.graph.retained_versions()
                     if v not in retained]
        if not to_retire:
            return []
        self.graph.retire(to_retire)
        if self.proj is not None:
            self.proj.drop_versions(to_retire)
        for v in to_retire:
            self._pk_arrays.pop(v, None)
        return to_retire

    def compact(self, **compactor_kw) -> CompactionReport:
        """Run one background compaction pass (see
        :class:`~repro_torch.core.compact.Compactor`): rewrite fragmented /
        low-liveness chunks through the configured partition algorithm in
        ONE group commit and GC the superseded keys in ONE ``multidelete``
        — each one backend round trip per shard touched.  Bumps the layout
        epoch; open snapshots re-pin with ``snapshot.refresh()``.

        Exception: with ``k > 1`` (sub-chunk compression) the pass falls
        back to a retention-aware full :meth:`build` — the online algorithm
        cannot re-group sub-chunks — which, like every rebuild, *hard*
        invalidates open snapshots (``refresh()`` raises; take a new
        ``snapshot()``)."""
        return Compactor(self, **compactor_kw).run_pass()

    @property
    def layout_epoch(self) -> int:
        return self._layout_epoch

    # --------------------------------------------------- secondary indexes
    def create_index(self, attr: str, extractor: AttributeExtractor,
                     n_buckets: int = 16) -> SecondaryIndex:
        """Register a secondary index on ``attr`` (see
        :mod:`repro_torch.core.secondary`).  Existing chunks are indexed now
        (one ``multiput`` of the ``idx2/{attr}/*`` buckets); every later
        flush / build / compaction keeps the postings coherent inside its
        own round trips.  Enables ``Q.where(vid, attr, value)`` and
        ``Q.where_range(vid, attr, lo, hi)`` on snapshots."""
        if attr in self._indexes:
            raise ValueError(f"secondary index on {attr!r} already exists")
        if not self.config.store_payloads:
            raise RuntimeError(
                "secondary indexes need store_payloads=True — attribute "
                "extraction reads record payloads")
        idx = SecondaryIndex(attr, extractor, n_buckets=n_buckets)
        if self._chunk_records:
            idx.add_chunks(sorted(self._chunk_records.items()),
                           self.graph.store.payload)
            writes, _ = idx.stage_writes()
            self.kvs.multiput(writes)
        self._indexes[attr] = idx
        return idx

    def drop_index(self, attr: str) -> None:
        """Unregister the index on ``attr`` and GC its ``idx2/`` keys (one
        ``multidelete``).  Raises ``KeyError`` if no such index exists."""
        idx = self._indexes.pop(attr)
        self.kvs.multidelete(idx.stored_keys())

    @property
    def indexes(self) -> Dict[str, SecondaryIndex]:
        return dict(self._indexes)

    # --------------------------------------------------------- cache layer
    def _cache(self):
        """The CachingKVS layer, if one tops the backend stack."""
        return self.kvs if getattr(self.kvs, "is_cache", False) else None

    def _notify_layout_change(self, superseded_keys) -> None:
        """Layout-epoch hook: ``build()`` / ``compact()`` re-partitioned
        chunk storage — flush the cache entries the pass superseded, at the
        same moment open snapshots need ``refresh()`` / re-``snapshot()``.
        (Rewritten keys are already fresh via write-through; this drops the
        deleted old layout's keys even if maintenance bypassed the cache.)"""
        c = self._cache()
        if c is not None:
            c.on_layout_epoch(self._build_epoch + self._layout_epoch,
                              superseded_keys)

    def cache_stats(self) -> Optional[Dict[str, float]]:
        """Hit-rate / occupancy report of the chunk cache layer; ``None``
        when the backend stack has no
        :class:`~repro_torch.core.cache.CachingKVS` on top."""
        c = self._cache()
        return None if c is None else c.cache_report()

    # ------------------------------------------------------------- queries
    def snapshot(self, mode: str = "fresh") -> Snapshot:
        """Immutable read view of the store (the session API).

        ``mode="fresh"`` (default) is read-your-writes: with a
        :class:`~repro_torch.core.flusher.BackgroundFlusher` attached it
        drains first, so every committed version is visible.  Without a
        flusher, ``auto_flush=True`` (seed behaviour) flushes pending deltas
        first while ``auto_flush=False`` makes reads strictly side-effect
        free (unflushed deltas raise — call :meth:`flush` explicitly).

        ``mode="pinned"`` pins the last DURABLE state without flushing
        anything: zero write round trips, bounded staleness.  Versions
        still staged are invisible (querying one fails loudly) and the
        snapshot's ``staleness_lag`` reports how many.  After a *failed*
        drain the in-memory layout is ahead of the durable state, so a
        pinned snapshot raises until a barrier (or backend recovery)
        lands the replay.
        """
        if mode not in ("fresh", "pinned"):
            raise ValueError(f"unknown snapshot mode {mode!r} "
                             "(expected 'fresh' or 'pinned')")
        lag = 0
        if self._flusher is not None:
            if mode == "fresh":
                self._flusher.drain()
            else:
                if self._flusher.has_unacked_writes:
                    raise RuntimeError(
                        "a failed drain left the in-memory layout ahead of "
                        "the durable state; barrier() (or recover the "
                        "backend) before taking a pinned snapshot")
                lag = self._flusher.staleness_lag
        elif self.pending:
            if mode == "pinned":
                lag = len(self.pending)
            elif self._writer is not None and not self._writer._closed:
                # flushing here would split the open session's one group
                # commit into several multiputs behind the caller's back —
                # misuse is loud, like every other mid-session hazard
                raise RuntimeError(
                    f"{len(self.pending)} unflushed version(s) staged by an "
                    "open WriteSession; close the session (its group flush) "
                    "before reading")
            elif self.config.auto_flush:
                self.flush()
            else:
                raise RuntimeError(
                    f"{len(self.pending)} unflushed version(s); call flush() "
                    "explicitly (auto_flush=False makes reads side-effect free)")
        assert self.proj is not None, "no data ingested"
        return Snapshot(self.graph, self.proj, self.kvs,
                        epoch=self._build_epoch,
                        current_epoch=lambda: self._build_epoch,
                        layout_epoch=self._layout_epoch,
                        current_layout_epoch=lambda: self._layout_epoch,
                        indexes=self._indexes,
                        repin=lambda: (self.proj, self._indexes,
                                       self._layout_epoch),
                        staleness_lag=lag,
                        chunk_bytes=self.config.capacity,
                        device=self.device)

    def execute(self, queries) -> "BatchResult":
        """Run a batch of queries against a fresh snapshot (convenience)."""
        return self.snapshot().execute(queries)

    # Back-compat wrappers: each is a single-query session (one KVS round
    # trip; the seed paid two — chunks, then maps).
    def get_version(self, vid: int):
        r = self.snapshot().execute([Q.version(vid)])[0]
        return r.value, r.stats

    def get_record(self, vid: int, pk: int):
        r = self.snapshot().execute([Q.record(vid, pk)])[0]
        return r.value, r.stats

    def get_range(self, vid: int, key_lo: int, key_hi: int):
        r = self.snapshot().execute([Q.range(vid, key_lo, key_hi)])[0]
        return r.value, r.stats

    def get_evolution(self, pk: int):
        r = self.snapshot().execute([Q.evolution(pk)])[0]
        return r.value, r.stats

    # ------------------------------------------------------------- metrics
    def storage_stats(self) -> Dict[str, object]:
        """Chunk/index sizes (plus a ``"cache"`` sub-report when a
        :class:`~repro_torch.core.cache.CachingKVS` tops the backend stack).
        ``stored_chunk_bytes`` is tracked incrementally at chunk-write time
        — the seed multiget every chunk blob just to size it, a full-store
        read per stats call."""
        out = {
            # stored chunks, not the high-water id counter: after a
            # compaction pass the id space is sparse (old ids deleted, new
            # ones appended) but this stays the physical chunk count
            "n_chunks": len(self._chunk_records),
            "stored_chunk_bytes": int(sum(self._chunk_bytes.values())),
            "raw_unique_bytes": int(self.graph.store.sizes.sum()),
        }
        if self.proj is not None:
            out.update(self.proj.compressed_size())
        if self._indexes:
            out["secondary_index_bytes"] = int(sum(
                idx.stored_bytes() for idx in self._indexes.values()))
            out["secondary_indexes"] = {
                attr: idx.report() for attr, idx in self._indexes.items()}
        cache = self.cache_stats()
        if cache is not None:
            out["cache"] = cache
        out["ingest"] = self._ingest_report()
        return out

    def _ingest_report(self) -> Dict[str, object]:
        """The ``storage_stats()["ingest"]`` sub-report: staging state and
        the flusher counters (which live on the top-of-stack ``KVSStats``
        so they ride reset/snapshot/restore/merged like every counter)."""
        fl = self._flusher
        stats = self.kvs.stats
        out: Dict[str, object] = {
            "mode": "async" if fl is not None else "sync",
            "staged_versions": (fl.staged_versions if fl is not None
                                else len(self.pending)),
            "staleness_lag": (fl.staleness_lag if fl is not None
                              else len(self.pending)),
            "n_flush_batches": stats.n_flush_batches,
            "n_versions_staged": stats.n_versions_staged,
            "max_observed_lag": stats.max_observed_lag,
        }
        if fl is not None:
            out.update(
                staged_bytes=fl.staged_bytes,
                clock=fl.step,
                open_sessions=len([w for w in self._async_writers
                                   if not w._closed]),
                pending_replay_writes=len(fl._replay),
                watermarks=fl.watermarks(),
            )
        return out

