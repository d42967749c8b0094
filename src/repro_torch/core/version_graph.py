"""Version graph machinery (§2.1, §2.5, §3.2 delta algebra).

Holds the directed version DAG, per-edge deltas, DAG→tree conversion (Fig. 4),
materialized version memberships, and the record↔version bipartite graph in
CSR form that the partitioners consume.

Records are referenced by dense integer *record ids* into a
:class:`RecordStore`; all hot paths are vectorized NumPy over sorted int64
arrays (the partitioners are offline host-side algorithms, exactly as in the
paper where they run on the application server).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .types import (CompositeKey, PrimaryKey, VersionId, pack_ck,
                    pack_ck_array, unpack_ck_array)


class RecordStore:
    """Registry of all distinct records (each stored once — dedupe by design).

    Composite keys, sizes and primary keys live in growable numpy buffers
    (capacity doubles), so the ``cks``/``sizes``/``keys()`` arrays the commit
    and flush paths read are views, never rebuilt from Python lists: a
    rebuild per commit would make ingest quadratic in the record count."""

    def __init__(self) -> None:
        self._n = 0
        self._cks_buf = np.empty(0, dtype=np.int64)     # packed composite keys
        self._sizes_buf = np.empty(0, dtype=np.int64)
        self._keys_buf = np.empty(0, dtype=np.int64)    # primary keys
        self._payloads: List[Optional[bytes]] = []
        self._index: Dict[int, int] = {}   # packed ck -> record id

    def __len__(self) -> int:
        return self._n

    def _append(self, cks: np.ndarray, sizes: np.ndarray) -> None:
        n = self._n + len(cks)
        if n > len(self._cks_buf):
            cap = max(n, 2 * len(self._cks_buf), 1024)
            for name in ("_cks_buf", "_sizes_buf", "_keys_buf"):
                grown = np.empty(cap, dtype=np.int64)
                grown[:self._n] = getattr(self, name)[:self._n]
                setattr(self, name, grown)
        self._cks_buf[self._n:n] = cks
        self._sizes_buf[self._n:n] = sizes
        self._keys_buf[self._n:n] = unpack_ck_array(cks)[0]
        self._n = n

    def add(self, ck: int, size: int, payload: Optional[bytes] = None) -> int:
        return int(self.add_batch(np.asarray([ck], dtype=np.int64),
                                  np.asarray([size], dtype=np.int64),
                                  [payload])[0])

    def add_batch(self, cks: np.ndarray, sizes: np.ndarray,
                  payloads: Optional[Sequence[bytes]] = None) -> np.ndarray:
        cks = np.asarray(cks, dtype=np.int64)
        ck_list = cks.tolist()
        dup = [c for c in ck_list if c in self._index]
        if not dup and len(set(ck_list)) != len(ck_list):
            seen: set = set()
            dup = [c for c in ck_list if c in seen or seen.add(c)]
        if dup:
            raise ValueError(
                f"record {CompositeKey.from_packed(dup[0])} already exists")
        base = self._n
        self._append(cks, np.asarray(sizes, dtype=np.int64))
        self._payloads.extend([None] * len(ck_list) if payloads is None
                              else payloads)
        self._index.update(zip(ck_list, range(base, self._n)))
        return np.arange(base, self._n, dtype=np.int64)

    def lookup(self, ck: int) -> Optional[int]:
        return self._index.get(ck)

    @property
    def cks(self) -> np.ndarray:
        return self._cks_buf[:self._n]

    @property
    def sizes(self) -> np.ndarray:
        return self._sizes_buf[:self._n]

    def size_of(self, rid: int) -> int:
        return int(self._sizes_buf[rid])

    def keys(self) -> np.ndarray:
        """Primary keys per record id."""
        return self._keys_buf[:self._n]

    def origin_versions(self) -> np.ndarray:
        return unpack_ck_array(self.cks)[1]

    def payload(self, rid: int) -> bytes:
        p = self._payloads[rid]
        if p is None:
            raise KeyError(f"record {rid} has no payload stored")
        return p

    def has_payloads(self) -> bool:
        return len(self._payloads) > 0 and self._payloads[0] is not None

    def set_payload(self, rid: int, payload: bytes) -> None:
        self._payloads[rid] = payload
        self._sizes_buf[rid] = len(payload)


@dataclass
class DeltaIds:
    """Record-id level delta along a (parent → child) tree edge.

    ``adds``  — records present in child, absent in parent (Δ+).
    ``dels``  — records present in parent, absent in child (Δ−).
    Both are sorted int64 record-id arrays.  Reversing the edge swaps the two
    (the paper's Δij = Δji symmetry).
    """

    adds: np.ndarray
    dels: np.ndarray

    def reversed(self) -> "DeltaIds":
        return DeltaIds(adds=self.dels, dels=self.adds)

    def validate(self) -> None:
        if np.intersect1d(self.adds, self.dels).size:
            raise ValueError("inconsistent delta: Δ+ ∩ Δ− ≠ ∅")


class VersionGraph:
    """The version DAG + tree view + memberships.

    DAG→tree (Fig. 4): for a merge node we retain the edge to its *first*
    parent and drop the rest; records that arrived exclusively from dropped
    parents simply appear in the tree-delta's Δ+ of the merge node ("renamed
    to appear as newly inserted").  We keep the original record ids (the
    rename is bookkeeping — partitioners dedupe on first placement), and the
    original DAG remains available to queries afterwards, as in the paper.
    """

    def __init__(self, store: Optional[RecordStore] = None) -> None:
        self.store = RecordStore() if store is None else store
        self.parents: Dict[VersionId, Tuple[VersionId, ...]] = {}
        self.tree_delta: Dict[VersionId, DeltaIds] = {}   # keyed by child vid
        self._children: Dict[VersionId, List[VersionId]] = {}
        self.root: Optional[VersionId] = None
        self._memberships: Dict[VersionId, np.ndarray] = {}
        self._order: List[VersionId] = []                 # insertion (= topo) order
        # retention GC: retired versions keep their tree structure (stable
        # version indices for stored chunk-map bitmaps, ancestor walks) but
        # lose their membership — their content is logically deleted
        self._retired: set = set()

    # ------------------------------------------------------------- building
    def add_root(self, vid: VersionId, record_ids: np.ndarray) -> None:
        if self.root is not None:
            raise ValueError("root already set")
        self.root = vid
        self.parents[vid] = ()
        self._children[vid] = []
        record_ids = np.sort(np.asarray(record_ids, dtype=np.int64))
        self.tree_delta[vid] = DeltaIds(adds=record_ids, dels=np.empty(0, np.int64))
        self._memberships[vid] = record_ids
        self._order.append(vid)

    def add_version(self, vid: VersionId, parents: Sequence[VersionId],
                    adds: np.ndarray, dels: np.ndarray) -> None:
        """Add a version.  ``adds``/``dels`` are record ids relative to the
        *first* (retained) parent — callers with multi-parent merges must pass
        the delta vs. the retained parent (ingest.py computes this)."""
        if vid in self.parents:
            raise ValueError(f"version {vid} already exists")
        for p in parents:
            if p not in self.parents:
                raise ValueError(f"unknown parent version {p}")
        for p in parents:
            if p in self._retired:
                raise ValueError(
                    f"cannot commit onto retired version {p} (pruned by a "
                    "retention policy)")
        adds = np.sort(np.asarray(adds, dtype=np.int64))
        dels = np.sort(np.asarray(dels, dtype=np.int64))
        d = DeltaIds(adds=adds, dels=dels)
        d.validate()
        self.parents[vid] = tuple(parents)
        self._children[vid] = []
        for p in parents:
            self._children[p].append(vid)
        self.tree_delta[vid] = d
        parent_members = self.members(parents[0])
        if np.setdiff1d(dels, parent_members, assume_unique=False).size:
            raise ValueError("delta deletes records absent from parent")
        members = np.union1d(
            np.setdiff1d(parent_members, dels, assume_unique=True), adds)
        self._memberships[vid] = members
        self._order.append(vid)

    # ------------------------------------------------------------ structure
    @property
    def versions(self) -> List[VersionId]:
        return list(self._order)

    @property
    def num_versions(self) -> int:
        return len(self._order)

    def tree_parent(self, vid: VersionId) -> Optional[VersionId]:
        p = self.parents[vid]
        return p[0] if p else None

    def tree_children(self, vid: VersionId) -> List[VersionId]:
        """Children in the tree view (i.e. nodes whose retained parent is vid)."""
        return [c for c in self._children[vid] if self.parents[c][0] == vid]

    def dag_children(self, vid: VersionId) -> List[VersionId]:
        return list(self._children[vid])

    def is_merge(self, vid: VersionId) -> bool:
        return len(self.parents[vid]) > 1

    def depth(self, vid: VersionId) -> int:
        d = 0
        v: Optional[VersionId] = vid
        while v is not None and v != self.root:
            v = self.tree_parent(v)
            d += 1
        return d

    def path_to_root(self, vid: VersionId) -> List[VersionId]:
        path = [vid]
        v = vid
        while v != self.root:
            v = self.tree_parent(v)  # type: ignore[assignment]
            path.append(v)
        return path

    def leaves(self) -> List[VersionId]:
        return [v for v in self._order if not self.tree_children(v)]

    def avg_depth(self) -> float:
        ls = self.leaves()
        return float(np.mean([self.depth(v) for v in ls])) if ls else 0.0

    def dfs_order(self) -> List[VersionId]:
        """Pre-order DFS of the tree view, children in insertion order."""
        assert self.root is not None
        out: List[VersionId] = []
        stack = [self.root]
        while stack:
            v = stack.pop()
            out.append(v)
            stack.extend(reversed(self.tree_children(v)))
        return out

    def bfs_order(self) -> List[VersionId]:
        assert self.root is not None
        out: List[VersionId] = []
        frontier = [self.root]
        while frontier:
            out.extend(frontier)
            frontier = [c for v in frontier for c in self.tree_children(v)]
        return out

    def postorder(self) -> List[VersionId]:
        """Children-before-parent order of the tree view (bottom-up)."""
        return list(reversed(self.bfs_topdown_parents_first()))

    def bfs_topdown_parents_first(self) -> List[VersionId]:
        # insertion order is already parents-before-children
        return list(self._order)

    # ------------------------------------------------------------ retention
    def retire(self, vids: Sequence[VersionId]) -> None:
        """Logically delete ``vids`` (retention GC).

        The tree structure (parents, deltas, insertion order) survives so
        stored chunk-map bitmaps keep their version indices and ancestor
        walks still work; only the membership is dropped — the version's
        content becomes unreachable, and records reachable from no retained
        version are garbage that a compaction pass reclaims physically.
        """
        for v in vids:
            if v not in self.parents:
                raise ValueError(f"unknown version {v}")
        self._retired.update(vids)
        for v in vids:
            self._memberships.pop(v, None)

    def is_retired(self, vid: VersionId) -> bool:
        return vid in self._retired

    def has_retired(self) -> bool:
        return bool(self._retired)

    def retained_versions(self) -> List[VersionId]:
        """Non-retired versions in insertion order."""
        return [v for v in self._order if v not in self._retired]

    def live_record_mask(self) -> np.ndarray:
        """Bool mask over record ids: reachable from ≥1 retained version.
        With no retirement every membership record is live by definition."""
        mask = np.zeros(len(self.store), dtype=bool)
        for m in self._memberships.values():
            mask[m] = True
        return mask

    # ----------------------------------------------------------- membership
    def members(self, vid: VersionId) -> np.ndarray:
        """Sorted record ids constituting version ``vid``.  A retired
        version has no content: empty (partitioners treat it as carrying
        nothing to preserve; ingest/query paths guard explicitly)."""
        if vid in self._retired:
            return np.empty(0, dtype=np.int64)
        return self._memberships[vid]

    def memberships(self) -> Dict[VersionId, np.ndarray]:
        return dict(self._memberships)

    def version_sizes(self) -> Dict[VersionId, int]:
        sizes = self.store.sizes
        return {v: int(sizes[m].sum()) for v, m in self._memberships.items()}

    def total_entries(self) -> int:
        return sum(len(m) for m in self._memberships.values())

    # --------------------------------------------------- bipartite CSR view
    def record_version_csr(self) -> Tuple[np.ndarray, np.ndarray]:
        """Record→versions adjacency in CSR: (indptr[num_records+1], vids).

        Row r lists (sorted by version insertion index) the versions that
        contain record r.  This is the bipartite graph of §2.5 used by the
        shingle partitioner and the index builders.
        """
        indptr, vidx = self.record_version_index_csr()
        return indptr, np.asarray(self._order, dtype=np.int64)[vidx]

    def record_version_index_csr(self) -> Tuple[np.ndarray, np.ndarray]:
        """Like :meth:`record_version_csr` but with dense version *indices*."""
        n_rec = len(self.store)
        vidx = {v: i for i, v in enumerate(self._order)}
        ms = list(self._memberships.items())
        rec_cat = (np.concatenate([m for _, m in ms]) if ms
                   else np.empty(0, np.int64))
        ver_cat = np.repeat(np.asarray([vidx[v] for v, _ in ms], np.int64),
                            [len(m) for _, m in ms])
        # memberships are kept in insertion order, so ver_cat is already
        # ascending: a stable sort by record alone orders each row's versions
        order = np.argsort(rec_cat, kind="stable")
        indptr = np.zeros(n_rec + 1, dtype=np.int64)
        np.cumsum(np.bincount(rec_cat, minlength=n_rec), out=indptr[1:])
        return indptr, ver_cat[order]

    # ------------------------------------------------------------ utilities
    def check_invariants(self) -> None:
        """Structural invariants used by property tests."""
        assert self.root is not None
        for v in self._order:
            if v in self._retired:
                assert v not in self._memberships
                continue
            m = self._memberships[v]
            assert (np.diff(m) > 0).all(), f"membership of {v} not sorted-unique"
            p = self.tree_parent(v)
            if p is None or p in self._retired:
                continue
            d = self.tree_delta[v]
            pm = self._memberships[p]
            # Δ+ disjoint from parent, Δ− subset of parent
            assert np.intersect1d(d.adds, pm).size == 0
            assert np.setdiff1d(d.dels, pm).size == 0
            recon = np.union1d(np.setdiff1d(pm, d.dels, assume_unique=True), d.adds)
            assert np.array_equal(recon, m)
            # every add carries this version as origin — except records pulled
            # in from dropped merge parents (Fig. 4), which keep their origin
            origins = self.store.origin_versions()[d.adds]
            if not self.is_merge(v):
                assert (origins == v).all(), f"adds of {v} carry wrong origin"
