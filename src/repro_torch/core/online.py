"""Online (batched) partitioning (§4).

New commits land in a *delta store* (a list of pending version ids — their
records/deltas are already in the version graph, just not yet chunked).  When
``batch_size`` versions accumulate, the batch is partitioned by an adapted
version of the configured algorithm restricted to the batch's *new* records:
previously chunked records are never re-partitioned (the paper defers
re-partitioning to future work).  Chunk maps of affected old chunks are
rebuilt from the in-memory index and rewritten once per batch — the paper's
"recreate from scratch instead of fetch+update" trick — and the whole
batch's writes (new chunks + rebuilt maps) are group-committed by the
caller in one ``multiput`` per backend shard.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from .partition import ALGORITHMS
from .partition.base import ChunkPacker
from .types import Chunk, Partitioning
from .version_graph import VersionGraph

_VIRTUAL_ROOT = -1


def affected_old_chunks(batch_version_chunks: Sequence[np.ndarray],
                        first_new_chunk: int) -> np.ndarray:
    """Pre-existing chunks touched by the batch's versions (their chunk maps
    gained version-membership bits and must be rebuilt).  Takes the
    per-version chunk-id arrays the flush already computed for its
    projections — one vectorized unique instead of a per-version Python
    set union."""
    if not batch_version_chunks:
        return np.empty(0, dtype=np.int64)
    cs = np.unique(np.concatenate(list(batch_version_chunks)))
    return cs[(cs >= 0) & (cs < first_new_chunk)]


class _BatchView:
    """Duck-typed VersionGraph view: the batch's versions as a forest hanging
    off a virtual root, memberships restricted to not-yet-placed records."""

    def __init__(self, graph: VersionGraph, batch: Sequence[int],
                 new_rids: np.ndarray) -> None:
        self._graph = graph
        self._batch = list(batch)
        self._bset = set(batch)
        self._is_new = np.zeros(len(graph.store), dtype=bool)
        self._is_new[new_rids] = True
        self.store = graph.store
        self.root = _VIRTUAL_ROOT

    def postorder(self) -> List[int]:
        # commit order is parents-before-children ⇒ reversed is a valid
        # children-first order; the virtual root comes last.
        return list(reversed(self._batch)) + [_VIRTUAL_ROOT]

    def tree_children(self, vid: int) -> List[int]:
        if vid == _VIRTUAL_ROOT:
            return [v for v in self._batch
                    if self._graph.tree_parent(v) not in self._bset]
        return [c for c in self._graph.tree_children(vid) if c in self._bset]

    def members(self, vid: int) -> np.ndarray:
        if vid == _VIRTUAL_ROOT:
            return np.empty(0, np.int64)
        # graph.members is empty for retired versions, so a compaction
        # rewrite spanning the whole (partially retired) tree just sees
        # nothing to preserve there
        m = self._graph.members(vid)
        return m[self._is_new[m]]       # == intersect1d(m, new): m is sorted

    def dfs_order(self) -> List[int]:
        out: List[int] = []
        stack = list(reversed(self.tree_children(_VIRTUAL_ROOT)))
        while stack:
            v = stack.pop()
            out.append(v)
            stack.extend(reversed(self.tree_children(v)))
        return out

    def bfs_order(self) -> List[int]:
        out: List[int] = []
        frontier = self.tree_children(_VIRTUAL_ROOT)
        while frontier:
            out.extend(frontier)
            frontier = [c for v in frontier for c in self.tree_children(v)]
        return out

    @property
    def tree_delta(self):
        return self._graph.tree_delta


def partition_batch(graph: VersionGraph, batch: Sequence[int],
                    placed: np.ndarray, algorithm: str, capacity: int,
                    chunk_id_base: int,
                    records: Optional[np.ndarray] = None,
                    **algo_kw) -> Partitioning:
    """Partition the batch's new records; chunk ids start at chunk_id_base.

    ``records`` overrides the delta-derived record set: the compaction path
    passes the live records of its candidate chunks here (with ``placed``
    masking everything else) and ``batch`` = every version, re-running the
    same restricted partitioner over the records being rewritten.
    """
    if records is not None:
        new = np.unique(np.asarray(records, dtype=np.int64))
    else:
        new_rids: List[np.ndarray] = []
        for v in batch:
            adds = graph.tree_delta[v].adds
            new_rids.append(adds[~placed[adds]])
        new = (np.unique(np.concatenate(new_rids)) if new_rids
               else np.empty(0, np.int64))

    if algorithm in ("depth_first", "breadth_first", "delta", "shingle"):
        # greedy/stream algorithms: place new records in traversal order
        packer = ChunkPacker(graph.store.sizes, capacity)
        view = _BatchView(graph, batch, new)
        order = view.dfs_order() if algorithm != "breadth_first" else view.bfs_order()
        if algorithm == "delta":
            order = list(batch)
        keys = graph.store.keys()
        for v in order:
            adds = graph.tree_delta[v].adds
            adds = adds[~placed[adds]]
            adds = adds[np.argsort(keys[adds], kind="stable")]
            for r in adds:
                if not packer.is_placed(int(r)):
                    packer.place(int(r))
        part = packer.finish(algorithm, merge_partial=(algorithm != "delta"))
    elif algorithm == "bottom_up":
        view = _BatchView(graph, batch, new)
        algo = ALGORITHMS["bottom_up"](**algo_kw)
        part = algo.partition(view, capacity)  # type: ignore[arg-type]
    else:
        raise ValueError(f"online mode unsupported for {algorithm}")

    # re-base chunk ids
    chunks = [Chunk(chunk_id_base + i, c.record_ids, c.nbytes)
              for i, c in enumerate(part.chunks)]
    r2c = part.record_to_chunk.copy()
    r2c[r2c >= 0] += chunk_id_base
    return Partitioning(chunks=chunks, record_to_chunk=r2c,
                        algorithm=f"online_{algorithm}")
