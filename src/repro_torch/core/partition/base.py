"""Partitioner API + the fixed-size chunk packer (§2.5 fixed chunk size).

All partitioning algorithms produce a :class:`Partitioning` by streaming
record ids (in an algorithm-specific order) into a :class:`ChunkPacker` that
enforces the paper's fixed-chunk-size design decision: chunks target capacity
``C`` bytes with up to ``slack`` (default 25%) overflow allowed, and partial
chunks created at forced boundaries are merged at the end to reduce
fragmentation (§3.2).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Protocol, Sequence

import numpy as np

from ..types import Chunk, Partitioning
from ..version_graph import VersionGraph


class Partitioner(Protocol):
    name: str

    def partition(self, graph: VersionGraph, capacity: int) -> Partitioning: ...


class ChunkPacker:
    """Sequentially packs records into ~equal-sized chunks.

    - ``place(rid)`` appends a record to the open chunk, closing it when the
      next record would push it past ``C*(1+slack)``.
    - ``boundary()`` force-closes the open chunk (used by BOTTOM-UP at each
      version's finalization step so that "highly common" records are not
      split across chunks).
    - ``finish(merge_partial=True)`` merges under-half-full chunks (in
      creation order, preserving locality) and emits the Partitioning.
    Oversized single records get a dedicated (over-slack) chunk, mirroring the
    paper's handling of records comparable to the chunk size.
    """

    def __init__(self, record_sizes: np.ndarray, capacity: int,
                 slack: float = 0.25) -> None:
        self.sizes = record_sizes
        self.capacity = int(capacity)
        self.slack = float(slack)
        self.limit = int(capacity * (1 + slack))
        self._chunks: List[List[int]] = []
        self._chunk_bytes: List[int] = []
        self._cur: List[int] = []
        self._cur_bytes = 0
        self._placed = np.zeros(len(record_sizes), dtype=bool)

    # ------------------------------------------------------------ placement
    def is_placed(self, rid: int) -> bool:
        return bool(self._placed[rid])

    def place(self, rid: int) -> None:
        if self._placed[rid]:
            raise ValueError(f"record {rid} placed twice")
        sz = int(self.sizes[rid])
        if self._cur and self._cur_bytes + sz > self.limit:
            self._close()
        self._cur.append(int(rid))
        self._cur_bytes += sz
        self._placed[rid] = True
        if self._cur_bytes >= self.capacity:
            self._close()

    def place_many(self, rids: Sequence[int], dedupe: bool = False) -> None:
        for r in rids:
            r = int(r)
            if dedupe and self._placed[r]:
                continue
            self.place(r)

    def boundary(self) -> None:
        if self._cur:
            self._close()

    def _close(self) -> None:
        self._chunks.append(self._cur)
        self._chunk_bytes.append(self._cur_bytes)
        self._cur = []
        self._cur_bytes = 0

    # -------------------------------------------------------------- sealing
    def finish(self, algorithm: str, merge_partial: bool = True) -> Partitioning:
        self.boundary()
        chunks_r = self._chunks
        bytes_r = self._chunk_bytes
        if merge_partial:
            chunks_r, bytes_r = self._merge_partial(chunks_r, bytes_r)
        chunks = []
        r2c = np.full(len(self.sizes), -1, dtype=np.int64)
        for cid, (rids, nb) in enumerate(zip(chunks_r, bytes_r)):
            arr = np.asarray(rids, dtype=np.int64)
            chunks.append(Chunk(chunk_id=cid, record_ids=arr, nbytes=nb))
            r2c[arr] = cid
        return Partitioning(chunks=chunks, record_to_chunk=r2c, algorithm=algorithm)

    def _merge_partial(self, chunks: List[List[int]], cbytes: List[int]):
        """First-fit merge of partial (< C/2) chunks in creation order."""
        out_chunks: List[List[int]] = []
        out_bytes: List[int] = []
        open_idx: Optional[int] = None  # index in out of a partial merge target
        for rids, nb in zip(chunks, cbytes):
            if nb >= self.capacity // 2:
                out_chunks.append(rids)
                out_bytes.append(nb)
                continue
            if open_idx is not None and out_bytes[open_idx] + nb <= self.limit:
                out_chunks[open_idx] = out_chunks[open_idx] + rids
                out_bytes[open_idx] += nb
                if out_bytes[open_idx] >= self.capacity // 2:
                    open_idx = None
            else:
                out_chunks.append(rids)
                out_bytes.append(nb)
                open_idx = len(out_chunks) - 1 if nb < self.capacity // 2 else None
        return out_chunks, out_bytes


# --------------------------------------------------------------------- span
def version_spans(graph: VersionGraph, part: Partitioning) -> Dict[int, int]:
    """Span of every full-version-retrieval query (§2.5): number of distinct
    chunks holding the version's records."""
    r2c = part.record_to_chunk
    return {v: int(np.unique(r2c[m]).size) for v, m in graph.memberships().items()}


def total_version_span(graph: VersionGraph, part: Partitioning) -> int:
    """The paper's Fig. 8 metric: Σ_v span(v)."""
    return int(sum(version_spans(graph, part).values()))


def key_spans(graph: VersionGraph, part: Partitioning) -> Dict[int, int]:
    """Span of every record-evolution query: chunks per primary key."""
    r2c = part.record_to_chunk
    keys = graph.store.keys()
    out: Dict[int, int] = {}
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    cs = r2c[order]
    bounds = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1], True])
    for i in range(len(bounds) - 1):
        lo, hi = bounds[i], bounds[i + 1]
        out[int(ks[lo])] = int(np.unique(cs[lo:hi]).size)
    return out
