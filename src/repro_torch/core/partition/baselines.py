"""Baseline storage schemes (§2.2, Table 1 rivals).

- SINGLE-ADDRESS: one KVS entry per record (chunk of one) — best ingest,
  no compression, span(v) = |v|.
- SUBCHUNK: all records of a primary key in one (unbounded) group — best
  storage & evolution queries, catastrophic version retrieval.
- DELTA: git-style delta chains packed into fixed-size chunks in commit
  order; reconstructing ``v`` touches every chunk holding any delta content
  on the root→v path (including records later overwritten — the reason
  key-centric queries are "abysmal").
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from ..types import Chunk, Partitioning
from ..version_graph import VersionGraph
from .base import ChunkPacker


@dataclass
class SingleAddressPartitioner:
    name: str = "single_address"

    def partition(self, graph: VersionGraph, capacity: int) -> Partitioning:
        n = len(graph.store)
        chunks = [Chunk(i, np.array([i], dtype=np.int64), int(graph.store.sizes[i]))
                  for i in range(n)]
        return Partitioning(chunks=chunks,
                            record_to_chunk=np.arange(n, dtype=np.int64),
                            algorithm=self.name)


@dataclass
class SubChunkPartitioner:
    """One group per primary key (k = ∞).  Violates the fixed-chunk-size
    assumption by design — do not validate() capacity on its output."""

    name: str = "subchunk"

    def partition(self, graph: VersionGraph, capacity: int) -> Partitioning:
        keys = graph.store.keys()
        order = np.argsort(keys, kind="stable")
        ks = keys[order]
        bounds = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1], True])
        chunks = []
        r2c = np.full(len(keys), -1, dtype=np.int64)
        sizes = graph.store.sizes
        for cid in range(len(bounds) - 1):
            rids = order[bounds[cid]:bounds[cid + 1]]
            chunks.append(Chunk(cid, np.sort(rids), int(sizes[rids].sum())))
            r2c[rids] = cid
        return Partitioning(chunks=chunks, record_to_chunk=r2c, algorithm=self.name)


@dataclass
class DeltaBaseline:
    """Delta chains.  Produces a Partitioning (records packed by commit order
    of their origin version = the physical delta stream) plus the DELTA-
    specific span semantics."""

    name: str = "delta"

    def partition(self, graph: VersionGraph, capacity: int) -> Partitioning:
        packer = ChunkPacker(graph.store.sizes, capacity)
        live = graph.live_record_mask() if graph.has_retired() else None
        for v in graph.versions:  # commit order
            adds = graph.tree_delta[v].adds
            if live is not None:
                adds = adds[live[adds]]
            packer.place_many(adds, dedupe=True)
        # no boundary merging: the stream layout *is* the baseline
        return packer.finish(self.name, merge_partial=False)

    def version_spans(self, graph: VersionGraph, part: Partitioning) -> Dict[int, int]:
        """span(v) = unique chunks holding delta content of any version on the
        root→v path (the whole chain must be read and replayed)."""
        r2c = part.record_to_chunk
        chunks_of: Dict[int, np.ndarray] = {}
        spans: Dict[int, int] = {}
        for v in graph.versions:
            own = np.unique(r2c[graph.tree_delta[v].adds])
            p = graph.tree_parent(v)
            acc = own if p is None else np.union1d(chunks_of[p], own)
            chunks_of[v] = acc
            spans[v] = int(acc.size)
        return spans

    def total_version_span(self, graph: VersionGraph, part: Partitioning) -> int:
        return int(sum(self.version_spans(graph, part).values()))
