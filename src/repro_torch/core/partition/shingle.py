"""SHINGLE partitioning (§3.1, Algorithms 1–2).

For every record, compute ``l`` min-hashes of its version-membership set
(the hand-written ``minhash`` kernel does the hashing, on ``device``), sort
records lexicographically by their shingle vectors — which places records
with highly-overlapping version sets next to each other — and pack them into
fixed-size chunks in that order.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ...device import DeviceLike
from ...kernels import ops as kops
from ..types import Partitioning
from ..version_graph import VersionGraph
from .base import ChunkPacker


@dataclass
class ShinglePartitioner:
    n_hashes: int = 8
    seed: int = 0
    name: str = "shingle"
    device: DeviceLike = None       # where the min-hash runs; None = the card

    def partition(self, graph: VersionGraph, capacity: int) -> Partitioning:
        indptr, vidx = graph.record_version_index_csr()
        a, b = kops.hash_family(self.n_hashes, self.seed)
        shingles = kops.minhash_csr(indptr, vidx, a, b,
                                    device=self.device)  # (R, L) uint32
        # lexicographic order over the shingle vector; ties broken by origin
        # version then primary key for determinism.  The shingles must stay
        # uint32 here: an int32 view would sort every hash >= 2^31 first.
        keys = graph.store.keys()
        origins = graph.store.origin_versions()
        order = np.lexsort((keys, origins) + tuple(shingles[:, l]
                           for l in range(self.n_hashes - 1, -1, -1)))
        # retention GC: a record in no version (empty CSR row — all its
        # versions were retired) is garbage and must not be re-chunked
        degree = np.diff(indptr)
        order = order[degree[order] > 0]
        packer = ChunkPacker(graph.store.sizes, capacity)
        packer.place_many(order)
        return packer.finish(self.name)
