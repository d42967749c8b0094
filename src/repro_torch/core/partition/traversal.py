"""DEPTH-FIRST / BREADTH-FIRST greedy partitioning (§3.3, Algorithm 4).

Traverse the version tree from the root; at each newly visited version, pack
the records of its Δ+ (relative to the tree parent) into the open chunk.
DFS keeps a parent's records adjacent to its descendants' (Example 5's
option (b)); BFS interleaves siblings and is uniformly worse except on
chains, where both reduce to the same order — exactly the paper's claim,
which test_partition_traversal.py asserts.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..types import Partitioning
from ..version_graph import VersionGraph
from .base import ChunkPacker


def _traverse(graph: VersionGraph, order, name: str, capacity: int) -> Partitioning:
    packer = ChunkPacker(graph.store.sizes, capacity)
    keys = graph.store.keys()
    # retention GC: deltas of retired versions may carry records reachable
    # from no retained version — a rebuild must not resurrect that garbage
    live = graph.live_record_mask() if graph.has_retired() else None
    for v in order:
        adds = graph.tree_delta[v].adds
        if live is not None:
            adds = adds[live[adds]]
        # deterministic within-delta order: by primary key
        adds = adds[np.argsort(keys[adds], kind="stable")]
        packer.place_many(adds, dedupe=True)  # dedupe: merge-sourced repeats
    return packer.finish(name)


@dataclass
class DFSPartitioner:
    name: str = "depth_first"

    def partition(self, graph: VersionGraph, capacity: int) -> Partitioning:
        return _traverse(graph, graph.dfs_order(), self.name, capacity)


@dataclass
class BFSPartitioner:
    name: str = "breadth_first"

    def partition(self, graph: VersionGraph, capacity: int) -> Partitioning:
        return _traverse(graph, graph.bfs_order(), self.name, capacity)
