"""BOTTOM-UP partitioning (§3.2, Algorithm 3) — the paper's best algorithm.

The version tree is processed children-before-parent.  Each processed version
``v`` hands its parent a collection π_v of record sets tagged with a *depth*:
the number of consecutive versions (starting at ``v``, going down) known to
contain those records.  At ``v``:

  - a child set ``(j, S)`` splits into ``S ∩ members(v)`` (consecutive run
    extends: depth ``j+1`` in π_v) and ``S \\ members(v)`` (the run breaks —
    these are the paper's α sets and are *finalized*, i.e. chunked now,
    deepest-first, starting a fresh chunk at each version);
  - records of ``v`` present in no child form the new depth-1 set S_v^1.

At the root everything remaining is finalized.  Two paper-specified
refinements for general trees are implemented: sets of equal depth coming
from different children are unioned ("sets from different children that
correspond to same number of consecutive versions are chunked together"),
and duplicates (records reachable via several branches after the Fig. 4
DAG→tree conversion) are dropped at placement time via the packer's placed
bitmap ("a hash-table is maintained to identify records that have already
been chunked").

β subtree control (§3.2.1): when π_v holds more than β depth-sets, the
deepest set is merged into the next-deepest until |π_v| ≤ β — the exact
"merge leaves into parents" reduction specialized to the depth-collection
representation.  Partial chunks are merged at the end (the paper's
fragmentation cleanup).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from ..types import Partitioning
from ..version_graph import VersionGraph
from .base import ChunkPacker


def _mask(n: int, ids: np.ndarray) -> np.ndarray:
    """Boolean membership mask over ``n`` record ids.  The sets here are
    sorted-unique record-id arrays, so ``a[mask[a]]`` is exactly
    ``intersect1d(a, ids)`` (and ``a[~mask[a]]`` ``setdiff1d``) without a
    sort."""
    m = np.zeros(n, dtype=bool)
    m[ids] = True
    return m


@dataclass
class BottomUpPartitioner:
    beta: int = 64          # §3.2.1 subtree (set-collection) bound
    name: str = "bottom_up"

    def partition(self, graph: VersionGraph, capacity: int) -> Partitioning:
        packer = ChunkPacker(graph.store.sizes, capacity)
        # π per processed version: dict depth -> sorted record-id array
        pis: Dict[int, Dict[int, np.ndarray]] = {}

        n_rec = len(graph.store)
        for v in graph.postorder():
            members = graph.members(v)
            children = graph.tree_children(v)
            pi_v: Dict[int, np.ndarray] = {}
            finalized: List[Tuple[int, np.ndarray]] = []

            in_v = _mask(n_rec, members) if children else None
            for c in children:
                pi_c = pis.pop(c)
                for depth, s in pi_c.items():
                    hit = in_v[s]
                    stay = s[hit]
                    gone = s[~hit]
                    if gone.size:
                        finalized.append((depth, gone))
                    if stay.size:
                        d = depth + 1
                        pi_v[d] = (np.union1d(pi_v[d], stay)
                                   if d in pi_v else stay)

            # records of v in no child → new depth-1 set
            fresh = (members[~_mask(n_rec, np.concatenate(list(pi_v.values())))
                             [members]]
                     if pi_v else members)
            if fresh.size:
                pi_v[1] = np.union1d(pi_v[1], fresh) if 1 in pi_v else fresh

            # β control: cap the number of depth-sets by merging deepest pairs
            while len(pi_v) > self.beta:
                depths = sorted(pi_v)
                d1 = depths[-1]            # deepest
                d2 = depths[-2]
                pi_v[d2] = np.union1d(pi_v[d2], pi_v.pop(d1))

            # chunk finalized α sets, deepest (most-consecutive) first; a new
            # chunk starts at every version's finalization step
            if finalized:
                packer.boundary()
                for depth, s in sorted(finalized, key=lambda t: -t[0]):
                    packer.place_many(s, dedupe=True)

            pis[v] = pi_v

        # root: everything still in flight is finalized, deepest-first
        root_pi = pis.pop(graph.root)  # type: ignore[arg-type]
        packer.boundary()
        for depth in sorted(root_pi, reverse=True):
            packer.place_many(root_pi[depth], dedupe=True)

        return packer.finish(self.name)
