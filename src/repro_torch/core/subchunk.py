"""Sub-chunk construction + transformed version tree (§3.4, Algorithm 5).

Sub-chunks group ≤ k records of one primary key that form a *connected*
subgraph of the version tree (connectivity maximizes delta-compressibility:
"records are more likely to be similar to their parents than their
siblings").  The bottom-up pass keeps, per version, a collection Ψ of pending
same-key record sets; at each version the paper's e(K)/s(K) case analysis
either seals sub-chunks or defers them upward.

The transformed version tree (Example 6) then re-expresses versions over
sub-chunks (each represented by the composite key of its shallowest record)
and deletes versions whose sub-chunk membership duplicates their parent's —
the ordinary partitioners (§3.1–3.3) run unchanged on this derived graph.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from .version_graph import RecordStore, VersionGraph


# ----------------------------------------------------------- Algorithm 5
def build_subchunks(graph: VersionGraph, k: int) -> List[np.ndarray]:
    """Partition all records into connected same-primary-key groups of ≤ k.

    Returns a list of record-id arrays in tree order (shallowest-origin
    first — the sub-chunk's delta base).  k=1 degenerates to singletons
    (the paper's no-compression case).
    """
    if k <= 1:
        return [np.array([r], dtype=np.int64) for r in range(len(graph.store))]

    store = graph.store
    keys = store.keys()
    origins = store.origin_versions()
    depth = {v: graph.depth(v) for v in graph.versions}

    # records originated per version (merge-carried records belong to their
    # true origin version, where they already entered Ψ)
    orig_at: Dict[int, List[int]] = {v: [] for v in graph.versions}
    for rid in range(len(store)):
        v = int(origins[rid])
        if v in orig_at:
            orig_at[v].append(rid)

    out: List[np.ndarray] = []

    def seal(records: List[int]) -> None:
        rs = sorted(set(records), key=lambda r: (depth[int(origins[r])], r))
        out.append(np.asarray(rs, dtype=np.int64))

    # Ψ per version: pk -> list of pending record-lists
    psi: Dict[int, Dict[int, List[List[int]]]] = {}

    for v in graph.postorder():
        children = graph.tree_children(v)
        own: Dict[int, int] = {}
        for rid in orig_at[v]:
            pk = int(keys[rid])
            if pk in own:           # same pk twice in one version cannot happen
                seal([rid])
                continue
            own[pk] = rid
        sigma: Dict[int, List[List[int]]] = {}
        for c in children:
            for pk, sets in psi.pop(c).items():
                sigma.setdefault(pk, []).extend(sets)
        for pk in own:
            sigma.setdefault(pk, [])

        mine: Dict[int, List[List[int]]] = {}
        for pk, sets in sigma.items():
            e = 1 if pk in own else 0
            s = sum(len(x) for x in sets)
            # seal largest sets until the union could fit in one sub-chunk
            while s + e > k:
                sets.sort(key=len)
                big = sets.pop()
                seal(big)
                s -= len(big)
            if e:
                merged = [own[pk]] + [r for x in sets for r in x]
                if len(merged) == k:
                    seal(merged)
                else:
                    mine[pk] = [merged]
            elif sets:
                mine[pk] = sets      # pass through unmerged (connect at ancestor)
        psi[v] = mine

    for pk, sets in psi.pop(graph.root).items():  # type: ignore[arg-type]
        for x in sets:
            seal(x)
    assert not psi

    # coverage check: every record in exactly one group
    flat = np.concatenate(out) if out else np.empty(0, np.int64)
    assert len(flat) == len(store) and len(np.unique(flat)) == len(store)
    return out


# --------------------------------------------------- transformed version tree
@dataclass
class TransformedDataset:
    tgraph: VersionGraph             # versions over sub-chunk "records"
    groups: List[np.ndarray]         # sub-chunk id -> member record ids
    rec_to_sub: np.ndarray           # record id -> sub-chunk id
    version_alias: Dict[int, int]    # original vid -> surviving tree vid


def build_transformed(graph: VersionGraph, groups: List[np.ndarray],
                      sub_sizes: Optional[np.ndarray] = None) -> TransformedDataset:
    """Build the transformed version tree over sub-chunks (Example 6)."""
    n_sub = len(groups)
    rec_to_sub = np.full(len(graph.store), -1, dtype=np.int64)
    for sid, grp in enumerate(groups):
        rec_to_sub[grp] = sid

    if sub_sizes is None:
        sizes = graph.store.sizes
        sub_sizes = np.array([int(sizes[g].sum()) for g in groups], dtype=np.int64)

    # representative composite key = shallowest member's ck
    rep_cks = np.array([int(graph.store.cks[g[0]]) for g in groups], dtype=np.int64)

    tstore = RecordStore()
    tstore.add_batch(rep_cks, sub_sizes)

    tgraph = VersionGraph(tstore)
    alias: Dict[int, int] = {}
    member_cache: Dict[int, np.ndarray] = {}

    for v in graph.versions:          # parents-before-children
        msub = np.unique(rec_to_sub[graph.members(v)])
        p = graph.tree_parent(v)
        if p is None:
            tgraph.add_root(v, msub)
            alias[v] = v
            member_cache[v] = msub
            continue
        pv = alias[p]
        pm = member_cache[pv]
        if np.array_equal(msub, pm):
            alias[v] = pv             # duplicate version — deleted (Ex. 6)
            continue
        adds = np.setdiff1d(msub, pm, assume_unique=True)
        dels = np.setdiff1d(pm, msub, assume_unique=True)
        tgraph.add_version(v, [pv], adds, dels)
        alias[v] = v
        member_cache[v] = msub

    return TransformedDataset(tgraph=tgraph, groups=groups,
                              rec_to_sub=rec_to_sub, version_alias=alias)


def compose_record_to_chunk(tds: TransformedDataset,
                            sub_to_chunk: np.ndarray) -> np.ndarray:
    """record -> chunk through the sub-chunk assignment."""
    return sub_to_chunk[tds.rec_to_sub]


def compressed_subchunk_sizes(graph: VersionGraph, groups: List[np.ndarray],
                              device=None) -> np.ndarray:
    """Actual stored size per sub-chunk (XOR-delta + zlib), requires payloads.

    Every (payloads[i-1], payloads[i]) pair of the build goes through ONE
    ``xor_delta_pairs`` call (a few, bounded by memory), not one kernel call
    per record pair."""
    import zlib

    from ..kernels import ops as kops
    origins = graph.store.origin_versions()
    depth = {v: graph.depth(v) for v in graph.versions}
    ordered_payloads: List[List[bytes]] = []
    parents: List[bytes] = []
    children: List[bytes] = []
    for grp in groups:
        ordered = sorted(grp.tolist(), key=lambda r: (depth[int(origins[r])], r))
        payloads = [graph.store.payload(r) for r in ordered]
        ordered_payloads.append(payloads)
        for i in range(1, len(ordered)):
            # delta against nearest in-group ancestor (tree order ⇒ previous
            # member on the path)
            w = max(len(payloads[i - 1]), len(payloads[i]))
            parents.append(payloads[i - 1].ljust(w, b"\0"))
            children.append(payloads[i].ljust(w, b"\0"))
    deltas, _ = kops.xor_delta_pairs(parents, children, device=device)
    sizes = np.zeros(len(groups), dtype=np.int64)
    j = 0
    for sid, payloads in enumerate(ordered_payloads):
        pieces = [payloads[0]] + deltas[j:j + len(payloads) - 1]
        j += len(payloads) - 1
        sizes[sid] = len(zlib.compress(b"".join(pieces), 6))
    return sizes
