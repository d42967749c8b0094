"""Synthetic versioned-dataset generator (§5.1).

Reproduces the paper's experimental data construction: a version graph is
grown from a single root ("method outlined in [4]" — versions either extend
the current head, branch off an existing version, or merge), and every
non-root version updates/deletes/inserts a configurable fraction of its
parent's records, with record selection either uniform ("Random") or Zipf
("Skewed").  For compression studies, a modified record differs from its
parent payload by at most ``p_d`` (the paper's P_d knob).

Everything is deterministic given ``seed``.  Payload generation is optional —
span/partitioning experiments only need record sizes, matching the paper's
use of chunk-count as the storage/retrieval proxy.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

import numpy as np

from .types import pack_ck_array
from .version_graph import RecordStore, VersionGraph


@dataclass(frozen=True)
class DatasetSpec:
    """Knobs mirror Table 2's dataset dimensions."""

    n_versions: int = 100
    n_base_records: int = 1000
    pct_update: float = 0.05          # fraction of parent records changed/version
    update_dist: str = "random"       # "random" | "zipf"  (paper: Random/Skewed)
    zipf_a: float = 1.2
    frac_modify: float = 0.90         # of the selected records: modify
    frac_insert: float = 0.05         # new primary keys (relative count)
    frac_delete: float = 0.05
    record_size: int = 256            # mean payload bytes
    size_sigma: float = 0.0           # lognormal sigma (0 = fixed size)
    p_d: Optional[float] = None       # bounded per-record change (compression)
    branch_prob: float = 0.0          # 0 → linear chain (dataset A/B family)
    merge_prob: float = 0.0          # DAG merges (exercises Fig. 4 conversion)
    payloads: bool = False
    # structured prefix for secondary-index experiments: the first
    # 4*attr_fields bytes of every payload are little-endian uint32
    # attribute values drawn uniformly from [0, attr_cardinality) — the
    # layout core/secondary.py's datagen_extractor(attr_fields) reads
    attr_fields: int = 0
    attr_cardinality: int = 256
    seed: int = 0

    def label(self) -> str:
        return (f"v{self.n_versions}_r{self.n_base_records}_u{self.pct_update}"
                f"_{self.update_dist}_b{self.branch_prob}_s{self.seed}")


# Scaled-down analogues of the paper's Table 2 datasets (same structure,
# container-sized).  Names match the paper's.
PAPER_DATASETS: Dict[str, DatasetSpec] = {
    # A-family: deep linear chains
    "A0": DatasetSpec(n_versions=300, n_base_records=4000, pct_update=0.50,
                      update_dist="random", branch_prob=0.0, seed=10),
    "A1": DatasetSpec(n_versions=300, n_base_records=4000, pct_update=0.05,
                      update_dist="zipf", branch_prob=0.0, seed=11),
    "A2": DatasetSpec(n_versions=300, n_base_records=4000, pct_update=0.05,
                      update_dist="random", branch_prob=0.0, seed=12),
    # B-family: mostly-deep trees
    "B0": DatasetSpec(n_versions=1001, n_base_records=2000, pct_update=0.05,
                      update_dist="zipf", branch_prob=0.02, seed=20),
    "B1": DatasetSpec(n_versions=1001, n_base_records=2000, pct_update=0.05,
                      update_dist="random", branch_prob=0.02, seed=21),
    "B2": DatasetSpec(n_versions=1001, n_base_records=2000, pct_update=0.10,
                      update_dist="random", branch_prob=0.02, seed=22),
    # C-family: many versions, shallower trees
    "C0": DatasetSpec(n_versions=2000, n_base_records=1000, pct_update=0.10,
                      update_dist="random", branch_prob=0.10, seed=30),
    "C1": DatasetSpec(n_versions=2000, n_base_records=1000, pct_update=0.01,
                      update_dist="random", branch_prob=0.10, seed=31),
    "C2": DatasetSpec(n_versions=2000, n_base_records=1000, pct_update=0.05,
                      update_dist="zipf", branch_prob=0.10, seed=32),
    # D-family: shallow bushy trees
    "D0": DatasetSpec(n_versions=2000, n_base_records=1000, pct_update=0.10,
                      update_dist="random", branch_prob=0.25, seed=40),
    "D1": DatasetSpec(n_versions=2000, n_base_records=1000, pct_update=0.01,
                      update_dist="random", branch_prob=0.25, seed=41),
    "D2": DatasetSpec(n_versions=2000, n_base_records=1000, pct_update=0.05,
                      update_dist="zipf", branch_prob=0.25, seed=42),
}


def _sizes(rng: np.random.Generator, n: int, spec: DatasetSpec) -> np.ndarray:
    if spec.size_sigma <= 0:
        return np.full(n, spec.record_size, dtype=np.int64)
    s = rng.lognormal(mean=np.log(spec.record_size), sigma=spec.size_sigma, size=n)
    return np.maximum(8, s).astype(np.int64)


def _payload(rng: np.random.Generator, size: int,
             spec: Optional[DatasetSpec] = None) -> bytes:
    raw = rng.integers(0, 256, size=size, dtype=np.uint8)
    if spec is not None and spec.attr_fields > 0:
        vals = rng.integers(0, spec.attr_cardinality,
                            size=spec.attr_fields, dtype=np.uint32)
        pre = np.frombuffer(vals.astype("<u4").tobytes(), dtype=np.uint8)
        if len(raw) < len(pre):       # payload grows to fit the attr prefix
            raw = np.concatenate([raw, np.zeros(len(pre) - len(raw),
                                                np.uint8)])
        raw[:len(pre)] = pre
    return raw.tobytes()


def _mutate(rng: np.random.Generator, parent: bytes, p_d: Optional[float],
            spec: Optional[DatasetSpec] = None) -> bytes:
    """Child payload: contiguous block rewrite bounded by P_d (or full rewrite)."""
    if p_d is None:
        return _payload(rng, len(parent), spec)
    n = len(parent)
    span = max(1, int(n * p_d))
    off = int(rng.integers(0, max(1, n - span + 1)))
    buf = bytearray(parent)
    buf[off:off + span] = _payload(rng, span)
    return bytes(buf)


def generate(spec: DatasetSpec) -> VersionGraph:
    rng = np.random.default_rng(spec.seed)
    store = RecordStore()
    graph = VersionGraph(store)

    # ---- root version --------------------------------------------------
    n0 = spec.n_base_records
    keys0 = np.arange(n0, dtype=np.int64)
    cks0 = pack_ck_array(keys0, np.zeros(n0, dtype=np.int64))
    sizes0 = _sizes(rng, n0, spec)
    payloads0 = ([_payload(rng, int(s), spec) for s in sizes0]
                 if spec.payloads else None)
    rids0 = store.add_batch(cks0, sizes0, payloads0)
    graph.add_root(0, rids0)

    next_key = n0
    head = 0                           # current chain head
    # latest record id per (version, primary key) is derivable from membership;
    # we keep a per-version dict for parent lookup during generation.
    key_to_rid: Dict[int, Dict[int, int]] = {0: dict(zip(keys0.tolist(), rids0.tolist()))}

    for vid in range(1, spec.n_versions):
        # ---- choose parent(s): extend head, branch, or merge ----------
        r = rng.random()
        if r < spec.branch_prob and vid > 2:
            parent = int(rng.integers(0, vid))
        else:
            parent = head
        parents = [parent]
        if spec.merge_prob > 0 and vid > 3 and rng.random() < spec.merge_prob:
            other = int(rng.integers(0, vid))
            if other != parent:
                parents.append(other)

        pmap = key_to_rid[parent]
        pkeys = np.fromiter(pmap.keys(), dtype=np.int64, count=len(pmap))

        # ---- merge: pull in keys exclusive to the second parent (Fig. 4)
        merged_extra: Dict[int, int] = {}
        if len(parents) > 1:
            omap = key_to_rid[parents[1]]
            for k, rid in omap.items():
                if k not in pmap:
                    merged_extra[k] = rid

        # ---- pick records to change -----------------------------------
        n_sel = max(1, int(len(pkeys) * spec.pct_update))
        if spec.update_dist == "zipf":
            w = 1.0 / np.power(pkeys + 1.0, spec.zipf_a)
            w /= w.sum()
            sel = rng.choice(pkeys, size=min(n_sel, len(pkeys)), replace=False, p=w)
        else:
            sel = rng.choice(pkeys, size=min(n_sel, len(pkeys)), replace=False)

        tot = spec.frac_modify + spec.frac_insert + spec.frac_delete
        n_mod = int(len(sel) * spec.frac_modify / tot)
        n_del = int(len(sel) * spec.frac_delete / tot)
        n_ins = max(0, len(sel) - n_mod - n_del)
        mod_keys = sel[:n_mod]
        del_keys = sel[n_mod:n_mod + n_del]

        # ---- build delta ------------------------------------------------
        new_keys = np.arange(next_key, next_key + n_ins, dtype=np.int64)
        next_key += n_ins
        add_keys = np.concatenate([mod_keys, new_keys])
        add_cks = pack_ck_array(add_keys, np.full(len(add_keys), vid, dtype=np.int64))
        add_sizes = np.concatenate([
            # modified records keep their parent's size (bounded change)
            np.array([store.size_of(pmap[int(k)]) for k in mod_keys],
                     dtype=np.int64)
            if n_mod else np.empty(0, np.int64),
            _sizes(rng, n_ins, spec),
        ])
        add_payloads = None
        if spec.payloads:
            add_payloads = [
                _mutate(rng, store.payload(pmap[int(k)]), spec.p_d, spec)
                for k in mod_keys
            ] + [_payload(rng, int(s), spec) for s in add_sizes[n_mod:]]
        add_rids = store.add_batch(add_cks, add_sizes, add_payloads)

        del_rids = np.array(
            [pmap[int(k)] for k in np.concatenate([mod_keys, del_keys])],
            dtype=np.int64)
        # merged-in records count as adds relative to the retained parent
        merge_rids = np.array([rid for k, rid in merged_extra.items()
                               if k not in set(del_keys.tolist())], dtype=np.int64)
        all_adds = np.concatenate([add_rids, merge_rids])

        graph.add_version(vid, parents, all_adds, del_rids)

        # ---- update bookkeeping ----------------------------------------
        cmap = dict(pmap)
        for k, rid in merged_extra.items():
            cmap[int(k)] = rid
        for k in del_keys:
            cmap.pop(int(k), None)
        for k, rid in zip(add_keys.tolist(), add_rids.tolist()):
            cmap[int(k)] = rid
        key_to_rid[vid] = cmap
        head = vid

    return graph


def dataset_stats(graph: VersionGraph) -> Dict[str, float]:
    sizes = graph.store.sizes
    vsz = graph.version_sizes()
    return {
        "versions": graph.num_versions,
        "unique_records": len(graph.store),
        "unique_bytes": int(sizes.sum()),
        "total_bytes": int(sum(vsz.values())),
        "avg_depth": graph.avg_depth(),
        "avg_records_per_version": graph.total_entries() / graph.num_versions,
    }
