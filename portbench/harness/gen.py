"""The one traffic generator: a seeded op log and the requests of a mix.

The data is the RStore paper's dataset family A (arXiv:1802.07693, §5.1):
versions each touching a share of their parent's live records chosen
uniformly, split into modifies, inserts and deletes, records of a fixed
size.  With ``p_d`` a modified record differs from its parent in one
contiguous span of ``int(record_size * p_d)`` bytes; without it, it is
drawn anew.  The pattern is ``chip_smoke.py``'s ``Chain``, vectorised and
frozen here: the generator keeps no oracle, the op log is what both sides
get.

The versions form a tree: the traffic kind gives each commit its parent
(:func:`make_log`), and each branch keeps its own live records.  A2's linear
chain is the tree in which every parent is the version before
(:func:`chain`, :func:`make_chain`).  Keys are issued in order over the
whole tree, so two branches never insert the same key.

A traffic mix is a data file (``traffic/<mix>.json``).  Read mixes list the
queries of one request (a wave) by kind and say how versions are chosen;
every kind below is built here, so a mix that recombines them needs no
code.  Versions follow the golden-ratio sequence (:func:`versions_of`).  Requests are plain tuples: the
program side turns them into ``Q`` queries (:func:`to_queries`), the
reference answers the same tuples.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclass
class Commit:
    """One version of the tree: its parent, the records it writes (keys
    and payload ids, modifies then inserts) and the keys it deletes."""

    vid: int
    parent: int
    keys: np.ndarray
    pids: np.ndarray
    dels: np.ndarray


@dataclass
class OpLog:
    """A root and its commits, in version order, over a pool of payload
    rows: payload id ``i`` is ``payloads[i]``.  Keys are issued in order, so
    every key ever issued lies in ``[0, max_key)``."""

    record_size: int
    n_base: int
    payloads: np.ndarray                    # (n_payloads, record_size) uint8
    root_keys: np.ndarray
    root_pids: np.ndarray
    commits: List[Commit] = field(default_factory=list)
    max_key: int = 0

    @property
    def n_versions(self) -> int:
        return 1 + len(self.commits)

    def records_of(self, vid: int) -> int:
        """Records version ``vid`` writes (its whole root for 0)."""
        return (len(self.root_keys) if vid == 0
                else len(self.commits[vid - 1].keys))


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one named stream of a run's seed (any integer)."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


# The shapes this generator makes; a configuration that states another is
# refused rather than quietly generated as one of these.
SHAPE = {"family": ("A",), "topology": ("linear_chain", "tree"),
         "update_dist": ("random",)}


def chain(n_versions: int) -> List[int]:
    """The parents of a linear chain's versions ``1..n_versions-1``."""
    return list(range(n_versions - 1))


def check_shape(data: Dict, parents: Sequence[int]) -> None:
    """Refuse a ``data`` block that states a shape :func:`make_log` does
    not make, or a ``linear_chain`` whose ``parents`` branch, naming the
    key."""
    for key, made in SHAPE.items():
        if data.get(key) not in made:
            raise ValueError(f"data.{key} = {data.get(key)!r}: the generator "
                             f"makes only {' or '.join(map(repr, made))}")
    if data["topology"] == "linear_chain" and list(parents) != \
            chain(len(parents) + 1):
        raise ValueError("data.topology = 'linear_chain', but the traffic "
                         "kind gives its versions other parents")
    total = sum(float(data[k]) for k in
                ("frac_modify", "frac_insert", "frac_delete"))
    if abs(total - 1.0) > 1e-9:
        raise ValueError(f"data.frac_modify + frac_insert + frac_delete = "
                         f"{total}, not 1: inserts are the rest")


def make_chain(data: Dict, n_base: int, n_versions: int, seed: int
               ) -> OpLog:
    """The op log of an A-family chain: a root of ``n_base`` records and
    ``n_versions - 1`` commits, each on the one before."""
    return make_log(data, n_base, chain(n_versions), seed)


def make_log(data: Dict, n_base: int, parents: Sequence[int], seed: int
             ) -> OpLog:
    """The op log of an A-family tree: a root of ``n_base`` records and one
    commit for each entry of ``parents``, version ``v`` on ``parents[v -
    1]``.  Commits are drawn in version order from one stream, so a chain
    gives the same log whatever else the tree could have held."""
    parents = [int(p) for p in parents]
    check_shape(data, parents)
    last_child: Dict[int, int] = {}     # version -> its newest child
    for vid, parent in enumerate(parents, 1):
        if not 0 <= parent < vid:
            raise ValueError(f"version {vid} cannot have the parent "
                             f"{parent}: a parent comes before its child")
        last_child[parent] = vid
    rng = rng_for(seed, 1)
    R = int(data["record_size"])
    span = (None if data.get("p_d") is None
            else max(1, int(R * float(data["p_d"]))))
    pct, f_mod, f_del = (float(data["pct_update"]), float(data["frac_modify"]),
                         float(data["frac_delete"]))

    def fresh(n: int) -> np.ndarray:
        return np.frombuffer(rng.bytes(n * R), dtype=np.uint8).reshape(n, R)

    rows = [fresh(n_base)]                  # payload rows, in id order
    n_pay = n_base
    live = np.arange(n_base, dtype=np.int64)
    log = OpLog(R, n_base, rows[0], live.copy(), live.copy(), [], n_base)
    # a version a later commit builds on: (its live keys, key -> its payload
    # id there); its newest child takes the arrays over, the others copy
    heads = {0: (live, live.copy())}
    for vid, parent in enumerate(parents, 1):
        if last_child[parent] == vid:
            live, cur = heads.pop(parent)
        else:
            live, cur = (a.copy() for a in heads[parent])
        n_sel = max(1, int(len(live) * pct))
        idx = rng.choice(len(live), size=n_sel, replace=False)
        n_mod, n_del = int(n_sel * f_mod), int(n_sel * f_del)
        n_ins = n_sel - n_mod - n_del
        mod = live[idx[:n_mod]]
        dels = live[idx[n_mod:n_mod + n_del]]
        new = np.arange(log.max_key, log.max_key + n_ins, dtype=np.int64)
        log.max_key += n_ins
        if span is None:                    # a modify draws a new payload
            changed = fresh(n_mod)
        else:                               # ... or rewrites one span of it
            rows = [np.concatenate(rows)]
            changed = rows[0][cur[mod]].copy()
            offs = rng.integers(0, R - span + 1, size=n_mod)
            changed[np.arange(n_mod)[:, None],
                    offs[:, None] + np.arange(span)[None, :]] = \
                fresh(n_mod)[:, :span]
        rows.append(np.concatenate([changed, fresh(n_ins)]))
        pids = np.arange(n_pay, n_pay + n_mod + n_ins, dtype=np.int64)
        n_pay += n_mod + n_ins
        keys = np.concatenate([mod, new])
        if len(cur) < log.max_key:
            grown = np.full(max(log.max_key, 2 * len(cur)), -1, np.int64)
            grown[:len(cur)] = cur
            cur = grown
        cur[keys] = pids
        keep = np.ones(len(live), dtype=bool)
        keep[idx[n_mod:n_mod + n_del]] = False
        live = np.concatenate([live[keep], new])
        log.commits.append(Commit(vid, parent, keys, pids, dels))
        if vid in last_child:
            heads[vid] = (live, cur)
    log.payloads = np.concatenate(rows) if len(rows) > 1 else rows[0]
    return log


def version_dicts(log: OpLog, first: int, last: int
                  ) -> List[Tuple[int, Dict[int, bytes], List[int]]]:
    """``(parent, adds, dels)`` of versions ``first..last-1`` in the form
    ``WriteSession.commit`` takes (parent -1 for the root)."""
    blob, R = log.payloads.tobytes(), log.record_size
    out = []
    for v in range(first, last):
        if v == 0:
            keys, pids, parent, dels = log.root_keys, log.root_pids, -1, []
        else:
            c = log.commits[v - 1]
            keys, pids, parent, dels = c.keys, c.pids, c.parent, \
                c.dels.tolist()
        offs = (pids * R).tolist()
        out.append((parent, dict(zip(keys.tolist(),
                                     [blob[o:o + R] for o in offs])), dels))
    return out


# ------------------------------------------------------------------ requests
# A request is a tuple of queries; a query is a tuple whose first item is
# its kind:
#   ("version", v)            ("record", v, k)        ("records", v, keys)
#   ("range", v, lo, hi)      ("evolution", k)
#   ("or_record_range", v, k, lo, hi)
#   ("and_range_records", v, lo, hi, keys)
QueryT = Tuple


def _query(kind: str, spec: Dict, v: int, log: OpLog,
           rng: np.random.Generator) -> QueryT:
    key = lambda: int(rng.integers(0, log.max_key))  # noqa: E731
    span = int(spec.get("span", 256))
    if kind == "version":
        return ("version", v)
    if kind == "record":
        return ("record", v, key())
    if kind == "records":
        return ("records", v, tuple(key() for _ in range(int(spec["keys"]))))
    if kind == "range":
        lo = key()
        return ("range", v, lo, lo + span - 1)
    if kind == "evolution":
        hi = log.n_base if spec.get("key_pool") == "base" else log.max_key
        return ("evolution", int(rng.integers(0, hi)))
    if kind == "or_record_range":
        k, lo = key(), key()
        return ("or_record_range", v, k, lo, lo + span - 1)
    if kind == "and_range_records":
        lo = key()
        spread = int(spec.get("key_spread", 2 * span))
        ks = tuple(lo + int(x) for x in
                   rng.integers(0, spread, int(spec["keys"])))
        return ("and_range_records", v, lo, lo + span - 1, ks)
    raise ValueError(f"unknown query kind {kind!r} in the traffic mix")


GOLDEN = (5 ** 0.5 - 1) / 2


def versions_of(n_versions: int, n: int, rng: np.random.Generator
                ) -> np.ndarray:
    """The version of each of ``n`` requests: the golden-ratio sequence from
    a start drawn from the seed, so that every stretch of requests, whatever
    its length, visits the versions evenly: each seed gets the same spread
    of versions in another order, and the work of a window depends little
    on the seed."""
    u = (rng.random() + GOLDEN * np.arange(n)) % 1.0
    return np.minimum((u * n_versions).astype(np.int64), n_versions - 1)


def read_requests(mix: Dict, log: OpLog, seed: int, n: int, stream: int = 2
                  ) -> List[Tuple[QueryT, ...]]:
    """``n`` requests of a read mix: each a wave at one version (see
    :func:`versions_of`); an entry whose ``query`` is a list takes its kinds
    in turn, one a request."""
    rng = rng_for(seed, stream)
    vids = versions_of(log.n_versions, n, rng).tolist()
    out = []
    for i in range(n):
        v = vids[i]
        wave: List[QueryT] = []
        for spec in mix["wave"]:
            kinds = spec["query"]
            kind = kinds[i % len(kinds)] if isinstance(kinds, list) else kinds
            for _ in range(int(spec.get("count", 1))):
                wave.append(_query(kind, spec, v, log, rng))
        out.append(tuple(wave))
    return out


def shift_versions(q: QueryT, by: int) -> QueryT:
    """The same query asked ``by`` versions earlier (never below 0)."""
    if q[0] == "evolution":
        return q
    return (q[0], max(0, q[1] - by), *q[2:])


def to_queries(Q, request: Sequence[QueryT], stale: int = 0) -> list:
    """The program's ``Q`` queries for one request (``stale`` versions
    earlier when a control asks for it)."""
    out = []
    for q in request:
        q = shift_versions(q, stale) if stale else q
        kind = q[0]
        if kind == "version":
            out.append(Q.version(q[1]))
        elif kind == "record":
            out.append(Q.record(q[1], q[2]))
        elif kind == "records":
            out.append(Q.records(q[1], list(q[2])))
        elif kind == "range":
            out.append(Q.range(q[1], q[2], q[3]))
        elif kind == "evolution":
            out.append(Q.evolution(q[1]))
        elif kind == "or_record_range":
            out.append(Q.or_(Q.record(q[1], q[2]), Q.range(q[1], q[3], q[4])))
        elif kind == "and_range_records":
            out.append(Q.and_(Q.range(q[1], q[2], q[3]),
                              Q.records(q[1], list(q[4]))))
        else:
            raise ValueError(f"unknown query kind {kind!r}")
    return out
