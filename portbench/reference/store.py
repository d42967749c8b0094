"""The plain reference: a multi-version keyed store replayed from the op log.

It shares nothing with the program under test: it imports only numpy, reads
only the op log and the queries the benchmark generated, and answers each
query from its own replay.  The semantics are RStore's (arXiv:1802.07693,
§2.1): a version is its parent's records with the commit's writes applied
and its deletes removed; a record read at version ``v`` is the copy the
newest version at or below ``v`` on its lineage wrote; a key's evolution is
every copy ever written, oldest first, with the version that wrote it.

The versions form a tree, each commit naming its parent, which comes before
it.  So a key's copy at version ``v`` is its newest write on ``v``'s lineage
(the path from the root to ``v``), unless a delete on that path came after
it.  On a linear chain the lineage is every version ``<= v``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

DELETED = -1


class Replay:
    """Every write and delete of the op log as one table of events sorted by
    (key, version), and each version's parent.  ``commits`` come in version
    order, ``(vid, parent, keys, pids, deleted keys)``; ``payloads[pid]``
    is a payload's bytes."""

    def __init__(self, root: Tuple[np.ndarray, np.ndarray],
                 commits: Sequence[Tuple[int, int, np.ndarray, np.ndarray,
                                         np.ndarray]],
                 payloads: np.ndarray) -> None:
        keys, vids, pids = [root[0]], [np.zeros(len(root[0]), np.int64)], \
            [root[1]]
        self.parent = [-1]
        for i, (vid, parent, ks, ps, dels) in enumerate(commits):
            if vid != i + 1 or not 0 <= parent < vid:
                raise ValueError(f"version {vid} (parent {parent}): commits "
                                 "come in version order, each after its "
                                 "parent")
            self.parent.append(int(parent))
            keys += [ks, dels]
            vids += [np.full(len(ks) + len(dels), vid, np.int64)]
            pids += [ps, np.full(len(dels), DELETED, np.int64)]
        k = np.concatenate(keys).astype(np.int64)
        v = np.concatenate(vids)
        p = np.concatenate(pids).astype(np.int64)
        order = np.lexsort((v, k))
        self.k, self.v, self.p = k[order], v[order], p[order]
        self.n_versions = 1 + len(commits)
        self.payloads = payloads
        self._states: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    def payload(self, pid: int) -> bytes:
        return self.payloads[pid].tobytes()

    # ------------------------------------------------------------ versions
    def lineage(self, vid: int) -> np.ndarray:
        """Whether each version lies on the path from the root to ``vid``."""
        on = np.zeros(self.n_versions, dtype=bool)
        while vid >= 0:
            on[vid] = True
            vid = self.parent[vid]
        return on

    def state(self, vid: int) -> Tuple[np.ndarray, np.ndarray]:
        """(sorted live keys, their payload ids) at version ``vid``."""
        if not 0 <= vid < self.n_versions:
            raise KeyError(f"version {vid} was never committed")
        if vid not in self._states:
            m = self.lineage(vid)[self.v]
            k, p = self.k[m], self.p[m]
            last = np.ones(len(k), dtype=bool)
            last[:-1] = k[1:] != k[:-1]           # a key's newest event
            k, p = k[last], p[last]
            live = p != DELETED
            self._states[vid] = (k[live], p[live])
        return self._states[vid]

    def get(self, vid: int, key: int) -> Optional[int]:
        keys, pids = self.state(vid)
        i = int(np.searchsorted(keys, key))
        return int(pids[i]) if i < len(keys) and keys[i] == key else None

    def rows(self, vid: int, wanted: np.ndarray) -> Dict[int, bytes]:
        keys, pids = self.state(vid)
        wanted = np.unique(np.asarray(wanted, dtype=np.int64))
        i = np.searchsorted(keys, wanted)
        i = np.minimum(i, max(len(keys) - 1, 0))
        hit = (keys[i] == wanted) if len(keys) else np.zeros(0, bool)
        return {int(k): self.payload(int(p))
                for k, p in zip(wanted[hit], pids[i[hit]])}

    def span(self, vid: int, lo: int, hi: int) -> Dict[int, bytes]:
        keys, pids = self.state(vid)
        a, b = np.searchsorted(keys, [lo, hi + 1])
        return {int(k): self.payload(int(p))
                for k, p in zip(keys[a:b], pids[a:b])}

    def history(self, key: int) -> List[Tuple[int, bytes]]:
        a, b = np.searchsorted(self.k, [key, key + 1])
        return [(int(v), self.payload(int(p)))
                for v, p in zip(self.v[a:b], self.p[a:b]) if p != DELETED]


def answer(rep: Replay, q: Tuple):
    """The value RStore's ``Q`` query of the same tuple must return: bytes
    or None for a record, a dict of key to bytes for the set queries, a
    list of (version, bytes) for an evolution.  A whole version is returned
    as its (sorted keys, payload ids), which :func:`same_version` compares
    without building a dict."""
    kind = q[0]
    if kind == "version":
        return rep.state(q[1])
    if kind == "record":
        pid = rep.get(q[1], q[2])
        return None if pid is None else rep.payload(pid)
    if kind == "records":
        return rep.rows(q[1], np.asarray(q[2]))
    if kind == "range":
        return rep.span(q[1], q[2], q[3])
    if kind == "evolution":
        return rep.history(q[1])
    if kind == "or_record_range":
        out = rep.span(q[1], q[3], q[4])
        out.update(rep.rows(q[1], np.asarray([q[2]])))
        return out
    if kind == "and_range_records":
        ks = np.asarray(q[4], dtype=np.int64)
        return rep.rows(q[1], ks[(ks >= q[2]) & (ks <= q[3])])
    raise ValueError(f"unknown query kind {kind!r}")


def same_version(got, want: Tuple[np.ndarray, np.ndarray],
                 payloads: np.ndarray) -> bool:
    """Whether a version's answer (a dict of key to bytes) holds exactly
    the reference's keys with exactly their payloads."""
    keys, pids = want
    if not isinstance(got, dict) or len(got) != len(keys):
        return False
    try:
        joined = b"".join([got[k] for k in keys.tolist()])
    except KeyError:
        return False
    return joined == payloads[pids].tobytes()


def same(got, q: Tuple, want, payloads: np.ndarray) -> bool:
    if q[0] == "version":
        return same_version(got, want, payloads)
    if q[0] == "evolution":
        return isinstance(got, (list, tuple)) and \
            [tuple(x) for x in got] == want
    return got == want
