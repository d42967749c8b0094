"""Lossy projections + posting-list compression (§2.4, Fig. 3b).

Two in-memory maps answer "which chunks might hold what I need":
  - version→chunks (drives Q1 full version retrieval),
  - key→chunks     (drives Q3 record evolution).
Record/range retrieval ANDs the two (index-ANDing) over chunk-membership
bitmaps — the planner (``core/plan.py``) builds the rows with
:meth:`Projections._bitmap_of` and runs them through the bitmap VM; the
``candidates*`` API plans a whole session of index-AND queries in ONE
``and_popcount`` kernel launch (``candidates_batch``), and range predicates locate their keys via ``searchsorted`` over a cached sorted
key array rather than scanning the key dictionary.  Both lists are
*lossy*: a fetched chunk may turn out to hold no relevant record (the paper
notes this explicitly); the exact information lives in the per-chunk maps.

Posting lists are stored delta+varint compressed (the paper's pointer to the
inverted-index literature) with ``compressed_size`` exposed so benchmarks can
reproduce the §2.4 index-size discussion.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..device import DeviceLike
from ..kernels import ops as kops
from .types import Partitioning
from .version_graph import VersionGraph


# ------------------------------------------------------------------- varints
def varint_encode(arr: np.ndarray) -> bytes:
    """Delta + LEB128 varint encoding of a sorted non-negative int array.

    Vectorized: byte counts, byte values, and continuation bits are computed
    for the whole array at once; the only Python loop is over the (≤10)
    byte *positions* of the widest delta, not over array elements.  The byte
    format is the classic little-endian 7-bit-group LEB128 the original
    per-element loop produced.
    """
    a = np.asarray(arr, dtype=np.int64)
    if len(a) == 0:
        return b""
    d = np.empty(len(a), dtype=np.uint64)
    d[0] = a[0]
    np.subtract(a[1:], a[:-1], out=d[1:], casting="unsafe")
    # bytes needed per delta: ceil(bit_length / 7), minimum 1
    nbytes = np.ones(len(d), dtype=np.int64)
    rest = d >> np.uint64(7)
    while rest.any():
        nbytes += (rest > 0)
        rest >>= np.uint64(7)
    ends = np.cumsum(nbytes)
    starts = ends - nbytes
    out = np.empty(int(ends[-1]), dtype=np.uint8)
    for j in range(int(nbytes.max())):
        m = nbytes > j
        b = ((d[m] >> np.uint64(7 * j)) & np.uint64(0x7F)).astype(np.uint8)
        cont = (nbytes[m] - 1 > j).astype(np.uint8) << 7
        out[starts[m] + j] = b | cont
    return out.tobytes()


def varint_decode(buf: bytes) -> np.ndarray:
    """Inverse of :func:`varint_encode` (vectorized).

    Each encoded group's bytes are OR'd into its value in one scatter per
    byte *position*; a trailing incomplete group (continuation bit set on
    the final byte) is discarded, matching the original decoder.
    """
    a = np.frombuffer(buf, dtype=np.uint8)
    if len(a) == 0:
        return np.empty(0, dtype=np.int64)
    is_last = (a & 0x80) == 0
    n_groups = int(is_last.sum())
    # group index of every byte: groups end at terminator bytes
    grp = np.zeros(len(a), dtype=np.int64)
    grp[1:] = np.cumsum(is_last[:-1])
    idx = np.arange(len(a), dtype=np.int64)
    group_start = np.empty(n_groups + 1, dtype=np.int64)
    group_start[0] = 0
    group_start[1:] = idx[is_last] + 1
    pos = idx - group_start[grp]
    vals = np.zeros(n_groups, dtype=np.uint64)
    complete = grp < n_groups          # drop a trailing incomplete group
    np.bitwise_or.at(
        vals, grp[complete],
        (a[complete] & np.uint8(0x7F)).astype(np.uint64)
        << (np.uint64(7) * pos[complete].astype(np.uint64)))
    return np.cumsum(vals.astype(np.int64))


# --------------------------------------------------------------- projections
@dataclass
class Projections:
    version_chunks: Dict[int, np.ndarray]   # vid -> sorted chunk ids
    key_chunks: Dict[int, np.ndarray]       # pk  -> sorted chunk ids
    n_chunks: int
    # sorted primary-key array (lazy cache) backing O(log n) range lookups.
    # Staleness contract: the cache covers the key *set* only (not the
    # posting lists), and _keys_dirty is set explicitly by every mutation
    # that can grow the key set (extend_keys) — adding chunks to an
    # *existing* key leaves the cache valid and does not rebuild it.
    _sorted_keys: Optional[np.ndarray] = field(default=None, repr=False,
                                               compare=False)
    _keys_dirty: bool = field(default=True, repr=False, compare=False)

    # -------------------------------------------------------------- building
    @staticmethod
    def build(graph: VersionGraph, part: Partitioning) -> "Projections":
        """Build both projections from a record→chunk map.  Unplaced records
        (``r2c == -1``: retention garbage dropped by compaction or a
        retention-aware rebuild) are simply absent from the index."""
        r2c = part.record_to_chunk
        vc = {}
        for v, m in graph.memberships().items():
            cs_v = np.unique(r2c[m])
            vc[v] = cs_v[cs_v >= 0]
        keys = graph.store.keys()
        placed = r2c >= 0
        kc = dict(zip(*_postings(keys[placed], r2c[placed])))
        return Projections(version_chunks=vc, key_chunks=kc,
                           n_chunks=part.num_chunks)

    @staticmethod
    def build_from_r2c(graph: VersionGraph, r2c: np.ndarray,
                       n_chunks: int) -> "Projections":
        class _P:  # minimal Partitioning stand-in
            record_to_chunk = r2c
            num_chunks = n_chunks
        return Projections.build(graph, _P())  # type: ignore[arg-type]

    # -------------------------------------------------------------- lookups
    def chunks_for_version(self, vid: int) -> np.ndarray:
        return self.version_chunks[vid]

    def chunks_for_key(self, pk: int) -> np.ndarray:
        return self.key_chunks.get(pk, np.empty(0, np.int64))

    # ------------------------------------------------------- index-ANDing
    def _bitmap_of(self, chunk_ids: np.ndarray) -> np.ndarray:
        W = (self.n_chunks + 31) // 32
        bm = np.zeros(W, dtype=np.uint32)
        np.bitwise_or.at(bm, chunk_ids // 32,
                         np.uint32(1) << (chunk_ids % 32).astype(np.uint32))
        return bm

    def candidates(self, vid: int, pks: Iterable[int], *,
                   device: DeviceLike = None) -> np.ndarray:
        """Chunks possibly holding records of any of ``pks`` within version
        ``vid``: AND of the key bitmaps with the version bitmap, OR'd across
        keys.  Single-query form of :meth:`candidates_batch`."""
        return self.candidates_batch([(vid, pks)], device=device)[0]

    def candidates_batch(
            self, items: Sequence[Tuple[int, Iterable[int]]], *,
            device: DeviceLike = None) -> List[np.ndarray]:
        """Plan a whole batch of index-AND queries in ONE kernel launch.

        ``items`` is a list of ``(vid, pks)`` pairs — one per point/multi-
        point/range query in a session.  Per query, the key posting lists
        are OR'd on the host (cheap: W words each) into one row; the rest
        is :meth:`and_version_batch`.
        """
        return self.and_version_batch(
            [(vid, [self.key_chunks.get(pk) for pk in pks])
             for vid, pks in items], device=device)

    def and_version_batch(
            self, items: Sequence[Tuple[int, Sequence[Optional[np.ndarray]]]],
            *, device: DeviceLike = None) -> List[np.ndarray]:
        """AND arbitrary chunk-id posting lists against version bitmaps in
        ONE pairwise kernel launch on ``device`` (``None`` = the card).

        Each item is ``(vid, posting_lists)``: the posting lists (any
        chunk-granularity source — primary-key postings, secondary-attribute
        postings; ``None``/empty entries allowed) are OR'd into one bitmap
        row, and the N OR'd rows are AND'd pairwise against the N version
        rows by a single ``and_popcount_batch`` call (the (N, W) & (N, W)
        kernel path).  Returns one sorted chunk-id array per item.
        """
        if not items:
            return []
        W = (self.n_chunks + 31) // 32
        key_rows = np.zeros((len(items), max(W, 1)), dtype=np.uint32)
        ver_rows = np.zeros((len(items), max(W, 1)), dtype=np.uint32)
        nonempty = np.zeros(len(items), dtype=bool)
        for i, (vid, postings) in enumerate(items):
            ver_rows[i] = self._bitmap_of(self.version_chunks[vid])
            for ids in postings:
                if ids is not None and len(ids):
                    np.bitwise_or.at(key_rows[i], ids // 32,
                                     np.uint32(1) << (ids % 32).astype(np.uint32))
                    nonempty[i] = True
        anded, _ = kops.and_popcount_batch(key_rows, ver_rows, device=device)
        empty = np.empty(0, np.int64)
        return [_bitmap_to_ids(anded[i], self.n_chunks) if nonempty[i] else empty
                for i in range(len(items))]

    # ----------------------------------------------------------- key ranges
    def sorted_keys(self) -> np.ndarray:
        """All indexed primary keys, sorted.

        Cached behind an explicit dirty flag: ``extend_keys`` marks the
        cache dirty exactly when it adds a primary key the index did not
        hold before (the earlier ``len(...) != len(...)`` heuristic could
        not distinguish "new keys" from "same keys, more chunks", and would
        silently go stale on any future mutation that swapped keys while
        preserving the count)."""
        if self._sorted_keys is None or self._keys_dirty:
            self._sorted_keys = np.sort(np.fromiter(
                self.key_chunks.keys(), dtype=np.int64, count=len(self.key_chunks)))
            self._keys_dirty = False
        return self._sorted_keys

    def keys_in_range(self, key_lo: int, key_hi: int) -> np.ndarray:
        """Indexed keys in [key_lo, key_hi] — O(log n + m) via searchsorted
        over the sorted key array (not an O(all-keys) dict scan)."""
        ks = self.sorted_keys()
        lo = np.searchsorted(ks, key_lo, side="left")
        hi = np.searchsorted(ks, key_hi, side="right")
        return ks[lo:hi]

    def candidates_range(self, vid: int, key_lo: int, key_hi: int, *,
                         device: DeviceLike = None) -> np.ndarray:
        return self.candidates(vid, self.keys_in_range(key_lo, key_hi),
                               device=device)

    # ----------------------------------------------------------- index size
    def compressed_size(self) -> Dict[str, int]:
        v = sum(len(varint_encode(c)) for c in self.version_chunks.values())
        k = sum(len(varint_encode(c)) for c in self.key_chunks.values())
        return {"version_chunks_bytes": v, "key_chunks_bytes": k}

    def raw_size(self) -> Dict[str, int]:
        v = sum(8 * len(c) for c in self.version_chunks.values())
        k = sum(8 * len(c) for c in self.key_chunks.values())
        return {"version_chunks_bytes": v, "key_chunks_bytes": k}

    # ------------------------------------------------------ online updates
    def extend_version(self, vid: int, chunk_ids: np.ndarray) -> None:
        self.version_chunks[vid] = np.unique(chunk_ids)

    def drop_versions(self, vids: Iterable[int]) -> None:
        """Retention: retired versions leave the version→chunks projection
        so queries against them fail loudly at plan time.  Key postings are
        left alone — they are lossy by design, and compaction rebuilds them
        when the dead chunks actually go away."""
        for v in vids:
            self.version_chunks.pop(v, None)

    def extend_keys(self, pks: np.ndarray, cids: np.ndarray) -> None:
        """Add (primary key, chunk id) pairs: each touched key's posting
        list becomes the sorted union of its old and new chunk ids."""
        pks = np.asarray(pks, dtype=np.int64)
        cids = np.asarray(cids, dtype=np.int64)
        touched = np.unique(pks)
        olds = [self.key_chunks.get(pk) for pk in touched.tolist()]
        have = np.fromiter((o is not None for o in olds), dtype=bool,
                           count=len(olds))
        if not have.all():
            self._keys_dirty = True          # key set grew: sorted cache stale
        if have.any():
            # same key set, more chunks: sorted_keys cache stays valid
            kept = [o for o in olds if o is not None]
            pks = np.concatenate([pks, np.repeat(touched[have],
                                                 [len(o) for o in kept])])
            cids = np.concatenate([cids, *kept])
        self.key_chunks.update(zip(*_postings(pks, cids)))

    def grow(self, n_chunks: int) -> None:
        self.n_chunks = max(self.n_chunks, n_chunks)


def _postings(pks: np.ndarray, cids: np.ndarray
              ) -> Tuple[List[int], List[np.ndarray]]:
    """(keys, sorted unique chunk ids per key) of (key, chunk) pairs."""
    if len(pks) == 0:
        return [], []
    order = np.lexsort((cids, pks))
    p, c = pks[order], cids[order]
    keep = np.ones(len(p), dtype=bool)
    keep[1:] = (p[1:] != p[:-1]) | (c[1:] != c[:-1])
    p, c = p[keep], c[keep]
    starts = np.flatnonzero(np.r_[True, p[1:] != p[:-1]])
    return p[starts].tolist(), np.split(c, starts[1:])


def _bitmap_to_ids(bm: np.ndarray, n: int) -> np.ndarray:
    bits = np.unpackbits(bm.view(np.uint8), bitorder="little")[:n]
    return np.flatnonzero(bits).astype(np.int64)
