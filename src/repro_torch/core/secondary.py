"""Secondary attribute indexes: filtered scans without full-version fetches.

The paper places RStore "as a layer on top of a distributed key-value store
that houses the raw data as well as any indexes" — but until now only the
primary key was indexed (``Projections.key_chunks``), so a value-predicate
query ("all records of version v where field X = y") had to fetch the whole
version and scan it.  This module adds the missing index family, resolved
the RStore way: postings are *lossy chunk-granularity* lists, exactly like
the primary projections (§2.4), so the index stays small, updates are
append-mostly, and the query side reuses the bitmap machinery — a
``Q.where``/``Q.where_range`` leaf loads its postings as a register of the
wave's one ``bitmap_vm`` program, ANDed there with the version's bitmap
(and combined with the other leaves of ``and_``/``or_``/``not_`` trees) in
the same single kernel launch that plans the rest of the session
(:mod:`repro_torch.core.plan`).  Lossiness never leaks into
results: fetched chunks are post-filtered exactly against the extracted
attribute values (the same contract the paper states for the primary
projections — "a fetched chunk may turn out to hold no relevant record").

Three pieces:

- :class:`AttributeExtractor` — any callable ``payload -> {attr: int}``.
  Records whose extractor omits an attribute are simply unindexed for it.
  :func:`struct_extractor` builds the common case: fixed-offset
  little-endian unsigned integer fields, which makes ``datagen`` payloads
  (``DatasetSpec.attr_fields``) indexable out of the box.

- :class:`SecondaryIndex` — per-attribute ``value -> sorted chunk ids``
  postings, delta+varint compressed for persistence (``varint_encode``,
  the same inverted-index-literature encoding the primary projections
  report sizes with) and hash-bucketed into the backend keyspace under
  ``idx2/{attr}/{bucket}`` keys.  Because the postings live behind the
  :class:`~repro_torch.core.kvs.Backend` protocol they ride ``ShardedKVS``
  sharding, ``ReplicatedKVS`` replication, and ``CachingKVS`` caching for
  free, and their bytes are priced by ``storage_stats()``.

- Maintenance hooks — every mutation path keeps postings coherent inside
  its existing round trips: ``WriteSession.flush``/online ingest extend
  postings for the batch's new chunks (dirty buckets join the flush's ONE
  ``multiput``), ``build()`` and ``Compactor.run_pass`` rewrite superseded
  postings inside the same staged multiput/multidelete as the chunk
  rewrite (so the layout-epoch bump, ``snapshot.refresh()`` semantics and
  ``CachingKVS`` invalidation carry over unchanged), and retention
  composes through the existing retained-version mask — retired versions
  fail at plan time, and dead record copies are dropped by the exact
  post-filter until compaction physically reclaims them.
"""
from __future__ import annotations

import struct
from typing import (Callable, Dict, Iterable, List, Optional, Protocol,
                    Sequence, Tuple)

import numpy as np

from .index import varint_decode, varint_encode

IDX2_PREFIX = "idx2"


class AttributeExtractor(Protocol):
    """Pulls integer attribute values out of an opaque record payload.

    Returns ``{attr_name: value}``; attributes absent from the dict leave
    the record unindexed for them (and excluded from exact post-filtering).
    """

    def __call__(self, payload: bytes) -> Dict[str, int]: ...


def struct_extractor(fields: Dict[str, Tuple[int, int]]) -> AttributeExtractor:
    """Built-in extractor for fixed-offset binary layouts.

    ``fields`` maps attribute name -> ``(byte_offset, byte_width)``; each
    field is read as a little-endian unsigned integer.  Payloads too short
    for a field simply omit it (mixed-schema stores stay indexable).
    """
    items = [(name, int(off), int(width)) for name, (off, width)
             in fields.items()]
    for name, off, width in items:
        if off < 0 or width < 1 or width > 8:
            raise ValueError(f"field {name!r}: bad (offset, width) "
                             f"({off}, {width})")

    def extract(payload: bytes) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for name, off, width in items:
            if len(payload) >= off + width:
                out[name] = int.from_bytes(payload[off:off + width], "little")
        return out

    return extract


def datagen_extractor(n_fields: int) -> AttributeExtractor:
    """Extractor matching :class:`~repro_torch.core.datagen.DatasetSpec`'s
    ``attr_fields`` payload layout: ``n_fields`` little-endian uint32
    values at the start of the payload, named ``f0 .. f{n-1}``."""
    return struct_extractor({f"f{i}": (4 * i, 4) for i in range(n_fields)})


def _group_by_value(vals_of: List[np.ndarray], cids_of: List[np.ndarray]
                    ) -> List[Tuple[int, np.ndarray]]:
    """``(value, chunk ids)`` per distinct value of the concatenated
    ``(value, chunk id)`` pairs, values ascending."""
    if not vals_of:
        return []
    vals = np.concatenate(vals_of).astype(np.int64, copy=False)
    cids = np.concatenate(cids_of)
    if not len(vals):
        return []
    order = np.argsort(vals, kind="stable")
    vals, cids = vals[order], cids[order]
    starts = np.flatnonzero(np.r_[True, vals[1:] != vals[:-1]])
    return list(zip(vals[starts].tolist(), np.split(cids, starts[1:])))


# ---------------------------------------------------------------- the index
class SecondaryIndex:
    """Lossy chunk-granularity postings for one extracted attribute.

    ``postings`` maps each observed attribute value to the sorted chunk ids
    that *may* hold a record with that value (lossy: the record copies in
    the chunk may all be dead, or live only in other versions — the exact
    answer is recovered by post-filtering fetched chunks).  A reverse map
    ``chunk_values`` (chunk id -> values it contributed) makes compaction
    removal O(affected) instead of a full posting scan.

    Persistence is bucketed: values hash into ``n_buckets`` buckets, each
    stored under ``idx2/{attr}/{bucket}`` as a blob of delta+varint
    compressed posting lists.  Mutators mark buckets dirty;
    :meth:`stage_writes` drains them as ``(key, blob)`` writes plus keys of
    now-empty buckets to delete, which the caller folds into the multiput /
    multidelete round trips it was already paying.
    """

    def __init__(self, attr: str, extractor: AttributeExtractor,
                 n_buckets: int = 16) -> None:
        if n_buckets < 1:
            raise ValueError("n_buckets must be >= 1")
        self.attr = str(attr)
        self.extractor = extractor
        self.n_buckets = int(n_buckets)
        self.postings: Dict[int, np.ndarray] = {}     # value -> sorted cids
        self.chunk_values: Dict[int, np.ndarray] = {} # cid -> sorted values
        # cid -> (values int64, present bool) aligned to the chunk's stored
        # record order (row i of the chunk map).  This is what lets the
        # planner's index-only aggregates and composite post-filters be
        # *exact* without fetching the payload blob: the values were
        # extracted from the same payloads at index-maintenance time.
        self.chunk_record_values: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._dirty: set = set()                      # bucket ids to persist
        self._stored: set = set()                     # bucket ids with a live key
        self._bucket_bytes: Dict[int, int] = {}       # persisted blob sizes
        # sorted distinct-value cache for range predicates — same explicit
        # dirty-flag contract as Projections.sorted_keys
        self._sorted_values: Optional[np.ndarray] = None
        self._values_dirty = True

    # ------------------------------------------------------------- keyspace
    def bucket_of(self, value: int) -> int:
        return int(value) % self.n_buckets

    def key_of(self, bucket: int) -> str:
        return f"{IDX2_PREFIX}/{self.attr}/{bucket}"

    def stored_keys(self) -> List[str]:
        """Backend keys currently holding this index's buckets."""
        return [self.key_of(b) for b in sorted(self._stored)]

    # -------------------------------------------------------------- queries
    def postings_for(self, value: int) -> np.ndarray:
        """Chunk ids that may hold a record with ``attr == value``."""
        return self.postings.get(int(value), np.empty(0, np.int64))

    def sorted_values(self) -> np.ndarray:
        """All indexed attribute values, sorted (dirty-flag cached)."""
        if self._sorted_values is None or self._values_dirty:
            self._sorted_values = np.sort(np.fromiter(
                self.postings.keys(), dtype=np.int64, count=len(self.postings)))
            self._values_dirty = False
        return self._sorted_values

    def postings_in_range(self, lo: int, hi: int) -> List[np.ndarray]:
        """Posting lists of every indexed value in ``[lo, hi]`` —
        O(log n + m) via searchsorted over the sorted value array."""
        vs = self.sorted_values()
        a = np.searchsorted(vs, int(lo), side="left")
        b = np.searchsorted(vs, int(hi), side="right")
        return [self.postings[int(v)] for v in vs[a:b]]

    # -------------------------------------------------- per-record values
    def _record_values_of(self, rids: np.ndarray,
                          payload_of: Callable[[int], bytes]
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """Extract ``(values, present)`` per record, in ``rids`` order —
        which is the chunk's stored order (row i of its chunk map)."""
        vals = np.zeros(len(rids), dtype=np.int64)
        present = np.zeros(len(rids), dtype=bool)
        for i, r in enumerate(rids):
            v = self.extractor(payload_of(int(r))).get(self.attr)
            if v is not None:
                vals[i] = int(v)
                present[i] = True
        return vals, present

    def record_values(self, cid: int) -> Tuple[np.ndarray, np.ndarray]:
        """``(values int64, present bool)`` aligned to chunk ``cid``'s
        stored record order — the exact per-record attribute values the
        planner's answer layer filters with (no payload fetch needed)."""
        return self.chunk_record_values[int(cid)]

    # ---------------------------------------------------------- maintenance
    def add_chunks(self, chunks: Iterable[Tuple[int, np.ndarray]],
                   payload_of: Callable[[int], bytes]) -> None:
        """Extend postings for freshly written chunks (flush / compaction
        rewrite).  Append-only: never empties a bucket.  Each touched
        value's posting list is merged once, with all the new chunks that
        hold it."""
        vals_of, cids_of = [], []
        for cid, rids in chunks:
            cid = int(cid)
            rvals, rpres = self._record_values_of(np.asarray(rids), payload_of)
            self.chunk_record_values[cid] = (rvals, rpres)
            vals = np.unique(rvals[rpres])
            self.chunk_values[cid] = vals
            vals_of.append(vals)
            cids_of.append(np.full(len(vals), cid, dtype=np.int64))
        for v, new in _group_by_value(vals_of, cids_of):
            old = self.postings.get(v)
            if old is None:
                self.postings[v] = np.unique(new)
                self._values_dirty = True
            else:
                self.postings[v] = np.union1d(old, new)
            self._dirty.add(self.bucket_of(v))

    def remove_chunks(self, cids: Iterable[int]) -> None:
        """Retire superseded chunks from every posting list (compaction GC).
        O(values actually present in the removed chunks), via the reverse
        map; each touched posting list is filtered once."""
        vals_of, cids_of = [], []
        for cid in cids:
            cid = int(cid)
            self.chunk_record_values.pop(cid, None)
            vals = self.chunk_values.pop(cid, None)
            if vals is None:
                continue
            vals_of.append(vals)
            cids_of.append(np.full(len(vals), cid, dtype=np.int64))
        for v, gone in _group_by_value(vals_of, cids_of):
            old = self.postings.get(v)
            if old is None:
                continue
            kept = old[~np.isin(old, gone)]
            if len(kept):
                self.postings[v] = kept
            else:
                del self.postings[v]
                self._values_dirty = True
            self._dirty.add(self.bucket_of(v))

    def rebuild(self, chunk_records: Dict[int, np.ndarray],
                payload_of: Callable[[int], bytes]) -> None:
        """Recompute postings from scratch (full ``build()`` path).  Every
        bucket that holds data — or held data before — is marked dirty so
        :meth:`stage_writes` rewrites or deletes it."""
        previously = {self.bucket_of(v) for v in self.postings}
        self.postings = {}
        self.chunk_values = {}
        self.chunk_record_values = {}
        self._values_dirty = True
        self.add_chunks(sorted(chunk_records.items()), payload_of)
        self._dirty |= previously | self._stored

    # ---------------------------------------------------------- persistence
    def _encode_bucket(self, bucket: int) -> bytes:
        vals = sorted(v for v in self.postings
                      if self.bucket_of(v) == bucket)
        parts = [struct.pack("<I", len(vals))]
        for v in vals:
            enc = varint_encode(self.postings[v])
            parts.append(struct.pack("<qI", v, len(enc)))
            parts.append(enc)
        return b"".join(parts)

    @staticmethod
    def decode_bucket(blob: bytes) -> Dict[int, np.ndarray]:
        """Inverse of the bucket encoding: ``{value: sorted chunk ids}``."""
        (n,) = struct.unpack_from("<I", blob, 0)
        off = 4
        out: Dict[int, np.ndarray] = {}
        for _ in range(n):
            v, nb = struct.unpack_from("<qI", blob, off)
            off += 12
            out[int(v)] = varint_decode(blob[off:off + nb])
            off += nb
        return out

    def stage_writes(self) -> Tuple[List[Tuple[str, bytes]], List[str]]:
        """Drain dirty buckets into ``(writes, deletes)`` for the caller's
        already-staged multiput/multidelete round trips.  Buckets that
        still hold values are (re)written; buckets that emptied out are
        deleted (only if they have a live backend key — no orphans, no
        spurious deletes)."""
        writes: List[Tuple[str, bytes]] = []
        deletes: List[str] = []
        live = {self.bucket_of(v) for v in self.postings}
        for b in sorted(self._dirty):
            if b in live:
                blob = self._encode_bucket(b)
                writes.append((self.key_of(b), blob))
                self._bucket_bytes[b] = len(blob)
                self._stored.add(b)
            elif b in self._stored:
                deletes.append(self.key_of(b))
                self._stored.discard(b)
                self._bucket_bytes.pop(b, None)
        self._dirty.clear()
        return writes, deletes

    @classmethod
    def load(cls, kvs, attr: str, extractor: AttributeExtractor,
             chunk_records: Dict[int, np.ndarray],
             payload_of: Callable[[int], bytes],
             n_buckets: int = 16) -> "SecondaryIndex":
        """Rehydrate an index from its persisted ``idx2/`` buckets (ONE
        multiget round trip), then rebuild the reverse chunk->values map
        from the store — the postings themselves come from the backend, so
        a persisted index round-trips without re-extracting every payload.
        """
        idx = cls(attr, extractor, n_buckets=n_buckets)
        present = [b for b in range(idx.n_buckets) if idx.key_of(b) in kvs]
        blobs = kvs.multiget([idx.key_of(b) for b in present])
        for b, blob in zip(present, blobs):
            idx.postings.update(SecondaryIndex.decode_bucket(blob))
            idx._stored.add(b)
            idx._bucket_bytes[b] = len(blob)
        idx._values_dirty = True
        for cid, rids in chunk_records.items():
            rvals, rpres = idx._record_values_of(np.asarray(rids), payload_of)
            idx.chunk_record_values[int(cid)] = (rvals, rpres)
            idx.chunk_values[int(cid)] = np.unique(rvals[rpres])
        return idx

    # ---------------------------------------------------------------- stats
    def stored_bytes(self) -> int:
        """Persisted posting bytes (what ``storage_stats()`` prices)."""
        return int(sum(self._bucket_bytes.values()))

    def report(self) -> Dict[str, int]:
        return {
            "n_values": len(self.postings),
            "n_postings": int(sum(len(p) for p in self.postings.values())),
            "n_buckets_stored": len(self._stored),
            "stored_bytes": self.stored_bytes(),
        }
