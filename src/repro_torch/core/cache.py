"""Chunk cache: cost-model-driven read-through cache over any backend.

:class:`CachingKVS` implements the full :class:`~repro_torch.core.kvs.Backend`
protocol and stacks over any existing backend (``InMemoryKVS``,
``ShardedKVS``, ``ShardedDeviceKVS``, ``ReplicatedKVS``), attacking the
paper's storage-vs-retrieval trade-off online: hot chunks are served at
memory speed while the offline layout algorithms stay unchanged.

Three design pillars:

**Byte-budget segmented LRU with cost-model admission.**  Entries live in a
probation segment on first fill and are promoted to a protected segment on
re-reference (classic SLRU: one hit in probation proves reuse, so scans of
cold chunks can't flush the hot set).  When admitting a new entry would
force evictions, the entry is admitted only if its predicted re-fetch cost
(per-query overhead + bytes/bandwidth, priced by
:func:`repro_torch.core.costmodel.fetch_seconds`) is at least the combined
re-fetch cost of the victims it displaces — the per-query overhead term is
what makes many small hot chunks worth more than one big cold one.  Tiny
blobs (chunk maps are a few KB next to 64 KB chunk payloads) bypass the
comparison: they always win it in practice and sit on every read path.

**Strict coherence.**  Every mutation path in the system — session flush,
``build()``, compaction — flows through ``multiput``/``multidelete``, so the
cache (a) drops its copies of the touched keys *before* forwarding the write
(a partial backend failure can then only leave the cache cold, never stale)
and (b) re-admits written values after the backend acknowledges
(write-through).  ``on_layout_epoch`` is the belt-and-braces hook on top:
``rs.compact()`` and ``build()`` report the keys their re-partitioning
superseded, exactly the moment ``Snapshot.refresh()`` re-pins, guarding the
cache even against maintenance that mutates a backend below this layer.

**Honest round-trip accounting.**  ``stats.n_queries`` (and the other
read/write counters) mirror only *actual* inner-backend traffic, measured as
deltas around forwarded calls — a fully warm ``multiget`` is 0 round trips,
which is precisely what ``Snapshot.execute``'s per-batch ``kvs_queries``
then reports.  Cache-served traffic is counted separately in the
``n_cache_hits`` / ``n_cache_misses`` / ``bytes_served_from_cache`` fields
of :class:`~repro_torch.core.kvs.KVSStats`.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .costmodel import BANDWIDTH_BPS, PER_QUERY_S, fetch_seconds
from .kvs import Backend, KVSStats

# Per-entry bookkeeping charge on top of key+value bytes (dict slots,
# OrderedDict links) so the byte budget bounds real memory, not just payload.
ENTRY_OVERHEAD = 64


class CachingKVS:
    """Read-through cache wrapping ``inner``; full Backend protocol.

    Parameters
    ----------
    inner : Backend to serve misses from and forward writes to.
    cache_bytes : byte budget; charged bytes (value+key+overhead) never
        exceed it.
    protected_frac : share of the budget the protected segment may hold
        before its LRU entries demote back to probation.
    always_admit_bytes : values at or under this size skip the cost-model
        admission comparison (chunk-map blobs always cached).
    per_query_s / bandwidth_Bps : re-fetch pricing, defaulting to the
        system-wide §2.3 constants in :mod:`repro_torch.core.costmodel`.
    """

    # Discovery marker: RStore.cache_stats() / storage_stats() and
    # Snapshot.prefetch* find the cache layer through this instead of an
    # isinstance check, so wrappers composing CachingKVS keep working.
    is_cache = True

    def __init__(self, inner: Backend, cache_bytes: int = 64 << 20,
                 protected_frac: float = 0.8,
                 always_admit_bytes: int = 4096,
                 per_query_s: float = PER_QUERY_S,
                 bandwidth_Bps: float = BANDWIDTH_BPS) -> None:
        if cache_bytes <= 0:
            raise ValueError("cache_bytes must be positive")
        if not (0.0 < protected_frac < 1.0):
            raise ValueError("protected_frac must be in (0, 1)")
        self.inner = inner
        self.cache_bytes = int(cache_bytes)
        self.protected_frac = float(protected_frac)
        self.always_admit_bytes = int(always_admit_bytes)
        self.per_query_s = float(per_query_s)
        self.bandwidth_Bps = float(bandwidth_Bps)
        self.stats = KVSStats()
        # Both segments are OrderedDicts in LRU→MRU order.
        self._probation: "OrderedDict[str, bytes]" = OrderedDict()
        self._protected: "OrderedDict[str, bytes]" = OrderedDict()
        self._cached_bytes = 0      # charged bytes across both segments
        self._protected_bytes = 0   # charged bytes in protected only
        self.layout_epoch = 0       # last epoch reported via on_layout_epoch
        self.n_evictions = 0
        self.n_admit_rejected = 0
        self.n_invalidations = 0
        self.n_write_through = 0    # write-through re-admissions (per key)

    # ---------------------------------------------------------------- sizing

    @staticmethod
    def _charge(key: str, value: bytes) -> int:
        return len(value) + len(key) + ENTRY_OVERHEAD

    @property
    def cached_bytes(self) -> int:
        return self._cached_bytes

    @property
    def n_entries(self) -> int:
        return len(self._probation) + len(self._protected)

    # ------------------------------------------------------------ SLRU core

    def _lookup(self, key: str) -> Optional[bytes]:
        """Hit path: protected hits refresh recency; probation hits promote
        (the second reference is the reuse signal SLRU keys on)."""
        if key in self._protected:
            self._protected.move_to_end(key)
            return self._protected[key]
        if key in self._probation:
            v = self._probation.pop(key)
            self._protected[key] = v
            self._protected_bytes += self._charge(key, v)
            self._shrink_protected()
            return v
        return None

    def _shrink_protected(self) -> None:
        """Demote protected-LRU entries back to probation MRU once the
        segment outgrows its share — they get one more chance before
        leaving the cache entirely."""
        cap = self.protected_frac * self.cache_bytes
        while self._protected_bytes > cap and len(self._protected) > 1:
            k, v = self._protected.popitem(last=False)
            self._protected_bytes -= self._charge(k, v)
            self._probation[k] = v

    def _pop(self, key: str) -> Optional[bytes]:
        if key in self._probation:
            v = self._probation.pop(key)
        elif key in self._protected:
            v = self._protected.pop(key)
            self._protected_bytes -= self._charge(key, v)
        else:
            return None
        self._cached_bytes -= self._charge(key, v)
        return v

    def _victims(self) -> Iterable[Tuple[str, bytes]]:
        """Eviction order: probation LRU→MRU, then protected LRU→MRU."""
        yield from self._probation.items()
        yield from self._protected.items()

    def _evict(self, need: int) -> None:
        freed = 0
        while freed < need:
            if self._probation:
                k, v = self._probation.popitem(last=False)
            elif self._protected:
                k, v = self._protected.popitem(last=False)
                self._protected_bytes -= self._charge(k, v)
            else:
                break
            c = self._charge(k, v)
            self._cached_bytes -= c
            freed += c
            self.n_evictions += 1

    def _admit(self, key: str, value: bytes) -> bool:
        """Insert into probation if the cost model approves.

        Free budget admits unconditionally.  When eviction would be forced,
        the candidate's re-fetch price must beat the summed re-fetch price
        of the victims it displaces (each priced as one round trip + its
        transfer time — an upper bound, since real misses batch, but the
        same bound on both sides keeps the comparison fair).  Values at or
        under ``always_admit_bytes`` skip the comparison.
        """
        size = self._charge(key, value)
        if size > self.cache_bytes:
            self.n_admit_rejected += 1
            return False
        if key in self._probation or key in self._protected:
            self._refresh(key, value)
            return True
        need = self._cached_bytes + size - self.cache_bytes
        if need > 0 and len(value) > self.always_admit_bytes:
            victims_cost = 0.0
            freed = 0
            for k, v in self._victims():
                if freed >= need:
                    break
                freed += self._charge(k, v)
                victims_cost += fetch_seconds(1, len(v), self.per_query_s,
                                              self.bandwidth_Bps)
            if fetch_seconds(1, len(value), self.per_query_s,
                             self.bandwidth_Bps) < victims_cost:
                self.n_admit_rejected += 1
                return False
        if need > 0:
            self._evict(need)
        self._probation[key] = value
        self._cached_bytes += size
        return True

    def _refresh(self, key: str, value: bytes) -> None:
        """Replace a cached entry's bytes in place (same segment, same
        recency), re-evicting if the new value grew past the budget."""
        for seg in (self._probation, self._protected):
            if key in seg:
                delta = len(value) - len(seg[key])
                seg[key] = value
                self._cached_bytes += delta
                if seg is self._protected:
                    self._protected_bytes += delta
                if self._cached_bytes > self.cache_bytes:
                    self._evict(self._cached_bytes - self.cache_bytes)
                return

    # ------------------------------------------------------------ coherence

    def invalidate(self, keys: Iterable[str]) -> int:
        """Drop any cached copies of ``keys``; returns how many were held."""
        n = 0
        for k in keys:
            if self._pop(k) is not None:
                n += 1
        self.n_invalidations += n
        return n

    def clear(self) -> None:
        self.n_invalidations += self.n_entries
        self._probation.clear()
        self._protected.clear()
        self._cached_bytes = 0
        self._protected_bytes = 0

    def on_layout_epoch(self, epoch: int,
                        touched_keys: Optional[Iterable[str]] = None) -> None:
        """Layout-change hook: ``build()`` / ``compact()`` re-partitioned
        chunk storage; flush every entry the pass superseded (all entries
        when ``touched_keys`` is None).  Redundant with write-through /
        delete-invalidation when every mutation flows through this layer —
        load-bearing when maintenance mutates a backend below it."""
        self.layout_epoch = epoch
        if touched_keys is None:
            self.clear()
        else:
            self.invalidate(touched_keys)

    # ----------------------------------------------------------- read path

    def multiget(self, keys: Sequence[str]) -> List[bytes]:
        if not keys:           # empty batch: no round trip, stats untouched
            return []
        out: List[Optional[bytes]] = [None] * len(keys)
        misses: List[int] = []
        for i, k in enumerate(keys):
            v = self._lookup(k)
            if v is None:
                misses.append(i)
            else:
                out[i] = v
                self.stats.n_cache_hits += 1
                self.stats.bytes_served_from_cache += len(v)
        if misses:
            s = self.inner.stats
            q0, n0, b0 = s.n_queries, s.n_values, s.bytes_fetched
            vals = self.inner.multiget([keys[i] for i in misses])
            self.stats.n_queries += s.n_queries - q0
            self.stats.n_values += s.n_values - n0
            self.stats.bytes_fetched += s.bytes_fetched - b0
            self.stats.n_cache_misses += len(misses)
            for i, v in zip(misses, vals):
                out[i] = v
                self._admit(keys[i], v)
        return out  # type: ignore[return-value]

    def get(self, key: str) -> bytes:
        return self.multiget([key])[0]

    def scan(self) -> List[Tuple[str, bytes]]:
        """Recovery primitive: forwarded verbatim, and deliberately NOT
        admitted — one scan of a big store would flush the whole hot set."""
        s = self.inner.stats
        q0, n0, b0 = s.n_queries, s.n_values, s.bytes_fetched
        items = self.inner.scan()
        self.stats.n_queries += s.n_queries - q0
        self.stats.n_values += s.n_values - n0
        self.stats.bytes_fetched += s.bytes_fetched - b0
        return items

    def __contains__(self, key: str) -> bool:
        if key in self._probation or key in self._protected:
            return True
        return key in self.inner

    # ---------------------------------------------------------- write path

    def multiput(self, items: Sequence[Tuple[str, bytes]]) -> None:
        if not items:          # empty batch: no round trip, stats untouched
            return
        # Drop-before-write: if the backend applies partially and raises,
        # the cache is cold for those keys, never stale.  Previously-cached
        # keys are re-admitted after the ack (write-through) — proven-hot,
        # so they bypass the admission comparison via force.
        was_cached = {k for k, _ in items
                      if k in self._probation or k in self._protected}
        if was_cached:
            self.invalidate(was_cached)
        s = self.inner.stats
        p0, v0, b0 = s.n_put_queries, s.n_values_put, s.bytes_stored
        self.inner.multiput(items)
        self.stats.n_put_queries += s.n_put_queries - p0
        self.stats.n_values_put += s.n_values_put - v0
        self.stats.bytes_stored += s.bytes_stored - b0
        for k, v in items:
            if k in was_cached:
                self._force_admit(k, v)
                self.n_write_through += 1

    def _force_admit(self, key: str, value: bytes) -> None:
        """Write-through re-admission: skip the cost comparison (the entry
        already earned its place) but still respect the byte budget."""
        size = self._charge(key, value)
        if size > self.cache_bytes:
            return
        need = self._cached_bytes + size - self.cache_bytes
        if need > 0:
            self._evict(need)
        self._probation[key] = value
        self._cached_bytes += size

    def put(self, key: str, value: bytes) -> None:
        self.multiput([(key, value)])

    def multidelete(self, keys: Sequence[str]) -> None:
        if not keys:           # empty batch: no round trip, stats untouched
            return
        self.invalidate(keys)  # drop first — same partial-failure argument
        s = self.inner.stats
        d0, k0 = s.n_delete_queries, s.n_keys_deleted
        self.inner.multidelete(keys)
        self.stats.n_delete_queries += s.n_delete_queries - d0
        self.stats.n_keys_deleted += s.n_keys_deleted - k0

    def delete(self, key: str) -> None:
        self.multidelete([key])

    # ------------------------------------------------------------ reporting

    def total_stored_bytes(self) -> int:
        inner_total = getattr(self.inner, "total_stored_bytes", None)
        return inner_total() if callable(inner_total) else 0

    def cache_report(self) -> Dict[str, float]:
        """Hit-rate / occupancy report (surfaced by ``rs.cache_stats()``)."""
        h, m = self.stats.n_cache_hits, self.stats.n_cache_misses
        return {
            "cache_bytes": self.cache_bytes,
            "cached_bytes": self._cached_bytes,
            "n_entries": self.n_entries,
            "n_probation": len(self._probation),
            "n_protected": len(self._protected),
            "n_cache_hits": h,
            "n_cache_misses": m,
            "hit_rate": h / (h + m) if (h + m) else 0.0,
            "bytes_served_from_cache": self.stats.bytes_served_from_cache,
            "n_evictions": self.n_evictions,
            "n_admit_rejected": self.n_admit_rejected,
            "n_invalidations": self.n_invalidations,
            "n_write_through": self.n_write_through,
            "layout_epoch": self.layout_epoch,
        }
