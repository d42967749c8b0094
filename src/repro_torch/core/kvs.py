"""Backend key-value store abstraction (§2.4).

RStore assumes only get/put/multiget/multiput/multidelete from the backend —
the :class:`Backend` protocol.  All directions are batched: ``multiget`` is
one read round trip, ``multiput`` one write round trip (the §2.3 insight —
few large requests beat many small ones — applied symmetrically; the write
side is what the group-committing :class:`~repro_torch.core.ingest.WriteSession`
rides on), and ``multidelete`` one round trip reclaiming a batch of
superseded keys (what :class:`~repro_torch.core.compact.Compactor` GC rides
on).
Three implementations:

- :class:`InMemoryKVS` — host dict with request/byte counters and a simple
  latency model (per-query overhead + bandwidth), used to reproduce the §2.3
  "too many queries" experiment without a Cassandra cluster.

- :class:`ShardedDeviceKVS` — the device realization: a fixed-slot
  ``int32[n_slots, slot_words]`` table on one device (the card unless the
  caller asks for the CPU); ``multiget`` is ONE batched ``index_select``.

- :class:`ShardedKVS` — the *distributed* layer the paper assumes: a router
  that hash-partitions the keyspace over N inner backends and fans
  ``multiget``/``multiput`` out as one round trip per shard touched.

The replication & fault-tolerance layer lives in
:mod:`repro_torch.core.replica` and composes with all of the above through
the same protocol:

- :class:`~repro_torch.core.replica.ReplicatedKVS` — an N-way replica group
  (quorum writes, per-batch read failover, read-repair) that slots in as a
  ``ShardedKVS`` shard via ``make_sharded_backend(...,
  replication_factor=R)``.

- :class:`~repro_torch.core.replica.FaultInjectingKVS` — a wrapper with a
  deterministic seeded fault schedule (transient errors, timeouts, hard
  ``kill()``) raising the
  :class:`~repro_torch.core.replica.BackendUnavailable` taxonomy, for
  testing every degraded-mode path.

A missing key raises ``KeyError`` naming the key — a *data-level* miss,
deliberately distinct from ``BackendUnavailable`` so failover logic never
re-routes a legitimate miss.  ``scan`` (one round trip returning every
stored item) is the recovery primitive replica rebuilds ride on.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Protocol, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .costmodel import BANDWIDTH_BPS, PER_QUERY_S


@dataclass
class KVSStats:
    n_queries: int = 0          # read round-trips to the backend
    n_values: int = 0           # values fetched
    bytes_fetched: int = 0
    n_put_queries: int = 0      # write round-trips (each put / multiput)
    n_values_put: int = 0       # values stored
    bytes_stored: int = 0
    n_delete_queries: int = 0   # delete round-trips (each delete / multidelete)
    n_keys_deleted: int = 0     # keys removed
    n_retries: int = 0          # op retries after transient faults/timeouts
    n_failovers: int = 0        # replica read attempts that failed over
    simulated_backoff_seconds: float = 0.0  # backoff the retries would sleep
    n_cache_hits: int = 0       # reads served by a CachingKVS layer
    n_cache_misses: int = 0     # reads a CachingKVS had to forward down
    bytes_served_from_cache: int = 0  # payload served at memory speed
    n_flush_batches: int = 0    # BackgroundFlusher drains that committed
    n_versions_staged: int = 0  # versions staged through async ingest
    max_observed_lag: int = 0   # high-water committed-but-not-durable count

    def simulated_seconds(self, per_query_s: float = PER_QUERY_S,
                          bandwidth_Bps: float = BANDWIDTH_BPS) -> float:
        """Cassandra-like read cost model: per-request overhead + transfer."""
        return self.n_queries * per_query_s + self.bytes_fetched / bandwidth_Bps

    def simulated_write_seconds(self, per_query_s: float = PER_QUERY_S,
                                bandwidth_Bps: float = BANDWIDTH_BPS) -> float:
        """Same cost model for the write side.  Deletes carry payload-free
        requests: per-query overhead only."""
        return ((self.n_put_queries + self.n_delete_queries) * per_query_s
                + self.bytes_stored / bandwidth_Bps)

    def reset(self) -> None:
        for f in self._FIELDS:
            setattr(self, f, 0)

    def snapshot(self) -> "KVSStats":
        """Copy of the current counters (pair with :meth:`restore` to run
        bookkeeping traffic without polluting stats a caller is
        accumulating)."""
        return KVSStats(**{f: getattr(self, f) for f in self._FIELDS})

    def restore(self, saved: "KVSStats") -> None:
        for f in self._FIELDS:
            setattr(self, f, getattr(saved, f))

    @staticmethod
    def merged(parts: Iterable["KVSStats"]) -> "KVSStats":
        """Aggregate of several counters (e.g. per-shard stats)."""
        out = KVSStats()
        for p in parts:
            for f in KVSStats._FIELDS:
                setattr(out, f, getattr(out, f) + getattr(p, f))
        return out


# Derived, not hand-maintained: reset/snapshot/restore/merged iterate this in
# declaration order, so adding a counter to the dataclass is the whole change.
KVSStats._FIELDS = tuple(f.name for f in dataclasses.fields(KVSStats))


class Backend(Protocol):
    """What RStore requires of the distributed KV store (§2.4): batched reads
    AND batched writes, each one round trip per call.  ``multidelete`` is the
    maintenance-path primitive (compaction GC): one round trip removing a
    whole batch of superseded keys."""

    stats: KVSStats

    def put(self, key: str, value: bytes) -> None: ...
    def get(self, key: str) -> bytes: ...
    def multiget(self, keys: Sequence[str]) -> List[bytes]: ...
    def multiput(self, items: Sequence[Tuple[str, bytes]]) -> None: ...
    def delete(self, key: str) -> None: ...
    def multidelete(self, keys: Sequence[str]) -> None: ...
    def scan(self) -> List[Tuple[str, bytes]]: ...
    def __contains__(self, key: str) -> bool: ...


# Back-compat alias: the pre-write-path name for the protocol.
KVS = Backend


class InMemoryKVS:
    def __init__(self) -> None:
        self._d: Dict[str, bytes] = {}
        self.stats = KVSStats()

    def put(self, key: str, value: bytes) -> None:
        self.multiput([(key, value)])

    def _lookup(self, key: str) -> bytes:
        """A miss names the missing key — a *data-level* KeyError."""
        try:
            return self._d[key]
        except KeyError:
            raise KeyError(f"InMemoryKVS: missing key {key!r}") from None

    def get(self, key: str) -> bytes:
        v = self._lookup(key)
        self.stats.n_queries += 1
        self.stats.n_values += 1
        self.stats.bytes_fetched += len(v)
        return v

    def multiget(self, keys: Sequence[str]) -> List[bytes]:
        """One batched round-trip (the chunked design needs only this).

        An empty batch costs nothing: no backend call, no stats."""
        if not keys:
            return []
        vs = [self._lookup(k) for k in keys]
        self.stats.n_queries += 1
        self.stats.n_values += len(vs)
        self.stats.bytes_fetched += sum(len(v) for v in vs)
        return vs

    def multiput(self, items: Sequence[Tuple[str, bytes]]) -> None:
        """One batched write round-trip (the group-commit primitive)."""
        if not items:
            return
        for k, v in items:
            self._d[k] = v
        self.stats.n_put_queries += 1
        self.stats.n_values_put += len(items)
        self.stats.bytes_stored += sum(len(v) for _, v in items)

    def multiget_naive(self, keys: Sequence[str]) -> List[bytes]:
        """Per-key round-trips — the §2.3 baseline behaviour."""
        return [self.get(k) for k in keys]

    def delete(self, key: str) -> None:
        self.multidelete([key])

    def multidelete(self, keys: Sequence[str]) -> None:
        """One batched delete round-trip (the compaction GC primitive).

        An empty batch costs nothing, matching the empty multiget/multiput
        convention.  Deleting an absent key raises — the maintenance path
        only ever deletes keys it owns, so a miss is an index/storage
        divergence bug worth failing loudly on."""
        if not keys:
            return
        for k in keys:
            if k not in self._d:
                raise KeyError(f"InMemoryKVS: missing key {k!r}")
            del self._d[k]
        self.stats.n_delete_queries += 1
        self.stats.n_keys_deleted += len(keys)

    def scan(self) -> List[Tuple[str, bytes]]:
        """Every stored (key, value) in one round trip — the recovery
        primitive."""
        items = list(self._d.items())
        self.stats.n_queries += 1
        self.stats.n_values += len(items)
        self.stats.bytes_fetched += sum(len(v) for _, v in items)
        return items

    def __contains__(self, key: str) -> bool:
        return key in self._d

    def total_stored_bytes(self) -> int:
        return sum(len(v) for v in self._d.values())


# ---------------------------------------------------------------- shard router
class ShardedKVS:
    """Hash-partitioned router over N inner backends.

    The keyspace is split by a stable hash (crc32 of the key); ``multiget``
    and ``multiput`` fan out per shard — one inner round trip per shard
    touched — and results are reassembled in request order.  ``stats`` on the
    router counts those per-shard round trips (a batch spanning 4 shards is
    4 round trips: the shards are independent servers); per-shard counters
    stay on the inner backends (:meth:`shard_stats`).
    """

    def __init__(self, shards: Sequence[Backend]) -> None:
        if not shards:
            raise ValueError("ShardedKVS needs at least one shard")
        self.shards: List[Backend] = list(shards)
        self.stats = KVSStats()

    def shard_of(self, key: str) -> int:
        return zlib.crc32(key.encode()) % len(self.shards)

    # ------------------------------------------------------------------ reads
    def get(self, key: str) -> bytes:
        v = self.shards[self.shard_of(key)].get(key)
        self.stats.n_queries += 1
        self.stats.n_values += 1
        self.stats.bytes_fetched += len(v)
        return v

    def multiget(self, keys: Sequence[str]) -> List[bytes]:
        if not keys:
            return []
        groups: Dict[int, List[int]] = {}
        for i, k in enumerate(keys):
            groups.setdefault(self.shard_of(k), []).append(i)
        out: List[Optional[bytes]] = [None] * len(keys)
        for s, idxs in groups.items():
            vals = self.shards[s].multiget([keys[i] for i in idxs])
            for i, v in zip(idxs, vals):
                out[i] = v
        self.stats.n_queries += len(groups)
        self.stats.n_values += len(keys)
        self.stats.bytes_fetched += sum(len(v) for v in out)  # type: ignore
        return out  # type: ignore[return-value]

    # ----------------------------------------------------------------- writes
    def put(self, key: str, value: bytes) -> None:
        self.multiput([(key, value)])

    def multiput(self, items: Sequence[Tuple[str, bytes]]) -> None:
        """One round trip per shard touched — a whole group commit lands in
        O(shards) backend writes however many chunks it carries."""
        if not items:
            return
        groups: Dict[int, List[Tuple[str, bytes]]] = {}
        for kv in items:
            groups.setdefault(self.shard_of(kv[0]), []).append(kv)
        for s, sub in groups.items():
            self.shards[s].multiput(sub)
        self.stats.n_put_queries += len(groups)
        self.stats.n_values_put += len(items)
        self.stats.bytes_stored += sum(len(v) for _, v in items)

    # ---------------------------------------------------------------- deletes
    def delete(self, key: str) -> None:
        self.multidelete([key])

    def multidelete(self, keys: Sequence[str]) -> None:
        """One delete round trip per shard touched; an empty key list skips
        the backend entirely (the empty-batch convention)."""
        if not keys:
            return
        groups: Dict[int, List[str]] = {}
        for k in keys:
            groups.setdefault(self.shard_of(k), []).append(k)
        for s, sub in groups.items():
            self.shards[s].multidelete(sub)
        self.stats.n_delete_queries += len(groups)
        self.stats.n_keys_deleted += len(keys)

    # ------------------------------------------------------------------ misc
    def scan(self) -> List[Tuple[str, bytes]]:
        """Every stored item — one scan round trip per shard."""
        out: List[Tuple[str, bytes]] = []
        for s in self.shards:
            items = s.scan()
            out.extend(items)
            self.stats.n_queries += 1
            self.stats.n_values += len(items)
            self.stats.bytes_fetched += sum(len(v) for _, v in items)
        return out

    def __contains__(self, key: str) -> bool:
        return key in self.shards[self.shard_of(key)]

    def shard_stats(self) -> List[KVSStats]:
        """Per-shard counters, in shard order."""
        return [s.stats for s in self.shards]

    def aggregate_shard_stats(self) -> KVSStats:
        return KVSStats.merged(self.shard_stats())

    def total_stored_bytes(self) -> int:
        return sum(s.total_stored_bytes() for s in self.shards
                   if hasattr(s, "total_stored_bytes"))


class ShardedDeviceKVS:
    """Fixed-slot store living as an ``int32[n_slots, slot_words]`` tensor
    on one device.

    Values are padded into ``slot_bytes`` slots; longer values span
    consecutive slots.  ``multiput`` writes only the slots the batch
    touches — one host-to-device copy of those rows plus one
    ``index_copy_`` — and is one write round trip however many values it
    carries.  ``multiget`` is ONE ``index_select`` on the device plus one
    device-to-host copy of the gathered rows.  Freed extents (relocated or
    shrunk values) go on a first-fit free list so overwrites never leak
    slots.
    """

    def __init__(self, slot_bytes: int = 1 << 16, n_slots: int = 1024,
                 device=None) -> None:
        if slot_bytes <= 0 or slot_bytes % 4:
            raise ValueError(f"slot_bytes must be a positive multiple of 4, "
                             f"got {slot_bytes}")
        self.device = resolve_device(device)
        self.slot_bytes = int(slot_bytes)
        self.slot_words = self.slot_bytes // 4
        self._table = torch.zeros((max(int(n_slots), 1), self.slot_words),
                                  dtype=torch.int32, device=self.device)
        self._next_slot = 0
        self._free: List[Tuple[int, int]] = []   # (slot, n) reclaimed extents
        self._dir: Dict[str, Tuple[int, int, int]] = {}  # key -> (slot, n, len)
        self.stats = KVSStats()

    # ------------------------------------------------------------------ put
    def put(self, key: str, value: bytes) -> None:
        self.multiput([(key, value)])

    def multiput(self, items: Sequence[Tuple[str, bytes]]) -> None:
        """Write a batch: one transfer of the touched slots, however many
        values the batch carries."""
        if not items:
            return
        extents = [(self._place(k, v), v) for k, v in items]
        n_rows = sum(n for (_, n), _ in extents)
        buf = bytearray(n_rows * self.slot_bytes)
        slots = np.empty(n_rows, dtype=np.int64)
        row = 0
        for (slot, n), v in extents:
            buf[row * self.slot_bytes:row * self.slot_bytes + len(v)] = v
            slots[row:row + n] = np.arange(slot, slot + n)
            row += n
        # a slot written twice in one batch keeps its last write
        # (index_copy_ with repeated indices has no defined winner)
        _, last = np.unique(slots[::-1], return_index=True)
        keep = np.sort(n_rows - 1 - last)
        rows = np.frombuffer(buf, dtype=np.int32).reshape(n_rows,
                                                           self.slot_words)
        self._table.index_copy_(
            0, torch.from_numpy(slots[keep]).to(self.device),
            torch.from_numpy(rows[keep]).to(self.device))
        self.stats.n_put_queries += 1
        self.stats.n_values_put += len(items)
        self.stats.bytes_stored += sum(len(v) for _, v in items)

    def _place(self, key: str, value: bytes) -> Tuple[int, int]:
        """Allocate (or reuse) the extent ``key``'s new value goes to."""
        n = max(1, math.ceil(len(value) / self.slot_bytes))
        if key in self._dir:
            slot, old_n, _ = self._dir[key]
            if old_n < n:                       # relocate; reclaim old extent
                self._release(slot, old_n)
                slot = self._alloc(n)
            elif old_n > n:                     # shrink in place; free tail
                self._release(slot + n, old_n - n)
        else:
            slot = self._alloc(n)
        self._dir[key] = (slot, n, len(value))
        return slot, n

    def _release(self, slot: int, n: int) -> None:
        """Return an extent to the free list, coalescing adjacent extents —
        without merging, a repeatedly-growing value would fragment its old
        extents into ever-too-small holes and never reuse them.  An extent
        ending at the high-water mark shrinks it instead."""
        if n <= 0:
            return
        self._free.append((slot, n))
        self._coalesce()

    def _coalesce(self) -> None:
        self._free.sort()
        merged: List[Tuple[int, int]] = []
        for s, m in self._free:
            if merged and merged[-1][0] + merged[-1][1] == s:
                merged[-1] = (merged[-1][0], merged[-1][1] + m)
            else:
                merged.append((s, m))
        while merged and merged[-1][0] + merged[-1][1] == self._next_slot:
            self._next_slot = merged[-1][0]
            merged.pop()
        self._free = merged

    def _alloc(self, n: int) -> int:
        # first fit over the free list before bumping the high-water mark
        for i, (slot, m) in enumerate(self._free):
            if m >= n:
                if m == n:
                    self._free.pop(i)
                else:
                    self._free[i] = (slot + n, m - n)
                return slot
        slot = self._next_slot
        self._next_slot += n
        rows = len(self._table)
        if self._next_slot > rows:
            while rows < self._next_slot:
                rows *= 2
            grown = torch.zeros((rows, self.slot_words), dtype=torch.int32,
                                device=self.device)
            grown[:len(self._table)] = self._table
            self._table = grown
        return slot

    @property
    def free_slots(self) -> int:
        """Reclaimed-but-unreused slots (leak detector for tests)."""
        return sum(m for _, m in self._free)

    @property
    def high_water_slots(self) -> int:
        return self._next_slot

    @property
    def table_bytes(self) -> int:
        """Bytes of the device table (allocated slots, used or not)."""
        return self._table.numel() * 4

    # ------------------------------------------------------------------ get
    def multiget(self, keys: Sequence[str]) -> List[bytes]:
        if not keys:                      # empty batch: no gather, no stats
            return []
        metas = [self._dir[k] for k in keys]
        idx = np.concatenate([np.arange(s, s + n) for s, n, _ in metas])
        rows = self._table.index_select(
            0, torch.from_numpy(idx).to(self.device)).cpu().numpy()
        flat = rows.tobytes()
        out: List[bytes] = []
        off = 0
        for _, n, ln in metas:
            out.append(flat[off:off + ln])
            off += n * self.slot_bytes
        self.stats.n_queries += 1
        self.stats.n_values += len(keys)
        self.stats.bytes_fetched += int(rows.nbytes)
        return out

    def get(self, key: str) -> bytes:
        return self.multiget([key])[0]

    # --------------------------------------------------------------- delete
    def delete(self, key: str) -> None:
        self.multidelete([key])

    def multidelete(self, keys: Sequence[str]) -> None:
        """Remove a batch of keys in one round trip, returning their slot
        extents to the first-fit free list (coalesced via ``_release``).
        Absent keys raise; an empty batch costs nothing."""
        if not keys:
            return
        for k in keys:
            slot, n, _ = self._dir.pop(k)
            if n > 0:
                self._free.append((slot, n))
        self._coalesce()            # one sort+merge for the whole batch
        self.stats.n_delete_queries += 1
        self.stats.n_keys_deleted += len(keys)

    def scan(self) -> List[Tuple[str, bytes]]:
        """Every stored item via the one-gather ``multiget`` machinery —
        one round trip (the replica-rebuild primitive)."""
        keys = list(self._dir)
        return list(zip(keys, self.multiget(keys)))

    def __contains__(self, key: str) -> bool:
        return key in self._dir

    def total_stored_bytes(self) -> int:
        return sum(ln for _, _, ln in self._dir.values())
