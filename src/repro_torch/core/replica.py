"""Replication & fault tolerance: replica groups over the Backend protocol.

The paper inherits replication and availability from Cassandra (§2.4 — RStore
"assumes only get/multiget" of a distributed KV store that is itself
replicated and fault tolerant).  Our :class:`~repro_torch.core.kvs.ShardedKVS`
router had neither: one lost or flaky shard killed every snapshot read, group
commit, and compaction pass.  This module supplies the missing layer, in the
regime the multi-version coding line of work studies (Wang & Cadambe;
Ali & Cadambe — serving consistent versioned data from servers that fail and
lag):

- An error taxonomy rooted at :class:`BackendUnavailable`, distinguishing
  *recoverable* faults (:class:`TransientBackendError`,
  :class:`BackendTimeout` — retry) from *hard* ones (:class:`ShardDown` —
  fail over) and *write-path* ones (:class:`QuorumLost` — the group could
  not ack).  Crucially distinct from ``KeyError``: a missing key is a
  data-level miss and must never trigger a failover.

- :class:`FaultInjectingKVS`, a Backend wrapper with a deterministic seeded
  fault schedule (transient errors, simulated timeouts, hard ``kill()``)
  so every degraded-mode path is testable and byte-reproducible.

- :class:`RetryPolicy`, capped exponential backoff with deterministic
  jitter.  Nothing sleeps: the backoff the retries *would* have slept is
  accumulated in ``KVSStats.simulated_backoff_seconds`` (the same simulated-
  time convention as ``simulated_seconds``), alongside ``n_retries`` and
  ``n_failovers``.

- :class:`ReplicatedKVS`, an N-way replica group implementing the full
  Backend protocol.  Writes fan out to all live replicas with a write-ack
  quorum (default 1 — Cassandra consistency ONE, availability-first, so an
  R=2 group survives one death).  Reads go to one preferred replica and
  fail over per batch to the next on error — a failed-over batch costs at
  most one extra round trip, and a replica seen hard-down is skipped at
  zero cost until recovered.  Replicas that miss writes while unreachable
  accumulate a repair log that read-repair backfills before the replica
  serves again.

- :class:`RecoveryManager`, which ``rebuild()``\\ s a lost replica from
  survivors in O(1) round trips per surviving peer (one ``scan`` of one
  survivor + a bounded constant on the target), clearing the repair log
  and restoring the replica to the read rotation.

Composed under the hash router (``make_sharded_backend(...,
replication_factor=R)`` in :mod:`repro_torch.launch.mesh`), the read session
(:mod:`repro_torch.core.api`), group flush (:mod:`repro_torch.core.ingest`), and
compaction GC (:mod:`repro_torch.core.compact`) all survive a replica death
mid-workload unchanged — the group absorbs the fault below the router.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .kvs import Backend, KVSStats


# ------------------------------------------------------------ error taxonomy
class BackendUnavailable(RuntimeError):
    """A backend (or a whole replica group) could not serve the request.

    Root of the fault taxonomy.  Deliberately disjoint from ``KeyError``:
    "missing key" is an answer, "shard down" is not — failover logic retries
    or re-routes only the latter."""


class TransientBackendError(BackendUnavailable):
    """Recoverable blip (dropped connection, leader election, overload
    shedding).  The request was NOT applied; retrying is safe."""


class BackendTimeout(BackendUnavailable):
    """The request timed out.  A timed-out *write* may or may not have been
    applied (the ack was lost, not necessarily the write) — retries must be
    idempotent, which ``multiput`` is."""


class ShardDown(BackendUnavailable):
    """Hard failure: the shard is gone until explicitly recovered.  Retrying
    the same replica is pointless; fail over instead."""


class QuorumLost(BackendUnavailable):
    """A replicated write could not reach its write-ack quorum."""


# ------------------------------------------------------------- retry policy
@dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff with deterministic jitter.

    ``call(fn, stats)`` retries ``fn`` on recoverable faults
    (:class:`TransientBackendError` / :class:`BackendTimeout`) up to
    ``max_retries`` times; :class:`ShardDown` propagates immediately (the
    caller's failover concern, not a retry concern).  No wall-clock sleep
    happens: each retry's backoff is added to
    ``stats.simulated_backoff_seconds`` and counted in ``stats.n_retries``,
    keeping the whole fault path deterministic and fast under test.

    Jitter is derived from ``crc32(seed, attempt)`` — same policy, same
    attempt, same delay, every run (the §2.3 simulated-cost discipline
    applied to failure handling)."""

    max_retries: int = 4
    base_delay_s: float = 0.01
    max_delay_s: float = 1.0
    multiplier: float = 2.0
    jitter_frac: float = 0.1
    seed: int = 0

    def backoff(self, attempt: int) -> float:
        """Simulated delay before retry ``attempt`` (1-based): capped
        exponential, jittered deterministically within ±``jitter_frac``."""
        raw = min(self.max_delay_s,
                  self.base_delay_s * self.multiplier ** (attempt - 1))
        u = zlib.crc32(f"{self.seed}:{attempt}".encode()) / 2**32
        return raw * (1.0 - self.jitter_frac + 2.0 * self.jitter_frac * u)

    def call(self, fn: Callable, stats: Optional[KVSStats] = None):
        attempt = 0
        while True:
            try:
                return fn()
            except ShardDown:
                raise
            except BackendUnavailable:
                attempt += 1
                if attempt > self.max_retries:
                    raise
                if stats is not None:
                    stats.n_retries += 1
                    stats.simulated_backoff_seconds += self.backoff(attempt)


# ---------------------------------------------------------- fault injection
class FaultInjectingKVS:
    """Backend wrapper with a deterministic seeded fault schedule.

    Each data op draws from a seeded stream: with probability ``p_transient``
    it raises :class:`TransientBackendError` *before* touching the inner
    backend; with probability ``p_timeout`` it simulates a lost ack —
    reads and (non-idempotent) deletes raise before applying, while
    ``multiput`` applies first and *then* raises :class:`BackendTimeout`,
    so retry paths are exercised against the ambiguous-write case.  At most
    ``max_consecutive_faults`` faults fire in a row, so any retry loop with
    ``max_retries >= max_consecutive_faults`` is guaranteed to converge —
    the property tests lean on that bound.

    ``kill()`` takes the shard hard-down (every op raises
    :class:`ShardDown`) until ``revive()``; a revived shard answers again
    but may be arbitrarily stale — that's :class:`RecoveryManager`'s
    problem.  ``stats`` delegates to the inner backend so round-trip
    accounting sees through the wrapper."""

    def __init__(self, inner: Backend, seed: int = 0,
                 p_transient: float = 0.0, p_timeout: float = 0.0,
                 max_consecutive_faults: int = 2) -> None:
        self.inner = inner
        self.seed = int(seed)
        self.p_transient = float(p_transient)
        self.p_timeout = float(p_timeout)
        self.max_consecutive_faults = int(max_consecutive_faults)
        self._rng = np.random.default_rng(self.seed)
        self._down = False
        self._consecutive = 0
        self._forced: List[str] = []    # schedule_faults() queue, FIFO
        self.n_transient_injected = 0
        self.n_timeouts_injected = 0
        self.n_down_rejections = 0

    @property
    def stats(self) -> KVSStats:
        return self.inner.stats

    # ------------------------------------------------------------- schedule
    def kill(self) -> None:
        """Hard shard-down: every subsequent op raises ShardDown."""
        self._down = True

    def revive(self) -> None:
        """The shard answers again — with whatever (stale) data it has."""
        self._down = False

    @property
    def is_down(self) -> bool:
        return self._down

    def schedule_faults(self, kinds: Sequence[str]) -> None:
        """Deterministic fault queue for interleaving tests: the next
        ``len(kinds)`` data ops consume these verbatim (``"transient"`` /
        ``"timeout"`` / ``"ok"``) instead of drawing from the seeded
        probability stream.  The ``max_consecutive_faults`` bound does
        NOT apply to scheduled faults — an explicit schedule is the
        test's own contract; pair it with a retry budget that covers it."""
        kinds = list(kinds)
        bad = set(kinds) - {"transient", "timeout", "ok"}
        if bad:
            raise ValueError(f"unknown fault kind(s) {sorted(bad)}; "
                             "expected 'transient' | 'timeout' | 'ok'")
        self._forced.extend(kinds)

    def _next_fault(self) -> Optional[str]:
        if self._down:
            self.n_down_rejections += 1
            raise ShardDown(f"shard killed (seed={self.seed})")
        if self._forced:
            kind = self._forced.pop(0)
            if kind == "transient":
                self.n_transient_injected += 1
                return "transient"
            if kind == "timeout":
                self.n_timeouts_injected += 1
                return "timeout"
            return None
        if self.p_transient <= 0.0 and self.p_timeout <= 0.0:
            return None
        u = float(self._rng.random())
        if self._consecutive >= self.max_consecutive_faults:
            self._consecutive = 0          # bounded: force a success
            return None
        if u < self.p_transient:
            self._consecutive += 1
            self.n_transient_injected += 1
            return "transient"
        if u < self.p_transient + self.p_timeout:
            self._consecutive += 1
            self.n_timeouts_injected += 1
            return "timeout"
        self._consecutive = 0
        return None

    def _raise_pre(self, fault: Optional[str]) -> None:
        if fault == "transient":
            raise TransientBackendError(f"injected transient (seed={self.seed})")
        if fault == "timeout":
            raise BackendTimeout(f"injected timeout (seed={self.seed})")

    # ---------------------------------------------------------------- reads
    def multiget(self, keys: Sequence[str]) -> List[bytes]:
        self._raise_pre(self._next_fault())
        return self.inner.multiget(keys)

    def get(self, key: str) -> bytes:
        return self.multiget([key])[0]

    def scan(self) -> List[Tuple[str, bytes]]:
        self._raise_pre(self._next_fault())
        return self.inner.scan()

    # --------------------------------------------------------------- writes
    def multiput(self, items: Sequence[Tuple[str, bytes]]) -> None:
        fault = self._next_fault()
        if fault == "transient":           # not applied: retry is a clean redo
            raise TransientBackendError(
                f"injected transient (seed={self.seed})")
        self.inner.multiput(items)
        if fault == "timeout":             # applied, ack lost: retry re-puts
            raise BackendTimeout(f"injected timeout (seed={self.seed})")

    def put(self, key: str, value: bytes) -> None:
        self.multiput([(key, value)])

    def multidelete(self, keys: Sequence[str]) -> None:
        # deletes are not idempotent (absent keys raise), so both fault
        # kinds fire before applying
        self._raise_pre(self._next_fault())
        self.inner.multidelete(keys)

    def delete(self, key: str) -> None:
        self.multidelete([key])

    # ----------------------------------------------------------------- misc
    def __contains__(self, key: str) -> bool:
        if self._down:
            self.n_down_rejections += 1
            raise ShardDown(f"shard killed (seed={self.seed})")
        return key in self.inner

    def total_stored_bytes(self) -> int:
        if self._down:
            self.n_down_rejections += 1
            raise ShardDown(f"shard killed (seed={self.seed})")
        return self.inner.total_stored_bytes()  # type: ignore[attr-defined]


# ------------------------------------------------------------ replica group
class ReplicatedKVS:
    """N-way replica group implementing the full Backend protocol.

    **Writes** (``multiput``/``multidelete``) fan out to every live replica;
    ``write_quorum`` successful acks are required (default 1 — Cassandra
    consistency ONE: an R=2 group keeps accepting writes with one replica
    dead).  A replica that misses a write — hard-down, or a live replica
    whose retries ran out — gets the miss recorded in its *repair log*
    (key → value, or a ``None`` tombstone for a missed delete), so the group
    always knows exactly what each replica lacks.

    **Reads** (``multiget``/``get``/``scan``) go to one *preferred* replica.
    If its repair log is non-empty it is backfilled first (read-repair), so
    a replica never serves stale data.  On :class:`ShardDown` the replica is
    marked down — skipped at zero cost by every later op — and the read
    fails over to the next live replica: a failed-over batch costs at most
    ONE extra round trip (``stats.n_failovers`` counts the hops), and
    subsequent batches pay zero extra.  ``KeyError`` is *not* a failure:
    a missing key propagates without failover.

    ``stats`` counts group-level traffic: one logical write round trip per
    fan-out (replication is parallel), read round trips = attempts actually
    made (1 + failover hops).  Per-replica counters stay on the replicas.
    """

    def __init__(self, replicas: Sequence[Backend], write_quorum: int = 1,
                 retry: Optional[RetryPolicy] = None) -> None:
        if not replicas:
            raise ValueError("ReplicatedKVS needs at least one replica")
        self.replicas: List[Backend] = list(replicas)
        if not (1 <= int(write_quorum) <= len(self.replicas)):
            raise ValueError(
                f"write_quorum must be in [1, {len(self.replicas)}]")
        self.write_quorum = int(write_quorum)
        self.retry = retry or RetryPolicy()
        self.stats = KVSStats()
        self._live: List[bool] = [True] * len(self.replicas)
        self._preferred = 0
        # per-replica repair log: key -> bytes (missed put) | None (missed
        # delete).  Invariant: a replica was in sync when it last went
        # unreachable, so log ∪ its stored state reconstructs the truth.
        self._repair: List[Dict[str, Optional[bytes]]] = [
            {} for _ in self.replicas]

    # ------------------------------------------------------------ liveness
    @property
    def live(self) -> Tuple[bool, ...]:
        return tuple(self._live)

    @property
    def preferred(self) -> int:
        return self._preferred

    def n_live(self) -> int:
        return sum(self._live)

    def mark_down(self, i: int) -> None:
        self._live[i] = False
        if self._preferred == i and any(self._live):
            self._preferred = min(j for j, lv in enumerate(self._live) if lv)

    def mark_live(self, i: int) -> None:
        """Return replica ``i`` to the rotation (its repair log, if any,
        is backfilled before it serves a read).  Preference returns to the
        lowest-index live replica — deterministic read placement."""
        self._live[i] = True
        self._preferred = min(j for j, lv in enumerate(self._live) if lv)

    # -------------------------------------------------------------- repair
    def pending_repairs(self, i: int) -> int:
        return len(self._repair[i])

    def _flush_repair(self, i: int) -> None:
        """Backfill replica ``i``'s missed writes (read-repair).  Applies
        missed puts, then missed deletes — filtered to keys the replica
        actually holds, because a put-then-delete missed entirely leaves a
        tombstone for a key the replica never saw."""
        rep = self._repair[i]
        if not rep:
            return
        r = self.replicas[i]
        puts = [(k, v) for k, v in rep.items() if v is not None]
        if puts:
            self.retry.call(lambda: r.multiput(puts), self.stats)
            for k, _ in puts:
                del rep[k]
        tombs = [k for k, v in rep.items() if v is None]
        dels = [k for k in tombs if k in r]
        if dels:
            self.retry.call(lambda: r.multidelete(dels), self.stats)
        for k in tombs:
            del rep[k]

    def _record_miss_put(self, i: int, items: Sequence[Tuple[str, bytes]]) -> None:
        rep = self._repair[i]
        for k, v in items:
            rep[k] = v

    def _record_miss_delete(self, i: int, keys: Sequence[str]) -> None:
        rep = self._repair[i]
        for k in keys:
            rep[k] = None

    # ---------------------------------------------------------------- reads
    def _read(self, op: Callable[[Backend], object]) -> Tuple[object, int]:
        """Run ``op`` against the preferred replica, failing over per batch.
        Returns (result, attempts).  KeyError propagates untouched — a miss
        is an answer, not a fault."""
        n = len(self.replicas)
        attempts = 0
        last: Optional[BackendUnavailable] = None
        # capture the rotation up front: mark_down() moves _preferred, and
        # the failover order must not chase it mid-loop
        order = [(self._preferred + j) % n for j in range(n)]
        for i in order:
            if not self._live[i]:
                continue                    # known-down: zero-cost skip
            r = self.replicas[i]
            attempts += 1
            try:
                self._flush_repair(i)       # read-repair before serving
                out = self.retry.call(lambda: op(r), self.stats)
            except ShardDown as e:
                self.mark_down(i)
                self.stats.n_failovers += 1
                last = e
                continue
            except BackendUnavailable as e:
                self.stats.n_failovers += 1  # flaky but not hard-down
                last = e
                continue
            self._preferred = i
            return out, attempts
        raise last or ShardDown(
            f"all {n} replicas of the group are down")

    def multiget(self, keys: Sequence[str]) -> List[bytes]:
        if not keys:
            return []
        keys = list(keys)
        vals, attempts = self._read(lambda r: r.multiget(keys))
        self.stats.n_queries += attempts
        self.stats.n_values += len(vals)            # type: ignore[arg-type]
        self.stats.bytes_fetched += sum(len(v) for v in vals)  # type: ignore
        return vals                                  # type: ignore[return-value]

    def get(self, key: str) -> bytes:
        return self.multiget([key])[0]

    def scan(self) -> List[Tuple[str, bytes]]:
        items, attempts = self._read(lambda r: r.scan())
        self.stats.n_queries += attempts
        self.stats.n_values += len(items)           # type: ignore[arg-type]
        self.stats.bytes_fetched += sum(len(v) for _, v in items)  # type: ignore
        return items                                 # type: ignore[return-value]

    def multiget_naive(self, keys: Sequence[str]) -> List[bytes]:
        return [self.get(k) for k in keys]

    # --------------------------------------------------------------- writes
    def multiput(self, items: Sequence[Tuple[str, bytes]]) -> None:
        if not items:
            return
        items = list(items)
        acks = 0
        for i, r in enumerate(self.replicas):
            if not self._live[i]:
                self._record_miss_put(i, items)
                continue
            try:
                self._flush_repair(i)       # missed writes land first, in order
                self.retry.call(lambda r=r: r.multiput(items), self.stats)
                acks += 1
            except ShardDown:
                self.mark_down(i)
                self._record_miss_put(i, items)
            except BackendUnavailable:
                self._record_miss_put(i, items)
        if acks < self.write_quorum:
            raise QuorumLost(
                f"multiput acked by {acks}/{len(self.replicas)} replicas, "
                f"quorum is {self.write_quorum}")
        self.stats.n_put_queries += 1       # one logical (parallel) round trip
        self.stats.n_values_put += len(items)
        self.stats.bytes_stored += sum(len(v) for _, v in items)

    def put(self, key: str, value: bytes) -> None:
        self.multiput([(key, value)])

    def multidelete(self, keys: Sequence[str]) -> None:
        if not keys:
            return
        keys = list(keys)
        acks = 0
        for i, r in enumerate(self.replicas):
            if not self._live[i]:
                self._record_miss_delete(i, keys)
                continue
            try:
                self._flush_repair(i)
                self.retry.call(lambda r=r: r.multidelete(keys), self.stats)
                acks += 1
            except ShardDown:
                self.mark_down(i)
                self._record_miss_delete(i, keys)
            except BackendUnavailable:
                self._record_miss_delete(i, keys)
        if acks < self.write_quorum:
            raise QuorumLost(
                f"multidelete acked by {acks}/{len(self.replicas)} replicas, "
                f"quorum is {self.write_quorum}")
        self.stats.n_delete_queries += 1
        self.stats.n_keys_deleted += len(keys)

    def delete(self, key: str) -> None:
        self.multidelete([key])

    # ----------------------------------------------------------------- misc
    def __contains__(self, key: str) -> bool:
        n = len(self.replicas)
        order = [(self._preferred + j) % n for j in range(n)]
        for i in order:
            if not self._live[i]:
                continue
            rep = self._repair[i]
            if key in rep:                  # pending state is the truth
                return rep[key] is not None
            try:
                return key in self.replicas[i]
            except ShardDown:
                self.mark_down(i)
            except BackendUnavailable:
                continue
        raise ShardDown(f"all {n} replicas of the group are down")

    def total_stored_bytes(self) -> int:
        """Logical bytes (one copy), from the first answering live replica.
        Metrics-path: no stats, no failover accounting, no repair flush."""
        for j in range(len(self.replicas)):
            i = (self._preferred + j) % len(self.replicas)
            if not self._live[i]:
                continue
            try:
                return self.replicas[i].total_stored_bytes()  # type: ignore
            except BackendUnavailable:
                continue
        raise ShardDown("all replicas of the group are down")

    def replica_stats(self) -> List[KVSStats]:
        return [r.stats for r in self.replicas]


# ---------------------------------------------------------------- recovery
@dataclass
class RecoveryReport:
    """What one :meth:`RecoveryManager.rebuild` did, with its round-trip
    budget: one ``scan`` of one surviving peer, plus a constant (≤3 ops)
    on the target."""

    shard: Optional[int]
    replica: int
    source: int
    keys_copied: int = 0
    bytes_copied: int = 0
    stale_keys_deleted: int = 0
    read_round_trips: int = 0
    write_round_trips: int = 0
    delete_round_trips: int = 0

    @property
    def round_trips(self) -> int:
        return (self.read_round_trips + self.write_round_trips
                + self.delete_round_trips)


class RecoveryManager:
    """Rebuilds lost replicas from survivors.

    Wraps either a single :class:`ReplicatedKVS` group or a
    :class:`~repro_torch.core.kvs.ShardedKVS` router whose shards are replica
    groups.  ``rebuild(replica, shard=...)`` reconstructs one replica:

    1. pick the first live survivor, flush its repair log (its copy is then
       authoritative) and ``scan`` it — ONE read round trip on that peer;
    2. ``scan`` the target (revived-but-stale, or a fresh replacement),
       delete its stale keys, and copy every missing/changed value in one
       ``multiput`` — at most three ops on the target, never more;
    3. clear the target's repair log and return it to the read rotation
       (preference returns to the lowest live index, so a rebuilt replica 0
       serves reads again immediately).

    The target must be reachable (revive it, or swap in a fresh backend at
    ``group.replicas[i]``) — rebuilding a shard that still raises
    :class:`ShardDown` fails loudly."""

    def __init__(self, backend) -> None:
        self.backend = backend

    # ------------------------------------------------------------- helpers
    def _group(self, shard: Optional[int]) -> ReplicatedKVS:
        if isinstance(self.backend, ReplicatedKVS):
            if shard not in (None, 0):
                raise ValueError("backend is a single replica group; "
                                 "shard must be None")
            return self.backend
        shards = getattr(self.backend, "shards", None)
        if shards is None:
            raise TypeError("RecoveryManager needs a ReplicatedKVS or a "
                            "ShardedKVS over ReplicatedKVS groups")
        if shard is None:
            raise ValueError("backend is sharded; pass shard=<index>")
        group = shards[shard]
        if not isinstance(group, ReplicatedKVS):
            raise TypeError(f"shard {shard} is not a ReplicatedKVS")
        return group

    def groups(self) -> List[Tuple[Optional[int], ReplicatedKVS]]:
        if isinstance(self.backend, ReplicatedKVS):
            return [(None, self.backend)]
        return [(i, g) for i, g in enumerate(self.backend.shards)
                if isinstance(g, ReplicatedKVS)]

    # -------------------------------------------------------------- rebuild
    def rebuild(self, replica: int, shard: Optional[int] = None,
                ) -> RecoveryReport:
        group = self._group(shard)
        n = len(group.replicas)
        if not (0 <= replica < n):
            raise ValueError(f"replica index {replica} out of range [0,{n})")
        target = group.replicas[replica]

        # survivor selection fails over, like every read: a candidate whose
        # live flag is stale (killed since its last op) must not crash the
        # rebuild — mark it down and try the next peer.  Its copy becomes
        # authoritative only after its repair log flushes, so the flush is
        # inside the guarded attempt too.
        source = None
        want = None
        last_err: Optional[BackendUnavailable] = None
        start = group.preferred   # pin: mark_down below moves the preference
        for j in range(n):
            i = (start + j) % n
            if i == replica or not group._live[i]:
                continue
            try:
                # survivor: repair log flushed -> authoritative; ONE scan
                group._flush_repair(i)
                want = dict(group.retry.call(
                    lambda i=i: group.replicas[i].scan(), group.stats))
                source = i
                break
            except ShardDown as e:
                group.mark_down(i)
                group.stats.n_failovers += 1
                last_err = e
            except BackendUnavailable as e:
                group.stats.n_failovers += 1
                last_err = e
        if source is None:
            raise last_err or ShardDown("no live survivor to rebuild from")

        # target: diff against its (possibly stale, possibly empty) state
        have = dict(group.retry.call(lambda: target.scan(), group.stats))
        stale = [k for k in have if k not in want]
        if stale:
            group.retry.call(lambda: target.multidelete(stale), group.stats)
        to_put = [(k, v) for k, v in want.items() if have.get(k) != v]
        if to_put:
            group.retry.call(lambda: target.multiput(to_put), group.stats)

        group._repair[replica].clear()
        group.mark_live(replica)
        return RecoveryReport(
            shard=shard, replica=replica, source=source,
            keys_copied=len(to_put),
            bytes_copied=sum(len(v) for _, v in to_put),
            stale_keys_deleted=len(stale),
            read_round_trips=2,
            write_round_trips=1 if to_put else 0,
            delete_round_trips=1 if stale else 0)

    def recover_all(self) -> List[RecoveryReport]:
        """Rebuild every down replica and flush every live replica's repair
        log, leaving all groups fully replicated and in sync."""
        reports: List[RecoveryReport] = []
        for shard, group in self.groups():
            for i, lv in enumerate(group.live):
                if not lv:
                    reports.append(self.rebuild(i, shard=shard))
            for i in range(len(group.replicas)):
                if not group._live[i]:
                    continue
                try:
                    group._flush_repair(i)
                except ShardDown:
                    # stale-live replica discovered dead mid-flush: out of
                    # the rotation; its repair log is kept (flush removes
                    # ops only after they apply) for the next rebuild
                    group.mark_down(i)
                except BackendUnavailable:
                    pass  # flaky, not dead: log stays; a later flush retries
        return reports
