"""Async ingest: a background group-flusher with bounded lag (§6).

``WriteSession.flush`` group-commits synchronously — commit latency is
bound to backend write round trips, and K concurrent sessions pay K
separate group flushes (K·S round trips on S shards).  This module
decouples the two, in the buffering discipline the versioned-dictionary
line of work studies (Byde & Twigg — the update/query trade-off hinges on
exactly this staging buffer) and with the bounded-staleness semantics the
multi-version coding literature motivates (Ali & Cadambe — tolerating a
bounded lag between *committed* and *durable* versions):

- **Double-buffered staging.**  The *active* buffer is the store's delta
  area (``rs.pending``): ``commit()`` from any number of open
  :class:`~repro_torch.core.ingest.WriteSession`\\ s stages versions there at
  ZERO backend round trips.  A drain swaps the active buffer into the
  *shadow* buffer, prepares its physical writes (chunking, map rebuilds,
  index postings — all in-memory), and commits them in ONE ``multiput``.
  New commits land in the (now empty) active buffer while the shadow is
  in flight, so staging is never blocked on the backend.

- **Watermark triggers.**  A drain fires when the active buffer reaches
  ``max_staged_versions`` or ``max_staged_bytes``, when the oldest staged
  version is ``max_staged_age`` clock steps old, or explicitly via
  ``rs.barrier()``.  Between drains the store runs with *bounded lag*:
  ``staleness_lag`` committed-but-not-yet-durable versions.

- **Cross-session batching.**  One drain commits every staged version
  from every session in one group commit: K sessions on S shards cost
  ≤S write round trips, not K·S.

- **Replay-idempotent failure handling.**  The drain's ``multiput`` runs
  under a :class:`~repro_torch.core.replica.RetryPolicy`.  If retries are
  exhausted the prepared writes stay in the shadow buffer and the staged
  versions SURVIVE: the next drain appends any newly staged work after
  them and re-puts the whole batch.  ``multiput`` is idempotent and
  later duplicates of a key win, so a :class:`BackendTimeout` whose
  write actually applied is re-put harmlessly and newer chunk-map blobs
  supersede stale ones.

- **Virtual step clock.**  The flusher is event-driven off an integer
  step counter (every stage/tick/drain advances it) — no threads, no
  real sleeps, same discipline as ``RetryPolicy``'s simulated backoff.
  Every interleaving of stage/drain/read/compact/kill is deterministic
  and replayable, which the interleaving test harness exploits.

Reads get explicit semantics: ``rs.snapshot()`` (mode ``"fresh"``)
drains first — read-your-writes — while ``rs.snapshot(mode="pinned")``
pins the last durable state and reports its ``staleness_lag``.
Maintenance (``build()`` / ``compact()`` / ``retain()``) takes a drain
barrier before touching layout, so replayed writes never cross a
re-partition.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from . import costmodel
from .replica import RetryPolicy

# Adaptive watermark model (costmodel-derived defaults): a drain should be
# big enough that its transfer time dominates the per-round-trip overhead by
# this factor — bytes = _AMORTIZE_ROUND_TRIPS × PER_QUERY_S × BANDWIDTH_BPS.
_AMORTIZE_ROUND_TRIPS = 16
# Version watermark adapts to the observed average staged-version size
# (byte watermark ÷ avg bytes), clamped so tiny versions can't stage
# unboundedly and huge ones still batch a little.
_MIN_ADAPTIVE_VERSIONS = 8
_MAX_ADAPTIVE_VERSIONS = 8192
_DEFAULT_ADAPTIVE_VERSIONS = 64     # before any version size is observed


@dataclass
class DrainReport:
    """What one :meth:`BackgroundFlusher.drain` did.

    ``write_round_trips`` is measured against the top-of-stack stats
    (retries included), so the ≤S-round-trips contract is assertable
    directly.  An empty drain returns the all-zero report without
    touching the backend — the empty-multiput convention."""

    n_versions: int = 0          # versions made durable by this drain
    n_writes: int = 0            # (key, blob) pairs in the committed batch
    write_round_trips: int = 0   # backend write round trips the drain cost
    replayed: bool = False       # batch included writes from a failed drain
    step: int = 0                # virtual clock at completion


class BackgroundFlusher:
    """Background group-flusher: double-buffered staging with bounded lag.

    Attach with :meth:`~repro_torch.core.ingest.RStore.attach_flusher`; the
    store then allows any number of concurrent ``writer()`` sessions,
    whose commits stage at zero round trips and drain together.  Detach
    (and drain) with :meth:`close`.

    Watermarks: ``max_staged_versions`` / ``max_staged_bytes`` bound the
    active buffer; ``max_staged_age`` (in virtual clock steps, ``None``
    disables) bounds how long the oldest staged version may wait.  The
    lag between committed and durable state is therefore bounded by
    whichever watermark fires first — `staleness_lag` reports it live.

    By default both watermarks are *adaptive*, derived from the cost model
    instead of fixed constants: the byte watermark stages enough data that
    one drain's transfer time amortizes its per-round-trip overhead
    (``costmodel.PER_QUERY_S`` / ``BANDWIDTH_BPS``), and the version
    watermark re-derives from the byte watermark at the observed average
    staged-version size.  Passing an explicit value pins that watermark
    and disables its adaptation.  ``watermarks()`` (surfaced in
    ``storage_stats()["ingest"]``) reports the effective values.

    Online chunking is k=1 only (same restriction as ``flush()``), so
    attaching to a k>1 store raises."""

    def __init__(self, rs, max_staged_versions: Optional[int] = None,
                 max_staged_bytes: Optional[int] = None,
                 max_staged_age: Optional[int] = None,
                 retry: Optional[RetryPolicy] = None) -> None:
        if rs.config.k > 1:
            raise ValueError(
                "BackgroundFlusher needs k == 1 — the online chunking path "
                "cannot re-group sub-chunks (use build() for k > 1 stores)")
        if max_staged_versions is not None and max_staged_versions < 1:
            raise ValueError("max_staged_versions must be >= 1")
        self.rs = rs
        self._adaptive_versions = max_staged_versions is None
        self._adaptive_bytes = max_staged_bytes is None
        self.max_staged_bytes = (
            int(_AMORTIZE_ROUND_TRIPS * costmodel.PER_QUERY_S
                * costmodel.BANDWIDTH_BPS)
            if self._adaptive_bytes else int(max_staged_bytes))
        self.max_staged_versions = (_DEFAULT_ADAPTIVE_VERSIONS
                                    if self._adaptive_versions
                                    else int(max_staged_versions))
        # observed staged-version sizes, across drains (adaptation input)
        self._obs_versions = 0
        self._obs_bytes = 0
        self.max_staged_age = (None if max_staged_age is None
                               else int(max_staged_age))
        self.retry = retry or RetryPolicy()
        self.step = 0                       # virtual clock (event-driven)
        # active buffer: mirrors rs.pending 1:1 — (vid, nbytes, staged_step)
        self._active: List[Tuple[int, int, int]] = []
        self._active_bytes = 0
        # shadow buffer: versions whose physical writes are prepared but
        # not yet acked, plus those writes (the replay list)
        self._shadow_vids: List[int] = []
        self._replay: List[Tuple[str, bytes]] = []
        self._closed = False
        # adopt versions already staged synchronously (their byte sizes
        # were not observed at stage time; they count toward the version
        # watermark and the lag, with 0 recorded bytes)
        for vid in rs.pending:
            self._active.append((vid, 0, self.step))

    # -------------------------------------------------------------- state
    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def staged_versions(self) -> int:
        """Versions in the active buffer (not yet prepared)."""
        return len(self._active)

    @property
    def staged_bytes(self) -> int:
        return self._active_bytes

    @property
    def staleness_lag(self) -> int:
        """Committed-but-not-durable versions: active + shadow buffers."""
        return len(self._active) + len(self._shadow_vids)

    @property
    def has_unacked_writes(self) -> bool:
        """True after a failed drain: prepared writes await replay, so the
        in-memory layout is ahead of the durable state."""
        return bool(self._replay)

    def watermarks(self) -> Dict[str, object]:
        """The effective drain thresholds and where they came from
        (``storage_stats()["ingest"]["watermarks"]``)."""
        return {
            "max_staged_versions": self.max_staged_versions,
            "max_staged_bytes": self.max_staged_bytes,
            "max_staged_age": self.max_staged_age,
            "adaptive_versions": self._adaptive_versions,
            "adaptive_bytes": self._adaptive_bytes,
            "observed_avg_version_bytes": (
                int(self._obs_bytes / self._obs_versions)
                if self._obs_versions else 0),
        }

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError(
                "BackgroundFlusher is closed; attach_flusher() again")

    # ------------------------------------------------------------ staging
    def on_stage(self, vid: int, nbytes: int) -> None:
        """Hook called by the store for every staged version (the commit
        itself already landed in ``rs.pending`` — the active buffer)."""
        self._check_open()
        self.step += 1
        self._active.append((vid, int(nbytes), self.step))
        self._active_bytes += int(nbytes)
        if nbytes > 0:
            self._obs_versions += 1
            self._obs_bytes += int(nbytes)
            if self._adaptive_versions:
                avg = self._obs_bytes / self._obs_versions
                self.max_staged_versions = min(
                    _MAX_ADAPTIVE_VERSIONS,
                    max(_MIN_ADAPTIVE_VERSIONS,
                        int(self.max_staged_bytes // max(avg, 1.0))))
        stats = self.rs.kvs.stats
        stats.n_versions_staged += 1
        if self.staleness_lag > stats.max_observed_lag:
            stats.max_observed_lag = self.staleness_lag
        self._maybe_drain()

    def tick(self, n: int = 1) -> None:
        """Advance the virtual clock by ``n`` steps (an external event:
        a request arrived, a session closed...).  May fire the age
        watermark."""
        self._check_open()
        self.step += int(n)
        self._maybe_drain()

    def _maybe_drain(self) -> None:
        if len(self._active) >= self.max_staged_versions:
            self.drain()
        elif self._active_bytes >= self.max_staged_bytes:
            self.drain()
        elif (self.max_staged_age is not None and self._active
              and self.step - self._active[0][2] >= self.max_staged_age):
            self.drain()

    # ------------------------------------------------------------- drain
    def drain(self) -> DrainReport:
        """Swap buffers and group-commit everything staged: ONE
        ``multiput`` for all sessions' versions plus any replay from a
        previously failed drain.  Empty drain = all-zero report, zero
        round trips, no stats noise.  On backend failure (retries
        exhausted) the prepared writes and staged versions survive for
        the next drain; the exception propagates."""
        self._check_open()
        rs = self.rs
        if not rs.pending and not self._replay:
            return DrainReport(step=self.step)
        self.step += 1
        replayed = bool(self._replay)
        if rs.pending:
            batch = list(rs.pending)
            rs.pending = []
            self._shadow_vids.extend(batch)
            # newly prepared writes go AFTER any replay: within one
            # multiput later duplicates win, so fresher chunk-map/posting
            # blobs supersede the stale copies from the failed attempt
            self._replay.extend(rs._prepare_flush_writes(batch))
        self._active = []
        self._active_bytes = 0
        stats = rs.kvs.stats
        p0 = stats.n_put_queries
        self.retry.call(lambda: rs.kvs.multiput(self._replay), stats)
        report = DrainReport(
            n_versions=len(self._shadow_vids),
            n_writes=len(self._replay),
            write_round_trips=stats.n_put_queries - p0,
            replayed=replayed,
            step=self.step)
        stats.n_flush_batches += 1
        self._shadow_vids = []
        self._replay = []
        rs._flushed_versions = rs.graph.num_versions
        return report

    # ------------------------------------------------------------- close
    def close(self) -> Optional[DrainReport]:
        """Drain outstanding work and detach from the store (which
        returns to synchronous one-writer semantics).  Idempotent:
        a second close is a no-op returning ``None``."""
        if self._closed:
            return None
        report = self.drain()
        self._closed = True
        if self.rs._flusher is self:
            self.rs._flusher = None
        return report
