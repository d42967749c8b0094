"""Serve-side ingest frontend: many named clients, one store, one flusher.

The serving tier terminates many concurrent client connections; giving
each its own :class:`~repro_torch.core.ingest.RStore` (or serializing them
through the one-writer sync path) wastes exactly the batching the
:class:`~repro_torch.core.flusher.BackgroundFlusher` exists to exploit.
:class:`IngestGateway` multiplexes named clients onto ONE store with a
flusher attached: every client's ``commit()`` stages at zero backend
round trips, and all clients' versions drain together in one group
commit per watermark (≤S write round trips on S shards, however many
clients are connected).

The gateway is deliberately thin — sessions are plain
:class:`~repro_torch.core.ingest.WriteSession` objects in async mode; the
gateway adds per-client bookkeeping (staged counts for fair-share
accounting, mirroring the per-tenant direction in ROADMAP) and the
request-level entry points a server loop would expose: ``commit`` /
``barrier`` / ``snapshot`` / ``report``.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

from ..core.ingest import RStore, WriteSession


class IngestGateway:
    """Multiplex named clients onto one RStore + BackgroundFlusher.

    ``flusher_kw`` is forwarded to :meth:`RStore.attach_flusher` unless
    the store already has a flusher (then it must be empty — the gateway
    adopts the existing one rather than silently ignoring conflicting
    watermarks)."""

    def __init__(self, rs: RStore, **flusher_kw) -> None:
        self.rs = rs
        if rs.flusher is not None:
            if flusher_kw:
                raise ValueError(
                    "store already has a BackgroundFlusher attached; "
                    "gateway flusher kwargs would be ignored")
            self.flusher = rs.flusher
        else:
            self.flusher = rs.attach_flusher(**flusher_kw)
        self._sessions: Dict[str, WriteSession] = {}
        self._staged_by_client: Dict[str, int] = {}

    # ------------------------------------------------------------- sessions
    def open_session(self, client: str) -> WriteSession:
        """Open (or return) ``client``'s write session."""
        ws = self._sessions.get(client)
        if ws is None or ws._closed:
            ws = self.rs.writer()
            self._sessions[client] = ws
            self._staged_by_client.setdefault(client, 0)
        return ws

    def close_session(self, client: str) -> None:
        """Close ``client``'s session (no drain — watermarks own that).
        Unknown/already-closed clients are a no-op."""
        ws = self._sessions.pop(client, None)
        if ws is not None:
            ws.close()

    @property
    def open_clients(self) -> Sequence[str]:
        return sorted(c for c, ws in self._sessions.items()
                      if not ws._closed)

    # --------------------------------------------------------------- ingest
    def init_root(self, client: str, records: Dict[int, bytes]) -> int:
        vid = self.open_session(client).init_root(records)
        self._staged_by_client[client] += 1
        return vid

    def commit(self, client: str, parents: Sequence[int],
               adds: Dict[int, bytes], dels: Iterable[int] = ()) -> int:
        """Stage one commit for ``client`` — zero backend round trips;
        durability comes from the shared flusher's watermarks or
        :meth:`barrier`."""
        vid = self.open_session(client).commit(parents, adds, dels)
        self._staged_by_client[client] += 1
        return vid

    def barrier(self):
        """Drain on behalf of every client (one group commit)."""
        return self.rs.barrier()

    # ---------------------------------------------------------------- reads
    def snapshot(self, mode: str = "fresh"):
        return self.rs.snapshot(mode=mode)

    # ------------------------------------------------------------ reporting
    def report(self) -> Dict[str, object]:
        """Per-client staged totals plus the store's ingest sub-report."""
        return {
            "clients": dict(self._staged_by_client),
            "open_sessions": len(self.open_clients),
            "ingest": self.rs.storage_stats()["ingest"],
        }

    # ------------------------------------------------------------- shutdown
    def close(self) -> None:
        """Close every session and the flusher (final drain), returning
        the store to synchronous ingest.  Idempotent."""
        for client in list(self._sessions):
            self.close_session(client)
        self.flusher.close()
