"""Serving engines: the store's query front-end and the LLM decode loop.

:class:`StoreQueryEngine` is the RStore serving surface: it pins a snapshot
per wave of queries and routes every wave through the unified planner
(:mod:`repro_torch.core.plan` via ``Snapshot.execute`` — the same
one-launch / one-multiget pipeline the session API uses), re-snapshotting
when a full rebuild invalidates the pin.

:class:`Engine` is the batched LLM engine: prefill, then greedy decode in a
Python loop of ``decode_step`` (the reference's jitted ``lax.scan`` over
steps), each step writing its K/V into the padded caches in place (the
counterpart of the reference's donated caches).
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import torch

from .. import trace
from ..models.config import ModelConfig
from ..models.model import build_model


class StoreQueryEngine:
    """Store-serving front-end: waves of queries over pinned snapshots.

    Holds one snapshot at a time and executes whole waves against it —
    planning, kernel launches and the KVS multiget are batched per wave by
    the planner, not per query.  A full ``build()`` under the engine
    invalidates the pin and the next wave re-snapshots; a layout change
    that keeps content just re-pins via ``snapshot.refresh()``.
    """

    def __init__(self, rs) -> None:
        self.rs = rs
        self._snap = None
        self.waves_served = 0
        self.repins = 0

    def snapshot(self):
        """The current pinned snapshot (taken lazily, kept across waves)."""
        if self._snap is None:
            self._snap = self.rs.snapshot()
        return self._snap

    def _fresh_snapshot(self):
        snap = self.snapshot()
        try:
            snap._check_fresh()
        except RuntimeError:
            try:
                snap = snap.refresh()          # layout change: re-pin in place
            except RuntimeError:
                snap = self.rs.snapshot()      # full rebuild: new snapshot
            self._snap = snap
            self.repins += 1
        return snap

    def serve(self, queries: Sequence[Any]):
        """Execute one wave → :class:`~repro_torch.core.plan.BatchResult`
        (traced as one ``read.request``)."""
        tr = trace.ACTIVE
        if tr is not None:
            tr.open("read.request")
        try:
            batch = self._fresh_snapshot().execute(list(queries))
        finally:
            if tr is not None:
                tr.close()
        self.waves_served += 1
        return batch

    def explain(self, queries: Sequence[Any]) -> List[Dict[str, Any]]:
        """Rendered plans + predicted costs for a wave (no execution)."""
        return self._fresh_snapshot().explain(list(queries))

    def warm(self, queries: Sequence[Any]) -> Dict[str, int]:
        """Prefetch a wave's chunks into the cache layer, if one is on."""
        return self._fresh_snapshot().prefetch(list(queries))


class Engine:
    def __init__(self, cfg: ModelConfig, params, max_len: int = 4096):
        self.cfg = cfg
        self.model = build_model(cfg)
        self.params = params
        self.max_len = max_len

    @torch.no_grad()
    def generate(self, batch: Dict[str, torch.Tensor], steps: int
                 ) -> torch.Tensor:
        """Greedy-decode ``steps`` tokens after the prompt → (B, steps)
        int32, on the params' device."""
        prompt_len = batch["tokens"].shape[1]
        if prompt_len + steps > self.max_len:
            raise ValueError(f"exceeds cache capacity: prompt {prompt_len} + "
                             f"{steps} steps > max_len {self.max_len}")
        logits, caches = self.model.prefill(self.params, batch,
                                            max_len=self.max_len)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        toks = [tok]
        for pos in range(prompt_len, prompt_len + steps - 1):
            nxt, caches = self.model.decode_step(self.params, caches, tok, pos)
            tok = nxt[:, None]
            toks.append(tok)
        return torch.cat(toks, dim=1)
