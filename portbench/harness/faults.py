"""The control and the planted faults that the comparison must catch.

None of these runs in a measured run.  ``run.py --fault <name>`` and the
tests install one around the window, to show that ``correct`` comes out
false when the timed path is wrong:

- ``stale`` (the control): the program is asked each read one version
  earlier than the reference, breaking the guarantee that a read at version
  ``v`` sees exactly ``v`` (for ingest, that an acknowledged version reads
  back as itself);
- ``unchanged``: a step returns its state unchanged: ``serve`` does the
  work of each wave and hands back the first wave's answers; ``commit``
  stages a version with no writes;
- ``half``: half of the batch left out: ``plan.answer`` returns every
  second record of a set answer; ``commit`` writes every second record;
- ``altered``: an answer altered where it is produced: ``plan.answer``
  flips a byte of each answer it returns; ``commit`` flips a byte of each
  record it writes.

The exchange between chips has no fault here: every cell runs on one chip.
"""
from __future__ import annotations

from .spans import Patches

FAULTS = ("stale", "unchanged", "half", "altered")


def _flip(b: bytes) -> bytes:
    return bytes([b[0] ^ 0xFF]) + b[1:] if b else b"\xff"


def _alter(value):
    if isinstance(value, bytes):
        return _flip(value)
    if isinstance(value, dict) and value:
        k = next(iter(value))
        return {**value, k: _flip(value[k])}
    if isinstance(value, list) and value:
        v, b = value[0]
        return [(v, _flip(b))] + value[1:]
    return value


def _half(value):
    """Every second record of a dict or list answer (or of a commit's
    writes); other answers as they are."""
    if isinstance(value, dict):
        return {k: v for i, (k, v) in enumerate(value.items()) if i % 2 == 0}
    if isinstance(value, list):
        return value[::2]
    return value


def install(name: str) -> Patches:
    """Patch the program for fault ``name`` (``stale`` patches nothing: the
    runner asks its queries a version early)."""
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; have {FAULTS}")
    p = Patches()
    if name == "unchanged":
        first = {}

        def serve(fn):
            def unchanged(self, queries):
                batch = fn(self, queries)
                return first.setdefault("batch", batch)
            return unchanged
        p.replace("repro_torch.serve.engine:StoreQueryEngine.serve", serve)
        p.replace("repro_torch.core.ingest:WriteSession.commit",
                  lambda fn: lambda self, parents, adds, dels=():
                  fn(self, parents, {}, ()))
    elif name == "half":
        p.replace("repro_torch.core.plan:answer",
                  lambda fn: lambda pq, ctx, stats: _half(fn(pq, ctx, stats)))
        p.replace("repro_torch.core.ingest:WriteSession.commit",
                  lambda fn: lambda self, parents, adds, dels=():
                  fn(self, parents, _half(adds), dels))
    elif name == "altered":
        p.replace("repro_torch.core.plan:answer",
                  lambda fn: lambda pq, ctx, stats: _alter(fn(pq, ctx, stats)))
        p.replace("repro_torch.core.ingest:WriteSession.commit",
                  lambda fn: lambda self, parents, adds, dels=():
                  fn(self, parents, {k: _flip(v) for k, v in adds.items()},
                     dels))
    return p
