"""State carried across: build a port store from another store's dumped
state.

The state is plain data — numpy arrays, bytes and ints — so any store with
the same layout (the reference package's included) can hand its content
over without this package importing it:

- ``cks``, ``sizes``, ``payloads``: the record store, in record-id order
  (``payloads`` may be ``None`` for a size-only store);
- ``versions``: ``(vid, parents, adds, dels)`` per version in insertion
  order, ``adds``/``dels`` being record ids relative to the first parent
  (the version graph's tree deltas);
- ``r2c``: record id → chunk id;
- ``chunk_records``: chunk id → record ids in stored order;
- ``items``: the backend's ``scan()`` — every ``(key, blob)`` it holds.

The blobs are written to the new store's backend as they are, so the
result answers the same queries from the same bytes.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from .core.index import Projections
from .core.ingest import RStore, RStoreConfig
from .core.kvs import Backend
from .device import DeviceLike


def rstore_from_state(state: Dict[str, Any],
                      config: Optional[RStoreConfig] = None,
                      kvs: Optional[Backend] = None,
                      device: DeviceLike = None) -> RStore:
    """A port :class:`RStore` holding ``state`` (see the module docstring);
    its backend receives ``state["items"]`` in one ``multiput``."""
    rs = RStore(config, kvs, device=device)
    store = rs.graph.store
    store.add_batch(np.asarray(state["cks"], dtype=np.int64),
                    np.asarray(state["sizes"], dtype=np.int64),
                    state.get("payloads"))
    for vid, parents, adds, dels in state["versions"]:
        if not parents:
            rs.graph.add_root(int(vid), adds)
        else:
            rs.graph.add_version(int(vid), [int(p) for p in parents], adds,
                                 dels)
    rs._next_vid = max(rs.graph.versions, default=-1) + 1
    rs.r2c = np.asarray(state["r2c"], dtype=np.int64).copy()
    rs._chunk_records = {int(c): np.asarray(r, dtype=np.int64)
                         for c, r in state["chunk_records"].items()}
    rs.n_chunks = max(rs._chunk_records, default=-1) + 1
    items = list(state["items"])
    rs._chunk_bytes = {int(k.split("/", 1)[1]): len(v) for k, v in items
                       if k.startswith("chunk/")}
    rs.proj = Projections.build_from_r2c(rs.graph, rs.r2c, rs.n_chunks)
    rs.kvs.multiput(items)
    rs._flushed_versions = rs.graph.num_versions
    return rs
