"""State carried across from the reference package, as plain data.

Training state: ``state_from_reference`` turns a state tree of the reference
(nested dicts and lists of numpy arrays, ``np.asarray`` of each leaf) into
the port's tree of tensors on a device; ``state_to_numpy`` goes back.

Stores: ``rstore_from_state`` builds a port store from another store's
dumped state.

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
- ``items``: the backend's ``scan()`` — every ``(key, blob)`` it holds;
- ``retired`` (optional): the version ids a retention policy retired;
- ``layout_epoch`` (optional): how many compaction passes the layout has
  been through;
- ``indexes`` (optional): attribute → bucket count of each secondary index,
  whose ``idx2/`` postings are among ``items``.

The blobs are written to the new store's backend as they are, so the
result answers the same queries from the same bytes.  Extractors are code,
not state: a store with secondary indexes needs ``extractors`` naming one
per indexed attribute, and each index is re-registered from its persisted
buckets through :meth:`~repro_torch.core.secondary.SecondaryIndex.load`.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from . import tree as T

from .core.index import Projections
from .core.ingest import RStore, RStoreConfig
from .core.kvs import Backend
from .core.secondary import AttributeExtractor, SecondaryIndex
from .device import DeviceLike, resolve_device


def state_from_reference(tree, device: DeviceLike = None):
    """The same tree with every numpy leaf a tensor on ``device`` (``None``
    = the card), same dtype, shape and bits.  A ``bfloat16`` leaf (numpy's
    extension dtype of that name) becomes a ``torch.bfloat16`` tensor."""
    dev = resolve_device(device)

    def one(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)
                                 .copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a, copy=True))
        return t.to(dev)
    return T.tree_map(one, tree)


def state_to_numpy(tree):
    """The same tree with every tensor leaf a numpy array on the host;
    ``bfloat16`` tensors come back as float32 (exact), since numpy has no
    bfloat16 of its own."""
    def one(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()
    return T.tree_map(one, tree)


def rstore_from_state(state: Dict[str, Any],
                      config: Optional[RStoreConfig] = None,
                      kvs: Optional[Backend] = None,
                      device: DeviceLike = None,
                      extractors: Optional[Dict[str,
                                                AttributeExtractor]] = None,
                      ) -> RStore:
    """A port :class:`RStore` holding ``state`` (see the module docstring);
    its backend receives ``state["items"]`` in one ``multiput``, and each
    secondary index reads its buckets back in one ``multiget``."""
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
    retired = [int(v) for v in state.get("retired", ())]
    if retired:
        rs.graph.retire(retired)
    rs._layout_epoch = int(state.get("layout_epoch", 0))
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
    for attr, n_buckets in state.get("indexes", {}).items():
        if attr not in (extractors or {}):
            raise KeyError(f"no extractor given for the secondary index on "
                           f"{attr!r}")
        rs._indexes[attr] = SecondaryIndex.load(
            rs.kvs, attr, extractors[attr], rs._chunk_records,
            store.payload, n_buckets=int(n_buckets))
    return rs
