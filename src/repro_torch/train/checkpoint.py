"""RStore-backed versioned checkpointing — the store as the training
stack's artifact layer, over the port's :class:`~repro_torch.core.RStore`.

Every checkpoint commit is an RStore *version*; every tensor block is a keyed
*record* (primary key = stable hash of ``(tensor_path, block_idx)``).  Blocks
whose bytes did not change since the parent version dedupe automatically;
branched experiment forks form the version DAG.  Queries map onto training
operations:

  Q1 full version retrieval   → restore(version)
  Q.records multi-point batch → partial restore (one batched session → one
                                KVS round trip)
  Q3 record evolution         → per-tensor training forensics

A state is a tree of tensors (or numpy arrays) in nested dicts and lists.
It is flattened in JAX's order (dict keys sorted, list items by index), its
paths joined as the reference joins them (``params/blocks/0/attn/wq``), and
every block is cut from the tensor's bytes on the host, its dtype named as
numpy names it.  So block keys, record ids, chunks and every blob equal the
reference package's (``train/checkpoint.py``) for the same state.
``commit_many`` stages a chain of states through one write session: one
group commit, one write round trip per shard under ``ShardedKVS``.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import tree as T
from ..core import Q, RStore, RStoreConfig
from ..device import DeviceLike


def _block_key(tensor_path: str, block_idx: int) -> int:
    h = hashlib.blake2b(f"{tensor_path}#{block_idx}".encode(),
                        digest_size=4).digest()
    return int.from_bytes(h, "big") & 0x7FFFFFFF


def host_array(leaf) -> Tuple[np.ndarray, str]:
    """A leaf's bytes as a host numpy array (device to host for a tensor on
    the card), and its dtype's numpy name.  bfloat16 has no numpy dtype, so
    its words travel as int16 under the name ``"bfloat16"``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def to_like(arr, like: torch.Tensor) -> torch.Tensor:
    """A restored host array as a tensor on ``like``'s device with its dtype
    and shape (host to device)."""
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(arr)
    return t.to(device=like.device, dtype=like.dtype).reshape(like.shape)


@dataclass
class TensorMeta:
    path: str
    shape: Tuple[int, ...]
    dtype: str
    n_blocks: int
    block_keys: List[int]


class VersionedCheckpointer:
    """Commit/restore state trees through an RStore instance.  Without a
    ``store``, one is made with the reference's checkpoint config on
    ``device`` (``None`` = the card)."""

    def __init__(self, store: Optional[RStore] = None,
                 block_bytes: int = 1 << 20,
                 rstore_config: Optional[RStoreConfig] = None,
                 device: DeviceLike = None) -> None:
        self.block_bytes = int(block_bytes)
        self.rs = store or RStore(rstore_config or RStoreConfig(
            algorithm="bottom_up", capacity=4 << 20, batch_size=8,
            store_payloads=True), device=device)
        self.meta: Dict[int, Dict[str, TensorMeta]] = {}   # version -> metas
        self.tags: Dict[str, int] = {}   # tag -> newest version committed under it
        self._key_to_block: Dict[int, Tuple[str, int]] = {}
        self._root: Optional[int] = None

    # -------------------------------------------------------------- commits
    def _blocks_of(self, arr: np.ndarray):
        raw = np.ascontiguousarray(arr).tobytes()
        n = max(1, (len(raw) + self.block_bytes - 1) // self.block_bytes)
        for i in range(n):
            yield i, raw[i * self.block_bytes:(i + 1) * self.block_bytes]

    def _delta_of(self, state, parents: Sequence[int],
                  parent_payload: Optional[Dict[int, bytes]] = None):
        """(adds, dels, metas, child_payload) for committing ``state``
        against ``parents``: only blocks whose bytes differ from the first
        parent's are added.  ``parent_payload`` (pk -> bytes of the parent's
        live blocks) is resolved from the store when not given."""
        metas: Dict[str, TensorMeta] = {}
        adds: Dict[int, bytes] = {}
        all_keys: set = set()
        if parent_payload is None:
            parent_payload = {}
            if parents:
                pm = self.rs._key_map(parents[0])
                store = self.rs.graph.store
                parent_payload = {pk: store.payload(rid)
                                  for pk, rid in pm.items()}
        child_payload: Dict[int, bytes] = {}

        for path, leaf in T.leaves_with_paths(state):
            pstr = T.path_str(path)
            arr, dtype = host_array(leaf)
            keys = []
            for bi, blob in self._blocks_of(arr):
                pk = _block_key(pstr, bi)
                if pk in all_keys or (pk in self._key_to_block and
                                      self._key_to_block[pk] != (pstr, bi)):
                    raise RuntimeError(f"block key collision for {pstr}#{bi}")
                all_keys.add(pk)
                self._key_to_block[pk] = (pstr, bi)
                keys.append(pk)
                child_payload[pk] = blob
                if parent_payload.get(pk) != blob:
                    adds[pk] = blob
            metas[pstr] = TensorMeta(pstr, tuple(arr.shape), dtype,
                                     len(keys), keys)
        dels = [pk for pk in parent_payload if pk not in all_keys]
        return adds, dels, metas, child_payload

    def _commit_into(self, writer, state, parents: Sequence[int],
                     tag: str = "",
                     parent_payload: Optional[Dict[int, bytes]] = None):
        adds, dels, metas, child_payload = self._delta_of(
            state, parents, parent_payload)
        if not parents:
            vid = writer.init_root(adds)
        else:
            vid = writer.commit(list(parents), adds=adds, dels=dels)
        self.meta[vid] = metas
        if tag:
            self.tags[tag] = vid
        if self._root is None:
            self._root = vid
        return vid, child_payload

    def commit(self, state, parents: Sequence[int] = (),
               tag: str = "") -> int:
        """Commit a state tree as a new version derived from ``parents`` (a
        one-commit write session; flushing follows the store's batching)."""
        with self.rs.writer(flush_on_close=False) as w:
            return self._commit_into(w, state, parents, tag)[0]

    def commit_many(self, states: Sequence, parents: Sequence[int] = (),
                    tag: str = "") -> List[int]:
        """Commit a chain of states in ONE write session: each state's
        parent is the previous one (the first hangs off ``parents``); the
        session group-flushes on exit.  The parent payload map is carried
        along the chain instead of rebuilt per commit."""
        if not states:      # don't open (and group-flush) a writer for a no-op
            return []
        vids: List[int] = []
        with self.rs.writer() as w:
            chain = list(parents)
            carried: Optional[Dict[int, bytes]] = None
            for state in states:
                vid, carried = self._commit_into(w, state, tuple(chain), tag,
                                                 parent_payload=carried)
                chain = [vid]
                vids.append(vid)
        return vids

    # ------------------------------------------------------------ retention
    def _apply_retention(self, policy, compact: bool):
        from ..core.compact import CompactionReport, Compactor
        retired = set(self.rs.retain(policy))
        for v in retired:
            self.meta.pop(v, None)
        self.tags = {t: v for t, v in self.tags.items() if v not in retired}
        if not compact:
            return None
        # cost-model gate: only pay the rewrite once enough stored bytes are
        # dead or the layout fragmented
        cp = Compactor(self.rs)
        if cp.should_run():
            return cp.run_pass()
        return CompactionReport(mode="noop",
                                layout_epoch=self.rs.layout_epoch)

    def retain_last(self, k: int, compact: bool = True):
        """Keep only the most recent ``k`` committed versions and (by
        default) run a compaction pass gated by the cost model.  Returns the
        :class:`~repro_torch.core.compact.CompactionReport` (or None with
        ``compact=False``)."""
        from ..core.compact import keep_last
        return self._apply_retention(keep_last(k), compact)

    def retain_tagged(self, tags: Sequence[str], compact: bool = True):
        """Keep only the checkpoints committed under ``tags``; everything
        else is pruned and compacted away."""
        from ..core.compact import keep_tagged
        missing = [t for t in tags if t not in self.tags]
        if missing:
            raise KeyError(f"unknown checkpoint tag(s) {missing}")
        return self._apply_retention(
            keep_tagged([self.tags[t] for t in tags]), compact)

    # -------------------------------------------------------------- restore
    def restore(self, vid: int, like=None):
        """Q1: full version retrieval (one-query session).  Without
        ``like``: path → host array.  With ``like`` (a tree of tensors):
        ``like``'s tree, each tensor on ``like``'s device with its dtype and
        shape."""
        res = self.rs.snapshot().execute([Q.version(vid)])
        return self._assemble(vid, res[0].value, like)

    def restore_tensors(self, vid: int, prefixes: Sequence[str]):
        """Partial restore: only tensors matching prefixes, each a
        multi-point ``Q.records`` query, all in ONE batched session (one KVS
        round trip)."""
        metas = self.meta[vid]
        selected = [(pstr, tm) for pstr, tm in metas.items()
                    if any(pstr.startswith(p) for p in prefixes)]
        if not selected:
            return {}
        res = self.rs.snapshot().execute(
            [Q.records(vid, tm.block_keys) for _, tm in selected])
        out = {}
        for (pstr, tm), r in zip(selected, res):
            missing = [pk for pk in tm.block_keys if pk not in r.value]
            if missing:
                raise KeyError(f"missing blocks of {pstr}: {missing}")
            out[pstr] = self._tensor_from(tm, [r.value[pk]
                                               for pk in tm.block_keys])
        return out

    def evolution(self, tensor_path: str, block_idx: int = 0):
        """Q3: every distinct value a block ever had (origin order)."""
        evo, _ = self.rs.get_evolution(_block_key(tensor_path, block_idx))
        return evo

    # ------------------------------------------------------------- plumbing
    def _tensor_from(self, tm: TensorMeta, blobs: List[bytes]):
        """Host array of a tensor from its blocks: numpy, or a CPU
        ``torch.bfloat16`` tensor for ``"bfloat16"``."""
        raw = b"".join(blobs)
        if tm.dtype == "bfloat16":
            words = np.frombuffer(raw, dtype=np.int16).reshape(tm.shape)
            return torch.from_numpy(words.copy()).view(torch.bfloat16)
        return np.frombuffer(raw, dtype=np.dtype(tm.dtype)).reshape(
            tm.shape).copy()

    def _assemble(self, vid: int, records: Dict[int, bytes], like):
        metas = self.meta[vid]
        tensors = {pstr: self._tensor_from(tm, [records[pk]
                                                for pk in tm.block_keys])
                   for pstr, tm in metas.items()}
        if like is None:
            return tensors
        paths = T.leaves_with_paths(like)
        return T.unflatten_like(like, [to_like(tensors[T.path_str(p)], leaf)
                                       for p, leaf in paths])

    def latest(self) -> Optional[int]:
        vs = self.rs.graph.versions
        return vs[-1] if vs else None

    def storage_stats(self):
        return self.rs.storage_stats()
