#!/usr/bin/env python3
"""Drive the PyTorch port of RStore on one NVIDIA H100.

    python3 chip_smoke.py [--seed N] [--base-log2 17] [--versions 64]
        [--k3-base-log2 16] [--k3-versions 32] [--ops-base-log2 19]
        [--ops-versions 64] [--tr-layers 2] [--sv-layers 0]
        [--sv-registry-layers 2]

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``,
then:

1. k=1 main path: the default ``RStoreConfig()`` over a ``ShardedKVS`` of four
   ``ShardedDeviceKVS`` tables on the card.  A seeded A-family chain (2^17
   base records of 256 bytes, 64 versions, 5% of live records touched per
   version, 90/5/5 modify/insert/delete; the depth is cut, see below) goes
   in through ``rs.writer()``
   sessions; four waves of 64 mixed queries come out through
   ``StoreQueryEngine.serve``.  Every answer is checked against a plain dict
   oracle kept while the data was generated.
2. sh main path, the SHINGLE offline layout (§3.1):
   ``RStoreConfig(algorithm="shingle")`` (its online batch bound above the
   chain's version count) over four device tables as in k1,
   the same chain (and oracle) staged through two ``rs.writer`` sessions
   without flushing, then ONE ``rs.build()``: the record→version CSR, the
   min-hash kernel over every record, lexsort and packing, chunk staging and
   one multiput.  One checked 64-query wave, then the wave's record and
   range leaves as one ``Projections.candidates_batch`` (one pairwise
   ``and_popcount`` launch) and one ``candidates_range`` (the broadcast
   shape), each candidate set checked against a host intersection of the
   posting lists.
3. k=3 main path (§3.4 sub-chunk compression): 2^16 base records, 32
   versions, bounded payload changes (p_d = 0.1), ``rs.build()`` and one
   checked 64-query wave; then ``retain(keep_last(16))`` and ``compact()``,
   a full rebuild at k>1 (the delta kernel again), and a second wave.  The
   ``xor_delta`` launches of each phase are printed; a build or a
   compaction that makes more than 3 fails the run.
4. ops main path, the store's operational layer: an A-family chain of 2^19
   base records and 64 versions whose payloads carry two attributes (f0,
   f1 = a tenant id), ingested by 4 clients through an ``IngestGateway``
   and its ``BackgroundFlusher``, into ``make_sharded_backend``'s stack
   (4 shards × 2 device-table replicas, a 256 MiB ``CachingKVS`` on top);
   two secondary indexes; checked ``where`` waves (one bitmap_vm launch
   each): at versions 1 and 2 cold and warm, ``Q.evolution`` twice and
   ``prefetch_evolution``, at the late targets; one replica of every shard
   killed, failover, a write, ``RecoveryManager`` rebuilds; retention and a
   compaction pass.  k1 and sh run at 2^17 base records and ops at 2^19
   (cut from 2^20) so that the whole run fits its time.
5. tr main path, versioned training (``examples/versioned_training.py``):
   smollm-360m at its published width (d_model 960, 15/5 heads of 64, d_ff
   2,560, vocab 49,152, tied embeddings), its depth cut from 32 layers to
   ``--tr-layers``, f32, AdamW, batch 8 x 256 tokens from the synthetic
   pipeline on the card, deterministic algorithms.  The initial state is
   committed as an RStore version; a straight run of 20 steps; from the same
   init 10 steps, a commit, ``xor_delta_stats`` of the params (one launch),
   a restore that must equal the committed state and 10 more steps that
   must equal the straight run bit for bit; a fork of 5 steps from the
   restored checkpoint; a partial restore (one bitmap_vm launch), the
   evolution of a block, ``retain_last(2)`` with compaction, int8 update
   compression, and the training launcher's crash and ``--resume``.
6. sv main path, model serving (``launch/serve.py`` and
   ``examples/serve_demo.py``), deterministic algorithms throughout:
   granite-moe-1b-a400m as registered (24 layers, d_model 1,024, 16/8 heads
   of 64, 32 experts top-8 of width 512, vocab 49,155, tied embeddings,
   bf16, capacity factor 1.25; ``--sv-layers`` cuts its depth for a quick
   try) with random weights from a seeded generator, through ``Engine``:
   3 waves of 8 prompts of 64 tokens from the synthetic pipeline, 32
   generated tokens each, with prefill ms, decode ms per step, tokens/s
   and peak device memory per wave and the device-idle share of one
   profiled decode step.  Each wave's tokens must equal a manual prefill +
   decode loop bit for bit, with every logit finite; prefill's
   last-position logits must lie within 4 bf16 ulps of ``train_logits``'.
   mamba2-130m and whisper-base (with its frames and cross caches) the
   same way at full size, one wave each.  Every architecture's reduced
   config (f32): prefill at 16 tokens and 4 teacher-forced decode steps
   against the full forward (the reference's test), and the card's
   prefill logits within 1e-4 of the CPU's on the same weights, TF32 off.
   Then the versioned model registry: granite-moe at full width, its depth
   cut to ``--sv-registry-layers`` (2 of 24, so that its two commits of
   157,614,080 bf16 params fit the run's time), the init params committed
   as v0, 5 AdamW steps (batch 4 x 64), v1; each version restored (Q1: one
   KVS round trip, no bitmap program, bit-equal to the committed params),
   restored as the demo's partial restore of every param tensor (one round
   trip, one bitmap_vm launch) and served, its tokens equal to those of
   the params in memory.
7. sd main path, sharding (``launch/mesh.py``, ``sharding/rules.py``,
   ``train/elastic.py``, ``moe_shard_map``, ``launch/dryrun.py``) on a (1, 1)
   mesh of one NCCL rank: ``restore_for_mesh`` of tr's newest checkpoint
   version (every leaf a ``DTensor`` on the card, bit-equal to the
   restored state) and one train step of that state under ``mesh_env``,
   bit-identical to the plain step; granite-moe-1b-a400m at full width and
   depth, one 8 x 64 prefill through ``moe_shard_map``'s local branch (its
   ``OPTIMIZED`` prefill config) and one with ``DTensor`` params placed by
   ``tree_pspecs``, each within 4 bf16 ulps of the plain prefill's
   last-position logits with equal argmax tokens; one dry-run cell
   (granite-moe x decode_32k on the 256-GPU mesh of a fake process group)
   as a subprocess.  It launches no kernel; its NCCL group is destroyed
   before the kernel phases.
8. ex main path, the repo's examples on the port, in-process at their
   default flags (the reference's own sizes): ``examples/quickstart_torch.py``
   (k=3, a 4-shard ``ShardedKVS``), ``ehr_analytics_torch.py`` (k=4, 400
   patients) and ``serve_demo_torch.py`` (granite-moe-1b-a400m
   ``.reduced()``, the registry's two versions served).  quickstart's and
   ehr's output must equal the reference's transcripts
   (``tests/data/examples/``) exactly; serve_demo's line for line outside
   the named masks of ``masks.json`` (wall-clock seconds, the tokens of the
   random weights).  The launch counts are zeroed and read around each
   example.  ``versioned_training_torch.py`` is too long for this run's
   time limit: ``scripts/ex_alone.py`` runs it; tr is its checked
   counterpart here.
9. Kernel phases: each kernel against its plain PyTorch version on the card,
   bit-exact, at the shapes the main paths gave it (``xor_delta`` at every
   ragged launch of k3 and ex, ``bitmap_vm`` at every program of k1, ops,
   tr, sv and ex) and at the shapes named below, with device times (a CUDA
   graph of 200 launches) and host-launched CUDA-event times beside the
   bound.

Each kernel wrapper counts its own launches; all four counts are zeroed
just before each main path (each example of ex) and read just after it.
Every phase raises on failure.  The last line is ``{"ok": true, "device":
{...}}``; the line before it the card's name and power limit; the one before
that the per-kernel JSON.
Exits non-zero, printing no result, when no card is visible.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import io
import json
import os
import re
import resource
import subprocess
import sys
import time
from types import SimpleNamespace
from typing import Callable, Dict, List, Tuple

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

RECORD = 256
# Slot size of the device tables.  The reference's 64 KiB default would pad
# every chunk map (about 3 KiB at this record count) to a whole slot.
SLOT_BYTES = 4096
# Bytes written between launches to evict a kernel's inputs from the 50 MB L2
# when timing it cold.
L2_FLUSH_BYTES = 256 << 20
# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth, and
# the 32-bit rate outside the tensor cores, the table's entry for plain
# integer word operations.
PEAK_BYTES_PER_S = 3.35e12
PEAK_WORD_OPS_PER_S = 67e12
# The ops path's attributes (``Chain(attrs=True)``): f0's values, the
# reference's default ``DatasetSpec.attr_cardinality``, and the key bits
# below a tenant id (f1 = pk >> 12: 4,096 keys a tenant).
ATTR_CARDINALITY = 256
TENANT_SHIFT = 12
# The ops path's chunk cache budget (the top of its backend stack), two
# fifths of its 0.64 GB store at 2^19 base records.  A where wave at the late versions gathers more than
# it holds, and so does prefetch_evolution's lineage walk: both evict.  The
# repeated (warm) wave runs at the two versions after the root, whose chunks
# fit.
CACHE_BYTES = 256 << 20
# The versions of the ops path's warm wave (``Chain(early=...)``).
HOT_VERSIONS = (1, 2)
# The tr path: the model (at its published width; its depth is
# ``--tr-layers``), the batch, the straight run's steps (the crash and
# restore fall halfway) and the fork's steps.
TR_ARCH = "smollm-360m"
TR_BATCH, TR_SEQ = 8, 256
TR_STEPS = 20
TR_FORK_STEPS = 5
# The sv path: the model served at full width (its depth is ``--sv-layers``),
# the other families served at full size, ``launch/serve.py``'s traffic
# (waves of batch x prompt tokens, tokens generated per prompt), and the
# registry's training between its two versions (``examples/serve_demo.py``).
SV_ARCH = "granite-moe-1b-a400m"
SV_FAMILIES = ("mamba2-130m", "whisper-base")
SV_BATCH, SV_PROMPT, SV_GEN, SV_WAVES = 8, 64, 32, 3
SV_REG_STEPS, SV_REG_BATCH, SV_REG_SEQ = 5, 4, 64
# The sd path's dry-run cell: one (architecture, shape) on the 256-GPU mesh.
SD_DRY_ARCH, SD_DRY_SHAPE = "granite-moe-1b-a400m", "decode_32k"


# The reference's output of each example (``<name>.txt``) and the named
# masks (``masks.json``) of the fields the port may print otherwise.
EXAMPLES_DATA = os.path.join(ROOT, "tests", "data", "examples")


def log(*a) -> None:
    print(*a, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


# ------------------------------------------------------------------ workload
class Chain:
    """A seeded A-family chain (linear, ``pct`` of live records touched per
    version, 90/5/5 modify/insert/delete) plus the dict oracle: the full
    contents of each target version and the history of each tracked key,
    both recorded while the chain is generated, before any ingest.

    With ``attrs`` every payload's first 8 bytes are two little-endian
    uint32 attributes in ``DatasetSpec(attr_fields=2)``'s layout (what
    ``datagen_extractor(2)`` reads): ``f0`` uniform over [0, 256), the
    reference's default ``attr_cardinality``, drawn anew for every fresh or
    modified record; ``f1 = pk >> 12``, a tenant id that stays with its key.
    The contents of the versions in ``early`` are kept too, beside the
    targets'."""

    def __init__(self, seed: int, n_base: int, n_versions: int,
                 pct: float = 0.05, p_d=None, attrs: bool = False,
                 last_is_target: bool = False, early=()) -> None:
        rng = np.random.default_rng(seed)
        self.rng = rng
        self.n_versions = n_versions
        self.targets = sorted(set(int(v) for v in rng.choice(
            np.arange(n_versions // 2, n_versions), size=4, replace=False))
            | ({n_versions - 1} if last_is_target else set()))
        self.track = [int(k) for k in rng.choice(n_base, 32, replace=False)]
        self.early = [v for v in early if v < n_versions]
        self.pct, self.p_d, self.attrs = pct, p_d, attrs
        self.n_base = n_base
        self.versions: Dict[int, Dict[int, bytes]] = {}
        self.history: Dict[int, List[Tuple[int, bytes]]] = {
            k: [] for k in self.track}
        self.deleted: Dict[int, int] = {}    # tracked key -> version it died
        self._columns: Dict[int, tuple] = {}  # where_wave's per-version arrays
        self.ops: List[Tuple] = []           # ("root", recs) | ("commit", ...)
        self.n_records = 0
        self._generate()

    def _fresh(self, keys) -> List[bytes]:
        n = len(keys)
        arr = self.rng.integers(0, 256, size=n * RECORD, dtype=np.uint8)
        if self.attrs:
            arr = arr.reshape(n, RECORD)
            f = np.empty((n, 2), dtype="<u4")
            f[:, 0] = self.rng.integers(0, ATTR_CARDINALITY, size=n)
            f[:, 1] = np.asarray(keys, dtype=np.int64) >> TENANT_SHIFT
            arr[:, :8] = f.view(np.uint8)
        blob = arr.tobytes()
        return [blob[i * RECORD:(i + 1) * RECORD] for i in range(n)]

    def _mutated(self, keys, parents: List[bytes]) -> List[bytes]:
        if self.p_d is None:
            return self._fresh(keys)
        arr = np.frombuffer(b"".join(parents), dtype=np.uint8).reshape(
            len(parents), RECORD).copy()
        span = max(1, int(RECORD * self.p_d))
        offs = self.rng.integers(0, RECORD - span + 1, size=len(parents))
        cols = offs[:, None] + np.arange(span)[None, :]
        arr[np.arange(len(parents))[:, None], cols] = self.rng.integers(
            0, 256, size=(len(parents), span), dtype=np.uint8)
        blob = arr.tobytes()
        return [blob[i * RECORD:(i + 1) * RECORD] for i in range(len(parents))]

    def _note(self, vid: int, adds: Dict[int, bytes]) -> None:
        for k in self.track:
            if k in adds:
                self.history[k].append((vid, adds[k]))

    def _generate(self) -> None:
        rng = self.rng
        state = dict(zip(range(self.n_base),
                         self._fresh(range(self.n_base))))
        self.ops.append(("root", dict(state)))
        self._note(0, state)
        self.n_records = self.n_base
        if 0 in self.targets:
            self.versions[0] = dict(state)
        keys = np.arange(self.n_base, dtype=np.int64)
        next_key = self.n_base
        for vid in range(1, self.n_versions):
            n_sel = max(1, int(len(keys) * self.pct))
            sel = rng.choice(keys, size=n_sel, replace=False)
            n_mod = int(n_sel * 0.90)
            n_del = int(n_sel * 0.05)
            n_ins = n_sel - n_mod - n_del
            mod = sel[:n_mod].tolist()
            dels = sel[n_mod:n_mod + n_del].tolist()
            new = list(range(next_key, next_key + n_ins))
            next_key += n_ins
            adds = dict(zip(mod, self._mutated(mod, [state[k] for k in mod])))
            adds.update(zip(new, self._fresh(new)))
            for k in dels:
                del state[k]
                if k in self.history:
                    self.deleted[k] = vid
            state.update(adds)
            keys = np.concatenate([keys[~np.isin(keys, dels)],
                                   np.asarray(new, dtype=np.int64)])
            self.ops.append(("commit", [vid - 1], adds, dels))
            self._note(vid, adds)
            self.n_records += len(adds)
            if vid in self.targets or vid in self.early:
                self.versions[vid] = dict(state)
        self.max_key = next_key

    def evolution(self, k: int, first_kept: int = 0
                  ) -> List[Tuple[int, bytes]]:
        """``Q.evolution(k)``'s answer once the versions below
        ``first_kept`` are retired: the copies of ``k`` that some kept
        version still holds (each lives until the next change or the
        delete of its key)."""
        h = self.history[k]
        ends = [v for v, _ in h[1:]] + [self.deleted.get(k, 1 << 62)]
        return [c for c, end in zip(h, ends) if end > first_kept]

    # ------------------------------------------------------------ queries
    def wave(self, Q, vid: int, seed: int, first_kept: int = 0):
        """64 queries at version ``vid``: 1 version, 24 record, 8 records of
        16 keys, 16 ranges of 256 keys, 7 evolution, 4 or_(record, range),
        4 and_(range, records) — each with its oracle answer (evolution's
        with the versions below ``first_kept`` retired)."""
        rng = np.random.default_rng(seed)
        cur = self.versions[vid]
        key = lambda: int(rng.integers(0, self.max_key))  # noqa: E731

        def rng_dict(lo, hi):
            return {k: cur[k] for k in range(lo, hi + 1) if k in cur}

        qs = [(Q.version(vid), cur)]
        for _ in range(24):
            k = key()
            qs.append((Q.record(vid, k), cur.get(k)))
        for _ in range(8):
            ks = [key() for _ in range(16)]
            qs.append((Q.records(vid, ks), {k: cur[k] for k in ks if k in cur}))
        for _ in range(16):
            lo = key()
            qs.append((Q.range(vid, lo, lo + 255), rng_dict(lo, lo + 255)))
        for k in rng.choice(self.track, 7, replace=False).tolist():
            qs.append((Q.evolution(k), self.evolution(k, first_kept)))
        for _ in range(4):
            k, lo = key(), key()
            want = rng_dict(lo, lo + 255)
            if k in cur:
                want[k] = cur[k]
            qs.append((Q.or_(Q.record(vid, k), Q.range(vid, lo, lo + 255)),
                       want))
        for _ in range(4):
            lo = key()
            ks = [lo + int(d) for d in rng.integers(0, 512, 16)]
            want = {k: cur[k] for k in ks if k in cur and k <= lo + 255}
            qs.append((Q.and_(Q.range(vid, lo, lo + 255), Q.records(vid, ks)),
                       want))
        assert len(qs) == 64
        return [q for q, _ in qs], [w for _, w in qs]


    def where_wave(self, Q, vids, seed: int):
        """64 queries over the attributes of ``Chain(attrs=True)``, spread
        round-robin over ``vids``: ``where``/``where_range`` on the tenant
        f1, f0 only under a key range (alone it selects nearly every
        chunk), ``and_``/``or_``/``not_`` composites and ``count``/
        ``exists`` over them — each with its answer, the version's contents
        filtered on the host."""
        rng = np.random.default_rng(seed)
        n_tenants = max(1, self.n_base >> TENANT_SHIFT)
        cols = self._columns

        def columns(v):
            if v not in cols:
                cur = self.versions[v]
                keys = np.fromiter(cur.keys(), dtype=np.int64, count=len(cur))
                f0 = np.frombuffer(b"".join(p[:4] for p in cur.values()),
                                   dtype="<u4").astype(np.int64)
                cols[v] = (cur, keys, f0, keys >> TENANT_SHIFT)
            return cols[v]

        def rows(cur, keys, mask):
            return {k: cur[k] for k in keys[mask].tolist()}

        qs, wants = [], []
        for i in range(64):
            v = vids[i % len(vids)]
            cur, keys, f0, f1 = columns(v)
            t = int(rng.integers(0, n_tenants))
            x = int(rng.integers(0, ATTR_CARDINALITY))
            lo = int(rng.integers(0, self.max_key))
            span = (keys >= lo) & (keys <= lo + 4095)
            kind = (i // len(vids)) % 8
            if kind == 0:
                q, m = Q.where(v, "f1", t), f1 == t
            elif kind == 1:
                q = Q.where_range(v, "f1", t, t + 1)
                m = (f1 >= t) & (f1 <= t + 1)
            elif kind == 2:
                q = Q.and_(Q.where(v, "f0", x), Q.range(v, lo, lo + 4095))
                m = (f0 == x) & span
            elif kind == 3:
                q = Q.or_(Q.where(v, "f1", t),
                          Q.and_(Q.where(v, "f0", x),
                                 Q.range(v, lo, lo + 4095)))
                m = (f1 == t) | ((f0 == x) & span)
            elif kind == 4:
                q = Q.and_(Q.where(v, "f1", t), Q.range(v, lo, lo + 4095),
                           Q.not_(Q.where_range(v, "f0", 0, 127)))
                m = (f1 == t) & span & (f0 >= 128)
            elif kind == 5:
                q, m = Q.count(Q.where(v, "f1", t)), f1 == t
            elif kind == 6:
                q = Q.exists(Q.and_(Q.where(v, "f0", x),
                                    Q.range(v, lo, lo + 63)))
                m = (f0 == x) & (keys >= lo) & (keys <= lo + 63)
            else:
                q = Q.count(Q.and_(Q.where_range(v, "f1", t, t + 2),
                                   Q.range(v, lo, lo + 4095),
                                   Q.not_(Q.where(v, "f0", x))))
                m = (f1 >= t) & (f1 <= t + 2) & span & (f0 != x)
            qs.append(q)
            if kind in (5, 7):
                wants.append(int(m.sum()))
            elif kind == 6:
                wants.append(bool(m.any()))
            else:
                wants.append(rows(cur, keys, m))
        return qs, wants


def ingest(rs, chain: Chain, flush_on_close: bool = True) -> Dict[str, float]:
    """Write the chain through two ``rs.writer()`` sessions: the root alone,
    then every commit.  Returns host-clock seconds of staging and of the
    group flushes (session closes)."""
    stage = flush = 0.0
    for sess in (chain.ops[:1], chain.ops[1:]):
        t0 = time.perf_counter()
        w = rs.writer(flush_on_close=flush_on_close)
        for op in sess:
            if op[0] == "root":
                w.init_root(op[1])
            else:
                w.commit(op[1], op[2], op[3])
        t1 = time.perf_counter()
        w.close()
        t2 = time.perf_counter()
        stage += t1 - t0
        flush += t2 - t1
    return {"stage_s": stage, "flush_s": flush}


def check_wave(batch, wants, what: str) -> None:
    if len(batch) != len(wants):
        raise AssertionError(f"{what}: {len(batch)} results for "
                             f"{len(wants)} queries")
    for i, (r, want) in enumerate(zip(batch, wants)):
        got = r.value
        if r.query.kind == "evolution":
            got = list(got)
        if got != want:
            raise AssertionError(f"{what}: query {i} ({r.query.kind}) "
                                 "disagrees with the dict oracle")


class Timers:
    """Host-clock (and CUDA-event) time spent inside named functions,
    installed by wrapping module attributes for the length of a run."""

    def __init__(self, torch) -> None:
        self.torch = torch
        self.t: Dict[str, float] = {}
        self.calls: Dict[str, List[float]] = {}     # host seconds per call
        self._undo: List[Callable[[], None]] = []

    def wrap(self, owner, name: str, label: str, device_time: bool = False):
        fn = getattr(owner, name)
        torch = self.torch

        def timed(*a, **k):
            if device_time:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            dt = time.perf_counter() - t0
            self.t[label] = self.t.get(label, 0.0) + dt
            self.calls.setdefault(label, []).append(dt)
            if device_time:
                e1.record()
                e1.synchronize()
                key = label + "_device"
                self.t[key] = self.t.get(key, 0.0) + e0.elapsed_time(e1) / 1e3
            return out
        had, raw = name in vars(owner), vars(owner).get(name)
        setattr(owner, name, timed)

        def undo():
            if had:
                setattr(owner, name, raw)     # e.g. a staticmethod, as it was
            else:
                delattr(owner, name)          # an instance attribute we added
        self._undo.append(undo)

    def reset(self) -> None:
        self.t = {}
        self.calls = {}

    def close(self) -> None:
        for u in reversed(self._undo):
            u()
        self._undo = []


def cuda_ms(torch, fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def cold_ms(torch, fn, iters: int = 20) -> float:
    """Mean CUDA-event time of one ``fn()`` launched with a cold L2: each
    launch follows a write of ``L2_FLUSH_BYTES`` that is outside the events."""
    scratch = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    total = 0.0
    for _ in range(iters):
        scratch.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / iters


def device_busy(torch, fn):
    """(device-busy seconds, wall seconds, top device ops) of one ``fn()``
    under torch.profiler with CUDA activity: the union of the time spans of
    every device-side event (kernels and copies) over the host-clock span;
    the top ops follow the count of device events."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy_us, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy_us += b - a
            end = b
        elif b > end:
            busy_us += b - end
            end = b
    per_name: Dict[str, float] = {}
    for e in dev:
        per_name[e.name] = per_name.get(e.name, 0) + e.time_range.elapsed_us()
    top = f"{len(dev)} device events; " + "; ".join(
        f"{k} {us / 1e3:.3f} ms" for k, us in sorted(
            per_name.items(), key=lambda kv: -kv[1])[:4])
    return busy_us / 1e6, wall, top


def zero_launches(K) -> None:
    """Set every kernel wrapper's launch count to 0."""
    K.bitmap.LAUNCHES = K.bitmap.AND_LAUNCHES = 0
    K.delta.LAUNCHES = K.minhash.LAUNCHES = 0


def read_launches(K) -> Dict[str, int]:
    return {"bitmap_vm": K.bitmap.LAUNCHES, "xor_delta": K.delta.LAUNCHES,
            "and_popcount": K.bitmap.AND_LAUNCHES,
            "minhash": K.minhash.LAUNCHES}


# ------------------------------------------------------------------- phases
def main_path_k1(args, torch, dev, T, eng_mod, K):
    chain = Chain(args.seed, 1 << args.base_log2, args.versions)
    log(f"[k1] chain: {1 << args.base_log2} base records, {args.versions} "
        f"versions, {chain.n_records} stored records "
        f"({chain.n_records * RECORD / 2**30:.3f} GiB of payload), "
        f"targets {chain.targets}")
    kvs = T.ShardedKVS([T.ShardedDeviceKVS(slot_bytes=SLOT_BYTES, device=dev)
                        for _ in range(4)])
    rs = T.RStore(T.RStoreConfig(), kvs, device=dev)
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ing = ingest(rs, chain)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    table_bytes = sum(s.table_bytes for s in kvs.shards)
    log(f"[k1] ingest: {ingest_s:.3f} s ({chain.n_records / ingest_s:.0f} "
        f"records/s); staging {ing['stage_s']:.3f} s, group flushes "
        f"{ing['flush_s']:.3f} s; {rs.n_chunks} chunks; write round trips "
        f"{kvs.stats.n_put_queries}")
    log(f"[k1] device tables: {table_bytes} bytes "
        f"({table_bytes / 2**30:.3f} GiB), bytes stored "
        f"{kvs.total_stored_bytes()}; torch.cuda.memory_allocated "
        f"{torch.cuda.memory_allocated() - mem0} bytes above the start")

    kops, kbitmap = K.ops, K.bitmap
    engine = eng_mod.StoreQueryEngine(rs)
    timers = Timers(torch)
    from repro_torch.core import api as api_mod
    from repro_torch.core import chunkstore, plan as plan_mod
    timers.wrap(kops, "bitmap_vm_batch", "bitmap_vm_batch")
    timers.wrap(kbitmap, "bitmap_vm", "kernel", device_time=True)
    timers.wrap(kvs, "multiget", "gather")
    timers.wrap(chunkstore.StoredChunk, "from_bytes", "parse")
    timers.wrap(plan_mod, "answer", "answer")
    timers.wrap(api_mod.Snapshot, "plan_batch", "plan_batch")
    waves, bitmap_inputs = [], []
    orig_vm = kbitmap.bitmap_vm

    def recording_vm(regs, prog):
        bitmap_inputs.append((regs.clone(), prog.clone()))
        return orig_vm(regs, prog)
    kbitmap.bitmap_vm = recording_vm
    try:
        for w, vid in enumerate(chain.targets):
            qs, wants = chain.wave(T.Q, vid, args.seed * 100 + w)
            waves.append((qs, wants))
        engine.snapshot()                   # pin once, outside the timing
        zero_launches(K)
        l0 = kops.BITMAP_LAUNCHES
        results = []
        for w, (qs, wants) in enumerate(waves):
            timers.reset()
            q0 = kvs.stats.n_queries
            b0 = kvs.stats.bytes_fetched
            t0 = time.perf_counter()
            batch = engine.serve(qs)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            results.append((batch, dict(timers.t), dt,
                            kvs.stats.n_queries - q0,
                            kvs.stats.bytes_fetched - b0))
        launches = dict(read_launches(K),
                        BITMAP_LAUNCHES=kops.BITMAP_LAUNCHES - l0)
    finally:
        kbitmap.bitmap_vm = orig_vm
        timers.close()
    busy_s, wall_s, top = device_busy(torch, lambda: engine.serve(waves[0][0]))
    log(f"[k1] profiled re-run of wave 0: {wall_s:.4f} s wall, device busy "
        f"{busy_s:.6f} s ({busy_s / wall_s:.3%}), idle {1 - busy_s / wall_s:.3%}"
        f" (torch.profiler, CUDA activity); top device ops: {top}")
    for w, ((batch, t, dt, rts, nbytes), (qs, wants)) in enumerate(
            zip(results, waves)):
        check_wave(batch, wants, f"k1 wave {w}")
        if rts > 4:
            raise AssertionError(f"k1 wave {w}: {rts} read round trips > 4")
        kern = t.get("kernel_device", 0.0)
        plan_host = t.get("plan_batch", 0.0) - t.get("bitmap_vm_batch", 0.0)
        decode = t.get("answer", 0.0)
        log(f"[k1] wave {w} @v{chain.targets[w]}: {dt:.4f} s, "
            f"{len(qs) / dt:.1f} queries/s, {rts} read round trips, "
            f"{nbytes} bytes gathered, {batch.batch.records_returned} records; "
            f"kernel {kern:.6f} s ({kern / dt:.2%}), host planning "
            f"{plan_host:.4f} s ({plan_host / dt:.2%}), bitmap entry incl. "
            f"copies {t.get('bitmap_vm_batch', 0.0):.4f} s, gather "
            f"{t.get('gather', 0.0):.4f} s ({t.get('gather', 0.0) / dt:.2%}), "
            f"chunk parse {t.get('parse', 0.0):.4f} s "
            f"({t.get('parse', 0.0) / dt:.2%}), host decode/answer "
            f"{decode:.4f} s ({decode / dt:.2%})")
    if launches["BITMAP_LAUNCHES"] != len(waves):
        raise AssertionError(f"BITMAP_LAUNCHES delta {launches} != "
                             f"{len(waves)} waves")
    if launches["bitmap_vm"] != len(waves):
        raise AssertionError(f"bitmap_vm kernel launches {launches} != "
                             f"{len(waves)} waves")
    log(f"[k1] launches during the waves: {json.dumps(launches)}")
    log("[k1] every answer equals the dict oracle")
    return launches, bitmap_inputs, chain


def main_path_k3(args, torch, dev, T, K):
    """The k=3 path.  Every ``xor_delta`` launch goes through the ragged
    entry; each is recorded (its phase and a copy of its inputs) for the
    kernel phase.  A build and a compaction (a rebuild at k>1) may make at
    most 3 launches each: the sizing pass and the one call that XORs every
    delta pair of the chunks staged."""
    chain = Chain(args.seed + 1, 1 << args.k3_base_log2, args.k3_versions,
                  p_d=0.1)
    log(f"[k3] chain: {1 << args.k3_base_log2} base records, "
        f"{args.k3_versions} versions, {chain.n_records} stored records, "
        f"p_d 0.1, targets {chain.targets}")
    kvs = T.ShardedKVS([T.ShardedDeviceKVS(slot_bytes=SLOT_BYTES, device=dev)
                        for _ in range(4)])
    rs = T.RStore(T.RStoreConfig(k=3), kvs, device=dev)
    kdelta = K.delta
    delta_inputs = []           # (phase, parent, child, row offsets)
    phase = ["staging"]
    per_phase: Dict[str, int] = {}
    orig = kdelta.xor_delta_ragged

    def recording_ragged(p, c, off):
        delta_inputs.append((phase[0], p.clone(), c.clone(), off.clone()))
        return orig(p, c, off)

    def run(name, fn):
        phase[0] = name
        d0 = kdelta.LAUNCHES
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        per_phase[name] = kdelta.LAUNCHES - d0
        return out, time.perf_counter() - t0
    kdelta.xor_delta_ragged = recording_ragged
    try:
        _, stage_s = run("staging",
                         lambda: ingest(rs, chain, flush_on_close=False))
        zero_launches(K)
        delta_inputs.clear()
        _, build_s = run("build", rs.build)
        vid = chain.targets[-1]
        qs, wants = chain.wave(T.Q, vid, args.seed * 100 + 99)
        batch, wave_s = run("wave", lambda: rs.snapshot().execute(qs))
        check_wave(batch, wants, "k3 wave")
        st = rs.storage_stats()
        # retention, then compaction: at k>1 the pass is a full rebuild
        keep = min(16, args.k3_versions // 2)
        retired = rs.retain(T.keep_last(keep))
        crep, comp_s = run("compaction", rs.compact)
        qs2, wants2 = chain.wave(T.Q, vid, args.seed * 100 + 98,
                                 first_kept=args.k3_versions - keep)
        batch2, wave2_s = run("wave after compaction",
                              lambda: rs.snapshot().execute(qs2))
        launches = read_launches(K)
    finally:
        kdelta.xor_delta_ragged = orig
    check_wave(batch2, wants2, "k3 wave after compaction")

    def pairs(name):
        return sum(off.numel() - 1 for ph, _, _, off in delta_inputs
                   if ph == name)
    log(f"[k3] staging {stage_s:.3f} s, build {build_s:.3f} s "
        f"({per_phase['build']} xor_delta launches, {pairs('build')} pairs),"
        f" wave {wave_s:.4f} s ({batch.batch.kvs_queries} read round trips, "
        f"{batch.batch.bytes_fetched} bytes gathered); stored chunk bytes "
        f"{st['stored_chunk_bytes']} vs raw unique {st['raw_unique_bytes']}")
    log(f"[k3] retain(keep_last({keep})) retired {len(retired)} versions; "
        f"compact(): {comp_s:.3f} s, mode {crep.mode}, "
        f"{per_phase['compaction']} xor_delta launches "
        f"({pairs('compaction')} pairs), stored chunk bytes "
        f"{crep.stored_bytes_before} -> {crep.stored_bytes_after}, write/"
        f"delete round trips {crep.write_round_trips}/"
        f"{crep.delete_round_trips}; wave after it {wave2_s:.4f} s "
        f"({batch2.batch.kvs_queries} read round trips)")
    log(f"[k3] xor_delta launches per phase: {json.dumps(per_phase)}")
    if launches["xor_delta"] <= 0 or per_phase["compaction"] <= 0:
        raise AssertionError("the k=3 path (or its compaction) launched no "
                             "xor_delta kernel")
    if per_phase["build"] > 3 or per_phase["compaction"] > 3:
        raise AssertionError(f"k3: more than 3 xor_delta launches in build() "
                             f"or compact(): {per_phase}")
    if crep.mode != "rebuild" or vid in retired:
        raise AssertionError(f"k3 compaction: mode {crep.mode}, target "
                             f"v{vid} retired")
    if crep.stored_bytes_after >= crep.stored_bytes_before:
        raise AssertionError("k3 compaction stored no fewer bytes")
    if st["stored_chunk_bytes"] >= st["raw_unique_bytes"]:
        raise AssertionError("sub-chunk compression stored no fewer bytes")
    shapes = sorted((off.numel() - 1, p.numel()) for _, p, _, off
                    in delta_inputs)
    log(f"[k3] launches during build + waves + compaction: "
        f"{json.dumps(launches)}; xor_delta (pairs, words): largest "
        f"{shapes[-1]}, median {shapes[len(shapes) // 2]}, smallest "
        f"{shapes[0]}, {sum(n for n, _ in shapes)} pairs in all")
    log("[k3] every answer equals the dict oracle")
    return launches, delta_inputs


def ops_backend(T, dev, seed: int):
    """The ops path's backend: ``make_sharded_backend``'s stack for
    ``n_shards=4, replication_factor=2, cache_bytes=CACHE_BYTES`` (a
    ``CachingKVS`` over a ``ShardedKVS`` of four ``ReplicatedKVS`` groups,
    each over two ``ShardedDeviceKVS`` tables on the card, write quorum 1),
    built here from the same parts so that each device table sits behind a
    ``FaultInjectingKVS`` the replica phase can kill."""
    tables = [T.FaultInjectingKVS(T.ShardedDeviceKVS(SLOT_BYTES, device=dev),
                                  seed=seed + j) for j in range(8)]
    router = T.ShardedKVS([T.ReplicatedKVS(tables[2 * i:2 * i + 2])
                           for i in range(4)])
    return T.CachingKVS(router, cache_bytes=CACHE_BYTES), router, tables


def check_postings(rs, T) -> None:
    """Each secondary index is coherent with the layout: it covers exactly
    the stored chunks, its postings are what its per-chunk record values
    give, and the ``idx2/`` buckets in the backend decode to the same."""
    for attr, idx in rs.indexes.items():
        if set(idx.chunk_record_values) != set(rs._chunk_records):
            raise AssertionError(f"index {attr}: chunk set != the layout's")
        want: Dict[int, List[int]] = {}
        for cid in sorted(idx.chunk_record_values):
            vals, present = idx.chunk_record_values[cid]
            for v in np.unique(vals[present]).tolist():
                want.setdefault(v, []).append(cid)
        got = {v: p.tolist() for v, p in idx.postings.items()}
        keys = idx.stored_keys()
        stored: Dict[int, List[int]] = {}
        for blob in rs.kvs.multiget(keys):
            stored.update({v: p.tolist() for v, p in
                           T.SecondaryIndex.decode_bucket(blob).items()})
        if not (got == want == stored):
            raise AssertionError(f"index {attr}: postings incoherent")


def main_path_ops(args, torch, dev, T, K):
    """The store's operational layer on the card: async ingest through an
    ``IngestGateway``, secondary indexes and their ``where`` waves, the
    chunk cache (a warm wave, evolution and ``prefetch_evolution``), replica
    death and recovery, retention and compaction."""
    from repro_torch.core import ingest as ingest_mod
    from repro_torch.serve.ingest_gateway import IngestGateway
    n_base = 1 << args.ops_base_log2
    chain = Chain(args.seed + 2, n_base, args.ops_versions + 1, attrs=True,
                  last_is_target=True, early=HOT_VERSIONS)
    ops, late_op = chain.ops[:-1], chain.ops[-1]
    log(f"[ops] chain: {n_base} base records, {args.ops_versions} versions "
        f"through the gateway + 1 written during a replica death, "
        f"{chain.n_records} stored records, attrs f0 (uniform < "
        f"{ATTR_CARDINALITY}) and f1 = pk >> {TENANT_SHIFT}, targets "
        f"{chain.targets}")
    kvs, router, tables = ops_backend(T, dev, args.seed)
    rs = T.RStore(T.RStoreConfig(), kvs, device=dev)
    log(f"[ops] backend: CachingKVS({CACHE_BYTES} bytes) over ShardedKVS of "
        f"4 ReplicatedKVS groups × 2 ShardedDeviceKVS tables on {dev} "
        "(make_sharded_backend's stack, each table behind a "
        "FaultInjectingKVS)")
    bitmap_inputs = []
    timers = Timers(torch)
    orig_vm = K.bitmap.bitmap_vm

    def recording_vm(regs, prog):
        bitmap_inputs.append((regs.clone(), prog.clone()))
        return orig_vm(regs, prog)

    def router_rts():
        st = router.stats
        return st.n_queries, st.n_put_queries, st.n_delete_queries

    def cache_line(what):
        cs = rs.cache_stats()
        log(f"[ops] cache {what}: hit ratio {cs['hit_rate']:.4f}, "
            f"{cs['n_entries']} entries, {cs['cached_bytes']} bytes, "
            f"{cs['n_evictions']} evictions, {cs['n_admit_rejected']} "
            "admissions refused")

    def wave(what, vids, seed, snap=None, max_reads=4, profile=False):
        """One checked where wave: exactly one bitmap_vm launch, at most
        ``max_reads`` read round trips below the cache; with ``profile``,
        under torch.profiler for the device's busy share."""
        qs, wants = chain.where_wave(T.Q, vids, seed)
        q0, l0, b0 = router_rts()[0], K.ops.BITMAP_LAUNCHES, K.bitmap.LAUNCHES
        h0 = kvs.stats.n_cache_hits
        out = []
        t0 = time.perf_counter()
        if profile:
            busy_s, _, top = device_busy(torch, lambda: out.append(
                (snap or rs.snapshot()).execute(qs)))
        else:
            out.append((snap or rs.snapshot()).execute(qs))
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        batch = out[0]
        reads = router_rts()[0] - q0
        check_wave(batch, wants, f"ops {what}")
        if K.ops.BITMAP_LAUNCHES - l0 != 1 or K.bitmap.LAUNCHES - b0 != 1:
            raise AssertionError(f"ops {what}: {K.bitmap.LAUNCHES - b0} "
                                 "bitmap_vm launches, not 1")
        if reads > max_reads:
            raise AssertionError(f"ops {what}: {reads} backend read round "
                                 f"trips > {max_reads}")
        log(f"[ops] {what} @v{vids}: {dt:.4f} s, {len(qs) / dt:.1f} "
            f"queries/s, 1 bitmap_vm launch, {reads} backend read round "
            f"trips, {batch.batch.bytes_fetched} bytes gathered, "
            f"{kvs.stats.n_cache_hits - h0} cache hits, "
            f"{batch.batch.records_returned} records")
        if profile:
            log(f"[ops] {what}, under torch.profiler: device busy "
                f"{busy_s:.6f} s ({busy_s / dt:.3%}), idle "
                f"{1 - busy_s / dt:.3%}; top device ops: {top}")

    K.bitmap.bitmap_vm = recording_vm
    timers.wrap(T.RStore, "_prepare_flush_writes", "prepare")
    timers.wrap(T.VersionGraph, "record_version_index_csr", "csr")
    timers.wrap(ingest_mod, "build_chunk_map", "maps")
    timers.wrap(T.RStore, "_stage_chunk_writes", "new chunks")
    timers.wrap(T.SecondaryIndex, "add_chunks", "add_chunks")
    timers.wrap(T.SecondaryIndex, "remove_chunks", "remove_chunks")
    timers.wrap(router, "multiput", "multiput")
    try:
        zero_launches(K)
        # ---- ingest: 4 clients in turn through the gateway's flusher
        gw = IngestGateway(rs)
        t0 = time.perf_counter()
        for i, op in enumerate(ops):
            client = f"client{i % 4}"
            if op[0] == "root":
                gw.init_root(client, op[1])
            else:
                gw.commit(client, op[1], op[2], op[3])
        drain = gw.barrier()
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        # (storage_stats() would varint-encode every key's posting list:
        # tens of seconds at this size; the flusher's counters are enough)
        st = kvs.stats
        n_in = chain.n_records - len(late_op[2])
        log(f"[ops] ingest: {ingest_s:.3f} s ({n_in / ingest_s:.0f} "
            f"records/s) from 4 clients; {st.n_flush_batches} drains "
            f"(the barrier's: {drain.n_versions} versions, "
            f"{drain.write_round_trips} write round trips); drain "
            f"preparation {timers.t.get('prepare', 0.0):.3f} s (CSR "
            f"{timers.t.get('csr', 0.0):.3f} s, old chunks' maps "
            f"{timers.t.get('maps', 0.0):.3f} s in "
            f"{len(timers.calls.get('maps', []))} calls, new chunks "
            f"{timers.t.get('new chunks', 0.0):.3f} s), multiputs "
            f"{timers.t.get('multiput', 0.0):.3f} s; write round trips "
            f"{router.stats.n_put_queries} (router), staleness: max "
            f"observed lag {st.max_observed_lag} versions, watermarks "
            f"{json.dumps(rs.flusher.watermarks())}; {rs.n_chunks} chunks, "
            f"{router.total_stored_bytes()} bytes stored per replica set")
        if rs.flusher.staleness_lag != 0:
            raise AssertionError("ops: versions left staged after barrier()")
        cache_line("after ingest")

        # ---- secondary indexes
        for attr in ("f0", "f1"):
            timers.reset()
            p0 = kvs.stats.n_put_queries
            t0 = time.perf_counter()
            idx = rs.create_index(attr, T.datagen_extractor(2))
            dt = time.perf_counter() - t0
            log(f"[ops] create_index({attr!r}): {dt:.3f} s (postings "
                f"{timers.t.get('add_chunks', 0.0):.3f} s), "
                f"{len(timers.calls.get('multiput', []))} multiput "
                f"({kvs.stats.n_put_queries - p0} write round trips), "
                f"{json.dumps(idx.report())}")
            if len(timers.calls.get("multiput", [])) != 1:
                raise AssertionError(f"create_index({attr!r}) did not write "
                                     "in one multiput")
        check_postings(rs, T)

        # ---- where wave at the two versions after the root, whose chunks
        # fit the cache (ingest leaves it empty: write-through refreshes only
        # keys already cached), then the same wave again from the cache
        late = args.ops_versions
        vids = chain.targets[:-1]
        hot = list(chain.early)
        snap = rs.snapshot()
        wave("where wave (cold cache)", hot, args.seed * 100 + 75, snap)
        wave("the same wave again (warm cache)", hot, args.seed * 100 + 75,
             snap, max_reads=0)
        cache_line("after the warm wave")
        # Q.evolution of the tracked keys twice: the second reads only the
        # cache.  Then prefetch_evolution of each, and the evolution again:
        # each prefetch also warms whole lineage versions, each more than the
        # cache holds, and the 32 walks overlap, so their chunks crowd the
        # keys' own out of the protected segment; the reads after it are
        # reported, not held to 0.
        qs = [T.Q.evolution(k) for k in chain.track]
        want = [[h for h in chain.history[k] if h[0] < late]
                for k in chain.track]
        rts = [router_rts()[0]]
        for what in ("ops evolution", "ops evolution again"):
            check_wave(snap.execute(qs), want, what)
            rts.append(router_rts()[0])
        t0 = time.perf_counter()
        warmed = [snap.prefetch_evolution(k) for k in chain.track]
        pre_s = time.perf_counter() - t0
        rts.append(router_rts()[0])
        check_wave(snap.execute(qs), want, "ops evolution after prefetch")
        rts.append(router_rts()[0])
        reads = np.diff(rts).tolist()
        log(f"[ops] Q.evolution of {len(chain.track)} tracked keys: "
            f"{reads[0]} backend read round trips, again {reads[1]}; "
            f"prefetch_evolution: {pre_s:.3f} s, "
            f"{sum(w['warmed_keys'] for w in warmed)} keys warmed in "
            f"{reads[2]} read round trips; then Q.evolution: {reads[3]} "
            "backend read round trips")
        cache_line("after prefetch_evolution")
        if reads[1]:
            raise AssertionError("ops: the repeated evolution read the "
                                 f"backend ({reads[1]} round trips)")

        # ---- where wave at the late targets (the last target comes with
        # the write made during the replica death); it gathers more than
        # the cache holds
        wave("where wave at the late targets", vids, args.seed * 100 + 70, snap)
        cache_line("after the late wave")

        # ---- replicas: one of every group dies; writes land in repair logs
        groups = router.shards
        for i in range(4):
            tables[2 * i].kill()
        hops0 = [g.stats.n_failovers for g in groups]
        kvs.clear()                   # so the wave reaches the replicas
        wave("where wave, one replica of every group dead", hot,
             args.seed * 100 + 71)
        hops1 = [g.stats.n_failovers for g in groups]
        kvs.clear()
        wave("where wave again, failed over", hot, args.seed * 100 + 72)
        hops2 = [g.stats.n_failovers for g in groups]
        log(f"[ops] failover hops per group: first wave "
            f"{[b - a for a, b in zip(hops0, hops1)]}, second "
            f"{[b - a for a, b in zip(hops1, hops2)]}")
        if (any(b - a > 1 for a, b in zip(hops0, hops1)) or hops2 != hops1
                or hops1 == hops0):
            raise AssertionError("ops: more than one extra hop per group, "
                                 "or hops after the first failover")
        gw.commit("client0", late_op[1], late_op[2], late_op[3])
        gw.barrier()
        misses = [g.pending_repairs(0) for g in groups]
        for i in range(4):
            tables[2 * i].revive()
        mgr = T.RecoveryManager(router)
        t0 = time.perf_counter()
        reports = [mgr.rebuild(0, shard=i) for i in range(4)]
        torch.cuda.synchronize()
        rec_s = time.perf_counter() - t0
        log(f"[ops] recovery: {rec_s:.3f} s for 4 replicas that missed "
            f"{misses} writes; round trips {[r.round_trips for r in reports]}"
            f", keys copied {[r.keys_copied for r in reports]}, stale keys "
            f"deleted {[r.stale_keys_deleted for r in reports]}")
        if any(r.round_trips > 4 for r in reports):
            raise AssertionError("ops: a rebuild took more than 4 round trips")
        if any(g.live != (True, True) for g in groups):
            raise AssertionError("ops: a replica is still down after rebuild")
        kvs.clear()                   # read the rebuilt replicas (preferred)
        wave("where wave after recovery", chain.targets, args.seed * 100 + 73,
             profile=True)
        cache_line("after the wave after recovery")

        # ---- retention and compaction
        keep = min(16, (args.ops_versions + 1) // 2)
        retired = rs.retain(T.keep_last(keep))
        ib0 = sum(i.stored_bytes() for i in rs.indexes.values())
        timers.reset()
        r0 = router_rts()
        g0 = [(g.stats.n_put_queries, g.stats.n_delete_queries)
              for g in groups]
        t0 = time.perf_counter()
        crep = rs.compact()
        torch.cuda.synchronize()
        comp_s = time.perf_counter() - t0
        r1 = router_rts()
        per_group = [(g.stats.n_put_queries - a, g.stats.n_delete_queries - b)
                     for g, (a, b) in zip(groups, g0)]
        ib1 = sum(i.stored_bytes() for i in rs.indexes.values())
        log(f"[ops] retain(keep_last({keep})) retired {len(retired)} "
            f"versions; compact(): {comp_s:.3f} s, mode {crep.mode}, "
            f"{crep.candidates} candidate chunks, {crep.chunks_written} "
            f"written, {crep.records_rewritten} records rewritten, "
            f"{crep.records_dropped} dropped (postings: removed "
            f"{timers.t.get('remove_chunks', 0.0):.3f} s, added "
            f"{timers.t.get('add_chunks', 0.0):.3f} s); write/delete round "
            f"trips "
            f"{r1[1] - r0[1]}/{r1[2] - r0[2]} (router), per group "
            f"{per_group}; stored chunk bytes {crep.stored_bytes_before} "
            f"-> {crep.stored_bytes_after}, index bytes {ib0} -> {ib1}; "
            f"layout epoch {rs.layout_epoch}")
        if crep.mode != "pass" or any(w > 1 or d > 1 for w, d in per_group):
            raise AssertionError(f"ops: compaction {crep.mode} took more than "
                                 "1 write + 1 delete round trip per shard")
        if crep.stored_bytes_after >= crep.stored_bytes_before:
            raise AssertionError("ops: compaction stored no fewer bytes")
        check_postings(rs, T)
        snap.refresh()
        kept = [v for v in chain.targets if v not in retired]
        wave("where wave after compaction (refreshed snapshot)", kept,
             args.seed * 100 + 74, snap)
        gone = [v for v in hot + chain.targets if v in retired]
        for v in gone:
            try:
                snap.execute([T.Q.version(v)])
            except KeyError as e:
                if "retired" not in str(e):
                    raise
            else:
                raise AssertionError(f"ops: retired version {v} answered")
        log(f"[ops] retired targets {gone} raise; targets kept {kept}")
        gw.close()
        launches = read_launches(K)
    finally:
        K.bitmap.bitmap_vm = orig_vm
        timers.close()
    if launches["bitmap_vm"] <= 0:
        raise AssertionError("the ops path launched no bitmap_vm kernel")
    log(f"[ops] launches: {json.dumps(launches)}")
    log("[ops] every answer equals the dict oracle")
    return launches, bitmap_inputs


def query_leaves(proj, q) -> List[Tuple[int, List[int]]]:
    """``(vid, pks)`` of every record, records and range leaf of ``q`` (a
    range's keys through the projections' sorted key array)."""
    if q.kind == "record":
        return [(q.vid, [q.pk])]
    if q.kind == "records":
        return [(q.vid, list(q.pks))]
    if q.kind == "range":
        return [(q.vid, proj.keys_in_range(q.key_lo, q.key_hi).tolist())]
    return [it for c in (q.children or ()) for it in query_leaves(proj, c)]


def host_candidates(proj, vid: int, pks) -> np.ndarray:
    """The candidate chunks of ``pks`` in ``vid`` without any bitmap: the
    union of the keys' posting lists intersected with the version's."""
    post = [proj.key_chunks[pk] for pk in pks if pk in proj.key_chunks]
    if not post:
        return np.empty(0, np.int64)
    return np.intersect1d(np.unique(np.concatenate(post)),
                          proj.version_chunks[vid])


def main_path_sh(args, torch, dev, T, eng_mod, K, chain: Chain):
    """The SHINGLE offline layout over k1's chain: staged writes, one full
    ``build()``, one checked wave and the index-AND candidates API."""
    from repro_torch.core import partition
    from repro_torch.core.partition import base as part_base
    log(f"[sh] chain: k1's ({chain.n_records} stored records), "
        f"RStoreConfig(algorithm='shingle', batch_size={chain.n_versions + 1})")
    kvs = T.ShardedKVS([T.ShardedDeviceKVS(slot_bytes=SLOT_BYTES, device=dev)
                        for _ in range(4)])
    # The online batch bound is set above the chain's version count: at the
    # default 64, which equals the chain's 64 versions, the second writer's
    # close would flush all of them online (a full k1-style group flush)
    # just before build() lays them out again.  It bounds online flushes
    # only; the offline layout and every answer are the same.
    rs = T.RStore(T.RStoreConfig(algorithm="shingle",
                                 batch_size=chain.n_versions + 1),
                  kvs, device=dev)
    timers = Timers(torch)
    mh_inputs, ap_inputs = [], []
    orig_mh, orig_ap = K.minhash.minhash, K.bitmap.and_popcount

    def recording_mh(indptr, col, a, b):
        mh_inputs.append((indptr, col, a, b))
        return orig_mh(indptr, col, a, b)

    def recording_ap(bms, row):
        ap_inputs.append((bms, row))
        return orig_ap(bms, row)
    K.minhash.minhash, K.bitmap.and_popcount = recording_mh, recording_ap
    timers.wrap(T.VersionGraph, "record_version_index_csr", "csr")
    timers.wrap(partition.ShinglePartitioner, "partition", "partition")
    timers.wrap(K.ops, "minhash_csr", "minhash_csr")
    timers.wrap(K.minhash, "minhash", "minhash", device_time=True)
    timers.wrap(part_base.ChunkPacker, "place_many", "place_many")
    timers.wrap(T.RStore, "_stage_chunk_writes", "stage")
    timers.wrap(kvs, "multiput", "multiput")
    timers.wrap(K.bitmap, "and_popcount", "and_popcount", device_time=True)
    try:
        zero_launches(K)
        t0 = time.perf_counter()
        ingest(rs, chain, flush_on_close=False)
        stage_s = time.perf_counter() - t0
        if rs.n_chunks or kvs.stats.n_put_queries:
            raise AssertionError("sh staging flushed before build()")
        timers.reset()
        t0 = time.perf_counter()
        rs.build()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        bt = dict(timers.t)
        csr_calls = list(timers.calls.get("csr", []))
        vid = chain.targets[-1]
        qs, wants = chain.wave(T.Q, vid, args.seed * 100 + 50)
        engine = eng_mod.StoreQueryEngine(rs)
        engine.snapshot()                   # pin once, outside the timing
        q0, b0 = kvs.stats.n_queries, kvs.stats.bytes_fetched
        t0 = time.perf_counter()
        batch = engine.serve(qs)
        torch.cuda.synchronize()
        wave_s = time.perf_counter() - t0
        rts, nbytes = kvs.stats.n_queries - q0, kvs.stats.bytes_fetched - b0
        proj = rs.proj
        items = [it for q in qs for it in query_leaves(proj, q)]
        timers.reset()
        t0 = time.perf_counter()
        cands = proj.candidates_batch(items, device=dev)
        torch.cuda.synchronize()
        cand_s = time.perf_counter() - t0
        cand_dev = timers.t.get("and_popcount_device", 0.0)
        lo = int(chain.rng.integers(0, chain.max_key))
        rng_cands = proj.candidates_range(vid, lo, lo + 255, device=dev)
        launches = read_launches(K)
    finally:
        timers.close()
        K.minhash.minhash, K.bitmap.and_popcount = orig_mh, orig_ap
    if len(ap_inputs) != 2:
        raise AssertionError(f"the sh path made {len(ap_inputs)} "
                             "and_popcount calls, not 2 (candidates_batch, "
                             "candidates_range)")
    check_wave(batch, wants, "sh wave")
    if rts > 4:
        raise AssertionError(f"sh wave: {rts} read round trips > 4")
    for i, ((v, pks), got) in enumerate(zip(items, cands)):
        if not np.array_equal(got, host_candidates(proj, v, pks)):
            raise AssertionError(f"sh candidates_batch item {i} disagrees "
                                 "with the host intersection")
    if not np.array_equal(rng_cands, host_candidates(
            proj, vid, proj.keys_in_range(lo, lo + 255).tolist())):
        raise AssertionError("sh candidates_range disagrees with the host "
                             "intersection")
    part_s = bt.get("partition", 0.0)
    csr_in_part = csr_calls[0] if csr_calls else 0.0
    mh_s = bt.get("minhash_csr", 0.0)
    sort_pack = part_s - csr_in_part - mh_s
    stage_put = bt.get("stage", 0.0) + bt.get("multiput", 0.0)
    other = build_s - part_s - sum(csr_calls[1:]) - stage_put
    log(f"[sh] staging {stage_s:.3f} s (two writer sessions, no flush)")
    log(f"[sh] build(): {build_s:.3f} s; record->version CSR "
        f"{' + '.join(f'{c:.3f}' for c in csr_calls)} s ({len(csr_calls)} "
        f"calls: partitioner, chunk maps); minhash entry {mh_s:.3f} s incl. "
        f"copies (kernel device time "
        f"{bt.get('minhash_device', 0.0) * 1e3:.3f} ms); lexsort + packing "
        f"{sort_pack:.3f} s (ChunkPacker.place_many "
        f"{bt.get('place_many', 0.0):.3f} s); chunk staging "
        f"{bt.get('stage', 0.0):.3f} s + multiput "
        f"{bt.get('multiput', 0.0):.3f} s; other (projections) {other:.3f} s")
    ip, col, a, _ = mh_inputs[0]
    log(f"[sh] {rs.n_chunks} chunks; minhash input R={ip.numel() - 1} "
        f"nnz={col.numel()} L={a.numel()}; write round trips "
        f"{kvs.stats.n_put_queries}")
    log(f"[sh] wave @v{vid}: {wave_s:.4f} s, {len(qs) / wave_s:.1f} "
        f"queries/s, {rts} read round trips, {nbytes} bytes gathered, "
        f"{batch.batch.records_returned} records")
    bms, row = ap_inputs[0]
    log(f"[sh] candidates_batch: {len(items)} record/range leaves -> one "
        f"and_popcount {tuple(bms.shape)} & {tuple(row.shape)}, {cand_s:.4f} s "
        f"host, kernel device {cand_dev * 1e3:.4f} ms; candidates_range "
        f"-> {tuple(ap_inputs[1][0].shape)} & {tuple(ap_inputs[1][1].shape)}")
    if launches["minhash"] <= 0 or launches["and_popcount"] <= 0:
        raise AssertionError(f"the sh path launched no minhash or no "
                             f"and_popcount kernel: {launches}")
    log(f"[sh] launches during staging + build + wave + candidates: "
        f"{json.dumps(launches)}")
    log("[sh] every answer equals the dict oracle; every candidate set "
        "equals the host intersection")
    return launches, mh_inputs[0], dict(
        zip(("candidates_batch", "candidates_range"), ap_inputs))


# --------------------------------------------------------------- tr path
def host_rss_kib() -> int:
    """Current resident set of this process, KiB (``VmRSS``)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1])
    return -1


def flat_params(torch, TR, params):
    """Every parameter tensor, flattened and joined in tree order."""
    return torch.cat([t.reshape(-1) for t in TR.leaves(params)])


def equal_trees(torch, TR, a, b) -> bool:
    la, lb = TR.leaves_with_paths(a), TR.leaves_with_paths(b)
    return ([p for p, _ in la] == [p for p, _ in lb]
            and all(x.dtype == y.dtype and torch.equal(x, y)
                    for (_, x), (_, y) in zip(la, lb)))


def main_path_tr(args, torch, dev, K):
    """Versioned training on the card, after ``examples/versioned_training.py``:
    smollm-360m at its published width (depth cut to ``--tr-layers``),
    AdamW, checkpoints committed as RStore versions, a simulated crash,
    a restore from the store, a bit-identical resume, a fork, partial
    restore, evolution, retention, update compression, and the training
    launcher's crash and resume.  Returns the path's launch counts, the
    bitmap program of its partial restore, the shape of its
    ``xor_delta_stats`` launch and what path sd restores: the checkpointer,
    its newest version, the state it restores like, the config and the
    optimizer."""
    import tempfile
    from repro_torch import tree as TR
    from repro_torch.configs import ARCHS
    from repro_torch.core import api as api_mod
    from repro_torch.core import chunkstore, plan as plan_mod
    from repro_torch.core import ingest as ingest_mod
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.launch import train as launch_train
    from repro_torch.models.model import build_model
    from repro_torch.train import checkpoint as ckmod
    from repro_torch.train import grad_compress
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import init_state, make_train_step

    base = ARCHS[TR_ARCH]
    cfg = base.__class__(**{**base.__dict__, "n_layers": args.tr_layers,
                            "dtype": "float32", "remat": "none"})
    model, opt = build_model(cfg), make_optimizer(cfg, lr=1e-3)
    step_fn = make_train_step(model, opt)
    tokens = TR_BATCH * TR_SEQ
    log(f"[tr] {cfg.name}: d_model {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.n_layers} layers (cut from "
        f"{base.n_layers}), {cfg.param_count()} params, f32, AdamW lr 1e-3; "
        f"batch {TR_BATCH} x seq {TR_SEQ}")
    torch.cuda.reset_peak_memory_stats()
    step_ms: List[float] = []

    def train(state, steps, record=True):
        losses = []
        for i in steps:
            batch = synthetic_batch(cfg, i, TR_BATCH, TR_SEQ, device=dev)
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            torch.cuda.synchronize()
            if record:
                step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
        if not all(np.isfinite(losses)):
            raise AssertionError(f"tr: non-finite loss {losses}")
        return state, losses

    timers = Timers(torch)
    timers.wrap(ckmod, "host_array", "d2h")
    timers.wrap(ckmod.VersionedCheckpointer, "_delta_of", "delta_of")
    timers.wrap(ingest_mod.RStore, "_prepare_flush_writes", "chunk_build")
    timers.wrap(api_mod.Snapshot, "plan_batch", "planning")
    timers.wrap(chunkstore.StoredChunk, "from_bytes", "parse")
    timers.wrap(plan_mod, "answer", "decode")
    timers.wrap(ckmod.VersionedCheckpointer, "_assemble", "assemble")
    timers.wrap(ckmod, "to_like", "h2d")
    orig_vm, orig_xor = K.bitmap.bitmap_vm, K.delta.xor_delta
    vm_inputs, xor_shapes = [], []

    def recording_vm(regs, prog):
        vm_inputs.append((regs.clone(), prog.clone()))
        return orig_vm(regs, prog)

    def recording_xor(p, c):
        xor_shapes.append(tuple(p.shape))
        return orig_xor(p, c)
    K.bitmap.bitmap_vm, K.delta.xor_delta = recording_vm, recording_xor
    torch.use_deterministic_algorithms(True)
    try:
        zero_launches(K)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        state0 = init_state(cfg, opt, gen, dev)
        state_bytes = sum(t.numel() * t.element_size()
                          for t in TR.leaves(state0))
        ckpt = ckmod.VersionedCheckpointer(device=dev)
        kvs = ckpt.rs.kvs
        timers.wrap(kvs, "multiput", "multiput")
        timers.wrap(kvs, "multiget", "multiget")
        log(f"[tr] state: {len(TR.leaves(state0))} tensors, {state_bytes} "
            f"bytes (params + mu + nu + step); checkpointer: "
            f"{ckpt.block_bytes}-byte blocks, RStoreConfig(bottom_up, "
            f"capacity {ckpt.rs.config.capacity}, batch_size "
            f"{ckpt.rs.config.batch_size}) on {ckpt.rs.device}")

        def commit(state, parents, tag):
            timers.reset()
            n0 = len(ckpt.rs.graph.store)
            t0 = time.perf_counter()
            vid = ckpt.commit(state, parents=parents, tag=tag)
            ckpt.rs.flush()
            dt = time.perf_counter() - t0
            t = timers.t
            log(f"[tr] commit v{vid} ({tag}) + flush: {dt:.3f} s host, "
                f"{state_bytes / dt / 1e9:.4f} GB/s of state "
                f"({dt / (state_bytes / 1e9):.3f} s per GB); D2H "
                f"{t.get('d2h', 0.0):.3f} s, _delta_of without D2H "
                f"{t.get('delta_of', 0.0) - t.get('d2h', 0.0):.3f} s, group "
                f"flush: chunk build (zlib) {t.get('chunk_build', 0.0):.3f} s,"
                f" multiput {t.get('multiput', 0.0):.3f} s; "
                f"{len(ckpt.rs.graph.store) - n0} blocks added")
            return vid

        def restore(vid, what):
            timers.reset()
            t0 = time.perf_counter()
            out = ckpt.restore(vid, like=state0)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            t = timers.t
            assemble = t.get("assemble", 0.0) - t.get("h2d", 0.0)
            log(f"[tr] restore v{vid} ({what}): {dt:.3f} s host, "
                f"{dt / (state_bytes / 1e9):.3f} s per GB; planning "
                f"{t.get('planning', 0.0):.3f} s, multiget "
                f"{t.get('multiget', 0.0):.3f} s, chunk parse "
                f"{t.get('parse', 0.0):.3f} s, decompress/answer "
                f"{t.get('decode', 0.0):.3f} s, assemble {assemble:.3f} s, "
                f"H2D {t.get('h2d', 0.0):.3f} s")
            return out

        v0 = commit(state0, (), "init")
        straight, straight_losses = train(state0, range(TR_STEPS))
        mid, _ = train(state0, range(TR_STEPS // 2))
        v_mid = commit(mid, (v0,), f"step{TR_STEPS // 2}")
        p_init = flat_params(torch, TR, state0["params"])
        p_mid = flat_params(torch, TR, mid["params"])
        t0 = time.perf_counter()
        xs = grad_compress.xor_delta_stats(p_init, p_mid)
        torch.cuda.synchronize()
        xs_s = time.perf_counter() - t0
        del p_init, p_mid
        log(f"[tr] xor_delta_stats(params at init, params at step "
            f"{TR_STEPS // 2}): {xs_s:.4f} s host, launch shape "
            f"{xor_shapes}, changed_word_fraction "
            f"{xs['changed_word_fraction']!r}, changed_block_fraction "
            f"{xs['changed_block_fraction']!r}")
        restored = restore(v_mid, "after the simulated crash")
        if not equal_trees(torch, TR, restored, mid):          # check 1
            raise AssertionError("tr: the restore differs from the committed "
                                 "state")
        del mid
        main, resumed_losses = train(restored, range(TR_STEPS // 2, TR_STEPS))
        if not equal_trees(torch, TR, main, straight):         # check 2
            raise AssertionError("tr: the resumed run differs from the "
                                 "straight run")
        if resumed_losses != straight_losses[TR_STEPS // 2:]:
            raise AssertionError("tr: the resumed losses differ")
        del straight
        log(f"[tr] restored state equals the committed one; the resumed run "
            f"equals the straight run bit for bit (params, mu, nu, step); "
            f"losses {straight_losses[0]!r} -> {straight_losses[-1]!r}")
        v_main = commit(main, (v_mid,), "main")
        fork = restore(v_mid, "for the fork")
        fork, _ = train(fork, [10_000 + i for i in range(
            TR_STEPS // 2, TR_STEPS // 2 + TR_FORK_STEPS)])
        v_fork = commit(fork, (v_mid,), "fork")

        q0, vm0 = kvs.stats.n_queries, len(vm_inputs)
        t0 = time.perf_counter()
        sub = ckpt.restore_tensors(v_main, ["params/embed"])
        part_s = time.perf_counter() - t0
        rts = kvs.stats.n_queries - q0
        want = main["params"]["embed"].cpu().numpy()
        if (rts != 1 or list(sub) != ["params/embed"]                 # check 3
                or not np.array_equal(sub["params/embed"], want)):
            raise AssertionError(f"tr: partial restore: {rts} round trips, "
                                 f"{list(sub)}")
        tr_program = vm_inputs[vm0:]
        t0 = time.perf_counter()
        evo = ckpt.evolution("params/final_norm", 0)
        evo_s = time.perf_counter() - t0
        n_evo = len({bytes(p) for _, p in evo})
        if n_evo < 3:                                           # check 4
            raise AssertionError(f"tr: evolution has {n_evo} distinct values")
        log(f"[tr] restore_tensors(v{v_main}, ['params/embed']): "
            f"{part_s:.3f} s, {rts} read round trip, "
            f"{len(tr_program)} bitmap_vm launch; evolution of "
            f"params/final_norm block 0: {len(evo)} versions, {n_evo} "
            f"distinct values, {evo_s:.3f} s")
        st = ckpt.storage_stats()
        log(f"[tr] storage: {st['n_chunks']} chunks, stored chunk bytes "
            f"{st['stored_chunk_bytes']}, raw unique bytes "
            f"{st['raw_unique_bytes']} (stored/raw "
            f"{st['stored_chunk_bytes'] / st['raw_unique_bytes']:.4f}), "
            f"{ckpt.rs.graph.num_versions} versions, "
            f"{len(ckpt.rs.graph.store)} blocks held")
        t0 = time.perf_counter()
        rep = ckpt.retain_last(2)
        ret_s = time.perf_counter() - t0
        log(f"[tr] retain_last(2): {ret_s:.3f} s; compaction mode "
            f"{rep.mode}, stored chunk bytes {rep.stored_bytes_before} -> "
            f"{rep.stored_bytes_after}, chunks deleted {rep.chunks_deleted}, "
            f"written {rep.chunks_written}, write/delete round trips "
            f"{rep.write_round_trips}/{rep.delete_round_trips}")
        again = restore(v_fork, "after retention")
        if not equal_trees(torch, TR, again, fork):             # check 5
            raise AssertionError("tr: v_fork differs after retention")
        try:
            ckpt.restore(v0)
        except KeyError as e:
            if "retired" not in str(e):
                raise
        else:
            raise AssertionError("tr: restore of a retired version worked")
        evo2 = ckpt.evolution("params/final_norm", 0)
        if len({bytes(p) for _, p in evo2}) != 2:
            raise AssertionError(f"tr: evolution after retention has "
                                 f"{len(evo2)} values, not 2")
        del again

        u = (flat_params(torch, TR, main["params"])
             - flat_params(torch, TR, restored["params"]))
        t0 = time.perf_counter()
        q, scale = grad_compress.compress_update(u)
        back = grad_compress.decompress_update(q, scale, u.shape,
                                               torch.float32)
        torch.cuda.synchronize()
        comp_s = time.perf_counter() - t0
        err = float((back - u).abs().max())
        lim = float(u.abs().max()) / 127 + 1e-8
        if not err <= lim:                                       # check 6
            raise AssertionError(f"tr: compression error {err} > {lim}")
        log(f"[tr] compress_update/decompress_update of params(main) - "
            f"params(step {TR_STEPS // 2}), {u.numel()} values: {comp_s:.4f}"
            f" s, max error {err!r} <= {lim!r}")
        del u, q, scale, back, main, fork, restored

        with tempfile.TemporaryDirectory() as tmp:
            argv = ["--arch", TR_ARCH, "--reduced", "--steps", "6",
                    "--checkpoint-every", "3", "--ckpt-state",
                    os.path.join(tmp, "ckpt.pkl")]
            t0 = time.perf_counter()
            try:
                launch_train.run(argv + ["--crash-at", "4"])
            except SystemExit as e:
                if e.code != 17:
                    raise
            else:
                raise AssertionError("tr: the launcher did not crash")
            _, st6 = launch_train.run(argv + ["--resume"])
            run_s = time.perf_counter() - t0
        rcfg = ARCHS[TR_ARCH].reduced()
        rcfg = rcfg.__class__(**{**rcfg.__dict__, "dtype": "float32",
                                 "remat": "none"})
        loss = float(build_model(rcfg).loss(
            st6["params"], synthetic_batch(rcfg, 6, 8, 128, device=dev)))
        if not np.isfinite(loss):                                # check 7
            raise AssertionError(f"tr: the resumed launcher's loss {loss}")
        log(f"[tr] launch.train.run crash at step 4, then --resume to step "
            f"6: {run_s:.3f} s, loss after it {loss!r}")
        launches = read_launches(K)
        batch = synthetic_batch(cfg, 0, TR_BATCH, TR_SEQ, device=dev)
        busy_s, wall_s, top = device_busy(torch, lambda: step_fn(state0,
                                                                 batch))
        log(f"[tr] profiled train step: {wall_s * 1e3:.3f} ms wall, device "
            f"busy {busy_s * 1e3:.3f} ms ({busy_s / wall_s:.3%}), idle "
            f"{1 - busy_s / wall_s:.3%}; top device ops: {top}")
    finally:
        torch.use_deterministic_algorithms(False)
        K.bitmap.bitmap_vm, K.delta.xor_delta = orig_vm, orig_xor
        timers.close()
    ms = sorted(step_ms)
    med = ms[len(ms) // 2]
    log(f"[tr] train step: median {med:.3f} ms over {len(ms)} steps "
        f"(synchronized; min {ms[0]:.3f}, max {ms[-1]:.3f}), "
        f"{tokens / med * 1e3:.0f} tokens/s")
    log(f"[tr] launches: {json.dumps(launches)}; peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes; host RSS "
        f"{host_rss_kib()} KiB")
    if launches["bitmap_vm"] <= 0 or launches["xor_delta"] <= 0:
        raise AssertionError(f"tr: a kernel of the path never launched: "
                             f"{launches}")
    return launches, tr_program, xor_shapes[0], (ckpt, v_fork, state0, cfg,
                                                 opt)


def bf16_ulp(x: float) -> float:
    """One bfloat16 ulp at magnitude ``x`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


def serve_waves(torch, dev, cfg, tag: str, seed: int, waves: int) -> None:
    """One model through ``Engine`` at ``launch/serve.py``'s traffic: waves
    of SV_BATCH prompts of SV_PROMPT tokens from the synthetic pipeline (the
    enc-dec family with its frames), SV_GEN tokens each.  Each wave checks
    ``Engine.generate`` against a manual prefill + decode loop bit for bit
    and every logit for finiteness; the first wave also holds prefill's
    last-position logits against ``train_logits`` there (4 bf16 ulps of the
    largest logit).  Then one decode step runs under the profiler."""
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.models.model import build_model, init_params
    from repro_torch.serve.engine import Engine
    model = build_model(cfg)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         dev)
    max_len = SV_PROMPT + SV_GEN + 8
    eng = Engine(cfg, params, max_len=max_len)
    V = cfg.vocab_size
    log(f"[sv] {tag}: {cfg.name}, {cfg.n_layers} layers"
        + (f" + {cfg.n_encoder_layers} encoder" if cfg.n_encoder_layers
           else "")
        + f", d_model {cfg.d_model}, {cfg.param_count()} params, "
        f"{cfg.dtype}, capacity_factor {cfg.capacity_factor}; {waves} waves"
        f" of {SV_BATCH} x {SV_PROMPT}-token prompts, {SV_GEN} tokens each, "
        f"max_len {max_len}")
    for wave in range(waves):
        batch = synthetic_batch(cfg, wave, SV_BATCH, SV_PROMPT, device=dev)
        batch = {k: v for k, v in batch.items() if k in ("tokens", "frames")}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        toks = eng.generate(batch, SV_GEN)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        with torch.no_grad():
            t0 = time.perf_counter()
            logits, caches = model.prefill(params, batch, max_len=max_len)
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
            finite = torch.isfinite(logits).all()
            tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
            manual, step_ms = [tok], []
            for pos in range(SV_PROMPT, SV_PROMPT + SV_GEN - 1):
                # decode_step, its logits kept for the finiteness check
                t0 = time.perf_counter()
                lg, caches = model.decode_logits(params, caches, tok, pos)
                tok = torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None]
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                finite &= torch.isfinite(lg).all()
                manual.append(tok)
            if wave == 0:
                full, _ = model.train_logits(params, batch)
                a = full[:, -1, :V].float()
                b = logits[:, 0, :V].float()
                err = float((a - b).abs().max())
                tol = 4 * bf16_ulp(float(a.abs().max()))
                if not err <= tol:
                    raise AssertionError(f"sv {tag}: prefill logits differ "
                                         f"from train_logits by {err} > "
                                         f"{tol}")
                log(f"[sv] {tag}: prefill's last-position logits vs "
                    f"train_logits: max |diff| {err!r} <= {tol!r} (4 bf16 "
                    "ulps of the largest logit)")
                del full
        if not torch.equal(toks, torch.cat(manual, dim=1)):       # check 1
            raise AssertionError(f"sv {tag} wave {wave}: Engine.generate "
                                 "differs from the manual decode loop")
        if not bool(finite):                                       # check 2
            raise AssertionError(f"sv {tag} wave {wave}: non-finite logits")
        med = sorted(step_ms)[len(step_ms) // 2]
        tps = SV_BATCH * SV_GEN / gen_s
        log(f"[sv] {tag} wave {wave}: generate {gen_s * 1e3:.3f} ms "
            f"({tps:.1f} tokens/s); prefill {prefill_ms:.3f} ms, decode "
            f"median {med:.3f} ms/step over {len(step_ms)} steps (min "
            f"{min(step_ms):.3f}, max {max(step_ms):.3f}); peak device memory"
            f" {peak} bytes; tokens equal the manual loop, logits finite")
    with torch.no_grad():
        busy_s, wall_s, top = device_busy(torch, lambda: model.decode_step(
            params, caches, tok, SV_PROMPT + SV_GEN - 1))
    log(f"[sv] {tag}: profiled decode step: {wall_s * 1e3:.3f} ms wall, "
        f"device busy {busy_s * 1e3:.3f} ms ({busy_s / wall_s:.3%}), idle "
        f"{1 - busy_s / wall_s:.3%}; top device ops: {top}")


def reduced_arch_checks(torch, dev, seed: int) -> None:
    """Every architecture's ``.reduced()`` config (f32) on the card: the
    reference's ``test_arch_decode_matches_full_forward`` check (prefill
    at 16 tokens within rtol 2e-2/atol 2e-3 of the full forward, then 4
    teacher-forced decode steps whose greedy tokens equal the full
    forward's), and the card's prefill logits within 1e-4 of the port's
    CPU run on the same weights, TF32 off."""
    from repro_torch import tree as TR
    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.models.model import build_model, init_params
    B, S, S0 = 2, 32, 16
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for name in ARCHS:
            cfg = ARCHS[name].reduced()
            model = build_model(cfg)
            t0 = time.perf_counter()
            p_cpu = init_params(cfg, torch.Generator().manual_seed(seed),
                                "cpu")
            params = TR.tree_map(lambda t: t.to(dev), p_cpu)
            b_cpu = synthetic_batch(cfg, 0, B, S, device="cpu")
            batch = {k: v.to(dev) for k, v in b_cpu.items()}
            P = cfg.n_prefix_embeds if cfg.family == "vlm" else 0
            V = cfg.vocab_size
            with torch.no_grad():
                full, _ = model.train_logits(params, batch)
                full = full[..., :V].cpu().numpy()
                pre = dict(batch, tokens=batch["tokens"][:, :S0])
                l0, caches = model.prefill(params, pre)
                l0 = l0[:, 0, :V].cpu()
                np.testing.assert_allclose(l0.numpy(), full[:, P + S0 - 1],
                                           rtol=2e-2, atol=2e-3)
                for t in range(S0, S0 + 4):
                    nxt, caches = model.decode_step(
                        params, caches, batch["tokens"][:, t:t + 1], t + P)
                    want = np.argmax(full[:, P + t], axis=-1)
                    if not np.array_equal(nxt.cpu().numpy(), want):
                        raise AssertionError(f"sv reduced {name}: decode "
                                             f"step {t} differs from the "
                                             "full forward")
                l_cpu, _ = model.prefill(
                    p_cpu, dict(b_cpu, tokens=b_cpu["tokens"][:, :S0]))
                err = float((l0 - l_cpu[:, 0, :V]).abs().max())
            if not err <= 1e-4:
                raise AssertionError(f"sv reduced {name}: card vs CPU prefill"
                                     f" logits differ by {err}")
            log(f"[sv] reduced {name}: prefill + 4 decode steps match the "
                f"full forward; card vs CPU prefill logits max |diff| "
                f"{err!r}; {time.perf_counter() - t0:.3f} s")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def main_path_sv(args, torch, dev, K):
    """Model serving on the card, after ``launch/serve.py`` and
    ``examples/serve_demo.py``: granite-moe-1b-a400m as registered (depth
    ``--sv-layers``) through ``Engine``; mamba2-130m and whisper-base at
    full size; every architecture's reduced config against its full forward
    and the CPU; then the versioned model registry (granite-moe at full
    width, depth cut to ``--sv-registry-layers``): the init params
    committed as v0, 5 AdamW steps, v1, and each version restored (Q1: one
    KVS round trip and no bitmap program), restored again as the demo's
    partial restore of every param tensor (one round trip, one bitmap_vm
    launch) and served.  Deterministic algorithms throughout.  Returns the
    path's launch counts and the bitmap programs of its restores."""
    from repro_torch import tree as TR
    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import Engine
    from repro_torch.train import checkpoint as ckmod
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import init_state, make_train_step

    def registered(name, **kw):
        c = ARCHS[name]
        return c.__class__(**{**c.__dict__, "remat": "none", **kw})

    orig_vm = K.bitmap.bitmap_vm
    vm_inputs = []

    def recording_vm(regs, prog):
        vm_inputs.append((regs.clone(), prog.clone()))
        return orig_vm(regs, prog)
    K.bitmap.bitmap_vm = recording_vm
    torch.use_deterministic_algorithms(True)
    try:
        zero_launches(K)
        base = ARCHS[SV_ARCH]
        serve_waves(torch, dev, registered(
            SV_ARCH, n_layers=args.sv_layers or base.n_layers), "granite",
            args.seed, SV_WAVES)
        gc.collect()
        torch.cuda.empty_cache()
        for name in SV_FAMILIES:
            serve_waves(torch, dev, registered(name), name.split("-")[0],
                        args.seed, 1)
            gc.collect()
            torch.cuda.empty_cache()
        reduced_arch_checks(torch, dev, args.seed)

        # ---- the versioned model registry
        cfg = registered(SV_ARCH, n_layers=args.sv_registry_layers)
        model, opt = build_model(cfg), make_optimizer(cfg)
        step_fn = make_train_step(model, opt)
        state = init_state(cfg, opt, torch.Generator(device=dev)
                           .manual_seed(args.seed), dev)
        ckpt = ckmod.VersionedCheckpointer(device=dev)
        kvs = ckpt.rs.kvs
        n_bytes = sum(t.numel() * t.element_size()
                      for t in TR.leaves(state["params"]))
        log(f"[sv] registry: {cfg.name} at full width, {cfg.n_layers} layers"
            f" (cut from {base.n_layers}), {cfg.param_count()} params, "
            f"{n_bytes} bytes of params ({cfg.dtype}); params only are "
            "committed")

        def commit(params, parents, tag):
            t0 = time.perf_counter()
            vid = ckpt.commit({"params": params}, parents=parents, tag=tag)
            ckpt.rs.flush()
            return vid, time.perf_counter() - t0

        versions = []
        v0, s0 = commit(state["params"], (), "init")
        versions.append((v0, state["params"], s0))
        losses = []
        for i in range(SV_REG_STEPS):
            state, m = step_fn(state, synthetic_batch(
                cfg, i, SV_REG_BATCH, SV_REG_SEQ, device=dev))
            losses.append(float(m["loss"]))
        if not all(np.isfinite(losses)):
            raise AssertionError(f"sv registry: non-finite loss {losses}")
        v1, s1 = commit(state["params"], (v0,), "tuned")
        versions.append((v1, state["params"], s1))
        del state
        log(f"[sv] registry: {SV_REG_STEPS} AdamW steps (batch "
            f"{SV_REG_BATCH} x {SV_REG_SEQ}), losses {losses[0]!r} -> "
            f"{losses[-1]!r}")
        prompts = {"tokens": synthetic_batch(cfg, 0, SV_BATCH, SV_PROMPT,
                                             device=dev)["tokens"]}
        max_len = SV_PROMPT + SV_GEN + 8
        for vid, want, commit_s in versions:
            # Q1, the full restore: one round trip, no bitmap program
            q0, l0 = kvs.stats.n_queries, K.bitmap.LAUNCHES
            t0 = time.perf_counter()
            got = ckpt.restore(vid, like={"params": want})["params"]
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            rts, vms = kvs.stats.n_queries - q0, K.bitmap.LAUNCHES - l0
            if rts != 1 or vms != 0:                               # check 3
                raise AssertionError(f"sv registry v{vid}: restore made {rts}"
                                     f" round trips, {vms} bitmap_vm "
                                     "launches")
            if not equal_trees(torch, TR, got, want):              # check 4
                raise AssertionError(f"sv registry v{vid}: the restore "
                                     "differs from the committed params")
            # the demo's partial restore of every param tensor: one batched
            # session of Q.records queries, one round trip, one launch
            q0, l0 = kvs.stats.n_queries, K.bitmap.LAUNCHES
            t0 = time.perf_counter()
            part = ckpt.restore_tensors(vid, ["params"])
            part_s = time.perf_counter() - t0
            prts, pvms = kvs.stats.n_queries - q0, K.bitmap.LAUNCHES - l0
            by_path = {TR.path_str(p): t for p, t in
                       TR.leaves_with_paths({"params": want})}
            if (prts != 1 or pvms != 1 or sorted(part) != sorted(by_path)
                    or not all(torch.equal(torch.as_tensor(a),
                                           by_path[k].cpu())
                               for k, a in part.items())):         # check 5
                raise AssertionError(f"sv registry v{vid}: partial restore: "
                                     f"{prts} round trips, {pvms} bitmap_vm "
                                     "launches, or other values")
            del part
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = Engine(cfg, got, max_len=max_len).generate(prompts, SV_GEN)
            torch.cuda.synchronize()
            gen_s = time.perf_counter() - t0
            mem = Engine(cfg, want, max_len=max_len).generate(prompts, SV_GEN)
            if not torch.equal(toks, mem):                         # check 6
                raise AssertionError(f"sv registry v{vid}: the restored "
                                     "model serves other tokens")
            log(f"[sv] registry v{vid}: commit + flush {commit_s:.3f} s "
                f"({n_bytes / commit_s / 1e6:.2f} MB/s); restore "
                f"{restore_s:.3f} s ({rts} KVS round trip, no bitmap "
                f"program), bit-equal; partial restore of "
                f"{len(by_path)} tensors {part_s:.3f} s ({prts} round trip, "
                f"{pvms} bitmap_vm launch), equal; generate "
                f"{gen_s * 1e3:.3f} ms ({SV_BATCH * SV_GEN / gen_s:.1f} "
                "tokens/s), tokens equal the in-memory model's")
        launches = read_launches(K)
    finally:
        torch.use_deterministic_algorithms(False)
        K.bitmap.bitmap_vm = orig_vm
    log(f"[sv] launches: {json.dumps(launches)}")
    if launches["bitmap_vm"] <= 0:
        raise AssertionError(f"sv: bitmap_vm never launched: {launches}")
    return launches, vm_inputs


def main_path_sd(args, torch, dev, K, tr_ckpt):
    """Sharding on the card, on a (1, 1) mesh of one NCCL rank
    (``make_debug_mesh``): an elastic restore of tr's newest checkpoint
    (every param a ``DTensor`` placed by the rules, every leaf bit-equal to
    the restored state, its shard on the card) and one train step of that
    state under ``mesh_env``, bit-identical to the plain step; then
    granite-moe-1b-a400m at full width and depth, one SV_BATCH x SV_PROMPT
    prefill through ``moe_shard_map``'s local branch (its ``OPTIMIZED``
    prefill config) and one with its params as ``DTensor``s placed by
    ``tree_pspecs``, each against the plain prefill; then one dry-run cell
    (``launch/dryrun.py``, granite-moe decode_32k on the 256-GPU mesh of a
    fake process group) as a subprocess.  Deterministic algorithms, as tr
    runs them.  The NCCL group is destroyed before returning.  Returns the
    path's launch counts (it runs no kernel of its own)."""
    import dataclasses
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor
    from repro_torch import tree as TR
    from repro_torch.configs import ARCHS
    from repro_torch.configs.registry import OPTIMIZED
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.sharding.rules import mesh_env, rules_for
    from repro_torch.train.elastic import restore_for_mesh
    from repro_torch.train.train_step import make_train_step

    ckpt, version, like, cfg, opt = tr_ckpt
    torch.use_deterministic_algorithms(True)
    zero_launches(K)
    mesh = make_debug_mesh(1, 1)
    try:
        log(f"[sd] mesh {mesh}, backend {dist.get_backend()}, world "
            f"{dist.get_world_size()}")

        def place(env, t, axes):
            return distribute_tensor(t, mesh, env.sharding_for(t.shape, axes))

        # ---- 1. elastic restore of tr's newest version, and a train step
        t0 = time.perf_counter()
        state = restore_for_mesh(ckpt, version, like, cfg, opt, mesh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        host = ckpt.restore(version, like=like)
        pairs = list(zip(TR.leaves(state), TR.leaves(host)))
        for d, h in pairs:                                          # check 1
            if not (isinstance(d, DTensor) and d.to_local().device == dev
                    and d.dtype == h.dtype and torch.equal(d.full_tensor(),
                                                           h)):
                raise AssertionError("sd: a restored leaf is not the "
                                     "restored state on the card")
        log(f"[sd] restore_for_mesh(v{version}) of {cfg.name} (width "
            f"{cfg.d_model}, {cfg.n_layers} layers): {restore_s:.3f} s, "
            f"{len(pairs)} leaves, each a DTensor on the card whose "
            "full_tensor() equals the restored state bit for bit")
        step_fn = make_train_step(M.build_model(cfg), opt)
        batch = synthetic_batch(cfg, 0, TR_BATCH, TR_SEQ, device=dev)
        t0 = time.perf_counter()
        want, m_want = step_fn(host, batch)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        with mesh_env(mesh, rules_for(cfg, mesh)) as env:
            dbatch = {k: place(env, v, ("batch",) + (None,) * (v.ndim - 1))
                      for k, v in batch.items()}
            t0 = time.perf_counter()
            got, m_got = step_fn(state, dbatch)
            torch.cuda.synchronize()
            dt_ms = (time.perf_counter() - t0) * 1e3
        loss_w, loss_g = float(m_want["loss"]), float(
            m_got["loss"].full_tensor())
        same = all(torch.equal(g.full_tensor() if isinstance(g, DTensor)
                               else g, w) for g, w in
                   zip(TR.leaves(got), TR.leaves(want)))
        if loss_g != loss_w or not same:                          # check 2
            raise AssertionError(f"sd: the DTensor train step differs from "
                                 f"the plain one (loss {loss_g!r} vs "
                                 f"{loss_w!r}, state equal {same})")
        log(f"[sd] one train step of the DTensor state under mesh_env: loss "
            f"{loss_g!r}, params/mu/nu/step equal the plain step's bit for "
            f"bit; {dt_ms:.3f} ms (plain {plain_ms:.3f} ms)")
        del state, host, got, want, pairs
        gc.collect()
        torch.cuda.empty_cache()

        # ---- 2. granite-moe at full width and depth, three prefills
        base = ARCHS[SV_ARCH]
        gcfg = base.__class__(**{**base.__dict__, "remat": "none"})
        sm_cfg = dataclasses.replace(gcfg, **OPTIMIZED[SV_ARCH]["prefill"])
        params = M.init_params(gcfg, torch.Generator(device=dev)
                               .manual_seed(args.seed), dev)
        tokens = synthetic_batch(gcfg, 0, SV_BATCH, SV_PROMPT,
                                 device=dev)["tokens"]
        V = gcfg.vocab_size
        calls = {"moe_shard_map": 0, "moe": 0}
        orig_sm, orig_moe = M.moe_shard_map, L.moe

        def counting(name, fn):
            def run(*a, **kw):
                calls[name] += 1
                return fn(*a, **kw)
            return run

        def prefill(cfg_, params_, batch_):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with torch.no_grad():
                logits, _ = M.build_model(cfg_).prefill(params_, batch_)
            logits = logits.full_tensor() if isinstance(logits, DTensor) \
                else logits
            torch.cuda.synchronize()
            return (logits[:, -1, :V].float(),
                    (time.perf_counter() - t0) * 1e3,
                    torch.cuda.max_memory_allocated())

        ref, ref_ms, ref_peak = prefill(gcfg, params, {"tokens": tokens})
        tol = 4 * bf16_ulp(float(ref.abs().max()))
        M.moe_shard_map = counting("moe_shard_map", orig_sm)
        L.moe = counting("moe", orig_moe)
        try:
            with mesh_env(mesh, rules_for(sm_cfg, mesh)):
                sm, sm_ms, sm_peak = prefill(sm_cfg, params,
                                             {"tokens": tokens})
        finally:
            M.moe_shard_map, L.moe = orig_sm, orig_moe
        n_moe = gcfg.n_layers
        if calls != {"moe_shard_map": n_moe, "moe": 0}:            # check 3
            raise AssertionError(f"sd: moe_shard_map's local branch did not "
                                 f"run in every layer: {calls}")
        with mesh_env(mesh, rules_for(gcfg, mesh)) as env:
            dparams = TR.tree_map(lambda t, pl: distribute_tensor(t, mesh, pl),
                                  params, L.tree_pspecs(M.param_defs(gcfg),
                                                        env))
            dt, dt_ms, dt_peak = prefill(gcfg, dparams, {
                "tokens": place(env, tokens, ("batch", None))})
        for what, got_, ms, peak in (("shard_map", sm, sm_ms, sm_peak),
                                     ("DTensor params", dt, dt_ms, dt_peak)):
            err = float((got_ - ref).abs().max())
            same_tok = torch.equal(got_.argmax(-1), ref.argmax(-1))
            if not (err <= tol and same_tok):                     # check 4
                raise AssertionError(f"sd: granite prefill through {what}: "
                                     f"max |diff| {err} > {tol} or other "
                                     "argmax tokens")
            log(f"[sd] granite prefill ({gcfg.n_layers} layers, "
                f"{SV_BATCH} x {SV_PROMPT}) through {what}: last-position "
                f"logits max |diff| {err!r} <= {tol!r} (4 bf16 ulps of the "
                f"largest logit), argmax tokens equal; {ms:.3f} ms, peak "
                f"device memory {peak} bytes")
        log(f"[sd] plain granite prefill: {ref_ms:.3f} ms, peak device "
            f"memory {ref_peak} bytes; moe_shard_map ran its local branch in "
            f"all {calls['moe_shard_map']} MoE layers")
        del params, dparams
        launches = read_launches(K)
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 3. one dry-run cell, in a process of its own (a fake group)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           SD_DRY_ARCH, "--shape", SD_DRY_SHAPE]
    env_ = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, env=env_, capture_output=True,
                         text=True, timeout=300)
    dry_s = time.perf_counter() - t0
    lines = [x for x in out.stdout.splitlines() if x.startswith("{")]
    rec = json.loads(lines[-1]) if lines else {}
    if out.returncode != 0 or rec.get("status") != "ok":          # check 5
        raise AssertionError(f"sd: the dry run failed (exit "
                             f"{out.returncode}): {out.stdout[-2000:]} "
                             f"{out.stderr[-2000:]}")
    log(f"[sd] dry run {' '.join(cmd[2:])}: {dry_s:.1f} s, exit 0")
    log(f"[sd] dry run record: {lines[-1]}")
    log(f"[sd] launches: {json.dumps(launches)} (sd has no kernel of its "
        "own)")
    return launches


def load_example(file: str):
    """``examples/<file>`` as a module, its ``main`` not yet run."""
    spec = importlib.util.spec_from_file_location(
        "example_" + file[:-3], os.path.join(ROOT, "examples", file))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def masked(text: str, example: str) -> List[str]:
    """``text``'s lines, each field that ``example``'s masks name replaced
    by ``<its name>``."""
    with open(os.path.join(EXAMPLES_DATA, "masks.json")) as f:
        masks = json.load(f)[example]
    lines = text.splitlines()
    for name, m in masks.items():
        lines = [re.sub(m["pattern"], f"<{name}>", ln) for ln in lines]
    return lines


def main_path_ex(torch, K):
    """The repo's examples on the port (``examples/*_torch.py``), each
    called in-process at its default flags (the reference's own sizes) on
    the card, its stdout captured: ``quickstart`` and ``ehr_analytics`` must
    print the reference's transcript exactly, and ``serve_demo`` line for
    line outside its named masks.  The four launch counts are zeroed just
    before each example and read just after it.  Every ``bitmap_vm``
    program and ``xor_delta`` ragged launch is recorded (its example and a
    copy of its inputs) for the kernel phases.  Returns the launches per
    example and the inputs."""
    orig_vm, orig_ragged = K.bitmap.bitmap_vm, K.delta.xor_delta_ragged
    vm_inputs, delta_inputs = [], []
    current = [""]

    def recording_vm(regs, prog):
        vm_inputs.append((current[0], regs.clone(), prog.clone()))
        return orig_vm(regs, prog)

    def recording_ragged(p, c, off):
        delta_inputs.append((current[0], p.clone(), c.clone(), off.clone()))
        return orig_ragged(p, c, off)

    # each example, whether its output must equal the transcript exactly,
    # and the kernels its path must launch
    plan = (("quickstart", True, ("bitmap_vm", "xor_delta")),
            ("ehr_analytics", True, ("bitmap_vm", "xor_delta")),
            ("serve_demo", False, ("bitmap_vm",)))
    launches = {}
    K.bitmap.bitmap_vm = recording_vm
    K.delta.xor_delta_ragged = recording_ragged
    try:
        for example, exact, needs in plan:
            mod = load_example(f"{example}_torch.py")
            current[0] = f"ex {example}"
            buf = io.StringIO()
            zero_launches(K)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                mod.main([])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            n = launches[f"ex {example}"] = read_launches(K)
            with open(os.path.join(EXAMPLES_DATA, example + ".txt")) as f:
                want = f.read()
            got = buf.getvalue()
            for line in got.splitlines():
                log(f"[ex] {example}> {line}")
            if not (got == want if exact else
                    masked(got, example) == masked(want, example)):
                raise AssertionError(f"ex {example}: the output differs from "
                                     f"the reference's transcript:\n{got}")
            if any(n[k] <= 0 for k in needs):
                raise AssertionError(f"ex {example}: a kernel of its path "
                                     f"never launched: {n}")
            log(f"[ex] {example}: {dt:.3f} s, output equals the reference's "
                f"transcript{'' if exact else ' outside its masks'}; "
                f"launches {json.dumps(n)}")
    finally:
        K.bitmap.bitmap_vm, K.delta.xor_delta_ragged = orig_vm, orig_ragged
    return launches, vm_inputs, delta_inputs

class Bench:
    """Shared tools of the kernel phases: seeded random words on the card,
    exact comparison, CUDA-event times of a C entry point, and the bound."""

    def __init__(self, torch, dev) -> None:
        from repro_torch.kernels import _build
        self.torch, self.dev, self._build = torch, dev, _build
        self.lib = _build.library()
        self.stream = torch.cuda.current_stream().cuda_stream
        self.gen = torch.Generator(device="cpu").manual_seed(1234)

    def words(self, *shape):
        return self.torch.randint(-2**31, 2**31 - 1, shape, generator=self.gen,
                                  dtype=self.torch.int32).to(self.dev)

    def err(self, a, b) -> int:
        """Largest absolute difference; raises if the shapes differ."""
        if tuple(a.shape) != tuple(b.shape):
            raise AssertionError(f"shapes {tuple(a.shape)} != "
                                 f"{tuple(b.shape)}")
        t = self.torch
        return int((a.to(t.int64) - b.to(t.int64)).abs().max()) \
            if a.numel() else 0

    def launch_ms(self, entry, *args) -> Dict[str, float]:
        """Times of one launch of a C entry point on preallocated buffers:
        ``ms``, device time (a CUDA graph of 200 launches, replayed between
        CUDA events, so the host's launch rate stays out of it);
        ``event_ms``, CUDA events around 200 launches from the host (below
        about 10 us this is the host's launch rate); ``cold_ms``, single
        launches after L2 has been overwritten."""
        torch, check = self.torch, self._build.check

        def on_current_stream():
            # inside a graph capture, the current stream is the capture's
            check(entry(*args, torch.cuda.current_stream().cuda_stream),
                  entry.__name__)
        check(entry(*args, self.stream), entry.__name__)
        return dict(ms=self.graph_ms(on_current_stream),
                    event_ms=cuda_ms(torch, lambda: entry(*args, self.stream),
                                     iters=200),
                    cold_ms=cold_ms(torch, lambda: entry(*args, self.stream)))

    def graph_ms(self, fn, iters: int = 200, replays: int = 5) -> float:
        """Mean device time of one ``fn()``: ``iters`` calls captured into
        one CUDA graph, replayed between CUDA events."""
        torch = self.torch
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(replays):
            graph.replay()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / (replays * iters)

    @staticmethod
    def bound(nbytes: float, nops: float) -> Tuple[float, str]:
        b_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        b_ops = nops / PEAK_WORD_OPS_PER_S * 1e3
        return max(b_bytes, b_ops), ("bytes" if b_bytes >= b_ops
                                     else "operations")


def path_launches(launches, kernel: str) -> Dict[str, object]:
    """A kernel row's launch counts: the sum over the main paths, and each
    path's own (each read just after its path ran)."""
    by_path = {p: n[kernel] for p, n in launches.items()}
    return {"launches": sum(by_path.values()), "launches_by_path": by_path}


def vm_and_xor_phases(B: Bench, K, bitmap_inputs, delta_inputs,
                      tr_xor_shape, launches):
    """bitmap_vm and xor_delta against their plain versions, then timed.
    Each time is the kernel alone, launched through its C entry point on
    preallocated buffers (``Bench.launch_ms``: ``ms`` device time from a
    CUDA graph, ``event_ms`` host-launched, ``cold_ms`` after an L2
    overwrite), so the Python wrapper's own cost (allocation, checks;
    ``wrapper_ms`` in the log) stays out of it.  Warm launches find their
    inputs in L2, as the main path's do: it copies them to the card just
    before each launch."""
    torch, dev = B.torch, B.dev
    kbitmap, kdelta, kref = K.bitmap, K.delta, K.ref

    def rand_prog(S, P):
        prog = torch.empty((P, 4), dtype=torch.int32)
        prog[:, 0] = torch.randint(0, 3, (P,), generator=B.gen)
        prog[:, 1:] = torch.randint(0, S, (P, 3), generator=B.gen)
        return prog.to(dev)

    self_prog = rand_prog(129, 64)
    self_prog[::2, 1] = self_prog[::2, 2]           # dst == lhs
    self_prog[1::4, 1] = self_prog[1::4, 3]         # dst == rhs
    # ---- bitmap_vm: the waves' own programs, then the named shapes; the
    # last is too tall for a shared-memory tile, so the kernel works in out
    cases = list(bitmap_inputs)
    cases += [("random", B.words(256, 4096), rand_prog(256, 128)),
              ("P=0", B.words(256, 4096), rand_prog(256, 0)),
              ("all-zero", torch.zeros((64, 1024), dtype=torch.int32,
                                       device=dev), rand_prog(64, 64)),
              ("dst=lhs", B.words(129, 512), self_prog),
              ("P=1500", B.words(129, 512), rand_prog(129, 1500)),
              ("W=1", B.words(129, 1), rand_prog(129, 64)),
              ("W=33", B.words(129, 33), rand_prog(129, 64)),
              ("W=511", B.words(129, 511), rand_prog(129, 64)),
              ("S=1024 (128 KiB tile)", B.words(1024, 512),
               rand_prog(1024, 256)),
              ("S=4096 (tile in out)", B.words(4096, 64),
               rand_prog(4096, 64))]
    err = 0
    for name, regs, prog in cases:
        o1, c1 = kbitmap.bitmap_vm(regs, prog)
        o2, c2 = kref.bitmap_vm_ref(regs, prog)
        torch.cuda.synchronize()
        e = max(B.err(o1, o2), B.err(c1, c2))
        if e:
            raise AssertionError(f"bitmap_vm {name} {tuple(regs.shape)} "
                                 f"P={prog.shape[0]} disagrees: {e}")
        err = max(err, e)
    rows = []

    def vm_row(regs, prog):
        S, W = regs.shape
        P = prog.shape[0]
        nbytes = 2 * S * W * 4 + P * 16 + S * 4
        nops = P * W + 2 * S * W           # one op per instruction and word,
        #                                    popcount + sum per word
        out = torch.empty_like(regs)
        cnt = torch.zeros(S, dtype=torch.int32, device=dev)
        t = B.launch_ms(B.lib.bitmap_vm_launch, regs.data_ptr(),
                        prog.data_ptr(), out.data_ptr(), cnt.data_ptr(), S, W,
                        P)
        wrapper = cuda_ms(torch, lambda: kbitmap.bitmap_vm(regs, prog))
        plain = cuda_ms(torch, lambda: kref.bitmap_vm_ref(regs, prog), 5)
        bound, by = B.bound(nbytes, nops)
        return dict(S=S, W=W, P=P, **t, wrapper_ms=wrapper, plain_ms=plain,
                    bound_ms=bound, bound_by=by)

    for name, regs, prog in cases:
        r = vm_row(regs, prog)
        log(f"[kernels] bitmap_vm {name} S={r['S']} W={r['W']} P={r['P']}: "
            f"device {r['ms']:.5f} ms (events {r['event_ms']:.5f} ms, cold L2 "
            f"{r['cold_ms']:.5f} ms, wrapper {r['wrapper_ms']:.5f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms by "
            f"{r['bound_by']}, {r['bound_ms'] / r['ms']:.2%} of it), "
            "bit-exact")
        rows.append((name, r))
    main = rows[0][1]                   # the first wave's own program
    rnd = dict(rows)["random"]
    vm = {"name": "bitmap_vm", "route": "cuda",
          "source": "src/repro_torch/kernels/csrc/bitmap_vm.cu",
          "replaces": "src/repro/kernels/bitmap.py:142",
          **path_launches(launches, "bitmap_vm"), "max_abs_err": err,
          "ms": main["ms"], "event_ms": main["event_ms"],
          "cold_ms": main["cold_ms"], "plain_ms": main["plain_ms"],
          "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
          "library_ms": None,
          "shape": [main["S"], main["W"], main["P"]],
          "random_256x4096_P128": {k: rnd[k] for k in (
              "ms", "event_ms", "bound_ms")},
          "ops_wave_0": {k: dict(rows)["ops wave 0"][k] for k in (
              "ms", "event_ms", "cold_ms", "plain_ms", "bound_ms", "S", "W",
              "P")},
          "tr_partial_restore": {k: dict(rows)["tr partial restore 0"][k]
                                 for k in ("ms", "event_ms", "cold_ms",
                                           "plain_ms", "bound_ms", "S", "W",
                                           "P")},
          "sv_restore_1": {k: dict(rows)["sv restore 1"][k]
                           for k in ("ms", "event_ms", "cold_ms", "plain_ms",
                                     "bound_ms", "S", "W", "P")},
          "ex": {name: {k: r[k] for k in ("ms", "event_ms", "cold_ms",
                                          "plain_ms", "bound_ms", "S", "W",
                                          "P")}
                 for name, r in rows if name.startswith("ex ")}}

    # ---- xor_delta: the ragged entry at every launch the k3 path made
    # (its build's and compaction's, and its waves' decode levels), then the
    # (N, W) entry at an odd width, at inputs off 16-byte alignment (4 and
    # 12 bytes: the two inputs aligned differently), at (80957, 64) and
    # (65536, 64) words (256-byte records) and at the tr path's
    # xor_delta_stats launch (the flattened params in rows of 64 KiB)
    err = 0
    for ph, p, c, off in delta_inputs:
        d1, n1 = kdelta.xor_delta_ragged(p, c, off)
        d2, n2 = kref.xor_delta_ragged_ref(p, c, off)
        torch.cuda.synchronize()
        e = max(B.err(d1, d2), B.err(n1, n2))
        if e:
            raise AssertionError(f"xor_delta ragged ({ph}, {off.numel() - 1} "
                                 f"rows, {p.numel()} words) disagrees: {e}")
        err = max(err, e)
    log(f"[kernels] xor_delta ragged: all {len(delta_inputs)} launches of "
        "the k3 and ex paths bit-exact")

    def shifted(N, W, shift):
        return B.words(N * W + shift)[shift:].view(N, W)
    uniform = {"W=63": (shifted(4096, 63, 0), shifted(4096, 63, 0)),
               "unaligned": (shifted(4096, 64, 1), shifted(4096, 64, 3)),
               "80957": (shifted(80957, RECORD // 4, 0),
                         shifted(80957, RECORD // 4, 0)),
               "65536": (shifted(65536, RECORD // 4, 0),
                         shifted(65536, RECORD // 4, 0)),
               "tr xor_delta_stats": (shifted(*tr_xor_shape, 0),
                                      shifted(*tr_xor_shape, 0)),
               "tr shape, unaligned": (shifted(*tr_xor_shape, 1),
                                       shifted(*tr_xor_shape, 3))}
    for name, (p, c) in uniform.items():
        N, W = p.shape
        c[::2] = p[::2] ^ (B.words((N + 1) // 2, W) & 0x0F)
        d1, n1 = kdelta.xor_delta(p, c)
        d2, n2 = kref.xor_delta_ref(p, c)
        torch.cuda.synchronize()
        e = max(B.err(d1, d2), B.err(n1, n2))
        if e:
            raise AssertionError(f"xor_delta {name} ({N}, {W}) disagrees: {e}")
        err = max(err, e)
        log(f"[kernels] xor_delta {name} ({N}, {W}): bit-exact")

    def by_words(ph):
        ins = [x for x in delta_inputs if x[0] == ph]
        return sorted(ins, key=lambda x: (x[1].numel(), x[3].numel()))
    ragged = {"k3 build": by_words("build")[-1],
              "k3 compaction": by_words("compaction")[-1]}
    waves = by_words("wave") + by_words("wave after compaction")
    if waves:
        ragged["k3 decode median"] = waves[len(waves) // 2]
    # every shape of the ex path's launches (its examples' flushes and reads)
    for x in delta_inputs:
        if x[0].startswith("ex "):
            ragged.setdefault(f"{x[0]} ({x[3].numel() - 1}, {x[1].numel()})",
                              x)
    xrows = {}

    def xrow(name, N, rows_words, t, plain, wrapper, half, half_dev, nbytes):
        bound, by = B.bound(nbytes, 2 * rows_words)
        xrows[name] = dict(**t, plain_ms=plain, library_ms=None,
                           xor_half_ms=half_dev, xor_half_event_ms=half,
                           bound_ms=bound, bound_by=by,
                           shape=[N, rows_words])
        log(f"[kernels] xor_delta {name} ({N} rows, {rows_words} words): "
            f"device {t['ms']:.5f} ms (events {t['event_ms']:.5f} ms, cold "
            f"L2 {t['cold_ms']:.5f} ms, wrapper {wrapper:.5f} ms, plain "
            f"{plain:.5f} ms, torch.bitwise_xor alone (the XOR half) device "
            f"{half_dev:.5f} ms, events {half:.5f} ms; bound {bound:.6f} ms "
            f"by {by}, {bound / t['ms']:.2%} of it)")
    for name, (_, p, c, off) in ragged.items():
        n, T = off.numel() - 1, p.numel()
        d, cnt = torch.empty_like(p), torch.empty(n, dtype=torch.int32,
                                                  device=dev)
        t = B.launch_ms(B.lib.xor_delta_ragged_launch, p.data_ptr(),
                        c.data_ptr(), d.data_ptr(), cnt.data_ptr(),
                        off.data_ptr(), n, T)
        xrow(name, n, T, t,
             cuda_ms(torch, lambda: kref.xor_delta_ragged_ref(p, c, off)),
             cuda_ms(torch, lambda: kdelta.xor_delta_ragged(p, c, off)),
             cuda_ms(torch, lambda: torch.bitwise_xor(p, c, out=d), 200),
             B.graph_ms(lambda: torch.bitwise_xor(p, c, out=d)),
             3 * T * 4 + 4 * n + 8 * (n + 1))
    for name in ("80957", "65536", "tr xor_delta_stats",
                 "tr shape, unaligned"):
        p, c = uniform[name]
        N, W = p.shape
        d, n = torch.empty_like(p), torch.empty(N, dtype=torch.int32,
                                                 device=dev)
        t = B.launch_ms(B.lib.xor_delta_launch, p.data_ptr(), c.data_ptr(),
                        d.data_ptr(), n.data_ptr(), N, W)
        xrow(name, N, N * W, t,
             cuda_ms(torch, lambda: kref.xor_delta_ref(p, c)),
             cuda_ms(torch, lambda: kdelta.xor_delta(p, c)),
             cuda_ms(torch, lambda: torch.bitwise_xor(p, c, out=d), 200),
             B.graph_ms(lambda: torch.bitwise_xor(p, c, out=d)),
             3 * N * W * 4 + 4 * N)
        xrows[name]["shape"] = [N, W]
    xd = {"name": "xor_delta", "route": "cuda",
          "source": "src/repro_torch/kernels/csrc/xor_delta.cu",
          "replaces": "src/repro/kernels/deltaenc.py:47",
          **path_launches(launches, "xor_delta"), "max_abs_err": err,
          **xrows["k3 build"],
          "k3_compaction": xrows["k3 compaction"],
          "k3_decode_median": xrows.get("k3 decode median"),
          "n80957": xrows["80957"], "n65536": xrows["65536"],
          "tr_launch": xrows["tr xor_delta_stats"],
          "tr_unaligned": xrows["tr shape, unaligned"],
          "ex": {name: {k: r[k] for k in ("ms", "event_ms", "cold_ms",
                                          "plain_ms", "bound_ms", "shape")}
                 for name, r in xrows.items() if name.startswith("ex ")}}
    return [vm, xd]


def minhash_phase(B: Bench, K, path_inputs, launches):
    """minhash against its plain version, bit-exact: the sh path's own CSR,
    empty rows, R = 0 and R = 1, R not a multiple of the rows a block takes,
    one row of 100,000 entries among rows of degree 0-3, entries whose
    hashes wrap mod 2^32 and mins >= 2^31 (a signed min would pick another
    word), -1 entries, L = 1 and L = 40 (five hash groups of 8, the last one
    full), and long rows at mean degrees from 96 to 1536; then
    timed at the path's shape."""
    torch, dev = B.torch, B.dev
    M32 = 0xFFFFFFFF
    kmh = K.minhash

    def params(a, b):
        def i32(x):
            x = np.asarray(x, dtype=np.uint32).view(np.int32)
            return torch.from_numpy(x.copy()).to(dev)
        return i32(a), i32(b)

    def csr(degrees, lo, hi):
        deg = torch.as_tensor(degrees, dtype=torch.int64)
        ptr = torch.zeros(len(deg) + 1, dtype=torch.int64)
        ptr[1:] = torch.cumsum(deg, 0)
        col = torch.randint(lo, hi, (int(ptr[-1]),), generator=B.gen,
                            dtype=torch.int64).to(torch.int32)
        return ptr.to(dev), col.to(dev)

    fam8 = params(*K.ops.hash_family(8, 0))
    deg = torch.randint(0, 40, (65536,), generator=B.gen)
    skew = torch.randint(0, 4, (65537,), generator=B.gen)
    skew[30001] = 100_000
    p_wrap, c_wrap = csr(torch.full((4096,), 16), 2**30, 2**31 - 1)
    p_pad, c_pad = csr(torch.full((4096,), 8), 0, 64)
    c_pad[::3] = -1
    cases = [("path", *path_inputs),
             ("empty rows", *csr([0, 3, 0, 0, 5, 0], 0, 100), *fam8),
             ("R=0", torch.zeros(1, dtype=torch.int64, device=dev),
              torch.zeros(0, dtype=torch.int32, device=dev), *fam8),
             ("R=1", *csr([23], 0, 2**31 - 1), *fam8),
             ("R=4133 (not a multiple of a block's 256 rows)",
              *csr(torch.full((4133,), 16), 0, 64), *fam8),
             ("skewed: one row of 100,000 among degree 0-3",
              *csr(skew, 0, 2**31 - 1), *fam8),
             ("wrap, mins >= 2^31", p_wrap, c_wrap,
              *params([1, 3, 0x9E3779B1], [2**31 + 5, 2**32 - 100, 2**31])),
             ("-1 entries", p_pad, c_pad, *fam8),
             ("L=1", *csr(deg, 0, 64), *params(*K.ops.hash_family(1, 3))),
             ("L=40", *csr(deg, 0, 64), *params(*K.ops.hash_family(40, 2)))]
    # longer rows, one set with L = 40
    for m in (96, 192, 384, 768, 1536):
        long_rows = csr(torch.randint(0, 2 * m + 1, (2048,), generator=B.gen),
                        0, 2**31 - 1)
        fam = params(*K.ops.hash_family(40, 4)) if m == 384 else fam8
        cases.append((f"mean degree {m}, L={fam[0].numel()}", *long_rows,
                      *fam))
    err = 0
    for name, ptr, col, a, b in cases:
        o1 = kmh.minhash(ptr, col, a, b)
        o2 = K.ref.minhash_csr_ref(ptr, col, a, b)
        torch.cuda.synchronize()
        e = B.err(o1, o2)
        if e:
            raise AssertionError(f"minhash {name} disagrees: {e}")
        if name.startswith("wrap"):
            lane0 = o2[0].to(torch.int64) & M32
            if not bool((lane0 >= 2**31).all()):
                raise AssertionError("minhash wrap case: a = 1 mins < 2^31")
        log(f"[kernels] minhash {name}: R={ptr.numel() - 1} "
            f"nnz={col.numel()} L={a.numel()}, bit-exact")
        err = max(err, e)
    ptr, col, a, b = path_inputs
    R, L, nnz = ptr.numel() - 1, a.numel(), col.numel()
    out = torch.empty((L, R), dtype=torch.int32, device=dev)
    t = B.launch_ms(B.lib.minhash_launch, ptr.data_ptr(), col.data_ptr(),
                    a.data_ptr(), b.data_ptr(), out.data_ptr(), R, L)
    wrapper = cuda_ms(torch, lambda: kmh.minhash(ptr, col, a, b))
    plain = cuda_ms(torch, lambda: K.ref.minhash_csr_ref(ptr, col, a, b), 5)
    bound, by = B.bound(8 * (R + 1) + 4 * nnz + 4 * L * R, 3 * L * nnz)
    log(f"[kernels] minhash path R={R} nnz={nnz} L={L}: device "
        f"{t['ms']:.5f} ms (events "
        f"{t['event_ms']:.5f} ms, cold L2 {t['cold_ms']:.5f} ms, wrapper "
        f"{wrapper:.5f} ms, plain {plain:.4f} ms, bound {bound:.6f} ms by "
        f"{by}, {bound / t['ms']:.2%} of it; no single PyTorch call)")
    return {"name": "minhash", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/minhash.cu",
            "replaces": "src/repro/kernels/minhash.py:59",
            **path_launches(launches, "minhash"), "max_abs_err": err,
            **t, "plain_ms": plain, "bound_ms": bound,
            "bound_by": by, "library_ms": None, "shape": [R, nnz, L]}


def and_popcount_phase(B: Bench, K, path_inputs, launches):
    """and_popcount against its plain version, bit-exact: the sh path's own
    pairwise (candidates_batch) and broadcast (candidates_range) inputs,
    N = 1, (65536, 512) and the odd width (65536, 513) in both modes, and
    (4096, 513) with its inputs 4 and 12 bytes off 16-byte alignment in both
    modes; then timed at the path's two shapes and at (65536, 512) and
    (65536, 513) in both modes."""
    torch, dev = B.torch, B.dev

    def shifted(N, W, shift):
        return B.words(N * W + shift)[shift:].view(N, W)
    cases = [(f"path {call}", bms, row)
             for call, (bms, row) in path_inputs.items()]
    cases += [("N=1", B.words(1, 512), B.words(1, 512)),
              ("pairwise 65536", B.words(65536, 512), B.words(65536, 512)),
              ("broadcast 65536", B.words(65536, 512), B.words(1, 512)),
              ("pairwise 65536x513", B.words(65536, 513),
               B.words(65536, 513)),
              ("broadcast 65536x513", B.words(65536, 513), B.words(1, 513)),
              ("pairwise unaligned", shifted(4096, 513, 1),
               shifted(4096, 513, 3)),
              ("broadcast unaligned", shifted(4096, 513, 1),
               shifted(1, 513, 3))]
    err = 0
    for name, bms, row in cases:
        a1, c1 = K.bitmap.and_popcount(bms, row)
        a2, c2 = K.ref.and_popcount_ref(bms, row)
        torch.cuda.synchronize()
        e = max(B.err(a1, a2), B.err(c1, c2))
        if e:
            raise AssertionError(f"and_popcount {name} disagrees: {e}")
        log(f"[kernels] and_popcount {name} {tuple(bms.shape)} & "
            f"{tuple(row.shape)}: bit-exact")
        err = max(err, e)
    timed = {}
    timed_names = ("path candidates_batch", "path candidates_range",
                   "pairwise 65536", "broadcast 65536", "pairwise 65536x513",
                   "broadcast 65536x513")
    for name, bms, row in (c for c in cases if c[0] in timed_names):
        n, w = bms.shape
        out = torch.empty_like(bms)
        cnt = torch.empty(n, dtype=torch.int32, device=dev)
        stride = w if row.shape[0] == n and n != 1 else 0
        t = B.launch_ms(B.lib.and_popcount_launch, bms.data_ptr(),
                        row.data_ptr(), out.data_ptr(), cnt.data_ptr(),
                        n, w, stride)
        wrapper = cuda_ms(torch, lambda: K.bitmap.and_popcount(bms, row))
        plain = cuda_ms(torch, lambda: K.ref.and_popcount_ref(bms, row))
        half = cuda_ms(torch, lambda: torch.bitwise_and(bms, row, out=out),
                       200)
        half_dev = B.graph_ms(lambda: torch.bitwise_and(bms, row, out=out))
        bound, by = B.bound(4 * (2 * n * w + row.shape[0] * w + n), 3 * n * w)
        timed[name] = dict(**t, plain_ms=plain, library_ms=None,
                           and_half_ms=half_dev, and_half_event_ms=half,
                           bound_ms=bound, bound_by=by,
                           shape=[n, w, int(row.shape[0])])
        log(f"[kernels] and_popcount {name} {tuple(bms.shape)} & "
            f"{tuple(row.shape)}: device {t['ms']:.5f} ms (events "
            f"{t['event_ms']:.5f} ms, cold L2 {t['cold_ms']:.5f} ms, "
            f"wrapper {wrapper:.5f} ms, plain {plain:.5f} ms, "
            f"torch.bitwise_and alone (the AND half) device {half_dev:.5f} "
            f"ms, events {half:.5f} ms; bound {bound:.6f} ms by {by}, "
            f"{bound / t['ms']:.2%} of it)")
    m = timed["path candidates_batch"]
    return {"name": "and_popcount", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/and_popcount.cu",
            "replaces": "src/repro/kernels/bitmap.py:78",
            **path_launches(launches, "and_popcount"), "max_abs_err": err,
            **m, "candidates_range": timed["path candidates_range"],
            "pairwise_65536x512": timed["pairwise 65536"],
            "broadcast_65536x512": timed["broadcast 65536"],
            "pairwise_65536x513": timed["pairwise 65536x513"],
            "broadcast_65536x513": timed["broadcast 65536x513"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--base-log2", type=int, default=17,
                    help="k1's and sh's base records (their chain's depth, "
                    "cut from 2^20 so the whole run fits its time)")
    ap.add_argument("--versions", type=int, default=64)
    ap.add_argument("--k3-base-log2", type=int, default=16)
    ap.add_argument("--k3-versions", type=int, default=32)
    ap.add_argument("--ops-base-log2", type=int, default=19,
                    help="ops's base records (cut from 2^20 so the whole "
                    "run fits its time)")
    ap.add_argument("--ops-versions", type=int, default=64)
    ap.add_argument("--tr-layers", type=int, default=2,
                    help="tr's depth (smollm-360m has 32; cut so the whole "
                    "run fits its time)")
    ap.add_argument("--sv-layers", type=int, default=0,
                    help="sv's served depth (0: granite-moe's registered 24)")
    ap.add_argument("--sv-registry-layers", type=int, default=2,
                    help="the sv registry's depth (granite-moe has 24; cut "
                    "so its two commits fit the run's time)")
    args = ap.parse_args()
    # cuBLAS is deterministic only with a fixed workspace, set before its
    # first call; the tr path's bit-identical resume depends on it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on the card only", file=sys.stderr)
        return 2
    import repro_torch.core as T
    from repro_torch.kernels import _build
    from repro_torch.kernels import bitmap as kbitmap
    from repro_torch.kernels import deltaenc as kdelta
    from repro_torch.kernels import minhash as kminhash
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.serve import engine as eng_mod
    K = SimpleNamespace(ops=kops, ref=kref, bitmap=kbitmap, delta=kdelta,
                        minhash=kminhash)

    t_start = time.perf_counter()
    card = gpu_line()
    log(f"[setup] {card}")
    log(f"[setup] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.library()
    log(f"[setup] kernels built in {_build.BUILD_INFO['seconds']:.2f} s -> "
        f"{os.path.relpath(str(_build.BUILD_INFO['library']), ROOT)}")
    for line in str(_build.BUILD_INFO.get("ptxas", "")).splitlines():
        if "Used" in line or "spill" in line:
            log(f"[setup] ptxas {line.strip()}")

    def free(what: str) -> None:
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[time] {what} done at {time.perf_counter() - t_start:.1f} s; "
            f"torch.cuda.memory_allocated {torch.cuda.memory_allocated()} "
            "bytes")

    launches = {}
    launches["k1"], bitmap_inputs, chain = main_path_k1(
        args, torch, dev, T, eng_mod, K)
    free("k1 (its store and device tables freed)")
    launches["sh"], mh_inputs, ap_inputs = main_path_sh(
        args, torch, dev, T, eng_mod, K, chain)
    del chain
    free("sh")
    launches["k3"], delta_inputs = main_path_k3(args, torch, dev, T, K)
    free("k3")
    launches["ops"], ops_bitmap_inputs = main_path_ops(args, torch, dev, T, K)
    free("ops")
    launches["tr"], tr_bitmap_inputs, tr_xor_shape, tr_ckpt = main_path_tr(
        args, torch, dev, K)
    free("tr")
    launches["sv"], sv_bitmap_inputs = main_path_sv(args, torch, dev, K)
    free("sv")
    launches["sd"] = main_path_sd(args, torch, dev, K, tr_ckpt)
    del tr_ckpt
    free("sd")
    ex_launches, ex_bitmap_inputs, ex_delta_inputs = main_path_ex(torch, K)
    launches.update(ex_launches)
    delta_inputs += ex_delta_inputs
    free("ex")
    bitmap_inputs = ([(f"k1 wave {i}", r, p)
                      for i, (r, p) in enumerate(bitmap_inputs)]
                     + [(f"ops wave {i}", r, p)
                        for i, (r, p) in enumerate(ops_bitmap_inputs)]
                     + [(f"tr partial restore {i}", r, p)
                        for i, (r, p) in enumerate(tr_bitmap_inputs)]
                     + [(f"sv restore {i}", r, p)
                        for i, (r, p) in enumerate(sv_bitmap_inputs)]
                     + [(f"{ex} {i}", r, p)
                        for i, (ex, r, p) in enumerate(ex_bitmap_inputs)])
    B = Bench(torch, dev)
    kernels = vm_and_xor_phases(B, K, bitmap_inputs, delta_inputs,
                                tr_xor_shape, launches)
    kernels.append(minhash_phase(B, K, mh_inputs, launches))
    kernels.append(and_popcount_phase(B, K, ap_inputs, launches))
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all; peak device "
        f"memory {torch.cuda.max_memory_allocated()} bytes; peak host RSS "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss} KiB")
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
