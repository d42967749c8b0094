#!/usr/bin/env python3
"""Drive the PyTorch port of RStore on one NVIDIA H100.

    python3 chip_smoke.py [--seed N] [--base-log2 20] [--versions 64]

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``,
then:

1. k=1 main path: the default ``RStoreConfig()`` over a ``ShardedKVS`` of four
   ``ShardedDeviceKVS`` tables on the card.  A seeded A-family chain (2^20
   base records of 256 bytes, 64 versions, 5% of live records touched per
   version, 90/5/5 modify/insert/delete) goes in through ``rs.writer()``
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
   checked 64-query wave.
4. Kernel phases: each kernel against its plain PyTorch version on the card,
   bit-exact, at the shapes the main paths gave it and at the shapes named
   below, with device times (a CUDA graph of 200 launches) and host-launched
   CUDA-event times beside the bound.

Each kernel wrapper counts its own launches; all four counts are zeroed
just before each main path and read just after it.  Every phase raises on
failure.  The last line is ``{"ok": true, "device": {...}}``; the line before
it the card's name and power limit; the one before that the per-kernel JSON.
Exits non-zero, printing no result, when no card is visible.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
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
    both recorded while the chain is generated, before any ingest."""

    def __init__(self, seed: int, n_base: int, n_versions: int,
                 pct: float = 0.05, p_d=None) -> None:
        rng = np.random.default_rng(seed)
        self.rng = rng
        self.n_versions = n_versions
        self.targets = sorted(set(int(v) for v in rng.choice(
            np.arange(n_versions // 2, n_versions), size=4, replace=False)))
        self.track = [int(k) for k in rng.choice(n_base, 32, replace=False)]
        self.pct, self.p_d = pct, p_d
        self.n_base = n_base
        self.versions: Dict[int, Dict[int, bytes]] = {}
        self.history: Dict[int, List[Tuple[int, bytes]]] = {
            k: [] for k in self.track}
        self.ops: List[Tuple] = []           # ("root", recs) | ("commit", ...)
        self.n_records = 0
        self._generate()

    def _fresh(self, n: int) -> List[bytes]:
        blob = self.rng.integers(0, 256, size=n * RECORD,
                                 dtype=np.uint8).tobytes()
        return [blob[i * RECORD:(i + 1) * RECORD] for i in range(n)]

    def _mutated(self, parents: List[bytes]) -> List[bytes]:
        if self.p_d is None:
            return self._fresh(len(parents))
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
        state = dict(zip(range(self.n_base), self._fresh(self.n_base)))
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
            adds = dict(zip(mod, self._mutated([state[k] for k in mod])))
            adds.update(zip(new, self._fresh(n_ins)))
            for k in dels:
                del state[k]
            state.update(adds)
            keys = np.concatenate([keys[~np.isin(keys, dels)],
                                   np.asarray(new, dtype=np.int64)])
            self.ops.append(("commit", [vid - 1], adds, dels))
            self._note(vid, adds)
            self.n_records += len(adds)
            if vid in self.targets:
                self.versions[vid] = dict(state)
        self.max_key = next_key

    # ------------------------------------------------------------ queries
    def wave(self, Q, vid: int, seed: int):
        """64 queries at version ``vid``: 1 version, 24 record, 8 records of
        16 keys, 16 ranges of 256 keys, 7 evolution, 4 or_(record, range),
        4 and_(range, records) — each with its oracle answer."""
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
            qs.append((Q.evolution(k), self.history[k]))
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
    every device-side event (kernels and copies) over the host-clock span."""
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
    top = "; ".join(f"{k} {us / 1e3:.3f} ms" for k, us in sorted(
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
    chain = Chain(args.seed + 1, 1 << args.k3_base_log2, args.k3_versions,
                  p_d=0.1)
    log(f"[k3] chain: {1 << args.k3_base_log2} base records, "
        f"{args.k3_versions} versions, {chain.n_records} stored records, "
        f"p_d 0.1, targets {chain.targets}")
    kvs = T.ShardedKVS([T.ShardedDeviceKVS(slot_bytes=SLOT_BYTES, device=dev)
                        for _ in range(4)])
    rs = T.RStore(T.RStoreConfig(k=3), kvs, device=dev)
    kdelta = K.delta
    delta_inputs = []
    orig = kdelta.xor_delta

    def recording_delta(p, c):
        delta_inputs.append(tuple(p.shape))
        return orig(p, c)
    kdelta.xor_delta = recording_delta
    try:
        t0 = time.perf_counter()
        ingest(rs, chain, flush_on_close=False)
        stage_s = time.perf_counter() - t0
        zero_launches(K)
        delta_inputs.clear()
        t0 = time.perf_counter()
        rs.build()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        build_launches = kdelta.LAUNCHES
        vid = chain.targets[-1]
        qs, wants = chain.wave(T.Q, vid, args.seed * 100 + 99)
        t0 = time.perf_counter()
        batch = rs.snapshot().execute(qs)
        torch.cuda.synchronize()
        wave_s = time.perf_counter() - t0
        launches = read_launches(K)
    finally:
        kdelta.xor_delta = orig
    check_wave(batch, wants, "k3 wave")
    st = rs.storage_stats()
    log(f"[k3] staging {stage_s:.3f} s, build {build_s:.3f} s "
        f"({build_launches} xor_delta launches), wave {wave_s:.4f} s "
        f"({batch.batch.kvs_queries} read round trips, "
        f"{batch.batch.bytes_fetched} bytes gathered); stored chunk bytes "
        f"{st['stored_chunk_bytes']} vs raw unique {st['raw_unique_bytes']}")
    if launches["xor_delta"] <= 0:
        raise AssertionError("the k=3 path launched no xor_delta kernel")
    if st["stored_chunk_bytes"] >= st["raw_unique_bytes"]:
        raise AssertionError("sub-chunk compression stored no fewer bytes")
    by_size = sorted(delta_inputs, key=lambda s: (s[0] * s[1], s))
    log(f"[k3] launches during build + wave: {json.dumps(launches)}; "
        f"xor_delta input shapes: largest {by_size[-1]}, median "
        f"{by_size[len(by_size) // 2]}, smallest {by_size[0]}, "
        f"{sum(s[0] for s in delta_inputs)} pairs in all")
    log("[k3] every answer equals the dict oracle")
    return launches, delta_inputs


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


def vm_and_xor_phases(B: Bench, K, bitmap_inputs, delta_shapes, launches):
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
    cases = [("wave", r, p) for r, p in bitmap_inputs]
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
          "launches": launches["k1"]["bitmap_vm"], "max_abs_err": err,
          "ms": main["ms"], "event_ms": main["event_ms"],
          "cold_ms": main["cold_ms"], "plain_ms": main["plain_ms"],
          "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
          "library_ms": None,
          "shape": [main["S"], main["W"], main["P"]],
          "random_256x4096_P128": {k: rnd[k] for k in (
              "ms", "event_ms", "bound_ms")}}

    # ---- xor_delta: the kernel's scalar branch (a width that is not a
    # multiple of 4 words; inputs 4 bytes off 16-byte alignment), then the
    # vector branch at the k3 path's largest and median launch shapes and at
    # (65536, 64) words = 256-byte records
    err = 0
    N, W = 4096, RECORD // 4
    flat_p, flat_c = B.words(N * W + 1), B.words(N * W + 1)
    for name, p, c in (
            ("W=63", B.words(N, W - 1), B.words(N, W - 1)),
            ("unaligned", flat_p[1:].view(N, W), flat_c[1:].view(N, W))):
        c[::2] = p[::2]
        d1, n1 = kdelta.xor_delta(p, c)
        d2, n2 = kref.xor_delta_ref(p, c)
        torch.cuda.synchronize()
        e = max(B.err(d1, d2), B.err(n1, n2))
        if e:
            raise AssertionError(f"xor_delta scalar branch {name} "
                                 f"{tuple(p.shape)} disagrees: {e}")
        log(f"[kernels] xor_delta scalar branch {name} {tuple(p.shape)}: "
            "bit-exact")
    by_size = sorted(delta_shapes, key=lambda s: (s[0] * s[1], s))
    shapes = {"path largest": by_size[-1],
              "path median": by_size[len(by_size) // 2],
              "65536": (65536, RECORD // 4)}
    xrows = {}
    for name, (N, W) in shapes.items():
        p, c = B.words(N, W), B.words(N, W)
        c[::2] = p[::2] ^ (B.words((N + 1) // 2, W) & 0x0F)
        d1, n1 = kdelta.xor_delta(p, c)
        d2, n2 = kref.xor_delta_ref(p, c)
        torch.cuda.synchronize()
        e = max(B.err(d1, d2), B.err(n1, n2))
        if e:
            raise AssertionError(f"xor_delta {name} ({N}, {W}) disagrees: {e}")
        d, n = torch.empty_like(p), torch.empty(N, dtype=torch.int32,
                                                 device=dev)
        vec = int(W % 4 == 0)
        t = B.launch_ms(B.lib.xor_delta_launch, p.data_ptr(), c.data_ptr(),
                        d.data_ptr(), n.data_ptr(), N, W, vec)
        wrapper = cuda_ms(torch, lambda: kdelta.xor_delta(p, c))
        plain = cuda_ms(torch, lambda: kref.xor_delta_ref(p, c))
        half = cuda_ms(torch, lambda: torch.bitwise_xor(p, c, out=d), 200)
        half_dev = B.graph_ms(lambda: torch.bitwise_xor(p, c, out=d))
        bound, by = B.bound(3 * N * W * 4 + 4 * N, 2 * N * W)
        xrows[name] = dict(**t, plain_ms=plain, library_ms=None,
                           xor_half_ms=half_dev, xor_half_event_ms=half,
                           bound_ms=bound, bound_by=by, shape=[N, W])
        log(f"[kernels] xor_delta {name} ({N}, {W}): device {t['ms']:.5f} ms "
            f"(events {t['event_ms']:.5f} ms, cold L2 {t['cold_ms']:.5f} ms, "
            f"wrapper {wrapper:.5f} ms, plain {plain:.5f} ms, "
            f"torch.bitwise_xor alone (the XOR half) device {half_dev:.5f} "
            f"ms, events {half:.5f} ms; bound {bound:.6f} ms by {by}, "
            f"{bound / t['ms']:.2%} of it), bit-exact")
        err = max(err, e)
    x = xrows["path median"]
    xd = {"name": "xor_delta", "route": "cuda",
          "source": "src/repro_torch/kernels/csrc/xor_delta.cu",
          "replaces": "src/repro/kernels/deltaenc.py:47",
          "launches": launches["k3"]["xor_delta"], "max_abs_err": err,
          **x, "path_largest": xrows["path largest"],
          "n65536": xrows["65536"]}
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
            "launches": launches["sh"]["minhash"], "max_abs_err": err,
            **t, "plain_ms": plain, "bound_ms": bound,
            "bound_by": by, "library_ms": None, "shape": [R, nnz, L]}


def and_popcount_phase(B: Bench, K, path_inputs, launches):
    """and_popcount against its plain version, bit-exact: the sh path's own
    pairwise (candidates_batch) and broadcast (candidates_range) inputs, N = 1, (65536, 512) pairwise and
    broadcast, and the scalar branch (W = 511; inputs 4 bytes off 16-byte
    alignment); then timed at the path's pairwise shape and at
    (65536, 512)."""
    torch, dev = B.torch, B.dev
    N, W = 4096, 512
    flat_b, flat_r = B.words(N * W + 1), B.words(N * W + 1)
    cases = [(f"path {call}", bms, row)
             for call, (bms, row) in path_inputs.items()]
    cases += [("N=1", B.words(1, 512), B.words(1, 512)),
              ("pairwise 65536", B.words(65536, 512), B.words(65536, 512)),
              ("broadcast 65536", B.words(65536, 512), B.words(1, 512)),
              ("W=511", B.words(N, W - 1), B.words(N, W - 1)),
              ("unaligned", flat_b[1:].view(N, W), flat_r[1:].view(N, W))]
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
                   "pairwise 65536", "broadcast 65536")
    for name, bms, row in (c for c in cases if c[0] in timed_names):
        n, w = bms.shape
        out = torch.empty_like(bms)
        cnt = torch.empty(n, dtype=torch.int32, device=dev)
        stride = w if row.shape[0] == n and n != 1 else 0
        t = B.launch_ms(B.lib.and_popcount_launch, bms.data_ptr(),
                        row.data_ptr(), out.data_ptr(), cnt.data_ptr(),
                        n, w, stride, int(w % 4 == 0))
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
            "launches": launches["sh"]["and_popcount"], "max_abs_err": err,
            **m}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--base-log2", type=int, default=20)
    ap.add_argument("--versions", type=int, default=64)
    ap.add_argument("--k3-base-log2", type=int, default=16)
    ap.add_argument("--k3-versions", type=int, default=32)
    args = ap.parse_args()

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
    launches["k3"], delta_shapes = main_path_k3(args, torch, dev, T, K)
    free("k3")
    B = Bench(torch, dev)
    kernels = vm_and_xor_phases(B, K, bitmap_inputs, delta_shapes, launches)
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
