"""Parity gate of the PyTorch port's store against the reference package.

The same seeded commit chain goes through ``repro.core.RStore`` and
``repro_torch.core.RStore(device="cpu")`` in the same write sessions; both
then serve the same mixed query waves.  Stored blobs, query values, per-query
and batch ``QueryStats``, ``KVSStats`` deltas and ``BITMAP_LAUNCHES`` deltas
must be identical, on an in-memory backend and on four device tables behind a
shard router, at ``k=1`` (online flushes) and ``k=3`` (§3.4 sub-chunk
compression through the full build).  The tolerance is exact equality: the
store's outputs are bytes and counts.
"""
import dataclasses
import zlib

import numpy as np
import pytest

import repro.core as R
import repro.kernels.ops as rops
from repro.serve.engine import StoreQueryEngine as RefEngine

import repro_torch.core as T
import repro_torch.kernels.ops as tops
from repro_torch.interop import rstore_from_state
from repro_torch.serve.engine import StoreQueryEngine as PortEngine

N_BASE = 160
N_VERSIONS = 12
RECORD = 48
CAPACITY = 2048


def _workload(seed: int, p_d=None):
    """Sessions of ops: ("root", records) / ("commit", parents, adds, dels).
    A linear chain with one side branch; payloads fully rewritten, or
    changed in one bounded block when ``p_d`` is set."""
    rng = np.random.default_rng(seed)
    state = {pk: rng.integers(0, 256, RECORD, dtype=np.uint8).tobytes()
             for pk in range(N_BASE)}
    states = {0: dict(state)}
    ops = [("root", dict(state))]
    next_pk = N_BASE
    for vid in range(1, N_VERSIONS):
        parent = vid - 1 if vid != 7 else 3          # one branch off v3
        cur = dict(states[parent])
        keys = np.array(sorted(cur))
        sel = rng.choice(keys, size=max(3, len(keys) // 12), replace=False)
        n_mod = int(len(sel) * 0.8)
        adds, dels = {}, []
        for pk in sel[:n_mod]:
            old = bytearray(cur[int(pk)])
            if p_d is None:
                old[:] = rng.integers(0, 256, RECORD, dtype=np.uint8).tobytes()
            else:
                span = max(1, int(RECORD * p_d))
                off = int(rng.integers(0, RECORD - span + 1))
                old[off:off + span] = rng.integers(0, 256, span,
                                                   dtype=np.uint8).tobytes()
            adds[int(pk)] = bytes(old)
        dels = [int(pk) for pk in sel[n_mod:]]
        for _ in range(2):
            adds[next_pk] = rng.integers(0, 256, RECORD,
                                         dtype=np.uint8).tobytes()
            next_pk += 1
        for pk in dels:
            cur.pop(pk)
        cur.update(adds)
        states[vid] = cur
        ops.append(("commit", [parent], adds, dels))
    # three write sessions: root, v1..v5, v6..
    return [ops[:1], ops[1:6], ops[6:]], states


def _drive(rs, sessions):
    for sess in sessions:
        with rs.writer() as w:
            for op in sess:
                if op[0] == "root":
                    w.init_root(op[1])
                else:
                    w.commit(op[1], op[2], op[3])


def _wave(Q, n_versions, seed):
    rng = np.random.default_rng(seed)
    qs = []
    for i in range(3):
        v = int(rng.integers(0, n_versions))
        lo = int(rng.integers(0, N_BASE))
        qs += [
            Q.version(v),
            Q.record(v, int(rng.integers(0, N_BASE + 10))),
            Q.records(v, [int(x) for x in rng.integers(0, N_BASE, 5)]),
            Q.range(v, lo, lo + 25),
            Q.evolution(int(rng.integers(0, N_BASE))),
            Q.or_(Q.record(v, lo + 40), Q.range(v, lo, lo + 9)),
            Q.and_(Q.range(v, lo, lo + 60),
                   Q.records(v, [lo + 1, lo + 3, lo + 70])),
            Q.not_(Q.range(v, 0, lo)),
            Q.count(Q.range(v, lo, lo + 30)),
            Q.exists(Q.record(v, 10_000)),
            Q.and_(Q.record(v, 10_000), Q.range(v, 0, 5)),   # EMPTY fold
        ]
    return qs


def _stats(s):
    return dataclasses.asdict(s)


def _backends(kind):
    if kind == "memory":
        return R.InMemoryKVS(), T.InMemoryKVS()
    return (R.ShardedKVS([R.ShardedDeviceKVS(slot_bytes=256, n_slots=16)
                          for _ in range(4)]),
            T.ShardedKVS([T.ShardedDeviceKVS(slot_bytes=256, n_slots=16,
                                             device="cpu")
                          for _ in range(4)]))


def _kvs_stats(kvs):
    out = [_stats(kvs.stats)]
    if hasattr(kvs, "shards"):
        out += [_stats(s.stats) for s in kvs.shards]
    return out


def _delta(after, before):
    return [{k: a[k] - b[k] for k in a} for a, b in zip(after, before)]


def _assert_same_batch(rb, tb):
    assert _stats(rb.batch) == _stats(tb.batch)
    assert len(rb) == len(tb)
    for r, t in zip(rb, tb):
        assert r.value == t.value, r.query
        assert _stats(r.stats) == _stats(t.stats), r.query


def _build_pair(kind, k, seed):
    p_d = None if k == 1 else 0.1
    sessions, _ = _workload(seed, p_d=p_d)
    rk, tk = _backends(kind)
    ref = R.RStore(R.RStoreConfig(capacity=CAPACITY, k=k), rk)
    port = T.RStore(T.RStoreConfig(capacity=CAPACITY, k=k), tk, device="cpu")
    r0, t0 = _kvs_stats(rk), _kvs_stats(tk)
    _drive(ref, sessions)
    _drive(port, sessions)
    assert _delta(_kvs_stats(rk), r0) == _delta(_kvs_stats(tk), t0)
    return ref, port


@pytest.mark.parametrize("kind", ["memory", "sharded_device"])
@pytest.mark.parametrize("k", [1, 3])
def test_store_parity(kind, k):
    ref, port = _build_pair(kind, k, seed=11 * k)
    assert ref.r2c.tolist() == port.r2c.tolist()
    assert ref.storage_stats() == port.storage_stats()

    for w in range(2):
        rq, tq = _wave(R.Q, N_VERSIONS, w), _wave(T.Q, N_VERSIONS, w)
        r0, t0 = _kvs_stats(ref.kvs), _kvs_stats(port.kvs)
        rl, tl = rops.BITMAP_LAUNCHES, tops.BITMAP_LAUNCHES
        rb = ref.snapshot().execute(rq)
        tb = port.snapshot().execute(tq)
        assert rops.BITMAP_LAUNCHES - rl == tops.BITMAP_LAUNCHES - tl == 1
        _assert_same_batch(rb, tb)
        assert _delta(_kvs_stats(ref.kvs), r0) == _delta(_kvs_stats(port.kvs),
                                                         t0)

    # every stored blob byte-identical (scan last: it counts as traffic)
    assert sorted(ref.kvs.scan()) == sorted(port.kvs.scan())


@pytest.mark.parametrize("k", [1, 3])
def test_answers_match_commit_oracle(k):
    """Independent of the reference: every version read equals the dict
    state the workload generator kept for it."""
    sessions, states = _workload(5, p_d=None if k == 1 else 0.1)
    port = T.RStore(T.RStoreConfig(capacity=CAPACITY, k=k), device="cpu")
    _drive(port, sessions)
    res = port.snapshot().execute([T.Q.version(v) for v in states])
    for (v, want), r in zip(states.items(), res):
        assert r.value == want


def test_query_engine_waves_match():
    ref, port = _build_pair("sharded_device", 1, seed=3)
    re_, te = RefEngine(ref), PortEngine(port)
    for w in range(3):
        rl, tl = rops.BITMAP_LAUNCHES, tops.BITMAP_LAUNCHES
        _assert_same_batch(re_.serve(_wave(R.Q, N_VERSIONS, 10 + w)),
                           te.serve(_wave(T.Q, N_VERSIONS, 10 + w)))
        assert rops.BITMAP_LAUNCHES - rl == tops.BITMAP_LAUNCHES - tl
    assert re_.waves_served == te.waves_served == 3
    assert [e["plan"] for e in re_.explain(_wave(R.Q, N_VERSIONS, 1))] == \
        [e["plan"] for e in te.explain(_wave(T.Q, N_VERSIONS, 1))]


# ------------------------------------------ offline layouts (rs.build())
OFFLINE = ["shingle", "depth_first", "breadth_first"]


def _same_partitioning(rp, tp):
    assert rp.algorithm == tp.algorithm
    assert [(c.chunk_id, c.record_ids.tolist(), c.nbytes) for c in rp.chunks] \
        == [(c.chunk_id, c.record_ids.tolist(), c.nbytes) for c in tp.chunks]
    assert rp.record_to_chunk.tolist() == tp.record_to_chunk.tolist()


def _build_offline_pair(algo, k, seed, kind="sharded_device",
                        flush_on_close=False):
    """Both stores write the workload (staged only, unless
    ``flush_on_close`` flushes each session online), then run one full
    offline ``build()`` with the configured partitioner."""
    sessions, states = _workload(seed, p_d=None if k == 1 else 0.1)
    rk, tk = _backends(kind)
    ref = R.RStore(R.RStoreConfig(algorithm=algo, capacity=CAPACITY, k=k), rk)
    port = T.RStore(T.RStoreConfig(algorithm=algo, capacity=CAPACITY, k=k),
                    tk, device="cpu")
    parts = []
    for rs, kvs in ((ref, rk), (port, tk)):
        for sess in sessions:
            w = rs.writer(flush_on_close=flush_on_close)
            for op in sess:
                if op[0] == "root":
                    w.init_root(op[1])
                else:
                    w.commit(op[1], op[2], op[3])
            w.close()
        assert bool(rs.n_chunks) == flush_on_close
        s0 = _kvs_stats(kvs)
        parts.append((rs.build(), _delta(_kvs_stats(kvs), s0)))
    (rp, rdelta), (tp, tdelta) = parts
    _same_partitioning(rp, tp)
    assert rdelta == tdelta
    return ref, port, states


@pytest.mark.parametrize("algo", OFFLINE)
@pytest.mark.parametrize("k", [1, 3])
def test_offline_layout_parity(algo, k):
    ref, port, states = _build_offline_pair(algo, k, seed=5 + k)
    assert ref.r2c.tolist() == port.r2c.tolist()
    assert ref.storage_stats() == port.storage_stats()
    for w in range(2):
        rq, tq = _wave(R.Q, N_VERSIONS, 20 + w), _wave(T.Q, N_VERSIONS, 20 + w)
        r0, t0 = _kvs_stats(ref.kvs), _kvs_stats(port.kvs)
        rl, tl = rops.BITMAP_LAUNCHES, tops.BITMAP_LAUNCHES
        rb = ref.snapshot().execute(rq)
        tb = port.snapshot().execute(tq)
        assert rops.BITMAP_LAUNCHES - rl == tops.BITMAP_LAUNCHES - tl == 1
        _assert_same_batch(rb, tb)
        assert _delta(_kvs_stats(ref.kvs), r0) == _delta(_kvs_stats(port.kvs),
                                                         t0)
    res = port.snapshot().execute([T.Q.version(v) for v in states])
    assert [r.value for r in res] == list(states.values())
    assert sorted(ref.kvs.scan()) == sorted(port.kvs.scan())


@pytest.mark.parametrize("algo", OFFLINE)
def test_offline_build_after_online_flush_parity(algo):
    """A store that has flushed online is laid out again by ``build()``."""
    ref, port, states = _build_offline_pair(algo, 1, seed=11,
                                            flush_on_close=True)
    assert ref.r2c.tolist() == port.r2c.tolist()
    assert ref.storage_stats() == port.storage_stats()
    rq, tq = _wave(R.Q, N_VERSIONS, 30), _wave(T.Q, N_VERSIONS, 30)
    r0, t0 = _kvs_stats(ref.kvs), _kvs_stats(port.kvs)
    _assert_same_batch(ref.snapshot().execute(rq),
                       port.snapshot().execute(tq))
    assert _delta(_kvs_stats(ref.kvs), r0) == _delta(_kvs_stats(port.kvs), t0)
    res = port.snapshot().execute([T.Q.version(v) for v in states])
    assert [r.value for r in res] == list(states.values())
    assert sorted(ref.kvs.scan()) == sorted(port.kvs.scan())


def _candidate_items(port, rng, n=12):
    vids = port.graph.versions
    return [(int(vids[i % len(vids)]),
             [int(x) for x in rng.integers(0, N_BASE + 30,
                                           int(rng.integers(0, 6)))])
            for i in range(n)]


def _host_candidates(proj, vid, pks):
    """Candidate chunks without bitmaps: the union of the keys' postings
    intersected with the version's chunks."""
    post = [proj.key_chunks[pk] for pk in pks if pk in proj.key_chunks]
    keys = np.unique(np.concatenate(post)) if post else np.empty(0, np.int64)
    return np.intersect1d(keys, proj.version_chunks[vid])


@pytest.mark.parametrize("algo", ["bottom_up", "shingle"])
def test_candidates_api_matches_reference(algo):
    ref, port, _ = _build_offline_pair(algo, 1, seed=9, kind="memory")
    rp, tp = ref.proj, port.proj
    rng = np.random.default_rng(4)
    items = _candidate_items(port, rng)
    r0, t0 = rops.BITMAP_LAUNCHES, tops.BITMAP_LAUNCHES
    rb = rp.candidates_batch(items)
    tb = tp.candidates_batch(items, device="cpu")
    assert rops.BITMAP_LAUNCHES - r0 == tops.BITMAP_LAUNCHES - t0 == 1
    for (vid, pks), r, t in zip(items, rb, tb):
        np.testing.assert_array_equal(t, r)
        np.testing.assert_array_equal(t, _host_candidates(tp, vid, pks))
        np.testing.assert_array_equal(tp.candidates(vid, pks, device="cpu"), r)
    for lo, hi in [(0, 5), (10, 40), (150, 175), (500, 600), (-5, 2)]:
        vid = int(port.graph.versions[lo % len(port.graph.versions)])
        r0, t0 = rops.BITMAP_LAUNCHES, tops.BITMAP_LAUNCHES
        want = rp.candidates_range(vid, lo, hi)
        got = tp.candidates_range(vid, lo, hi, device="cpu")
        assert rops.BITMAP_LAUNCHES - r0 == tops.BITMAP_LAUNCHES - t0 == 1
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, _host_candidates(tp, vid, tp.keys_in_range(lo, hi).tolist()))
    postings = [(int(port.graph.versions[-1]),
                 [None, np.array([0, 2], np.int64), np.empty(0, np.int64)]),
                (0, [None])]
    for r, t in zip(rp.and_version_batch(postings),
                    tp.and_version_batch(postings, device="cpu")):
        np.testing.assert_array_equal(t, r)
    t0 = tops.BITMAP_LAUNCHES
    assert tp.and_version_batch([], device="cpu") == [] == \
        rp.and_version_batch([])
    assert tops.BITMAP_LAUNCHES == t0                 # no launch for nothing


def test_query_processor_matches_reference():
    from repro.core.query import QueryProcessor as RQP
    from repro_torch.core.query import QueryProcessor as TQP
    ref, port, _ = _build_offline_pair("shingle", 1, seed=13, kind="memory")
    rq = RQP(ref.graph, ref.proj, ref.kvs)
    tq = TQP(port.graph, port.proj, port.kvs, device="cpu")
    calls = [("get_version", (3,)), ("get_version", (N_VERSIONS - 1,)),
             ("get_range", (8, 20, 60)), ("get_record", (5, 17)),
             ("get_record", (5, 10_000)), ("get_evolution", (17,)),
             ("get_evolution", (N_BASE + 1,))]
    for name, args in calls:
        rv, rs_ = getattr(rq, name)(*args)
        tv, ts_ = getattr(tq, name)(*args)
        assert rv == tv, name
        assert _stats(rs_) == _stats(ts_), name


@pytest.mark.parametrize("algo", ["shingle", "depth_first"])
def test_interop_carries_offline_layouts(algo):
    ref, _, _ = _build_offline_pair(algo, 1, seed=17, kind="memory")
    port = rstore_from_state(_dump(ref), T.RStoreConfig(
        algorithm=algo, capacity=CAPACITY), device="cpu")
    assert port.storage_stats() == ref.storage_stats()
    _assert_same_batch(ref.snapshot().execute(_wave(R.Q, N_VERSIONS, 6)),
                       port.snapshot().execute(_wave(T.Q, N_VERSIONS, 6)))


def _dump(rs):
    """The reference store's state as plain numpy arrays and bytes."""
    g = rs.graph
    return {
        "cks": g.store.cks, "sizes": g.store.sizes,
        "payloads": [g.store.payload(r) for r in range(len(g.store))],
        "versions": [(v, g.parents[v], g.tree_delta[v].adds,
                      g.tree_delta[v].dels) for v in g.versions],
        "r2c": rs.r2c,
        "chunk_records": dict(rs._chunk_records),
        "items": rs.kvs.scan(),
    }


@pytest.mark.parametrize("k", [1, 3])
def test_interop_store_answers_identically(k):
    ref, _ = _build_pair("memory", k, seed=7)
    port = rstore_from_state(_dump(ref), T.RStoreConfig(capacity=CAPACITY,
                                                        k=k),
                             device="cpu")
    assert port.storage_stats() == ref.storage_stats()
    _assert_same_batch(ref.snapshot().execute(_wave(R.Q, N_VERSIONS, 4)),
                       port.snapshot().execute(_wave(T.Q, N_VERSIONS, 4)))


def test_where_is_refused_at_plan_time():
    _, port = _build_pair("memory", 1, seed=2)
    with pytest.raises(KeyError, match="no secondary index"):
        port.snapshot().execute([T.Q.where(1, "color", 3)])


def test_device_kvs_overwrite_and_delete_reuse_slots():
    kvs = T.ShardedDeviceKVS(slot_bytes=64, n_slots=2, device="cpu")
    ref = R.ShardedDeviceKVS(slot_bytes=64, n_slots=2)
    for store in (kvs, ref):
        store.multiput([("a", b"x" * 200), ("b", b"y" * 10),
                        ("a", b"z" * 70)])          # same key twice: last wins
        store.multiput([("b", b"w" * 130)])         # grows: relocates
        store.multidelete(["a"])
        store.multiput([("c", b"v" * 64)])          # reuses a freed extent
    assert kvs.scan() == ref.scan()
    assert (kvs.free_slots, kvs.high_water_slots) == (ref.free_slots,
                                                      ref.high_water_slots)
    assert _stats(kvs.stats) == _stats(ref.stats)


# ------------------------------------------------- modules under the facade
def _graph_pair(branch, merge, payloads=False, p_d=None, seed=3):
    """The same dataset from each package's own generator (which
    ``test_torch_ops_parity`` holds identical)."""
    spec = dict(n_versions=30, n_base_records=200, branch_prob=branch,
                merge_prob=merge, payloads=payloads, p_d=p_d, record_size=40,
                seed=seed)
    g = R.generate(R.DatasetSpec(**spec))
    t = T.generate(T.DatasetSpec(**spec))
    np.testing.assert_array_equal(g.store.cks, t.store.cks)
    return g, t


@pytest.mark.parametrize("branch,merge", [(0.0, 0.0), (0.2, 0.1)])
def test_graph_partition_and_projections_match_reference(branch, merge):
    from repro.core.index import Projections as RP
    from repro.core.online import partition_batch as r_batch
    from repro.core.partition import BottomUpPartitioner as RB
    from repro_torch.core.index import Projections as TP
    from repro_torch.core.online import partition_batch as t_batch
    from repro_torch.core.partition import BottomUpPartitioner as TB
    g, t = _graph_pair(branch, merge)
    for f in ("record_version_csr", "record_version_index_csr"):
        for a, b in zip(getattr(g, f)(), getattr(t, f)()):
            np.testing.assert_array_equal(a, b)
    rp, tp = RB(beta=8).partition(g, 1024), TB(beta=8).partition(t, 1024)
    assert [c.record_ids.tolist() for c in rp.chunks] == \
        [c.record_ids.tolist() for c in tp.chunks]
    rj, tj = RP.build(g, rp), TP.build(t, tp)
    assert rj.version_chunks.keys() == tj.version_chunks.keys()
    assert all(np.array_equal(rj.version_chunks[v], tj.version_chunks[v])
               for v in rj.version_chunks)
    assert rj.key_chunks.keys() == tj.key_chunks.keys()
    assert all(np.array_equal(rj.key_chunks[k], tj.key_chunks[k])
               for k in rj.key_chunks)
    # online batches of the later versions over the earlier placement
    placed = np.zeros(len(g.store), dtype=bool)
    placed[np.concatenate([g.members(v) for v in g.versions[:10]])] = True
    rb = r_batch(g, g.versions[10:], placed, "bottom_up", 1024, 7)
    tb = t_batch(t, t.versions[10:], placed, "bottom_up", 1024, 7)
    assert rb.record_to_chunk.tolist() == tb.record_to_chunk.tolist()


def test_subchunks_and_compressed_sizes_match_reference():
    from repro.core import subchunk as rs
    from repro_torch.core import subchunk as ts
    g, t = _graph_pair(0.1, 0.0, payloads=True, p_d=0.1, seed=4)
    rg, tg = rs.build_subchunks(g, 3), ts.build_subchunks(t, 3)
    assert [x.tolist() for x in rg] == [x.tolist() for x in tg]
    np.testing.assert_array_equal(rs.compressed_subchunk_sizes(g, rg),
                                  ts.compressed_subchunk_sizes(t, tg, "cpu"))


@pytest.mark.parametrize("retire", [False, True])
@pytest.mark.parametrize("branch,merge", [(0.0, 0.0), (0.2, 0.1)])
def test_all_partitioners_match_reference(branch, merge, retire):
    """Every algorithm of ``ALGORITHMS`` gives the reference's partitioning,
    also over a graph with retired versions (the retention-GC paths)."""
    from repro.core import partition as rpart
    from repro_torch.core import partition as tpart
    assert list(rpart.ALGORITHMS) == list(tpart.ALGORITHMS)
    assert rpart.__all__ == tpart.__all__
    g, t = _graph_pair(branch, merge, seed=6)
    if retire:
        g.retire(g.versions[1:4])
        t.retire(t.versions[1:4])
    for name in rpart.ALGORITHMS:
        kw = {"device": "cpu"} if name == "shingle" else {}
        rp = rpart.ALGORITHMS[name]().partition(g, 1024)
        tp = tpart.ALGORITHMS[name](**kw).partition(t, 1024)
        _same_partitioning(rp, tp)
    db_r, db_t = rpart.DeltaBaseline(), tpart.DeltaBaseline()
    rp, tp = db_r.partition(g, 1024), db_t.partition(t, 1024)
    assert db_r.version_spans(g, rp) == db_t.version_spans(t, tp)
    assert db_r.total_version_span(g, rp) == db_t.total_version_span(t, tp)
    sp_r = rpart.ShinglePartitioner(n_hashes=4, seed=3).partition(g, 1024)
    sp_t = tpart.ShinglePartitioner(n_hashes=4, seed=3,
                                    device="cpu").partition(t, 1024)
    _same_partitioning(sp_r, sp_t)
    assert rpart.total_version_span(g, sp_r) == \
        tpart.total_version_span(t, sp_t)


# ------------------------------------------------- xor_delta calls per build
def _counting_pairs(monkeypatch):
    """Record the pair count of every ``xor_delta_pairs`` call."""
    calls = []
    orig = tops.xor_delta_pairs

    def counting(parents, children, **kw):
        calls.append(len(parents))
        return orig(parents, children, **kw)
    monkeypatch.setattr(tops, "xor_delta_pairs", counting)
    return calls


def test_k3_build_and_compact_xor_every_pair_in_one_call(monkeypatch):
    """At k=3 a build stages every chunk and XORs all of their delta pairs
    in one ``xor_delta_pairs`` call, beside the one call of its sizing pass
    (``compressed_subchunk_sizes``); a compaction (a rebuild at k>1) does
    the same.  The blobs, maps and ``storage_stats()`` stay the
    reference's."""
    sessions, _ = _workload(31, p_d=0.1)
    ref = R.RStore(R.RStoreConfig(capacity=CAPACITY, k=3), R.InMemoryKVS())
    port = T.RStore(T.RStoreConfig(capacity=CAPACITY, k=3), T.InMemoryKVS(),
                    device="cpu")
    for rs in (ref, port):
        for sess in sessions:
            with rs.writer(flush_on_close=False) as w:
                for op in sess:
                    if op[0] == "root":
                        w.init_root(op[1])
                    else:
                        w.commit(op[1], op[2], op[3])
    calls = _counting_pairs(monkeypatch)
    stagings = []
    orig_stage = T.RStore._stage_chunk_writes

    def counting_stage(self, chunks, *a, **kw):
        stagings.append(len(chunks))
        return orig_stage(self, chunks, *a, **kw)
    monkeypatch.setattr(T.RStore, "_stage_chunk_writes", counting_stage)

    ref.build()
    port.build()
    assert len(stagings) == 1 and stagings[0] == port.n_chunks > 1
    assert len(calls) == 2 and min(calls) > 0      # sizing, then staging
    assert ref.storage_stats() == port.storage_stats()
    assert sorted(ref.kvs.scan()) == sorted(port.kvs.scan())

    del calls[:], stagings[:]
    for rs, keep in ((ref, R.keep_last(6)), (port, T.keep_last(6))):
        rs.retain(keep)
    rrep, trep = ref.compact(), port.compact()
    assert trep.mode == rrep.mode == "rebuild"
    assert len(stagings) == 1 and len(calls) == 2
    assert ref.storage_stats() == port.storage_stats()
    assert sorted(ref.kvs.scan()) == sorted(port.kvs.scan())


@pytest.mark.parametrize("grouped", [False, True])
def test_build_chunk_single_chunk_matches_reference(grouped):
    """``build_chunk``, the one-chunk API (its own ``xor_delta_pairs``
    call), gives the reference's chunk and map bytes."""
    from repro.core import chunkstore as rc
    from repro.core import subchunk as rsub
    from repro_torch.core import chunkstore as tc
    g, t = _graph_pair(0.1, 0.0, payloads=True, p_d=0.1, seed=8)
    groups = [grp for grp in rsub.build_subchunks(g, 3) if len(grp) > 1][:12]
    # the groups' records and some records of no group
    rids = np.union1d(np.concatenate(groups), np.arange(20))
    if not grouped:
        groups = None
    args = ({v: i for i, v in enumerate(g.versions)}, g.num_versions)
    rch, rmap = rc.build_chunk(g, rids, 5, *args,
                               g.record_version_index_csr(),
                               subchunk_groups=groups)
    tch, tmap = tc.build_chunk(t, rids, 5, *args,
                               t.record_version_index_csr(),
                               subchunk_groups=groups, device="cpu")
    assert rch.to_bytes() == tch.to_bytes()
    assert (rch.raw_bytes, rch.stored_bytes) == (tch.raw_bytes,
                                                 tch.stored_bytes)
    assert rmap.to_bytes() == tmap.to_bytes()
    assert tch.payloads(device="cpu") == rch.payloads()
    if grouped:
        assert any(p >= 0 for sc in tch.subchunks for p in sc.parent_pos)


# ------------------------------------------- parsed chunks read in place
def _xor(a: bytes, b: bytes) -> bytes:
    w = max(len(a), len(b))
    return bytes(x ^ y for x, y in zip(a.ljust(w, b"\0"), b.ljust(w, b"\0")))


def _hand_chunk(subs, cid=9):
    """The same chunk in both packages from sub-chunks of ``(local id,
    parent position, payload)``: a delta stored at the longer of its and
    its parent's lengths, each sub-chunk zlib'd at level 6."""
    from repro.core import chunkstore as rc
    from repro_torch.core import chunkstore as tc
    rsubs, tsubs = [], []
    for sub in subs:
        ids = tuple(i for i, _, _ in sub)
        ppos = tuple(p for _, p, _ in sub)
        lens = tuple(len(pl) for *_, pl in sub)
        blob = zlib.compress(b"".join(
            pl if p < 0 else _xor(sub[p][2], pl) for _, p, pl in sub), 6)
        rsubs.append(rc.SubChunkBlob(np.array(ids, np.int32),
                                     np.array(ppos, np.int32),
                                     np.array(lens, np.int32), blob))
        tsubs.append(tc.SubChunkBlob(ids, ppos, lens, blob))
    n_rec = sum(map(len, subs))
    cks = np.arange(1000, 1000 + 7 * n_rec, 7, dtype=np.int64)
    raw = sum(len(pl) for sub in subs for *_, pl in sub)
    rch = rc.StoredChunk(chunk_id=cid, cks=cks, subchunks=rsubs, raw_bytes=raw)
    tch = tc.StoredChunk(chunk_id=cid, cks=cks, subchunks=tsubs, raw_bytes=raw)
    rch.stored_bytes = len(rch.to_bytes())
    tch.stored_bytes = len(tch.to_bytes())
    return rch, tch


def _built_chunk(grouped: bool):
    from repro.core import chunkstore as rc
    from repro.core import subchunk as rsub
    from repro_torch.core import chunkstore as tc
    g, t = _graph_pair(0.1, 0.0, payloads=True, p_d=0.1, seed=8)
    groups = [grp for grp in rsub.build_subchunks(g, 3) if len(grp) > 1][:12]
    rids = (np.union1d(np.concatenate(groups), np.arange(20)) if grouped
            else np.arange(40, 300))
    args = ({v: i for i, v in enumerate(g.versions)}, g.num_versions)
    rch, _ = rc.build_chunk(g, rids, 5, *args, g.record_version_index_csr(),
                            subchunk_groups=groups if grouped else None)
    tch, _ = tc.build_chunk(t, rids, 5, *args, t.record_version_index_csr(),
                            subchunk_groups=groups if grouped else None,
                            device="cpu")
    return rch, tch


def _payload(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


PARSED_CHUNKS = {
    "k1_singletons": lambda: _built_chunk(False),
    "k3_groups": lambda: _built_chunk(True),
    # trees of depth 2; parents longer and shorter than their children;
    # two deltas at one level of one sub-chunk
    "depth2_unequal_lengths": lambda: _hand_chunk([
        [(3, -1, _payload(40, 1)), (0, 0, _payload(52, 2)),
         (5, 1, _payload(30, 3)), (7, 0, _payload(40, 4))],
        [(1, -1, _payload(17, 5))],
        [(2, -1, _payload(8, 6)), (4, 0, _payload(8, 7)),
         (6, 1, _payload(21, 8))]]),
    "zero_length_payloads": lambda: _hand_chunk([
        [(0, -1, b"")],
        [(1, -1, b""), (2, 0, _payload(10, 9)), (3, 1, b"")],
        [(4, -1, _payload(5, 10))]]),
    "zero_length_singletons": lambda: _hand_chunk([
        [(i, -1, _payload(i % 3 * 6, i))] for i in (2, 0, 1, 4, 3)]),
    "no_records": lambda: _hand_chunk([]),
}


@pytest.mark.parametrize("case", list(PARSED_CHUNKS))
def test_parsed_chunk_reads_in_place_as_the_reference(case):
    """``StoredChunk.from_bytes`` of the reference's chunk bytes decodes to
    the reference's payloads, sizes and keys, keeps those bytes as its
    encoding, and builds the built chunk's ``subchunks`` when asked."""
    from repro_torch.core import chunkstore as tc
    rch, tch = PARSED_CHUNKS[case]()
    buf = rch.to_bytes()
    assert tch.to_bytes() == buf
    parsed = tc.StoredChunk.from_bytes(buf)
    assert parsed.to_bytes() is buf
    assert parsed.payloads(device="cpu") == rch.payloads()
    assert (parsed.chunk_id, parsed.raw_bytes, parsed.stored_bytes) == \
        (rch.chunk_id, rch.raw_bytes, rch.stored_bytes)
    np.testing.assert_array_equal(parsed.cks, rch.cks)
    assert parsed.cks.dtype == np.int64
    assert parsed.subchunks == tch.subchunks
    # a built chunk decodes through the directory of its own encoding
    assert tch.payloads(device="cpu") == rch.payloads()
    d = parsed.directory()
    assert d.singletons == (case in ("k1_singletons",
                                     "zero_length_singletons", "no_records"))
    if case in ("k3_groups", "depth2_unequal_lengths"):
        # a record whose delta parent is itself a delta: a second level
        assert any(sc.parent_pos[p] >= 0 for sc in tch.subchunks
                   for p in sc.parent_pos if p >= 0)
