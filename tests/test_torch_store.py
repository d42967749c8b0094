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
    from repro.core import datagen
    g = datagen.generate(datagen.DatasetSpec(
        n_versions=30, n_base_records=200, branch_prob=branch,
        merge_prob=merge, payloads=payloads, p_d=p_d, record_size=40,
        seed=seed))
    t = T.VersionGraph()
    t.store.add_batch(g.store.cks, g.store.sizes,
                      [g.store.payload(r) for r in range(len(g.store))]
                      if payloads else None)
    for v in g.versions:
        if not g.parents[v]:
            t.add_root(v, g.tree_delta[v].adds)
        else:
            t.add_version(v, list(g.parents[v]), g.tree_delta[v].adds,
                          g.tree_delta[v].dels)
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
