"""Parity gate of the port's operational subsystems against the reference.

The same seeded dataset — made by each package's own ``datagen`` and checked
identical first — goes through ``repro.core`` and ``repro_torch.core``
(``device="cpu"``) stores driven alike: secondary indexes and their
``where`` waves, retention and compaction (``k=1`` passes and the ``k=3``
rebuild), the chunk cache, replica groups with seeded faults and their
recovery, and async ingest through the background flusher.  The tolerance is
exact equality of stored blobs (``idx2/`` included), query values,
``QueryStats``/``KVSStats`` (cache hits and simulated seconds included),
``CompactionReport``/``DrainReport``/``RecoveryReport`` fields and
``BITMAP_LAUNCHES`` deltas: the store's outputs are bytes and counts.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as R
import repro.kernels.ops as rops
from repro.launch.mesh import make_sharded_backend as r_backend

import repro_torch.core as T
import repro_torch.kernels.ops as tops
from repro_torch.interop import rstore_from_state
from repro_torch.launch.mesh import make_sharded_backend as t_backend
from repro_torch.serve.ingest_gateway import IngestGateway

N_BASE = 160
N_VERSIONS = 12
CARD = 12                      # attribute cardinality: selective postings
CAPACITY = 2048


def _spec(**kw):
    base = dict(n_versions=N_VERSIONS, n_base_records=N_BASE,
                pct_update=0.1, record_size=48, payloads=True, attr_fields=2,
                attr_cardinality=CARD, seed=5)
    base.update(kw)
    return base


def _stats(s):
    return dataclasses.asdict(s)


def _same_graph(g, t):
    assert g.versions == t.versions
    np.testing.assert_array_equal(g.store.cks, t.store.cks)
    np.testing.assert_array_equal(g.store.sizes, t.store.sizes)
    assert g.store.has_payloads() == t.store.has_payloads()
    if g.store.has_payloads():
        assert ([g.store.payload(r) for r in range(len(g.store))]
                == [t.store.payload(r) for r in range(len(t.store))])
    for v in g.versions:
        assert list(g.parents[v]) == list(t.parents[v])
        np.testing.assert_array_equal(g.tree_delta[v].adds,
                                      t.tree_delta[v].adds)
        np.testing.assert_array_equal(g.tree_delta[v].dels,
                                      t.tree_delta[v].dels)


@pytest.mark.parametrize("kw", [
    {},
    {"branch_prob": 0.3, "merge_prob": 0.2, "seed": 7},
    {"update_dist": "zipf", "size_sigma": 0.5, "seed": 8},
    {"p_d": 0.1, "attr_fields": 0, "seed": 9},
    {"payloads": False, "attr_fields": 0, "n_versions": 30, "seed": 3},
])
def test_datagen_graphs_match_reference(kw):
    g, t = R.generate(R.DatasetSpec(**_spec(**kw))), \
        T.generate(T.DatasetSpec(**_spec(**kw)))
    _same_graph(g, t)
    assert R.dataset_stats(g) == T.dataset_stats(t)


def test_paper_datasets_match_reference():
    assert ({k: dataclasses.asdict(v) for k, v in R.PAPER_DATASETS.items()}
            == {k: dataclasses.asdict(v) for k, v in T.PAPER_DATASETS.items()})
    assert R.PAPER_DATASETS["A2"].label() == T.PAPER_DATASETS["A2"].label()
    assert R.__all__ == T.__all__


# ------------------------------------------------------------ the workload
def _sessions(graph):
    """The dataset as write sessions of ("root", records) / ("commit",
    parents, adds, dels), split into three sessions like a real writer."""
    store = graph.store
    pk = lambda r: int(store.cks[r]) >> 32          # noqa: E731
    ops = []
    for v in graph.versions:
        d = graph.tree_delta[v]
        adds = {pk(r): store.payload(int(r)) for r in d.adds
                if int(store.cks[r]) & 0xFFFFFFFF == v}
        if not graph.parents[v]:
            ops.append(("root", adds))
            continue
        dels = sorted({pk(r) for r in d.dels} - set(adds))
        ops.append(("commit", list(graph.parents[v]), adds, dels))
    return [ops[:1], ops[1:5], ops[5:]]


def _drive(rs, sessions):
    for sess in sessions:
        with rs.writer() as w:
            for op in sess:
                if op[0] == "root":
                    w.init_root(op[1])
                else:
                    w.commit(op[1], op[2], op[3])


def _backends(kind):
    if kind == "memory":
        return (R.ShardedKVS([R.InMemoryKVS() for _ in range(4)]),
                T.ShardedKVS([T.InMemoryKVS() for _ in range(4)]))
    return (R.ShardedKVS([R.ShardedDeviceKVS(slot_bytes=256, n_slots=16)
                          for _ in range(4)]),
            T.ShardedKVS([T.ShardedDeviceKVS(slot_bytes=256, n_slots=16,
                                             device="cpu")
                          for _ in range(4)]))


def _kvs_stats(kvs):
    out = [_stats(kvs.stats)]
    inner = getattr(kvs, "inner", kvs)
    if inner is not kvs:
        out.append(_stats(inner.stats))
    for s in getattr(inner, "shards", ()):
        out.append(_stats(s.stats))
        out += [_stats(r.stats) for r in getattr(s, "replicas", ())]
    return out


def _pair(kind="memory", k=1, batch_size=4, spec=None, wrap=None):
    """A reference and a port store over twin backends, each fed the same
    dataset; ``wrap(backend, package)`` tops the backend (a cache...)."""
    g = R.generate(R.DatasetSpec(**(spec or _spec())))
    t = T.generate(T.DatasetSpec(**(spec or _spec())))
    _same_graph(g, t)
    rk, tk = _backends(kind)
    if wrap is not None:
        rk, tk = wrap(rk, R), wrap(tk, T)
    cfg = dict(capacity=CAPACITY, k=k, batch_size=batch_size)
    ref = R.RStore(R.RStoreConfig(**cfg), rk)
    port = T.RStore(T.RStoreConfig(**cfg), tk, device="cpu")
    _drive(ref, _sessions(g))
    _drive(port, _sessions(t))
    assert _kvs_stats(rk) == _kvs_stats(tk)
    return ref, port


def _assert_same_batch(rb, tb):
    assert _stats(rb.batch) == _stats(tb.batch)
    assert len(rb) == len(tb)
    for r, t in zip(rb, tb):
        assert r.value == t.value, r.query
        assert _stats(r.stats) == _stats(t.stats), r.query


def _where_wave(Q, vids, seed):
    rng = np.random.default_rng(seed)
    qs = []
    for v in vids:
        x, lo = int(rng.integers(0, CARD)), int(rng.integers(0, CARD - 4))
        klo = int(rng.integers(0, N_BASE - 40))
        qs += [Q.where(v, "f0", x),
               Q.where_range(v, "f1", lo, lo + 3),
               Q.and_(Q.where(v, "f0", x), Q.range(v, klo, klo + 40)),
               Q.or_(Q.where(v, "f1", lo), Q.where_range(v, "f0", lo, lo + 1)),
               Q.and_(Q.where_range(v, "f1", lo, lo + 6),
                      Q.not_(Q.where(v, "f0", x))),
               Q.count(Q.where(v, "f0", x)),
               Q.exists(Q.and_(Q.where(v, "f1", lo), Q.range(v, 0, klo))),
               Q.distinct(v, "f1"),
               Q.record(v, klo), Q.range(v, klo, klo + 9),
               Q.evolution(klo)]
    return qs


def _same_wave(ref, port, vids, seed, rsnap=None, tsnap=None, launches=1):
    rq, tq = _where_wave(R.Q, vids, seed), _where_wave(T.Q, vids, seed)
    r0, t0 = _kvs_stats(ref.kvs), _kvs_stats(port.kvs)
    rl, tl = rops.BITMAP_LAUNCHES, tops.BITMAP_LAUNCHES
    rb = (rsnap or ref.snapshot()).execute(rq)
    tb = (tsnap or port.snapshot()).execute(tq)
    assert rops.BITMAP_LAUNCHES - rl == tops.BITMAP_LAUNCHES - tl == launches
    _assert_same_batch(rb, tb)
    d = lambda a, b: [{k: x[k] - y[k] for k in x}  # noqa: E731
                      for x, y in zip(a, b)]
    assert d(_kvs_stats(ref.kvs), r0) == d(_kvs_stats(port.kvs), t0)
    return tb


def _same_store(ref, port):
    assert ref.storage_stats() == port.storage_stats()
    assert ref.r2c.tolist() == port.r2c.tolist()
    assert ref.layout_epoch == port.layout_epoch
    assert sorted(ref.kvs.scan()) == sorted(port.kvs.scan())


def _index_both(ref, port):
    for rs, P in ((ref, R), (port, T)):
        ext = P.datagen_extractor(2)
        rs.create_index("f0", ext)
        rs.create_index("f1", ext, n_buckets=4)


# -------------------------------------------------------- secondary indexes
@pytest.mark.parametrize("kind", ["memory", "sharded_device"])
@pytest.mark.parametrize("k", [1, 3])
def test_secondary_index_parity(kind, k):
    """idx2/ blobs, where/where_range waves (one bitmap_vm launch each),
    and postings kept coherent by later flushes or rebuilds."""
    ref, port = _pair(kind, k)
    r0, t0 = _kvs_stats(ref.kvs), _kvs_stats(port.kvs)
    _index_both(ref, port)
    assert _kvs_stats(ref.kvs) != r0
    assert _kvs_stats(ref.kvs) == _kvs_stats(port.kvs)
    assert sorted(ref.indexes) == sorted(port.indexes) == ["f0", "f1"]
    for a in ("f0", "f1"):
        assert ref.indexes[a].report() == port.indexes[a].report()
    _same_store(ref, port)
    _same_wave(ref, port, [2, 7, N_VERSIONS - 1], seed=1)

    # more commits after the indexes exist: flush (k=1) or rebuild (k=3)
    # must carry the postings along inside their own round trips
    rng = np.random.default_rng(4)
    adds = {int(pk): bytes([int(rng.integers(0, CARD)), 0, 0, 0,
                            int(rng.integers(0, CARD)), 0, 0, 0]) * 6
            for pk in rng.choice(N_BASE, 20, replace=False)}
    last = N_VERSIONS - 1
    for rs in (ref, port):
        with rs.writer() as w:
            w.commit([last], adds, dels=[int(max(adds)) + 1
                                         if int(max(adds)) + 1 < N_BASE
                                         else 0])
    assert _kvs_stats(ref.kvs) == _kvs_stats(port.kvs)
    _same_store(ref, port)
    _same_wave(ref, port, [last, last + 1], seed=2)

    for rs, P in ((ref, R), (port, T)):
        rs.drop_index("f1")
        with pytest.raises(KeyError, match="no secondary index"):
            rs.snapshot().execute([P.Q.where(1, "f1", 0)])
    _same_store(ref, port)


# ---------------------------------------------------- retention, compaction
@pytest.mark.parametrize("kind", ["memory", "sharded_device"])
@pytest.mark.parametrize("k", [1, 3])
def test_retention_and_compaction_parity(kind, k):
    ref, port = _pair(kind, k)
    _index_both(ref, port)
    assert ref.retain(R.keep_last(6)) == port.retain(T.keep_last(6))
    # a flush (k=1) or rebuild (k=3) after retirement: the rewritten chunk
    # maps lose the retired versions' bits
    for rs in (ref, port):
        with rs.writer() as w:
            w.commit([N_VERSIONS - 1], {7: b"\x05\0\0\0\x06\0\0\0" * 6})
    _same_store(ref, port)
    rsnap, tsnap = ref.snapshot(), port.snapshot()
    assert ref.retain(R.keep_last(5)) == port.retain(T.keep_last(5))
    rh, th = R.measure_layout(ref), T.measure_layout(port)
    for f in dataclasses.fields(rh):
        a, b = getattr(rh, f.name), getattr(th, f.name)
        if f.name == "size_histogram":
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        else:
            assert a == b, f.name
    r0, t0 = _kvs_stats(ref.kvs), _kvs_stats(port.kvs)
    rrep, trep = ref.compact(), port.compact()
    assert _stats(rrep) == _stats(trep)
    assert trep.mode == ("pass" if k == 1 else "rebuild")
    assert trep.stored_bytes_after <= trep.stored_bytes_before
    if k == 1:
        assert trep.stored_bytes_after < trep.stored_bytes_before
        # one write and one delete round trip per shard touched, at most
        assert trep.write_round_trips <= 4 and trep.delete_round_trips <= 4
    assert _kvs_stats(ref.kvs) == _kvs_stats(port.kvs)
    assert _kvs_stats(ref.kvs) != r0 and _kvs_stats(port.kvs) != t0
    _same_store(ref, port)
    for a in ("f0", "f1"):
        assert ref.indexes[a].report() == port.indexes[a].report()

    kept = list(range(N_VERSIONS - 4, N_VERSIONS + 1))
    if k == 1:          # compaction preserves content: snapshots re-pin
        rsnap.refresh()
        tsnap.refresh()
        _same_wave(ref, port, kept[::2], seed=3, rsnap=rsnap, tsnap=tsnap)
    else:               # a rebuild hard-invalidates them
        for snap in (rsnap, tsnap):
            with pytest.raises(RuntimeError):
                snap.refresh()
    _same_wave(ref, port, kept, seed=4)
    for rs, P in ((ref, R), (port, T)):
        with pytest.raises(KeyError, match="retired"):
            rs.snapshot().execute([P.Q.version(1)])
    # a second pass finds nothing left to do
    assert _stats(ref.compact()) == _stats(port.compact())


# ------------------------------------------------------------- chunk cache
def _cached(budget):
    return lambda kvs, P: P.CachingKVS(kvs, cache_bytes=budget,
                                       always_admit_bytes=256)


@pytest.mark.parametrize("kind", ["memory", "sharded_device"])
@pytest.mark.parametrize("budget", [1 << 20, 6 << 10])
def test_cache_parity(kind, budget):
    """Hits, evictions, simulated seconds and the warm/prefetch round trips
    follow the reference exactly, with room to spare and under eviction."""
    ref, port = _pair(kind, wrap=_cached(budget))
    assert ref.cache_stats() == port.cache_stats()
    _index_both(ref, port)
    vids = [3, 8, N_VERSIONS - 1]
    for seed in (5, 5, 6):               # cold, warm, another
        tb = _same_wave(ref, port, vids, seed)
        assert ref.cache_stats() == port.cache_stats()
        assert ref.kvs.stats.simulated_seconds() == \
            port.kvs.stats.simulated_seconds()
    if budget == 1 << 20:                # the warm repeat read nothing below
        assert port.cache_stats()["n_cache_hits"] > 0
    rs, ts = ref.snapshot(), port.snapshot()
    for pk in (3, 40, 101):
        assert rs.prefetch_evolution(pk) == ts.prefetch_evolution(pk)
        rb = rs.execute([R.Q.evolution(pk)])
        tb = ts.execute([T.Q.evolution(pk)])
        _assert_same_batch(rb, tb)
        if budget == 1 << 20:
            assert tb.batch.kvs_queries == 0
    assert rs.prefetch([R.Q.version(4)]) == ts.prefetch([T.Q.version(4)])
    ref.retain(R.keep_last(4))
    port.retain(T.keep_last(4))
    assert _stats(ref.compact()) == _stats(port.compact())
    assert ref.cache_stats() == port.cache_stats()
    assert ref.kvs.n_invalidations == port.kvs.n_invalidations
    _same_wave(ref, port, [N_VERSIONS - 2], seed=7)
    assert ref.storage_stats() == port.storage_stats()


# ------------------------------------------------------ replicas and faults
def test_fault_schedule_matches_reference_seed_for_seed():
    def trace(P, seed):
        f = P.FaultInjectingKVS(P.InMemoryKVS(), seed=seed, p_transient=0.2,
                                p_timeout=0.1)
        out = []
        for i in range(300):
            try:
                if i % 3 == 0:
                    f.multiput([(f"k{i}", b"v" * (i % 7))])
                elif i % 3 == 1:
                    f.multiget([f"k{i - 1}"])
                else:
                    f.multidelete([f"k{i - 2}"])
                out.append("ok")
            except KeyError:
                out.append("miss")
            except P.BackendUnavailable as e:
                out.append(type(e).__name__)
        return out, (f.n_transient_injected, f.n_timeouts_injected)
    for seed in (0, 1, 17):
        assert trace(R, seed) == trace(T, seed)
    rp, tp = R.RetryPolicy(seed=3), T.RetryPolicy(seed=3)
    assert [rp.backoff(a) for a in range(8)] == [tp.backoff(a)
                                                 for a in range(8)]


def _replicated(kind, faults):
    def wrap(_, P):
        def table(j):
            inner = (P.InMemoryKVS() if kind == "memory" else
                     P.ShardedDeviceKVS(slot_bytes=256, n_slots=16,
                                        **({"device": "cpu"} if P is T
                                           else {})))
            return P.FaultInjectingKVS(inner, seed=j, **faults)
        return P.ShardedKVS([P.ReplicatedKVS(
            [table(2 * i), table(2 * i + 1)],
            retry=P.RetryPolicy(max_retries=4)) for i in range(2)])
    return wrap


@pytest.mark.parametrize("kind", ["memory", "sharded_device"])
def test_replica_failover_and_recovery_parity(kind):
    faults = dict(p_transient=0.05, p_timeout=0.05)
    ref, port = _pair(kind, wrap=_replicated(kind, faults))
    _index_both(ref, port)
    _same_wave(ref, port, [4, N_VERSIONS - 1], seed=8)
    for rs in (ref, port):                 # one replica of every group dies
        for g in rs.kvs.shards:
            g.replicas[0].kill()
    hops = lambda: [g.stats.n_failovers for g in port.kvs.shards]  # noqa
    h0 = hops()
    _same_wave(ref, port, [5, 9], seed=9)          # failover hops
    h1 = hops()
    assert all(0 < b - a <= 1 for a, b in zip(h0, h1))
    _same_wave(ref, port, [6, 10], seed=10)        # then none
    assert hops() == h1
    assert [_stats(g.stats) for g in ref.kvs.shards] == \
        [_stats(g.stats) for g in port.kvs.shards]
    # a flush while a replica is down lands in the repair logs
    for rs in (ref, port):
        with rs.writer() as w:
            w.commit([N_VERSIONS - 1], {5: b"\x01\0\0\0\x02\0\0\0" * 6})
    assert [[g.pending_repairs(i) for i in range(2)]
            for g in ref.kvs.shards] == \
        [[g.pending_repairs(i) for i in range(2)] for g in port.kvs.shards]
    for rs in (ref, port):
        for g in rs.kvs.shards:
            g.replicas[0].revive()
    rrep = R.RecoveryManager(ref.kvs).recover_all()
    trep = T.RecoveryManager(port.kvs).recover_all()
    assert [_stats(r) for r in rrep] == [_stats(r) for r in trep]
    assert all(r.round_trips <= 4 for r in trep)
    _same_store(ref, port)
    for rg, tg in zip(ref.kvs.shards, port.kvs.shards):
        assert rg.live == tg.live == (True, True)
        assert [(f.n_transient_injected, f.n_timeouts_injected,
                 f.n_down_rejections) for f in rg.replicas] == \
            [(f.n_transient_injected, f.n_timeouts_injected,
              f.n_down_rejections) for f in tg.replicas]
        assert sorted(rg.replicas[0].inner.scan()) == \
            sorted(tg.replicas[0].inner.scan())
    _same_wave(ref, port, [N_VERSIONS], seed=11)


def test_make_sharded_backend_parity():
    kw = dict(n_shards=2, slot_bytes=256, n_slots=16, replication_factor=2,
              cache_bytes=1 << 20, cache_kw={"always_admit_bytes": 256})
    ref, port = _pair(wrap=lambda _, P: (r_backend(**kw) if P is R else
                                         t_backend(devices=["cpu"], **kw)))
    assert [type(g).__name__ for g in ref.kvs.inner.shards] == \
        [type(g).__name__ for g in port.kvs.inner.shards]
    assert all(r.device.type == "cpu" for g in port.kvs.inner.shards
               for r in g.replicas)
    _index_both(ref, port)
    _same_wave(ref, port, [0, N_VERSIONS - 1], seed=12)
    assert ref.cache_stats() == port.cache_stats()


# ------------------------------------------------------------- async ingest
def _gateway_drive(rs, graph, gw_kw):
    """Four clients commit the dataset in turn through one gateway."""
    gw = IngestGateway(rs, **gw_kw) if isinstance(rs, T.RStore) else None
    if gw is None:
        from repro.serve.ingest_gateway import IngestGateway as RG
        gw = RG(rs, **gw_kw)
    reports = []
    for i, sess in enumerate(_sessions(graph)):
        for j, op in enumerate(sess):
            client = f"c{(i + j) % 4}"
            if op[0] == "root":
                gw.init_root(client, op[1])
            else:
                gw.commit(client, op[1], op[2], op[3])
            if j % 3 == 2:
                gw.close_session(client)
                rs.flusher.tick()
    reports.append(gw.report())
    reports.append(_stats(gw.barrier()))
    return gw, reports


@pytest.mark.parametrize("gw_kw", [{}, {"max_staged_versions": 3},
                                   {"max_staged_age": 2,
                                    "max_staged_versions": 100}])
def test_async_ingest_parity(gw_kw):
    g = R.generate(R.DatasetSpec(**_spec()))
    t = T.generate(T.DatasetSpec(**_spec()))
    rk, tk = _backends("memory")
    ref = R.RStore(R.RStoreConfig(capacity=CAPACITY, batch_size=10**9), rk)
    port = T.RStore(T.RStoreConfig(capacity=CAPACITY, batch_size=10**9), tk,
                    device="cpu")
    rgw, rrep = _gateway_drive(ref, g, gw_kw)
    tgw, trep = _gateway_drive(port, t, gw_kw)
    assert rrep == trep
    assert ref.storage_stats() == port.storage_stats()
    assert _kvs_stats(rk) == _kvs_stats(tk)
    _index_both(ref, port)
    _same_wave(ref, port, [3, N_VERSIONS - 1], seed=13)
    # a failed drain keeps its writes for the replay of the next one
    for rs in (ref, port):
        with rs.writer() as w:
            w.commit([N_VERSIONS - 1], {9: b"\x03\0\0\0\x04\0\0\0" * 6})
    rsh, tsh = rk.shards[0], tk.shards[0]
    ref.kvs.shards[0] = R.FaultInjectingKVS(rsh)
    port.kvs.shards[0] = T.FaultInjectingKVS(tsh)
    for rs, P in ((ref, R), (port, T)):
        rs.kvs.shards[0].kill()
        with pytest.raises(P.BackendUnavailable):
            rs.barrier()
        assert rs.flusher.has_unacked_writes
        rs.kvs.shards[0].revive()
    assert _stats(ref.barrier()) == _stats(port.barrier())
    assert ref.storage_stats() == port.storage_stats()
    rgw.close()
    tgw.close()
    assert ref.flusher is None and port.flusher is None
    _same_store(ref, port)


# ------------------------------------------------------------------ interop
def _dump(rs):
    g = rs.graph
    return {
        "cks": g.store.cks, "sizes": g.store.sizes,
        "payloads": [g.store.payload(r) for r in range(len(g.store))],
        "versions": [(v, g.parents[v], g.tree_delta[v].adds,
                      g.tree_delta[v].dels) for v in g.versions],
        "r2c": rs.r2c,
        "chunk_records": dict(rs._chunk_records),
        "items": rs.kvs.scan(),
        "retired": [v for v in g.versions if g.is_retired(v)],
        "layout_epoch": rs.layout_epoch,
        "indexes": {a: idx.n_buckets for a, idx in rs.indexes.items()},
    }


def test_interop_carries_retention_compaction_and_indexes():
    ref, _ = _pair("memory")
    ref.retain(R.keep_last(6))
    ref.compact()
    ref.create_index("f0", R.datagen_extractor(2))
    ref.create_index("f1", R.datagen_extractor(2), n_buckets=4)
    state = _dump(ref)
    with pytest.raises(KeyError, match="no extractor"):
        rstore_from_state(state, T.RStoreConfig(capacity=CAPACITY),
                          device="cpu")
    ext = T.datagen_extractor(2)
    port = rstore_from_state(state, T.RStoreConfig(capacity=CAPACITY),
                             _backends("memory")[1], device="cpu",
                             extractors={"f0": ext, "f1": ext})
    assert port.layout_epoch == ref.layout_epoch == 1
    assert ref.storage_stats() == port.storage_stats()
    for a in ("f0", "f1"):
        assert ref.indexes[a].report() == port.indexes[a].report()
    _same_wave(ref, port, list(range(N_VERSIONS - 6, N_VERSIONS)), seed=14)
    with pytest.raises(KeyError, match="retired"):
        port.snapshot().execute([T.Q.version(0)])
