"""Background compaction & retention GC: retention policies must prune
versions loudly, a compaction pass must cost one multiput + one multidelete
round trip per touched shard while keeping every retained version
byte-identical, deletes must reclaim device slots and storage stats, and
stale snapshots must re-pin via refresh() rather than die."""
import numpy as np
import pytest

from repro_torch.core import (Compactor, InMemoryKVS, Q, RStore, RStoreConfig,
                              ShardedDeviceKVS, ShardedKVS, keep_all,
                              keep_last, keep_tagged, measure_layout)


def _pay(rng, n=100):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _churn(rs, rng, n_versions=48, n_keys=24):
    """Root + a chain of single-key updates: the degradation workload (§4
    online appends, most record copies eventually superseded)."""
    v = rs.init_root({k: _pay(rng) for k in range(n_keys)})
    vids = [v]
    for _ in range(n_versions - 1):
        v = rs.commit([v], adds={int(rng.integers(0, n_keys)): _pay(rng)})
        vids.append(v)
    rs.flush()
    return vids


def _kvs_keys(kvs):
    if isinstance(kvs, ShardedKVS):
        out = set()
        for s in kvs.shards:
            out |= set(s._d)
        return out
    return set(kvs._d)


# ------------------------------------------------------------------ retention
def test_retention_policies_resolve():
    rng = np.random.default_rng(0)
    rs = RStore(RStoreConfig(capacity=2048, batch_size=8), device="cpu")
    vids = _churn(rs, rng, n_versions=10)
    assert keep_all().resolve(rs.graph) == vids
    assert keep_last(3).resolve(rs.graph) == vids[-3:]
    assert keep_tagged([vids[0], vids[5]]).resolve(rs.graph) == [vids[0], vids[5]]
    with pytest.raises(ValueError, match="k >= 1"):
        keep_last(0).resolve(rs.graph)
    with pytest.raises(ValueError, match="at least one"):
        keep_tagged([]).resolve(rs.graph)
    with pytest.raises(ValueError, match="unknown or already-retired"):
        keep_tagged([999]).resolve(rs.graph)


def test_retired_versions_fail_loudly():
    rng = np.random.default_rng(1)
    rs = RStore(RStoreConfig(capacity=2048, batch_size=8), device="cpu")
    vids = _churn(rs, rng, n_versions=8)
    retired = rs.retain(keep_last(3))
    assert retired == vids[:-3]
    # queries against a retired version raise at plan time
    with pytest.raises(KeyError, match="retired"):
        rs.get_version(vids[0])
    with pytest.raises(KeyError, match="retired"):
        rs.get_record(vids[0], 0)
    # committing onto a retired parent raises
    with pytest.raises(ValueError, match="retired"):
        rs.commit([vids[0]], adds={99: _pay(rng)})
    # retained versions unaffected; retirement is idempotent
    assert len(rs.get_version(vids[-1])[0]) > 0
    assert rs.retain(keep_last(3)) == []
    rs.graph.check_invariants()


def test_retain_keep_tagged_of_retired_raises():
    rng = np.random.default_rng(2)
    rs = RStore(RStoreConfig(capacity=2048, batch_size=8), device="cpu")
    vids = _churn(rs, rng, n_versions=6)
    rs.retain(keep_last(2))
    with pytest.raises(ValueError, match="already-retired"):
        rs.retain(keep_tagged([vids[0]]))


# ------------------------------------------------------------ compaction pass
def test_compaction_reclaims_and_preserves_content():
    rng = np.random.default_rng(3)
    kvs = InMemoryKVS()
    rs = RStore(RStoreConfig(capacity=2048, batch_size=8), kvs=kvs,
                device="cpu")
    vids = _churn(rs, rng, n_versions=48)
    keep = vids[-8:]
    oracle = {v: rs.get_version(v)[0] for v in keep}
    before = rs.storage_stats()["stored_chunk_bytes"]

    rs.retain(keep_last(8))
    rep = rs.compact()
    assert rep.mode == "pass" and rep.chunks_deleted > 0
    after = rs.storage_stats()["stored_chunk_bytes"]
    assert after < before
    assert rep.stored_bytes_after == after == kvs.total_stored_bytes() - sum(
        len(kvs._d[f"map/{c}"]) for c in rs._chunk_records)
    # retained versions byte-identical through the rewritten layout
    for v in keep:
        assert rs.get_version(v)[0] == oracle[v]
    # the KVS holds exactly the indexed keys — nothing orphaned, nothing lost
    want = {k for c in rs._chunk_records for k in (f"chunk/{c}", f"map/{c}")}
    assert _kvs_keys(kvs) == want
    rs.graph.check_invariants()


def test_compaction_round_trips_one_per_touched_shard():
    """The ci.sh gate contract: a pass = one multiput round trip per shard
    its writes touch + one multidelete round trip per shard its deletes
    touch, however many chunks move."""
    rng = np.random.default_rng(4)
    kvs = ShardedKVS([InMemoryKVS() for _ in range(4)])
    rs = RStore(RStoreConfig(capacity=2048, batch_size=8), kvs=kvs,
                device="cpu")
    _churn(rs, rng, n_versions=48)
    rs.retain(keep_last(8))

    puts0 = [s.stats.n_put_queries for s in kvs.shards]
    dels0 = [s.stats.n_delete_queries for s in kvs.shards]
    rep = rs.compact()
    assert rep.mode == "pass"
    dput = [s.stats.n_put_queries - p for s, p in zip(kvs.shards, puts0)]
    ddel = [s.stats.n_delete_queries - d for s, d in zip(kvs.shards, dels0)]
    assert all(d <= 1 for d in dput) and all(d <= 1 for d in ddel)
    assert rep.write_round_trips == sum(dput) >= 1
    assert rep.delete_round_trips == sum(ddel) >= 1


def test_compaction_noop_costs_zero_round_trips():
    rng = np.random.default_rng(5)
    kvs = InMemoryKVS()
    # big capacity → one well-packed chunk; no retention → nothing to do
    rs = RStore(RStoreConfig(capacity=1 << 20, batch_size=8), kvs=kvs,
                device="cpu")
    _churn(rs, rng, n_versions=8)
    s0 = kvs.stats.snapshot()
    rep = rs.compact()
    assert rep.mode == "noop"
    assert kvs.stats.n_put_queries == s0.n_put_queries
    assert kvs.stats.n_delete_queries == s0.n_delete_queries


def test_lone_small_chunk_not_churned():
    """A single small chunk has no merge partner: rewriting it would be
    pure churn, so a fully-live single-chunk store is a no-op."""
    rng = np.random.default_rng(6)
    rs = RStore(RStoreConfig(capacity=1 << 20, batch_size=4), device="cpu")
    rs.init_root({k: _pay(rng) for k in range(4)})
    rs.flush()
    assert rs.compact().mode == "noop"


def test_compaction_k3_falls_back_to_rebuild():
    rng = np.random.default_rng(7)
    kvs = InMemoryKVS()
    rs = RStore(RStoreConfig(capacity=2048, batch_size=8, k=3), kvs=kvs,
                device="cpu")
    vids = _churn(rs, rng, n_versions=24)
    keep = vids[-4:]
    oracle = {v: rs.get_version(v)[0] for v in keep}
    before = kvs.total_stored_bytes()
    rs.retain(keep_last(4))
    rep = rs.compact()
    assert rep.mode == "rebuild"
    assert kvs.total_stored_bytes() < before
    for v in keep:
        assert rs.get_version(v)[0] == oracle[v]
    want = {k for c in rs._chunk_records for k in (f"chunk/{c}", f"map/{c}")}
    assert _kvs_keys(kvs) == want


def test_build_deletes_stale_chunk_keys():
    """A rebuild that shrinks the chunk count must GC the now-unreferenced
    chunk/map keys (pre-existing leak, observable after retention)."""
    rng = np.random.default_rng(8)
    kvs = InMemoryKVS()
    rs = RStore(RStoreConfig(capacity=1024, batch_size=4), kvs=kvs,
                device="cpu")
    _churn(rs, rng, n_versions=32)
    rs.retain(keep_last(2))
    rs.build()
    want = {k for c in rs._chunk_records for k in (f"chunk/{c}", f"map/{c}")}
    assert _kvs_keys(kvs) == want


# ----------------------------------------------------- snapshots across passes
def test_snapshot_refresh_repins_after_compaction():
    rng = np.random.default_rng(9)
    rs = RStore(RStoreConfig(capacity=2048, batch_size=8), device="cpu")
    vids = _churn(rs, rng, n_versions=32)
    snap = rs.snapshot()
    keep = vids[-6:]
    oracle = {v: snap.execute([Q.version(v)])[0].value for v in keep}

    rs.retain(keep_last(6))
    rep = rs.compact()
    assert rep.mode == "pass"
    with pytest.raises(RuntimeError, match="refresh"):
        snap.execute([Q.version(keep[0])])
    assert snap.refresh() is snap            # re-pin, same object
    for v in keep:
        assert snap.execute([Q.version(v)])[0].value == oracle[v]


def test_snapshot_refresh_cannot_survive_build():
    rng = np.random.default_rng(10)
    rs = RStore(RStoreConfig(capacity=2048, batch_size=8), device="cpu")
    _churn(rs, rng, n_versions=8)
    snap = rs.snapshot()
    rs.build()
    with pytest.raises(RuntimeError, match="new snapshot"):
        snap.refresh()
    with pytest.raises(RuntimeError, match="rebuild"):
        snap.execute([Q.version(0)])


def test_compact_during_open_writer_raises():
    rng = np.random.default_rng(11)
    rs = RStore(RStoreConfig(capacity=2048, batch_size=10**9), device="cpu")
    with rs.writer() as w:
        w.init_root({k: _pay(rng) for k in range(8)})
        with pytest.raises(RuntimeError, match="group commit"):
            rs.compact()
        with pytest.raises(RuntimeError, match="group commit"):
            rs.retain(keep_last(1))


def test_retain_respects_auto_flush_contract():
    rng = np.random.default_rng(12)
    rs = RStore(RStoreConfig(capacity=2048, batch_size=10**9,
                             auto_flush=False), device="cpu")
    rs.init_root({k: _pay(rng) for k in range(8)})
    with pytest.raises(RuntimeError, match="unflushed"):
        rs.retain(keep_last(1))
    with pytest.raises(RuntimeError, match="unflushed"):
        rs.compact()
    rs.flush()
    assert rs.retain(keep_last(1)) == []


# ------------------------------------------------------- evolution semantics
def test_evolution_hides_dead_records_before_and_after_compaction():
    """Q3 must return only record copies reachable from retained versions —
    including dead copies still physically present in kept chunks."""
    rng = np.random.default_rng(13)
    rs = RStore(RStoreConfig(capacity=1 << 16, batch_size=4), device="cpu")
    v0 = rs.init_root({0: _pay(rng), 1: _pay(rng)})
    v1 = rs.commit([v0], adds={0: _pay(rng)})
    v2 = rs.commit([v1], adds={0: _pay(rng)})
    rs.flush()
    assert [o for o, _ in rs.get_evolution(0)[0]] == [v0, v1, v2]

    rs.retain(keep_last(1))           # only v2 retained
    # before any compaction: dead copies are filtered via chunk-map bitmaps
    assert [o for o, _ in rs.get_evolution(0)[0]] == [v2]
    rs.compact(liveness_threshold=1.0)
    assert [o for o, _ in rs.get_evolution(0)[0]] == [v2]
    # pk 1 is live in v2 (inherited) — still visible
    assert [o for o, _ in rs.get_evolution(1)[0]] == [v0]


# ------------------------------------------------------------ layout health
def test_layout_health_metrics():
    rng = np.random.default_rng(14)
    rs = RStore(RStoreConfig(capacity=2048, batch_size=8), device="cpu")
    _churn(rs, rng, n_versions=40)
    h = measure_layout(rs)
    assert h.n_chunks == rs.storage_stats()["n_chunks"]
    assert h.stored_bytes == rs.storage_stats()["stored_chunk_bytes"]
    assert h.n_dead_records == 0 and h.dead_frac == 0.0
    assert all(lv == 1.0 for lv in h.chunk_liveness.values())
    assert h.frag_score >= 1.0 and h.span_factor >= 1.0
    assert h.est_read_seconds >= h.est_read_seconds_ideal > 0
    assert int(h.size_histogram[0].sum()) == h.n_chunks
    assert h.model["version_queries"] > 0

    rs.retain(keep_last(4))
    h2 = measure_layout(rs)
    assert h2.n_dead_records > 0 and h2.dead_frac > 0
    cp = Compactor(rs)
    assert cp.should_run(h2)          # plenty of dead bytes → trigger
    rep = cp.run_pass()
    h3 = measure_layout(rs)
    assert h3.stored_bytes < h2.stored_bytes
    assert h3.frag_score <= h2.frag_score
    assert rep.records_dropped > 0


# -------------------------------------------------- multidelete (satellites)
@pytest.mark.parametrize("make", [
    InMemoryKVS,
    lambda: ShardedKVS([InMemoryKVS(), InMemoryKVS()]),
    lambda: ShardedDeviceKVS(slot_bytes=64, n_slots=8, device="cpu"),
])
def test_empty_multidelete_costs_zero_round_trips(make):
    kvs = make()
    kvs.multidelete([])
    assert kvs.stats.n_delete_queries == 0
    assert kvs.stats.n_keys_deleted == 0


@pytest.mark.parametrize("make", [
    InMemoryKVS,
    lambda: ShardedKVS([InMemoryKVS(), InMemoryKVS(), InMemoryKVS()]),
])
def test_multidelete_roundtrip_and_stats(make):
    kvs = make()
    items = [(f"k{i}", bytes([i]) * (i + 1)) for i in range(12)]
    kvs.multiput(items)
    kvs.multidelete([k for k, _ in items[:8]])
    assert kvs.stats.n_keys_deleted == 8
    assert all(k not in kvs for k, _ in items[:8])
    assert all(k in kvs for k, _ in items[8:])
    assert kvs.total_stored_bytes() == sum(len(v) for _, v in items[8:])
    with pytest.raises(KeyError):
        kvs.multidelete(["k0"])       # double delete is an ownership bug
    if isinstance(kvs, ShardedKVS):
        # one round trip per shard touched
        assert kvs.stats.n_delete_queries <= len(kvs.shards)
        assert kvs.stats.n_delete_queries == sum(
            1 for s in kvs.shards if s.stats.n_delete_queries)


def test_device_kvs_multidelete_reclaims_slots():
    """Deleted values must return their extents to the free list and stop
    counting toward total_stored_bytes (no double-counting forever)."""
    kvs = ShardedDeviceKVS(slot_bytes=64, n_slots=8, device="cpu")
    kvs.multiput([("a", b"x" * 60), ("b", b"y" * 130), ("c", b"z" * 64)])
    assert kvs.total_stored_bytes() == 60 + 130 + 64
    high = kvs.high_water_slots
    kvs.multidelete(["a", "b"])
    assert kvs.stats.n_delete_queries == 1 and kvs.stats.n_keys_deleted == 2
    assert kvs.total_stored_bytes() == 64
    assert kvs.free_slots == 4                  # 1 ("a") + 3 ("b") coalesced
    assert "a" not in kvs and "c" in kvs
    # freed extents are reused before growing the table
    kvs.multiput([("d", b"w" * 250)])           # 4 slots — fits the hole
    assert kvs.high_water_slots == high
    assert kvs.get("d") == b"w" * 250
    with pytest.raises(KeyError):
        kvs.delete("a")


def test_device_kvs_backed_store_compaction_shrinks_footprint():
    """End to end on the device backend: compaction must shrink the live
    slot footprint (deletes feed the free list, later writes reuse it)."""
    rng = np.random.default_rng(15)
    kvs = ShardedDeviceKVS(slot_bytes=256, n_slots=64, device="cpu")
    rs = RStore(RStoreConfig(capacity=2048, batch_size=8), kvs=kvs,
                device="cpu")
    vids = _churn(rs, rng, n_versions=40)
    stored_before = kvs.total_stored_bytes()
    oracle = rs.get_version(vids[-1])[0]
    rs.retain(keep_last(4))
    rep = rs.compact()
    assert rep.mode == "pass"
    assert kvs.total_stored_bytes() < stored_before
    assert kvs.free_slots > 0 or kvs.high_water_slots < stored_before // 256
    assert rs.get_version(vids[-1])[0] == oracle


def test_stats_snapshot_restore_merge_cover_delete_counters():
    from repro_torch.core import KVSStats
    a = KVSStats(n_queries=1, n_delete_queries=3, n_keys_deleted=7)
    b = a.snapshot()
    assert b.n_delete_queries == 3 and b.n_keys_deleted == 7
    m = KVSStats.merged([a, b])
    assert m.n_delete_queries == 6 and m.n_keys_deleted == 14
    a.reset()
    assert a.n_delete_queries == 0 and a.n_keys_deleted == 0
    a.restore(b)
    assert a.n_delete_queries == 3
    # deletes price per-request overhead in the write-side cost model
    assert KVSStats(n_delete_queries=2).simulated_write_seconds(1e-3, 1e9) \
        == pytest.approx(2e-3)



# ---------------------------------------------------------- checkpointer GC
def test_checkpointer_retain_last_caps_storage():
    from repro_torch.train.checkpoint import VersionedCheckpointer

    kvs = InMemoryKVS()
    rs = RStore(RStoreConfig(capacity=4096, batch_size=4), kvs=kvs,
                device="cpu")
    ck = VersionedCheckpointer(store=rs, block_bytes=512)
    rng = np.random.default_rng(16)
    state = {"w": rng.normal(size=(64, 8)).astype(np.float32)}
    vids = []
    for i in range(12):
        w = state["w"].copy()
        w[i % 64, :] += 1.0           # one dirty block per step
        state = {"w": w}
        vids.append(ck.commit(state, parents=vids[-1:] or ()))
    before = rs.storage_stats()["stored_chunk_bytes"]
    rep = ck.retain_last(3)
    assert rep is not None and rep.mode in ("pass", "noop")
    assert rs.storage_stats()["stored_chunk_bytes"] <= before
    assert set(ck.meta) == set(vids[-3:])    # metas of dropped versions gone
    got = ck.restore(vids[-1])
    np.testing.assert_array_equal(got["w"], state["w"])
    with pytest.raises(KeyError, match="retired"):
        ck.restore(vids[0])


def test_checkpointer_retain_tagged_pins_milestones():
    from repro_torch.train.checkpoint import VersionedCheckpointer

    rs = RStore(RStoreConfig(capacity=4096, batch_size=4), device="cpu")
    ck = VersionedCheckpointer(store=rs, block_bytes=512)
    rng = np.random.default_rng(17)
    state = {"w": rng.normal(size=(32, 8)).astype(np.float32)}
    vids = []
    for i in range(8):
        state = {"w": state["w"] + 1.0}
        vids.append(ck.commit(state, parents=vids[-1:] or (),
                              tag=f"step{i}" if i % 4 == 0 else ""))
    assert ck.tags == {"step0": vids[0], "step4": vids[4]}
    want = ck.restore(vids[4])
    rep = ck.retain_tagged(["step0", "step4"])
    assert rep is not None
    assert set(ck.meta) == {vids[0], vids[4]}
    np.testing.assert_array_equal(ck.restore(vids[4])["w"], want["w"])
    with pytest.raises(KeyError, match="retired"):
        ck.restore(vids[1])
    # dropped versions' tags vanish with them; unknown tags raise
    rep2 = ck.retain_tagged(["step4"])
    assert ck.tags == {"step4": vids[4]}
    with pytest.raises(KeyError, match="unknown checkpoint tag"):
        ck.retain_tagged(["step0"])
