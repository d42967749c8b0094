"""Replication & fault-tolerance layer: error taxonomy, fault injection,
retry/failover reads, quorum writes, read-repair, and shard recovery."""
import dataclasses

import numpy as np
import pytest

from repro_torch.core import (InMemoryKVS, KVSStats, Q, RStore, RStoreConfig,
                              ShardedKVS, keep_last)
from repro_torch.core.replica import (BackendTimeout, BackendUnavailable,
                                      FaultInjectingKVS, QuorumLost,
                                      RecoveryManager, ReplicatedKVS,
                                      RetryPolicy, ShardDown,
                                      TransientBackendError)


def _group(n=2, quorum=1, retry=None, **fault_kw):
    reps = [FaultInjectingKVS(InMemoryKVS(), seed=100 + i, **fault_kw)
            for i in range(n)]
    return ReplicatedKVS(reps, write_quorum=quorum, retry=retry), reps


# ------------------------------------------------------------- stats guards
def test_kvsstats_fields_drift_guard():
    """_FIELDS is now DERIVED from dataclasses.fields(), so a new counter can
    never silently drop out of merged/snapshot/reset/restore — the guard only
    checks ordering (declaration order is the stable iteration order) and
    that every declared field actually round-trips."""
    declared = tuple(f.name for f in dataclasses.fields(KVSStats))
    assert KVSStats._FIELDS == declared
    for f in ("n_cache_hits", "n_cache_misses", "bytes_served_from_cache",
              "n_flush_batches", "n_versions_staged", "max_observed_lag"):
        assert f in KVSStats._FIELDS
    s = KVSStats(**{name: i + 1 for i, name in enumerate(declared)})
    snap = s.snapshot()
    assert all(getattr(snap, f) == getattr(s, f) for f in declared)
    m = KVSStats.merged([s, s])
    assert all(getattr(m, f) == 2 * getattr(s, f) for f in declared)
    s.reset()
    assert all(getattr(s, f) == 0 for f in declared)


def test_kvsstats_new_counters_roundtrip():
    s = KVSStats(n_retries=3, n_failovers=2, simulated_backoff_seconds=0.25)
    snap = s.snapshot()
    assert (snap.n_retries, snap.n_failovers) == (3, 2)
    assert snap.simulated_backoff_seconds == pytest.approx(0.25)
    m = KVSStats.merged([s, s])
    assert m.n_retries == 6 and m.n_failovers == 4
    assert m.simulated_backoff_seconds == pytest.approx(0.5)
    s.reset()
    assert s.n_retries == 0 and s.simulated_backoff_seconds == 0


# ----------------------------------------------------------- KeyError names
def test_inmemory_keyerror_names_missing_key():
    kvs = InMemoryKVS()
    kvs.put("present", b"x")
    for fn in (lambda: kvs.get("gone/7"),
               lambda: kvs.multiget(["present", "gone/7"]),
               lambda: kvs.multidelete(["gone/7"])):
        with pytest.raises(KeyError) as ei:
            fn()
        assert "gone/7" in str(ei.value)
    # and a miss is NOT a BackendUnavailable — failover must not eat it
    with pytest.raises(KeyError):
        kvs.get("gone/7")
    assert not issubclass(KeyError, BackendUnavailable)


# ------------------------------------------------------------- retry policy
def test_retry_backoff_capped_and_deterministic():
    p = RetryPolicy(base_delay_s=0.01, max_delay_s=0.1, multiplier=2.0,
                    jitter_frac=0.1, seed=7)
    delays = [p.backoff(a) for a in range(1, 10)]
    assert all(d <= 0.1 * 1.1 + 1e-12 for d in delays)
    assert delays[0] < delays[3]                      # grows before the cap
    assert delays == [RetryPolicy(base_delay_s=0.01, max_delay_s=0.1,
                                  multiplier=2.0, jitter_frac=0.1,
                                  seed=7).backoff(a) for a in range(1, 10)]
    # jitter stays within ±jitter_frac of the raw exponential
    assert 0.009 <= delays[0] <= 0.011


def test_retry_recovers_transient_and_counts():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] <= 2:
            raise TransientBackendError("blip")
        return "ok"

    stats = KVSStats()
    assert RetryPolicy(max_retries=4).call(flaky, stats) == "ok"
    assert stats.n_retries == 2
    assert stats.simulated_backoff_seconds > 0


def test_retry_gives_up_and_never_retries_sharddown():
    stats = KVSStats()
    with pytest.raises(BackendTimeout):
        RetryPolicy(max_retries=2).call(
            lambda: (_ for _ in ()).throw(BackendTimeout("t")), stats)
    assert stats.n_retries == 2

    calls = {"n": 0}

    def down():
        calls["n"] += 1
        raise ShardDown("dead")

    with pytest.raises(ShardDown):
        RetryPolicy(max_retries=5).call(down, stats)
    assert calls["n"] == 1                            # no retry on hard-down


# ---------------------------------------------------------- fault injection
def test_fault_schedule_is_deterministic():
    def trace(seed):
        f = FaultInjectingKVS(InMemoryKVS(), seed=seed, p_transient=0.4,
                              p_timeout=0.2, max_consecutive_faults=3)
        out = []
        for i in range(40):
            try:
                f.multiput([(f"k{i}", b"v")])
                out.append("ok")
            except TransientBackendError:
                out.append("transient")
            except BackendTimeout:
                out.append("timeout")
        return out

    a, b = trace(5), trace(5)
    assert a == b
    assert trace(6) != a                       # different seed, different run
    assert "transient" in a and "timeout" in a and "ok" in a


def test_fault_injection_bounds_consecutive_faults():
    f = FaultInjectingKVS(InMemoryKVS(), seed=1, p_transient=1.0,
                          max_consecutive_faults=2)
    outcomes = []
    for i in range(9):
        try:
            f.multiput([(f"k{i}", b"v")])
            outcomes.append(True)
        except TransientBackendError:
            outcomes.append(False)
    # with p=1, the pattern is exactly fail, fail, forced success, ...
    assert outcomes == [False, False, True] * 3


def test_schedule_faults_deterministic_queue():
    """schedule_faults() consumes verbatim before the probability stream and
    ignores the consecutive-fault bound — the interleaving harness's hook."""
    f = FaultInjectingKVS(InMemoryKVS(), seed=4, max_consecutive_faults=1)
    f.schedule_faults(["transient", "transient", "timeout", "ok"])
    with pytest.raises(TransientBackendError):
        f.multiput([("a", b"1")])
    with pytest.raises(TransientBackendError):   # bound does not apply
        f.multiput([("a", b"1")])
    with pytest.raises(BackendTimeout):
        f.multiput([("a", b"1")])
    assert f.inner.get("a") == b"1"              # timeout applied first
    f.multiput([("b", b"2")])                    # scheduled "ok"
    f.multiput([("c", b"3")])                    # queue empty, p=0: clean
    assert f.n_transient_injected == 2 and f.n_timeouts_injected == 1
    with pytest.raises(ValueError, match="unknown fault kind"):
        f.schedule_faults(["bogus"])


def test_timeout_write_is_applied_then_raises():
    f = FaultInjectingKVS(InMemoryKVS(), seed=2, p_timeout=1.0,
                          max_consecutive_faults=1)
    with pytest.raises(BackendTimeout):
        f.multiput([("k", b"payload")])
    assert f.inner.get("k") == b"payload"      # the write landed; ack lost
    f.multiput([("k2", b"x")])                 # forced success after the cap
    # deletes fault BEFORE applying (not idempotent), so a retry never
    # deletes twice
    with pytest.raises(BackendTimeout):
        f.multidelete(["k"])
    assert "k" in f.inner


def test_kill_and_revive():
    f = FaultInjectingKVS(InMemoryKVS(), seed=3)
    f.put("k", b"v")
    f.kill()
    for fn in (lambda: f.get("k"), lambda: f.multiput([("a", b"b")]),
               lambda: f.scan(), lambda: "k" in f,
               lambda: f.total_stored_bytes()):
        with pytest.raises(ShardDown):
            fn()
    assert f.n_down_rejections == 5
    f.revive()
    assert f.get("k") == b"v"                  # stale-but-answering


# ------------------------------------------------------------ replica group
def test_replicated_writes_fan_out_and_reads_prefer_one():
    g, reps = _group(n=3)
    g.multiput([("a", b"1"), ("b", b"2")])
    for r in reps:
        # peek at the raw dict — r.inner.get() would count read stats
        assert r.inner._d == {"a": b"1", "b": b"2"}
    assert g.multiget(["a", "b"]) == [b"1", b"2"]
    # reads hit only the preferred replica (no fan-out read amplification)
    assert reps[0].stats.n_queries >= 1
    assert reps[1].stats.n_queries == 0 and reps[2].stats.n_queries == 0
    assert "a" in g and "zzz" not in g
    g.multidelete(["a"])
    for r in reps:
        assert "a" not in r.inner
    assert g.total_stored_bytes() == 1         # logical bytes, one copy


def test_replicated_missing_key_is_not_a_failover():
    g, _ = _group(n=2)
    g.put("a", b"1")
    with pytest.raises(KeyError) as ei:
        g.multiget(["a", "nope"])
    assert "nope" in str(ei.value)
    assert g.stats.n_failovers == 0


def test_read_failover_costs_one_extra_round_trip_once():
    g, reps = _group(n=2)
    g.multiput([(f"k{i}", bytes([i])) for i in range(8)])
    reps[0].kill()
    q0 = g.stats.n_queries
    assert g.multiget(["k1", "k2"]) == [b"\x01", b"\x02"]
    # first degraded batch: failed attempt on the dead replica + the
    # successful failover = exactly one extra round trip
    assert g.stats.n_queries - q0 == 2
    assert g.stats.n_failovers == 1
    assert g.live == (False, True)
    q1 = g.stats.n_queries
    assert g.get("k3") == b"\x03"
    # known-down replica is skipped at zero cost from now on
    assert g.stats.n_queries - q1 == 1
    assert g.stats.n_failovers == 1


def test_all_replicas_down_raises_shard_down():
    g, reps = _group(n=2)
    g.put("k", b"v")
    for r in reps:
        r.kill()
    with pytest.raises(ShardDown):
        g.multiget(["k"])
    with pytest.raises(QuorumLost):
        g.multiput([("x", b"y")])


def test_write_quorum_enforced():
    g, reps = _group(n=3, quorum=2)
    g.put("a", b"1")
    reps[2].kill()
    g.put("b", b"2")                           # 2 of 3 acks: fine
    reps[1].kill()
    with pytest.raises(QuorumLost):
        g.put("c", b"3")                       # 1 of 3 acks < quorum 2
    # the quorum-failed write still reached the survivor and the repair
    # logs of the dead replicas — recovery converges, never loses acks
    assert reps[0].inner.get("c") == b"3"
    assert g.pending_repairs(1) >= 1 and g.pending_repairs(2) >= 1


def test_missed_writes_are_read_repaired_on_failover():
    g, reps = _group(n=2)
    g.multiput([("a", b"old"), ("b", b"1")])
    reps[1].kill()
    g.multiput([("a", b"new"), ("c", b"2")])   # replica 1 misses this
    g.multidelete(["b"])                       # ...and this
    assert g.pending_repairs(1) == 3
    reps[1].revive()
    g.mark_live(1)                             # back in rotation, log intact
    reps[0].kill()                             # force reads onto replica 1
    assert g.multiget(["a", "c"]) == [b"new", b"2"]   # backfilled first
    assert g.pending_repairs(1) == 0
    assert "b" not in reps[1].inner            # missed delete applied too
    with pytest.raises(KeyError):
        g.get("b")


def test_put_then_delete_missed_entirely_leaves_no_phantom():
    g, reps = _group(n=2)
    reps[1].kill()
    g.put("tmp", b"x")
    g.multidelete(["tmp"])                     # replica 1 never saw "tmp"
    reps[1].revive()
    g.mark_live(1)
    reps[0].kill()
    assert "tmp" not in g                      # tombstone; no KeyError crash
    assert "tmp" not in reps[1].inner


# ---------------------------------------------------------------- recovery
def test_rebuild_restores_replica_and_read_rotation():
    g, reps = _group(n=2)
    g.multiput([(f"k{i}", bytes([i]) * 4) for i in range(10)])
    reps[0].kill()
    g.multiput([("k3", b"updated"), ("new", b"fresh")])
    g.multidelete(["k7"])
    assert g.preferred == 1 or g.get("k0")     # reads moved off replica 0
    reps[0].revive()                           # stale: old k3/k7, no "new"
    rep = RecoveryManager(g).rebuild(0)
    assert rep.source == 1
    assert rep.stale_keys_deleted == 1         # k7
    assert rep.keys_copied == 2                # k3 (changed) + new (missing)
    assert rep.read_round_trips == 2 and rep.round_trips <= 4
    assert dict(reps[0].inner.scan()) == dict(reps[1].inner.scan())
    assert g.live == (True, True) and g.preferred == 0
    q0 = reps[0].stats.n_queries
    assert g.get("k3") == b"updated"
    assert reps[0].stats.n_queries == q0 + 1   # served by the rebuilt replica


def test_rebuild_from_total_loss_via_fresh_replacement():
    g, reps = _group(n=3)
    g.multiput([(f"k{i}", b"v%d" % i) for i in range(6)])
    reps[1].kill()
    g.put("late", b"z")
    fresh = FaultInjectingKVS(InMemoryKVS(), seed=999)
    g.replicas[1] = fresh                      # disk gone; new empty node
    rep = RecoveryManager(g).rebuild(1)
    assert rep.keys_copied == 7 and rep.stale_keys_deleted == 0
    assert dict(fresh.inner.scan()) == dict(reps[0].inner.scan())
    assert g.live == (True, True, True)


def test_rebuild_needs_a_live_survivor_and_reachable_target():
    g, reps = _group(n=2)
    g.put("k", b"v")
    reps[0].kill()
    reps[1].kill()
    g.mark_down(1)
    with pytest.raises(ShardDown):
        RecoveryManager(g).rebuild(0)          # no survivor
    reps[1].revive()
    g.mark_live(1)
    with pytest.raises(ShardDown):
        RecoveryManager(g).rebuild(0)          # target still down
    reps[0].revive()
    RecoveryManager(g).rebuild(0)
    assert g.live == (True, True)


def test_recover_all_over_sharded_router():
    shards = [ReplicatedKVS([FaultInjectingKVS(InMemoryKVS(), seed=i * 2 + r)
                             for r in range(2)]) for i in range(3)]
    kvs = ShardedKVS(shards)
    kvs.multiput([(f"key/{i}", bytes([i])) for i in range(30)])
    for g in shards:
        g.replicas[0].kill()
    kvs.multiput([(f"key/{i}", bytes([i]) * 2) for i in range(5)])
    for g in shards:
        g.replicas[0].revive()
    reports = RecoveryManager(kvs).recover_all()
    assert {r.shard for r in reports} <= {0, 1, 2}
    for g in shards:
        assert g.live == (True, True)
        assert dict(g.replicas[0].inner.scan()) == \
            dict(g.replicas[1].inner.scan())
        assert g.pending_repairs(0) == 0 and g.pending_repairs(1) == 0


def test_scan_fails_over_when_preferred_replica_down():
    """scan() is the recovery primitive — it must fail over exactly like
    multiget when the preferred replica is killed but not yet marked down
    (the recovery paths built on scan assume a live preferred replica)."""
    g, reps = _group(n=3)
    g.multiput([("a", b"1"), ("b", b"2")])
    reps[0].kill()                             # stale _live[0] == True
    assert dict(g.scan()) == {"a": b"1", "b": b"2"}
    assert g.live == (False, True, True)       # discovered during the scan
    assert g.stats.n_failovers >= 1


def test_rebuild_source_selection_fails_over_stale_live_survivor():
    """rebuild() picks its survivor by live flags; a candidate killed since
    its last op (flag still True) must be failed over like any read —
    marked down, next peer tried — not crash the rebuild."""
    g, reps = _group(n=3)
    g.multiput([("a", b"1"), ("b", b"2")])
    g.mark_down(0)                             # target: down, then revived
    g.put("late", b"z")                        # logged for replica 0
    reps[1].kill()                             # preferred survivor, stale flag
    rep = RecoveryManager(g).rebuild(0)
    assert rep.source == 2                     # skipped the dead candidate
    assert g.live == (True, False, True)       # 1 discovered down, 0 rebuilt
    assert dict(reps[0].inner.scan()) == dict(reps[2].inner.scan())
    assert g.pending_repairs(0) == 0
    # the discovered-dead survivor is rebuildable afterwards, same path
    reps[1].revive()
    RecoveryManager(g).rebuild(1)
    assert g.live == (True, True, True)
    assert dict(reps[1].inner.scan()) == dict(reps[2].inner.scan())


def test_recover_all_survives_stale_live_replica_during_flush():
    """recover_all's final repair-log flush must not crash on a replica
    whose live flag went stale: mark it down (the log survives — flushes
    drop ops only after they apply) instead of raising ShardDown."""
    g, reps = _group(n=3)
    g.multiput([("a", b"1"), ("b", b"2")])
    g.mark_down(2)
    g.put("late", b"z")                        # repair log for replica 2
    g.mark_live(2)                             # back in rotation, log pending
    reps[2].kill()                             # ...but actually dead
    reports = RecoveryManager(g).recover_all()
    assert reports == []                       # nothing was marked down going in
    assert g.live == (True, True, False)       # discovered during the flush
    assert g.pending_repairs(2) == 1           # log kept for the next rebuild
    reps[2].revive()
    RecoveryManager(g).recover_all()
    assert g.live == (True, True, True)
    assert g.pending_repairs(2) == 0
    assert dict(reps[2].inner.scan()) == dict(reps[0].inner.scan())


# ----------------------------------------------------------- RStore on top
def _replicated_store(n_shards=3, R=2, quorum=1, **cfg_kw):
    groups = [ReplicatedKVS([FaultInjectingKVS(InMemoryKVS(), seed=i * R + r)
                             for r in range(R)], write_quorum=quorum)
              for i in range(n_shards)]
    kvs = ShardedKVS(groups)
    cfg = RStoreConfig(algorithm="bottom_up", capacity=1024, batch_size=4,
                       **cfg_kw)
    return RStore(cfg, kvs=kvs, device="cpu"), kvs, groups


def test_rstore_survives_replica_death_mid_workload():
    rs, kvs, groups = _replicated_store()
    rng = np.random.default_rng(11)

    def pay():
        return rng.integers(0, 256, 64, dtype=np.uint8).tobytes()

    v = rs.init_root({k: pay() for k in range(16)})
    vids = [v]
    for _ in range(9):
        v = rs.commit([v], adds={int(rng.integers(0, 16)): pay()})
        vids.append(v)
    rs.flush()
    snap = rs.snapshot()
    qs = [Q.version(vids[-1]), Q.record(vids[-1], 3),
          Q.range(vids[0], 2, 9), Q.evolution(5)]
    healthy = [r.value for r in snap.execute(qs)]
    rts_healthy = snap.execute(qs).batch.kvs_queries

    for g in groups:
        g.replicas[0].kill()               # one replica death per shard
    res = snap.execute(qs)
    assert [r.value for r in res] == healthy
    # router-level round trips unchanged: the failover is absorbed inside
    # each group (≤1 extra inner attempt, counted on group stats)
    assert res.batch.kvs_queries == rts_healthy
    assert all(g.stats.n_failovers <= 1 for g in groups)

    # the write path keeps working degraded (quorum 1 of 2), unchanged
    with rs.writer() as w:
        v2 = w.commit([vids[-1]], adds={3: pay()})
    got, _ = rs.get_record(v2, 3)
    assert got is not None


def test_rstore_compaction_gc_spans_replicas_and_recovery_preserves_it():
    rs, kvs, groups = _replicated_store()
    rng = np.random.default_rng(13)

    def pay():
        return rng.integers(0, 256, 96, dtype=np.uint8).tobytes()

    v = rs.init_root({k: pay() for k in range(12)})
    vids = [v]
    for _ in range(14):
        v = rs.commit([v], adds={int(rng.integers(0, 12)): pay()})
        vids.append(v)
    rs.flush()
    for g in groups:
        g.replicas[0].kill()               # compact while degraded
    rs.retain(keep_last(6))
    rep = rs.compact()
    assert rep.mode == "pass"
    live = [x for x in vids if not rs.graph.is_retired(x)]
    oracle = {}
    for x in live:
        oracle[x] = rs.get_version(x)[0]

    for g in groups:
        g.replicas[0].revive()
    RecoveryManager(kvs).recover_all()
    for g in groups:                       # GC propagated: no resurrected keys
        assert dict(g.replicas[0].inner.scan()) == \
            dict(g.replicas[1].inner.scan())
    for g in groups:
        g.replicas[1].kill()               # read everything off rebuilt side
    for x in live:
        assert rs.get_version(x)[0] == oracle[x]


def test_rstore_flaky_replicas_masked_by_retries():
    groups = [ReplicatedKVS(
        [FaultInjectingKVS(InMemoryKVS(), seed=50 + i * 3 + r,
                           p_transient=0.3, p_timeout=0.2)
         for r in range(3)], write_quorum=2) for i in range(2)]
    kvs = ShardedKVS(groups)
    rs = RStore(RStoreConfig(algorithm="bottom_up", capacity=512,
                             batch_size=3), kvs=kvs, device="cpu")
    oracle_rs = RStore(RStoreConfig(algorithm="bottom_up", capacity=512,
                                    batch_size=3), kvs=InMemoryKVS(),
                       device="cpu")
    rng1, rng2 = np.random.default_rng(21), np.random.default_rng(21)

    def drive(store, rng):
        def pay():
            return rng.integers(0, 256, 48, dtype=np.uint8).tobytes()
        v = store.init_root({k: pay() for k in range(10)})
        vids = [v]
        for _ in range(8):
            v = store.commit([v], adds={int(rng.integers(0, 12)): pay()})
            vids.append(v)
        return [store.get_version(x)[0] for x in vids]

    assert drive(rs, rng1) == drive(oracle_rs, rng2)
    merged = KVSStats.merged([g.stats for g in groups])
    assert merged.n_retries > 0
    assert merged.simulated_backoff_seconds > 0


# ------------------------------------------------------------- launch wiring
def test_make_sharded_backend_replication_factor():
    from repro_torch.core.kvs import ShardedDeviceKVS
    from repro_torch.launch.mesh import make_sharded_backend

    kvs = make_sharded_backend(n_shards=2, replication_factor=2,
                               devices=["cpu"])
    assert len(kvs.shards) == 2
    for g in kvs.shards:
        assert isinstance(g, ReplicatedKVS)
        assert len(g.replicas) == 2
        assert all(isinstance(r, ShardedDeviceKVS) for r in g.replicas)
    kvs.multiput([(f"k{i}", bytes([i]) * 8) for i in range(6)])
    assert kvs.multiget(["k1", "k4"]) == [b"\x01" * 8, b"\x04" * 8]
    for g in kvs.shards:                       # every replica has its copy
        for r in g.replicas:
            assert r.total_stored_bytes() > 0
    # R=1 keeps the plain un-replicated router (back-compat)
    plain = make_sharded_backend(n_shards=2, replication_factor=1,
                                 devices=["cpu"])
    assert all(isinstance(s, ShardedDeviceKVS) for s in plain.shards)
