"""Async ingest: BackgroundFlusher watermarks, cross-session batching,
barrier/drain idempotence, failure replay, snapshot modes, and the
no-op conventions (empty drain, closed-session flush, double close)."""
import pytest

from repro_torch.core import (CachingKVS, FaultInjectingKVS, InMemoryKVS,
                              KVSStats, Q, RStore, RStoreConfig, RetryPolicy,
                              ShardedKVS, keep_last)
from repro_torch.core.flusher import BackgroundFlusher, DrainReport
from repro_torch.core.replica import BackendUnavailable, TransientBackendError
from repro_torch.serve.ingest_gateway import IngestGateway


def _payload(i, n=48):
    return bytes([i % 251]) * n


def _store(n_shards=0, **cfg_kw):
    cfg_kw.setdefault("capacity", 512)
    cfg_kw.setdefault("batch_size", 10**9)
    kvs = (InMemoryKVS() if n_shards == 0 else
           ShardedKVS([InMemoryKVS() for _ in range(n_shards)]))
    return RStore(RStoreConfig(**cfg_kw), kvs=kvs, device="cpu"), kvs


def _boot_root(rs, n=8):
    """Stage a root through a short-lived session (no drain)."""
    with rs.writer() as w:
        return w.init_root({pk: _payload(pk) for pk in range(n)})


# ------------------------------------------------------- watermark triggers
def test_version_watermark_triggers_drain():
    rs, kvs = _store()
    rs.attach_flusher(max_staged_versions=4)
    root = _boot_root(rs)
    w = rs.writer()
    v = root
    for i in range(2):
        v = w.commit([v], adds={100 + i: _payload(i)})
    assert kvs.stats.n_put_queries == 0          # 3 staged < 4
    v = w.commit([v], adds={200: _payload(7)})   # 4th: watermark fires
    assert kvs.stats.n_flush_batches == 1
    assert kvs.stats.n_put_queries >= 1
    assert rs.flusher.staleness_lag == 0
    w.close()


def test_byte_watermark_triggers_drain():
    rs, kvs = _store()
    rs.attach_flusher(max_staged_versions=10**9, max_staged_bytes=600)
    root = _boot_root(rs)                        # 8 * 48 = 384 bytes staged
    assert kvs.stats.n_put_queries == 0
    w = rs.writer()
    w.commit([root], adds={100: _payload(1, 300)})  # 684 >= 600: drain
    assert kvs.stats.n_flush_batches == 1
    assert rs.flusher.staged_bytes == 0
    w.close()


def test_age_watermark_triggers_drain():
    rs, kvs = _store()
    fl = rs.attach_flusher(max_staged_versions=10**9, max_staged_age=5)
    _boot_root(rs)
    assert kvs.stats.n_flush_batches == 0
    fl.tick(2)                                   # oldest age < 5: no drain
    assert kvs.stats.n_flush_batches == 0
    fl.tick(5)
    assert kvs.stats.n_flush_batches == 1
    assert fl.staleness_lag == 0


def test_no_drain_below_watermarks():
    rs, kvs = _store()
    rs.attach_flusher(max_staged_versions=100, max_staged_bytes=1 << 30)
    root = _boot_root(rs)
    w = rs.writer()
    v = root
    for i in range(10):
        v = w.commit([v], adds={100 + i: _payload(i)})
    w.close()
    assert kvs.stats.n_put_queries == 0
    assert kvs.stats.n_queries == 0
    assert rs.flusher.staleness_lag == 11        # root + 10 commits


# -------------------------------------------------- cross-session batching
def test_concurrent_sessions_allowed_in_async_mode():
    rs, _ = _store()
    rs.attach_flusher()
    ws = [rs.writer() for _ in range(4)]
    assert all(not w._closed for w in ws)
    for w in ws:
        w.close()


def test_sync_mode_still_one_writer():
    rs, _ = _store()
    w = rs.writer()
    with pytest.raises(RuntimeError, match="already open"):
        rs.writer()
    w.close()


def test_cross_session_drain_round_trips():
    """K sessions' staged versions drain in <= S write round trips on S
    shards — one group commit for everyone, not one per session."""
    n_shards, n_sessions, n_commits = 4, 6, 5
    rs, kvs = _store(n_shards=n_shards)
    rs.attach_flusher(max_staged_versions=10**9)
    root = _boot_root(rs, n=16)
    sessions = [rs.writer() for _ in range(n_sessions)]
    heads = [root] * n_sessions
    for step in range(n_commits):
        for j, w in enumerate(sessions):
            heads[j] = w.commit([heads[j]],
                                adds={1000 * (j + 1) + step: _payload(j)})
    assert kvs.stats.n_put_queries == 0          # staging is free
    rep = rs.barrier()
    assert rep.n_versions == 1 + n_sessions * n_commits
    assert rep.write_round_trips <= n_shards
    for w in sessions:
        w.close()

    # per-session sync flush baseline pays >= one group commit per session
    rs0, kvs0 = _store(n_shards=n_shards)
    root0 = _boot_root(rs0, n=16)     # flush_on_close=True default -> flush
    rs0.flush()
    base = kvs0.stats.n_put_queries
    heads0 = [root0] * n_sessions
    for j in range(n_sessions):
        with rs0.writer() as w:
            for step in range(n_commits):
                heads0[j] = w.commit([heads0[j]],
                                     adds={1000 * (j + 1) + step: _payload(j)})
    sync_rts = kvs0.stats.n_put_queries - base
    assert sync_rts >= n_sessions                # one+ round trip per session
    assert rep.write_round_trips < sync_rts

    # byte-identical content either way
    for v, v0 in zip(heads, heads0):
        assert rs.get_version(v)[0] == rs0.get_version(v0)[0]


def test_facade_commit_stages_through_flusher():
    rs, kvs = _store()
    rs.attach_flusher(max_staged_versions=10**9)
    root = _boot_root(rs)
    v = rs.commit([root], adds={100: _payload(1)})   # facade wrapper
    assert kvs.stats.n_put_queries == 0
    assert rs.flusher.staleness_lag == 2
    assert rs.get_version(v)[0][100] == _payload(1)  # fresh snapshot drains


# ------------------------------------------------ barrier/drain idempotence
def test_barrier_empty_is_free():
    rs, kvs = _store()
    rs.attach_flusher()
    _boot_root(rs)
    rs.barrier()
    before = kvs.stats.snapshot()
    rep = rs.barrier()                           # nothing staged
    assert rep == DrainReport(step=rep.step)
    assert rep.write_round_trips == 0
    assert kvs.stats.snapshot() == before        # zero stats noise
    rep2 = rs.flusher.drain()
    assert rep2.n_versions == 0 and kvs.stats.snapshot() == before


def test_barrier_drains_everything_once():
    rs, kvs = _store()
    rs.attach_flusher(max_staged_versions=10**9)
    root = _boot_root(rs)
    w = rs.writer()
    w.commit([root], adds={100: _payload(1)})
    r1 = rs.barrier()
    r2 = rs.barrier()
    assert r1.n_versions == 2 and r2.n_versions == 0
    assert kvs.stats.n_flush_batches == 1
    w.close()


def test_sync_barrier_flushes_pending_and_empty_is_noop():
    rs, kvs = _store(batch_size=10**9)
    rs.init_root({pk: _payload(pk) for pk in range(4)})
    assert rs.pending and kvs.stats.n_put_queries == 0
    rs.barrier()
    assert not rs.pending and kvs.stats.n_put_queries >= 1
    before = kvs.stats.snapshot()
    assert rs.barrier() is None
    assert kvs.stats.snapshot() == before


def test_virtual_clock_advances_on_events():
    rs, _ = _store()
    fl = rs.attach_flusher()
    s0 = fl.step
    _boot_root(rs)                  # stage + session close tick
    assert fl.step > s0
    s1 = fl.step
    fl.tick(3)
    assert fl.step == s1 + 3
    rs.barrier()
    assert fl.step == s1 + 4


# ------------------------------------------------------ flush-failure replay
def test_flush_failure_keeps_staged_versions():
    fkvs = FaultInjectingKVS(InMemoryKVS())
    rs = RStore(RStoreConfig(capacity=512, batch_size=10**9), kvs=fkvs,
                device="cpu")
    fl = rs.attach_flusher(max_staged_versions=10**9,
                           retry=RetryPolicy(max_retries=1))
    w = rs.writer()
    root = w.init_root({pk: _payload(pk) for pk in range(6)})
    v1 = w.commit([root], adds={100: _payload(1)})
    fkvs.schedule_faults(["transient", "transient"])  # exhausts retries
    with pytest.raises(TransientBackendError):
        rs.barrier()
    assert fl.has_unacked_writes
    assert fl.staleness_lag == 2                 # staged versions survive
    rep = rs.barrier()                           # backend healthy again
    assert rep.replayed and rep.n_versions == 2
    assert not fl.has_unacked_writes
    w.close()
    assert rs.get_version(v1)[0][100] == _payload(1)


def test_timeout_mid_drain_replay_is_idempotent():
    """BackendTimeout = applied but ack lost: the retry re-puts the same
    batch; results must be byte-identical to a fault-free oracle."""
    fkvs = FaultInjectingKVS(InMemoryKVS())
    rs = RStore(RStoreConfig(capacity=512, batch_size=10**9), kvs=fkvs,
                device="cpu")
    rs.attach_flusher(max_staged_versions=10**9)
    rs0, _ = _store()                            # fault-free oracle
    rs0.attach_flusher(max_staged_versions=10**9)
    for store in (rs, rs0):
        w = store.writer()
        r = w.init_root({pk: _payload(pk) for pk in range(6)})
        w.commit([r], adds={100: _payload(1)}, dels=[2])
        w.close()
    fkvs.schedule_faults(["timeout"])
    rs.barrier()
    rs0.barrier()
    assert fkvs.stats.n_retries == 1
    assert rs.get_version(1)[0] == rs0.get_version(1)[0]
    assert dict(fkvs.inner.scan()) == dict(rs0.kvs.scan())


def test_failed_drain_then_new_stages_merge_into_one_replay():
    fkvs = FaultInjectingKVS(InMemoryKVS())
    rs = RStore(RStoreConfig(capacity=512, batch_size=10**9), kvs=fkvs,
                device="cpu")
    fl = rs.attach_flusher(max_staged_versions=10**9,
                           retry=RetryPolicy(max_retries=0))
    w = rs.writer()
    root = w.init_root({pk: _payload(pk) for pk in range(6)})
    fkvs.schedule_faults(["transient"])
    with pytest.raises(TransientBackendError):
        rs.barrier()
    v1 = w.commit([root], adds={100: _payload(1)})
    p0 = fkvs.stats.n_put_queries
    rep = rs.barrier()                           # old replay + new batch
    assert rep.replayed and rep.n_versions == 2
    assert fkvs.stats.n_put_queries - p0 == 1    # still ONE multiput
    assert kvs_retained_versions_ok(rs, [root, v1])
    assert fl.staleness_lag == 0
    w.close()


def kvs_retained_versions_ok(rs, vids):
    for v in vids:
        got = rs.snapshot().execute([Q.version(v)])[0].value
        m = rs.graph.members(v)
        keys = rs.graph.store.keys()
        want = {int(keys[r]): rs.graph.store.payload(int(r)) for r in m}
        if got != want:
            return False
    return True


def test_failed_drain_blocks_pinned_snapshot():
    fkvs = FaultInjectingKVS(InMemoryKVS())
    rs = RStore(RStoreConfig(capacity=512, batch_size=10**9), kvs=fkvs,
                device="cpu")
    rs.attach_flusher(max_staged_versions=10**9,
                      retry=RetryPolicy(max_retries=0))
    _boot_root(rs)
    rs.barrier()                                 # something durable exists
    with rs.writer() as w:
        w.commit([0], adds={100: _payload(1)})
        fkvs.schedule_faults(["transient"])
        with pytest.raises(TransientBackendError):
            rs.barrier()
        with pytest.raises(RuntimeError, match="failed drain"):
            rs.snapshot(mode="pinned")
        rs.barrier()                             # replay lands
        assert rs.snapshot(mode="pinned").staleness_lag == 0


# ------------------------------------------------------------ snapshot modes
def test_fresh_snapshot_is_read_your_writes():
    rs, kvs = _store()
    rs.attach_flusher(max_staged_versions=10**9)
    root = _boot_root(rs)
    w = rs.writer()
    v = w.commit([root], adds={100: _payload(1)})
    snap = rs.snapshot()                         # default: drains first
    assert snap.staleness_lag == 0
    assert snap.execute([Q.version(v)])[0].value[100] == _payload(1)
    w.close()


def test_pinned_snapshot_is_stale_but_free():
    rs, kvs = _store()
    rs.attach_flusher(max_staged_versions=10**9)
    root = _boot_root(rs)
    rs.barrier()
    w = rs.writer()
    v_staged = w.commit([root], adds={100: _payload(1)})
    p0 = kvs.stats.n_put_queries
    snap = rs.snapshot(mode="pinned")
    assert kvs.stats.n_put_queries == p0         # no drain, no writes
    assert snap.staleness_lag == 1
    # durable versions serve normally; staged ones fail loudly
    assert snap.execute([Q.version(root)])[0].value == {
        pk: _payload(pk) for pk in range(8)}
    with pytest.raises(KeyError):
        snap.execute([Q.version(v_staged)])
    w.close()


def test_pinned_snapshot_without_flusher_reports_pending_lag():
    rs, kvs = _store(batch_size=10**9)
    rs.init_root({pk: _payload(pk) for pk in range(4)})
    rs.flush()
    rs.commit([0], adds={100: _payload(1)})      # pending, unflushed
    snap = rs.snapshot(mode="pinned")
    assert snap.staleness_lag == 1
    assert rs.pending                            # pinned did not flush


def test_snapshot_mode_validation():
    rs, _ = _store()
    with pytest.raises(ValueError, match="unknown snapshot mode"):
        rs.snapshot(mode="stale")


def test_staleness_lag_in_storage_stats():
    rs, _ = _store()
    rs.attach_flusher(max_staged_versions=10**9)
    root = _boot_root(rs)
    ing = rs.storage_stats()["ingest"]
    assert ing["mode"] == "async"
    assert ing["staleness_lag"] == 1 and ing["staged_versions"] == 1
    rs.barrier()
    w = rs.writer()
    for i in range(3):
        root = w.commit([root], adds={100 + i: _payload(i)})
    ing = rs.storage_stats()["ingest"]
    assert ing["staleness_lag"] == 3
    assert ing["n_flush_batches"] == 1
    assert ing["n_versions_staged"] == 4
    assert ing["max_observed_lag"] >= 3
    assert ing["open_sessions"] == 1
    w.close()
    rs.barrier()
    ing = rs.storage_stats()["ingest"]
    assert ing["staleness_lag"] == 0 and ing["pending_replay_writes"] == 0


def test_sync_mode_ingest_report():
    rs, _ = _store(batch_size=10**9)
    rs.init_root({pk: _payload(pk) for pk in range(4)})
    ing = rs.storage_stats()["ingest"]
    assert ing["mode"] == "sync"
    assert ing["staged_versions"] == 1 == ing["staleness_lag"]
    assert ing["n_flush_batches"] == 0


# --------------------------------------- no-op conventions and double close
def test_empty_drain_guard_never_touches_backend():
    rs, kvs = _store()
    fl = rs.attach_flusher()
    before = kvs.stats.snapshot()
    for _ in range(3):
        rep = fl.drain()
        assert rep.n_versions == 0 and rep.n_writes == 0
    assert kvs.stats.snapshot() == before


def test_writesession_flush_on_closed_session_is_noop():
    # sync mode
    rs, kvs = _store()
    w = rs.writer()
    w.init_root({pk: _payload(pk) for pk in range(4)})
    w.close()
    before = kvs.stats.snapshot()
    w.flush()                                    # closed: cheap no-op
    assert kvs.stats.snapshot() == before
    # async mode
    rs2, kvs2 = _store()
    rs2.attach_flusher(max_staged_versions=10**9)
    w2 = rs2.writer()
    w2.init_root({pk: _payload(pk) for pk in range(4)})
    w2.close()
    before2 = kvs2.stats.snapshot()
    w2.flush()
    assert kvs2.stats.snapshot() == before2      # no drain from a closed session
    assert rs2.flusher.staleness_lag == 1


def test_writesession_flush_midsession_sync_splits_explicitly():
    rs, kvs = _store()
    w = rs.writer()
    root = w.init_root({pk: _payload(pk) for pk in range(4)})
    w.flush()                                    # deliberate early flush
    assert kvs.stats.n_put_queries == 1
    assert not rs.pending
    v = w.commit([root], adds={100: _payload(1)})
    w.close()                                    # second group commit
    assert kvs.stats.n_put_queries == 2
    assert rs.get_version(v)[0][100] == _payload(1)


def test_writesession_flush_async_is_barrier():
    rs, kvs = _store()
    rs.attach_flusher(max_staged_versions=10**9)
    w = rs.writer()
    w.init_root({pk: _payload(pk) for pk in range(4)})
    w.flush()
    assert kvs.stats.n_flush_batches == 1
    assert rs.flusher.staleness_lag == 0
    w.close()


def test_flusher_double_close_is_noop():
    rs, kvs = _store()
    fl = rs.attach_flusher(max_staged_versions=10**9)
    _boot_root(rs)
    rep = fl.close()                             # final drain + detach
    assert rep.n_versions == 1
    assert rs.flusher is None
    assert fl.close() is None                    # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        fl.drain()
    # store is back to sync semantics: one-writer rule again
    w = rs.writer()
    with pytest.raises(RuntimeError, match="already open"):
        rs.writer()
    w.close()
    rs.attach_flusher()                          # re-attach works


def test_attach_flusher_guards():
    rs, _ = _store()
    w = rs.writer()
    with pytest.raises(RuntimeError, match="close the open WriteSession"):
        rs.attach_flusher()
    w.close()
    rs.attach_flusher()
    with pytest.raises(RuntimeError, match="already attached"):
        rs.attach_flusher()
    rs3, _ = _store(k=3)
    with pytest.raises(ValueError, match="k == 1"):
        rs3.attach_flusher()
    rs4, _ = _store()
    with pytest.raises(ValueError, match="max_staged_versions"):
        rs4.attach_flusher(max_staged_versions=0)


def test_attach_adopts_pending_versions():
    rs, kvs = _store(batch_size=10**9)
    rs.init_root({pk: _payload(pk) for pk in range(4)})
    rs.commit([0], adds={100: _payload(1)})
    assert len(rs.pending) == 2
    fl = rs.attach_flusher(max_staged_versions=10**9)
    assert fl.staleness_lag == 2                 # adopted into the buffer
    rep = rs.barrier()
    assert rep.n_versions == 2
    assert rs.get_version(1)[0][100] == _payload(1)


def test_commit_after_session_close_still_raises():
    rs, _ = _store()
    rs.attach_flusher()
    w = rs.writer()
    w.init_root({0: _payload(0)})
    w.close()
    with pytest.raises(RuntimeError, match="closed"):
        w.commit([0], adds={1: _payload(1)})


# ----------------------------------------------------- layer composition
def test_cache_write_through_fires_once_per_drained_batch():
    inner = ShardedKVS([InMemoryKVS() for _ in range(2)])
    ckvs = CachingKVS(inner, cache_bytes=4 << 20)
    rs = RStore(RStoreConfig(capacity=512, batch_size=10**9), kvs=ckvs,
                device="cpu")
    rs.attach_flusher(max_staged_versions=10**9)
    root = _boot_root(rs)
    rs.barrier()
    rs.get_version(root)                         # warm chunk/map keys
    assert ckvs.n_write_through == 0
    w = rs.writer()
    v = root
    for i in range(3):
        v = w.commit([v], adds={100 + i: _payload(i)})
    p0 = ckvs.stats.n_put_queries
    wt0 = ckvs.n_write_through
    rs.barrier()                                 # ONE drained batch
    assert ckvs.stats.n_put_queries - p0 <= 2    # <= one RT per shard
    # previously-cached map keys were re-admitted exactly once, in-batch
    assert ckvs.n_write_through > wt0
    # warm reads after the drain still serve fresh bytes
    got = rs.get_version(v)[0]
    assert got[100 + 2] == _payload(2)
    w.close()


def test_compact_takes_drain_barrier():
    rs, _ = _store()
    rs.attach_flusher(max_staged_versions=10**9)
    root = _boot_root(rs)
    rs.barrier()
    w = rs.writer()
    v = root
    for i in range(4):
        v = w.commit([v], adds={i: _payload(50 + i)})
    rep = rs.compact(liveness_threshold=1.0)     # drains staged work first
    assert rs.flusher.staleness_lag == 0
    assert rep.mode in ("online", "noop", "rebuild")
    assert rs.get_version(v)[0][3] == _payload(53)
    w.close()


def test_build_takes_drain_barrier():
    rs, _ = _store()
    rs.attach_flusher(max_staged_versions=10**9)
    root = _boot_root(rs)
    w = rs.writer()
    v = w.commit([root], adds={100: _payload(1)})
    rs.build()
    assert rs.flusher.staleness_lag == 0
    assert rs.get_version(v)[0][100] == _payload(1)
    w.close()


def test_retain_takes_drain_barrier():
    rs, _ = _store()
    rs.attach_flusher(max_staged_versions=10**9)
    root = _boot_root(rs)
    w = rs.writer()
    v = root
    for i in range(5):
        v = w.commit([v], adds={100 + i: _payload(i)})
    retired = rs.retain(keep_last(2))
    assert rs.flusher.staleness_lag == 0
    assert retired and root in retired
    assert rs.get_version(v)[0][104] == _payload(4)
    w.close()


# ------------------------------------------------------- KVSStats integration
def test_flusher_counters_ride_stats_protocol():
    rs, kvs = _store()
    rs.attach_flusher(max_staged_versions=2)
    root = _boot_root(rs)
    w = rs.writer()
    v = root
    for i in range(5):
        v = w.commit([v], adds={100 + i: _payload(i)})
    w.close()
    rs.barrier()
    s = kvs.stats
    assert s.n_versions_staged == 6
    assert s.n_flush_batches >= 2
    assert s.max_observed_lag >= 2
    before = (s.n_flush_batches, s.n_versions_staged, s.max_observed_lag)
    snap = s.snapshot()
    s.reset()
    assert (s.n_flush_batches, s.n_versions_staged, s.max_observed_lag) == (0, 0, 0)
    s.restore(snap)
    assert (s.n_flush_batches, s.n_versions_staged, s.max_observed_lag) == before
    merged = KVSStats.merged([snap, snap])
    assert merged.n_flush_batches == 2 * before[0]
    assert merged.n_versions_staged == 2 * before[1]


def test_storage_stats_does_not_reset_flusher_counters():
    """Regression: metrics calls must not clobber the ingest counters (the
    snapshot/restore bookkeeping pattern other paths use)."""
    rs, kvs = _store()
    rs.attach_flusher(max_staged_versions=2)
    root = _boot_root(rs)
    w = rs.writer()
    for i in range(4):
        root = w.commit([root], adds={100 + i: _payload(i)})
    w.close()
    rs.barrier()
    s = kvs.stats
    before = (s.n_flush_batches, s.n_versions_staged, s.max_observed_lag)
    assert before[0] >= 2
    for _ in range(3):
        rs.storage_stats()
        rs.cache_stats()
    assert (s.n_flush_batches, s.n_versions_staged,
            s.max_observed_lag) == before
    # and a snapshot()'ed report reflects them, not zeros
    assert rs.storage_stats()["ingest"]["n_flush_batches"] == before[0]


# ------------------------------------------------------------ serve gateway
def test_ingest_gateway_multiplexes_clients():
    n_shards = 4
    rs, kvs = _store(n_shards=n_shards)
    gw = IngestGateway(rs, max_staged_versions=10**9)
    root = gw.init_root("alice", {pk: _payload(pk) for pk in range(8)})
    heads = {"alice": root, "bob": root, "carol": root}
    for step in range(4):
        for c in ("alice", "bob", "carol"):
            heads[c] = gw.commit(c, [heads[c]],
                                 adds={hash(c) % 1000 + step: _payload(step)})
    assert kvs.stats.n_put_queries == 0          # all staged
    assert sorted(gw.open_clients) == ["alice", "bob", "carol"]
    rep = gw.barrier()
    assert rep.n_versions == 13
    assert rep.write_round_trips <= n_shards
    r = gw.report()
    assert r["clients"] == {"alice": 5, "bob": 4, "carol": 4}
    assert r["ingest"]["staleness_lag"] == 0
    snap = gw.snapshot()
    for c, v in heads.items():
        assert snap.execute([Q.version(v)])[0].value  # all durable
    gw.close()
    assert rs.flusher is None
    gw.close()                                   # idempotent


def test_ingest_gateway_adopts_existing_flusher():
    rs, _ = _store()
    rs.attach_flusher(max_staged_versions=10**9)
    gw = IngestGateway(rs)
    assert gw.flusher is rs.flusher
    with pytest.raises(ValueError, match="would be ignored"):
        IngestGateway(rs, max_staged_versions=8)
