"""Chunk cache subsystem: segmented-LRU eviction, cost-model admission,
write-through/delete coherence, layout-epoch invalidation, cache-aware read
path (0 round trips warm), evolution prefetch, and stats wiring."""
import numpy as np
import pytest

from repro_torch.core import (CachingKVS, InMemoryKVS, KVSStats, Q, RStore,
                              RStoreConfig, ShardedKVS, keep_last)
from repro_torch.core.cache import ENTRY_OVERHEAD
from repro_torch.core.costmodel import fetch_seconds
from repro_torch.core.replica import FaultInjectingKVS, ReplicatedKVS


def _cache(cache_bytes=1 << 16, **kw):
    inner = InMemoryKVS()
    return CachingKVS(inner, cache_bytes=cache_bytes, **kw), inner


# -------------------------------------------------------------- empty batches
def test_empty_batch_guard_no_round_trip_no_stats():
    """The empty-batch convention: empty multiget/multiput/multidelete are
    free — no backend call, stats untouched."""
    c, inner = _cache()
    assert c.multiget([]) == []
    c.multiput([])
    c.multidelete([])
    for f in KVSStats._FIELDS:
        assert getattr(c.stats, f) == 0
        assert getattr(inner.stats, f) == 0


# ------------------------------------------------------------ hit/miss basics
def test_miss_then_hit_round_trip_accounting():
    c, inner = _cache()
    inner.put("k", b"hello")
    inner.stats.reset()

    assert c.get("k") == b"hello"              # cold: 1 inner round trip
    assert (c.stats.n_queries, c.stats.n_cache_misses) == (1, 1)
    assert c.stats.n_cache_hits == 0

    assert c.get("k") == b"hello"              # warm: 0 inner round trips
    assert c.stats.n_queries == 1              # unchanged
    assert c.stats.n_cache_hits == 1
    assert c.stats.bytes_served_from_cache == len(b"hello")


def test_partial_hit_issues_one_multiget_for_misses_only():
    c, inner = _cache()
    inner.multiput([(f"k{i}", bytes([i]) * 8) for i in range(6)])
    inner.stats.reset()
    c.multiget(["k0", "k1", "k2"])             # warm 3 of 6
    q0, v0 = c.stats.n_queries, inner.stats.n_values
    got = c.multiget([f"k{i}" for i in range(6)])
    assert got == [bytes([i]) * 8 for i in range(6)]   # order preserved
    assert c.stats.n_queries - q0 == 1         # ONE fetch for the misses
    assert inner.stats.n_values - v0 == 3      # only k3..k5 crossed the wire


def test_missing_key_raises_data_level_keyerror():
    c, _ = _cache()
    with pytest.raises(KeyError) as ei:
        c.multiget(["gone/7"])
    assert "gone/7" in str(ei.value)


# ------------------------------------------------------------- coherence
def test_write_through_updates_cached_entry():
    c, inner = _cache()
    c.put("k", b"old")
    assert c.get("k") == b"old"                # cached now
    c.put("k", b"new")                         # write-through
    q0 = c.stats.n_queries
    assert c.get("k") == b"new"                # served fresh, from cache
    assert c.stats.n_queries == q0
    assert inner.get("k") == b"new"


def test_multidelete_invalidates_before_forwarding():
    c, inner = _cache()
    c.put("k", b"v")
    c.get("k")
    c.multidelete(["k"])
    assert "k" not in inner._d
    with pytest.raises(KeyError):              # not served from a stale cache
        c.get("k")


def test_writes_do_not_pollute_read_cache():
    """multiput of previously-uncached keys must not admit them — the cache
    holds what was *read*, not everything ever written."""
    c, _ = _cache()
    c.multiput([(f"w{i}", b"x" * 32) for i in range(10)])
    assert c.n_entries == 0
    c.get("w3")                                # reading it admits it
    assert c.n_entries == 1


def test_layout_epoch_hook_invalidates_touched_and_all():
    c, inner = _cache()
    inner.multiput([("a", b"1"), ("b", b"2"), ("c", b"3")])
    c.multiget(["a", "b", "c"])
    c.on_layout_epoch(1, ["a", "b"])
    assert c.layout_epoch == 1
    assert c.n_entries == 1                    # only "c" survives
    c.on_layout_epoch(2)                       # None -> flush everything
    assert c.n_entries == 0 and c.cached_bytes == 0


def test_contains_checks_cache_then_inner():
    c, inner = _cache()
    inner.put("k", b"v")
    assert "k" in c and "nope" not in c
    c.get("k")
    assert "k" in c


def test_scan_forwards_without_admitting():
    c, inner = _cache()
    inner.multiput([(f"k{i}", bytes([i])) for i in range(5)])
    assert dict(c.scan()) == dict(inner.scan())
    assert c.n_entries == 0                    # a scan must not flush the hot set


# --------------------------------------------------- budget / eviction / SLRU
def test_budget_never_exceeded_and_lru_evicts():
    val = b"x" * 100
    charge = len(val) + 2 + ENTRY_OVERHEAD     # 2-char keys
    c, inner = _cache(cache_bytes=charge * 4, always_admit_bytes=1 << 20)
    inner.multiput([(f"k{i}", val) for i in range(10)])
    for i in range(10):
        c.get(f"k{i}")
        assert c.cached_bytes <= c.cache_bytes
    assert c.n_entries == 4
    assert c.n_evictions == 6
    # the survivors are the most recently touched
    q0 = c.stats.n_queries
    c.multiget(["k6", "k7", "k8", "k9"])
    assert c.stats.n_queries == q0


def test_probation_promotion_protects_rereferenced_entries():
    """SLRU: one re-reference promotes to protected, so a scan of cold keys
    can't evict the hot set (probation is evicted first)."""
    val = b"x" * 100
    charge = len(val) + 2 + ENTRY_OVERHEAD
    c, inner = _cache(cache_bytes=charge * 4, always_admit_bytes=1 << 20)
    inner.multiput([(f"k{i}", val) for i in range(8)])
    c.multiget(["k0", "k1"])
    c.multiget(["k0", "k1"])                   # promote to protected
    rep = c.cache_report()
    assert rep["n_protected"] == 2
    c.multiget(["k2", "k3", "k4", "k5"])       # cold wave through probation
    q0 = c.stats.n_queries
    c.multiget(["k0", "k1"])                   # hot pair survived the wave
    assert c.stats.n_queries == q0


def test_protected_segment_demotes_over_share():
    val = b"x" * 100
    charge = len(val) + 2 + ENTRY_OVERHEAD
    c, inner = _cache(cache_bytes=charge * 10, protected_frac=0.3,
                      always_admit_bytes=1 << 20)
    inner.multiput([(f"k{i}", val) for i in range(10)])
    for i in range(10):
        c.get(f"k{i}")
        c.get(f"k{i}")                         # promote every entry
    rep = c.cache_report()
    # protected obeys its share of the budget; the rest demoted to probation
    assert rep["n_protected"] <= 3
    assert rep["n_probation"] + rep["n_protected"] == c.n_entries
    assert c.cached_bytes <= c.cache_bytes


# ----------------------------------------------------- cost-model admission
def test_admission_rejects_cold_big_chunk_over_hot_small_ones():
    """Forced eviction: one big chunk must NOT displace many small ones —
    per-query overhead makes the small set's re-fetch cost dominate."""
    small = b"s" * 200                         # re-fetch ≈ per_query_s each
    c, inner = _cache(cache_bytes=6000, always_admit_bytes=100)
    inner.multiput([(f"k{i}", small) for i in range(20)])
    inner.put("big", b"B" * 5000)
    for i in range(20):                        # fill the budget with small hot
        c.get(f"k{i}")
    n0 = c.n_entries
    assert c.get("big") == b"B" * 5000         # served, but...
    assert c.n_admit_rejected >= 1             # ...not admitted
    assert c.n_entries == n0
    # the cost model agrees: one 5000 B fetch is cheaper than re-fetching
    # the ~19 victims it would displace
    assert fetch_seconds(1, 5000) < 19 * fetch_seconds(1, 200)


def test_admission_accepts_when_refetch_cost_beats_victims():
    """A big chunk whose transfer time dwarfs the single tiny victim's
    re-fetch cost IS admitted."""
    c, inner = _cache(cache_bytes=1 << 20, always_admit_bytes=100)
    inner.put("tiny", b"t" * 150)
    inner.put("big", b"B" * ((1 << 20) - 200))
    c.get("tiny")
    c.get("big")                               # evicts tiny, admitted
    assert c.n_entries == 1
    q0 = c.stats.n_queries
    c.get("big")
    assert c.stats.n_queries == q0


def test_tiny_blobs_always_admitted():
    """Chunk-map-sized blobs bypass the admission comparison."""
    c, inner = _cache(cache_bytes=4096, always_admit_bytes=512)
    inner.multiput([("big0", b"B" * 1800), ("big1", b"B" * 1800),
                    ("map", b"m" * 300)])
    c.get("big0")
    c.get("big1")                              # budget now nearly full
    c.get("map")                               # tiny: admitted regardless
    q0 = c.stats.n_queries
    c.get("map")
    assert c.stats.n_queries == q0
    assert c.n_admit_rejected == 0


def test_value_larger_than_budget_never_admitted():
    c, inner = _cache(cache_bytes=256)
    inner.put("huge", b"H" * 1024)
    assert c.get("huge") == b"H" * 1024
    assert c.n_entries == 0 and c.n_admit_rejected == 1


# ----------------------------------------------------- RStore integration
def _store(cached=True, cache_bytes=8 << 20, n_shards=4):
    inner = ShardedKVS([InMemoryKVS() for _ in range(n_shards)])
    kvs = CachingKVS(inner, cache_bytes=cache_bytes) if cached else inner
    rs = RStore(RStoreConfig(algorithm="bottom_up", capacity=1024,
                             batch_size=4), kvs=kvs, device="cpu")
    return rs, kvs


def _drive(rs, seed=5, n_commits=10):
    rng = np.random.default_rng(seed)

    def pay():
        return rng.integers(0, 256, 64, dtype=np.uint8).tobytes()

    vids = [rs.init_root({pk: pay() for pk in range(16)})]
    for _ in range(n_commits):
        adds = {int(k): pay() for k in rng.integers(0, 32, 6)}
        vids.append(rs.commit([vids[-1]], adds=adds))
    rs.flush()
    return vids


def test_warm_execute_zero_round_trips_byte_identical():
    rs, kvs = _store(cached=True)
    rs0, _ = _store(cached=False)
    vids, vids0 = _drive(rs), _drive(rs0)
    assert vids == vids0
    qs = [Q.version(vids[-1]), Q.record(vids[-1], 3),
          Q.range(vids[-1], 0, 15), Q.evolution(3)]
    snap, snap0 = rs.snapshot(), rs0.snapshot()
    cold, ref = snap.execute(qs), snap0.execute(qs)
    assert cold.batch.kvs_queries == ref.batch.kvs_queries   # cold == uncached
    warm = snap.execute(qs)
    assert warm.batch.kvs_queries == 0                       # fully warm
    assert warm.batch.cache_hits > 0
    assert warm.batch.bytes_from_cache > 0
    assert [r.value for r in warm] == [r.value for r in ref]


def test_prefetch_evolution_warms_exactly_what_the_query_needs():
    rs, kvs = _store(cached=True)
    _drive(rs)
    snap = rs.snapshot()
    rep = snap.prefetch_evolution(3)
    assert rep["cache"] == 1 and rep["warmed_keys"] > 0
    res = snap.execute([Q.evolution(3)])
    assert res.batch.kvs_queries == 0          # lineage fully warmed
    # uncached snapshot reports a no-op instead of failing
    rs0, _ = _store(cached=False)
    _drive(rs0)
    assert rs0.snapshot().prefetch_evolution(3)["cache"] == 0


def test_compaction_invalidates_cache_and_results_stay_identical():
    rs, kvs = _store(cached=True)
    rs0, _ = _store(cached=False)
    vids, _ = _drive(rs), _drive(rs0)
    keep = vids[-4:]
    snap = rs.snapshot()
    snap.execute([Q.version(v) for v in keep])  # warm the cache
    for store in (rs, rs0):
        store.retain(keep_last(4))
        store.compact()
    assert kvs.layout_epoch > 0                # hook fired
    a = rs.snapshot().execute([Q.version(v) for v in keep])
    b = rs0.snapshot().execute([Q.version(v) for v in keep])
    assert [r.value for r in a] == [r.value for r in b]


def test_cache_stats_and_storage_stats_report():
    rs, kvs = _store(cached=True)
    vids = _drive(rs)
    assert rs.cache_stats()["n_cache_misses"] == 0
    rs.get_version(vids[-1])
    rs.get_version(vids[-1])
    rep = rs.cache_stats()
    assert rep["n_cache_hits"] > 0 and 0 < rep["hit_rate"] < 1
    assert rep["cached_bytes"] <= rep["cache_bytes"]
    assert rs.storage_stats()["cache"]["n_cache_hits"] == rep["n_cache_hits"]
    # uncached store: no cache section, cache_stats() is None
    rs0, _ = _store(cached=False)
    _drive(rs0)
    assert rs0.cache_stats() is None
    assert "cache" not in rs0.storage_stats()


def test_cache_over_replicated_backend_survives_replica_death():
    groups = [ReplicatedKVS([FaultInjectingKVS(InMemoryKVS(), seed=i * 2 + r)
                             for r in range(2)], write_quorum=1)
              for i in range(2)]
    kvs = CachingKVS(ShardedKVS(groups), cache_bytes=8 << 20)
    rs = RStore(RStoreConfig(capacity=1024, batch_size=4), kvs=kvs,
                device="cpu")
    rs0, _ = _store(cached=False, n_shards=2)
    vids, _ = _drive(rs), _drive(rs0)
    for g in groups:
        g.replicas[0].kill()
    got, _ = rs.get_version(vids[-1])
    want, _ = rs0.get_version(vids[-1])
    assert got == want                         # failover below the cache
    warm, _ = rs.get_version(vids[-1])
    assert warm == want


def test_make_sharded_backend_cache_bytes_wiring():
    from repro_torch.launch.mesh import make_sharded_backend

    kvs = make_sharded_backend(n_shards=2, cache_bytes=1 << 20,
                               cache_kw={"always_admit_bytes": 256},
                               devices=["cpu"])
    assert getattr(kvs, "is_cache", False)
    assert kvs.cache_bytes == 1 << 20 and kvs.always_admit_bytes == 256
    kvs.multiput([(f"k{i}", bytes([i]) * 16) for i in range(8)])
    assert kvs.multiget(["k3", "k6"]) == [b"\x03" * 16, b"\x06" * 16]
    q0 = kvs.stats.n_queries
    kvs.multiget(["k3", "k6"])                 # warm now
    assert kvs.stats.n_queries == q0
    # default stays uncached (back-compat)
    plain = make_sharded_backend(n_shards=2, devices=["cpu"])
    assert not getattr(plain, "is_cache", False)
