"""Write-path sessions and the sharded Backend protocol: group flushes must
cost one multiput per shard, the ShardedKVS router must be read/write
equivalent to a single InMemoryKVS, session misuse must be loud, and the
satellite fixes (empty-batch stats, device-KVS slot free list, incremental
stored_chunk_bytes) must hold."""
import numpy as np
import pytest
import torch

from repro_torch.core import Q, RStore, RStoreConfig
from repro_torch.core.kvs import InMemoryKVS, ShardedDeviceKVS, ShardedKVS


def _pay(rng, n=100):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _mixed_queries(vids, rng, n=32, n_keys=40):
    qs = []
    for i in range(n):
        v = vids[i % len(vids)]
        kind = i % 4
        if kind == 0:
            qs.append(Q.version(v))
        elif kind == 1:
            qs.append(Q.record(v, int(rng.integers(0, n_keys))))
        elif kind == 2:
            lo = int(rng.integers(0, n_keys))
            qs.append(Q.range(v, lo, lo + 10))
        else:
            qs.append(Q.evolution(int(rng.integers(0, n_keys))))
    return qs


def _session_workload(rs, rng, n_versions=64, n_keys=40):
    with rs.writer() as w:
        v = w.init_root({k: _pay(rng) for k in range(n_keys)})
        vids = [v]
        for i in range(n_versions - 1):
            v = w.commit([v], adds={int(rng.integers(0, n_keys)): _pay(rng),
                                    n_keys + i: _pay(rng)})
            vids.append(v)
    return vids


# ----------------------------------------------------------- group commits
def test_64_version_session_is_one_multiput_per_shard():
    """The acceptance criterion: a 64-version WriteSession flush on a
    4-shard ShardedKVS = exactly 4 backend write round trips."""
    rng = np.random.default_rng(0)
    kvs = ShardedKVS([InMemoryKVS() for _ in range(4)])
    rs = RStore(RStoreConfig(capacity=4096, batch_size=10**9), kvs=kvs, device="cpu")
    vids = _session_workload(rs, rng, n_versions=64)
    assert kvs.stats.n_put_queries == 4
    assert [s.stats.n_put_queries for s in kvs.shards] == [1, 1, 1, 1]
    # many more blobs than round trips moved through those 4 multiputs
    assert kvs.stats.n_values_put > 8

    # read sessions through the router: one round trip per shard touched
    snap = rs.snapshot()
    q0 = kvs.stats.n_queries
    res = snap.execute(_mixed_queries(vids, rng))
    read_rts = kvs.stats.n_queries - q0
    assert 1 <= read_rts <= 4
    assert res.batch.kvs_queries == read_rts


def test_single_backend_session_is_one_round_trip():
    rng = np.random.default_rng(1)
    kvs = InMemoryKVS()
    rs = RStore(RStoreConfig(capacity=4096, batch_size=10**9), kvs=kvs, device="cpu")
    _session_workload(rs, rng, n_versions=16)
    assert kvs.stats.n_put_queries == 1


def test_sharded_matches_inmemory_backend():
    """Identical workload through ShardedKVS(4) and InMemoryKVS must give
    byte-identical query results (routing is invisible to the engine)."""
    results = []
    for kvs in (InMemoryKVS(), ShardedKVS([InMemoryKVS() for _ in range(4)])):
        rng = np.random.default_rng(7)
        rs = RStore(RStoreConfig(capacity=1024, batch_size=5), kvs=kvs, device="cpu")
        v0 = rs.init_root({k: _pay(rng) for k in range(40)})
        v1 = rs.commit([v0], adds={3: _pay(rng), 40: _pay(rng)}, dels=[7])
        v2 = rs.commit([v0], adds={3: _pay(rng)}, dels=[2])
        v3 = rs.commit([v1, v2], adds={50: _pay(rng)})
        rs.flush()
        qs = _mixed_queries([v0, v1, v2, v3], np.random.default_rng(9))
        results.append([r.value for r in rs.snapshot().execute(qs)])
    assert results[0] == results[1]


def test_sharded_router_roundtrip_and_order():
    kvs = ShardedKVS([InMemoryKVS() for _ in range(3)])
    blobs = {f"k{i}": bytes([i]) * (i + 1) for i in range(30)}
    kvs.multiput(list(blobs.items()))
    assert kvs.multiget(list(blobs)) == list(blobs.values())
    assert all(k in kvs for k in blobs)
    assert "nope" not in kvs
    assert kvs.get("k3") == blobs["k3"]
    assert kvs.total_stored_bytes() == sum(len(v) for v in blobs.values())
    # keys actually spread over the shards
    assert sum(1 for s in kvs.shards if s.total_stored_bytes()) >= 2
    agg = kvs.aggregate_shard_stats()
    assert agg.n_values_put == 30


# ------------------------------------------------------------------ misuse
def test_commit_after_close_raises():
    rng = np.random.default_rng(2)
    rs = RStore(RStoreConfig(batch_size=10**9), device="cpu")
    w = rs.writer()
    w.init_root({0: _pay(rng)})
    w.close()
    with pytest.raises(RuntimeError, match="closed"):
        w.commit([0], adds={1: _pay(rng)})
    w.close()                                # idempotent


def test_overlapping_sessions_raise():
    rng = np.random.default_rng(3)
    rs = RStore(RStoreConfig(batch_size=10**9), device="cpu")
    w = rs.writer()
    with pytest.raises(RuntimeError, match="already open"):
        rs.writer()
    with pytest.raises(RuntimeError, match="already open"):
        rs.init_root({0: _pay(rng)})          # facade wrappers are sessions too
    w.close()
    rs.init_root({0: _pay(rng)})              # fine once closed


def test_session_exception_skips_flush():
    """If the with-body raises, nothing is flushed — staged versions stay
    pending and the next flush picks them up."""
    rng = np.random.default_rng(4)
    kvs = InMemoryKVS()
    rs = RStore(RStoreConfig(capacity=2048, batch_size=10**9), kvs=kvs, device="cpu")
    with pytest.raises(ZeroDivisionError):
        with rs.writer() as w:
            w.init_root({k: _pay(rng) for k in range(10)})
            raise ZeroDivisionError
    assert kvs.stats.n_put_queries == 0
    assert len(rs.pending) == 1
    rs.flush()
    assert kvs.stats.n_put_queries == 1
    assert len(rs.get_version(0)[0]) == 10


def test_read_during_open_session_raises():
    """snapshot()/get_* over versions an open session staged must raise —
    auto-flushing them would split the session's one group commit."""
    rng = np.random.default_rng(14)
    kvs = InMemoryKVS()
    rs = RStore(RStoreConfig(capacity=2048, batch_size=10**9), kvs=kvs, device="cpu")
    with rs.writer() as w:
        v0 = w.init_root({k: _pay(rng) for k in range(10)})
        with pytest.raises(RuntimeError, match="open WriteSession"):
            rs.get_version(v0)
        assert kvs.stats.n_put_queries == 0   # nothing leaked mid-session
    assert kvs.stats.n_put_queries == 1       # the close still group-flushed
    assert len(rs.get_version(v0)[0]) == 10
    # reading the *flushed* state while a writer is open stays legal
    with rs.writer() as w:
        snap = rs.snapshot()
        w.commit([v0], adds={50: _pay(rng)})
        assert len(snap.execute([Q.version(v0)])[0].value) == 10


def test_flush_and_build_during_open_session_raise():
    """Explicit flush()/build() mid-session are the one path that could
    split the group commit silently — they must raise like snapshot()."""
    rng = np.random.default_rng(16)
    kvs = InMemoryKVS()
    rs = RStore(RStoreConfig(capacity=2048, batch_size=10**9), kvs=kvs, device="cpu")
    with rs.writer() as w:
        w.init_root({k: _pay(rng) for k in range(10)})
        with pytest.raises(RuntimeError, match="group commit"):
            rs.flush()
        with pytest.raises(RuntimeError, match="group commit"):
            rs.build()
        assert kvs.stats.n_put_queries == 0
    assert kvs.stats.n_put_queries == 1       # close's own flush still runs


def test_facade_wrappers_keep_delta_store_batching():
    """rs.commit() is a one-commit session but must NOT flush per commit —
    the delta store still batches up to batch_size (seed behaviour)."""
    rng = np.random.default_rng(5)
    kvs = InMemoryKVS()
    rs = RStore(RStoreConfig(capacity=2048, batch_size=4), kvs=kvs, device="cpu")
    v = rs.init_root({k: _pay(rng) for k in range(10)})
    assert rs.pending and kvs.stats.n_put_queries == 0
    for i in range(3):
        v = rs.commit([v], adds={20 + i: _pay(rng)})
    assert not rs.pending                     # 4th staged version flushed
    assert kvs.stats.n_put_queries == 1       # ...as ONE group commit


# ------------------------------------------------- empty-batch stats (satellite)
@pytest.mark.parametrize("make", [
    InMemoryKVS,
    lambda: ShardedKVS([InMemoryKVS(), InMemoryKVS()]),
    lambda: ShardedDeviceKVS(slot_bytes=64, n_slots=8, device="cpu"),
])
def test_empty_batches_cost_zero_round_trips(make):
    kvs = make()
    assert kvs.multiget([]) == []
    kvs.multiput([])
    assert kvs.stats.n_queries == 0
    assert kvs.stats.n_put_queries == 0
    assert kvs.stats.n_values == 0 and kvs.stats.n_values_put == 0


def test_all_empty_plan_session_costs_zero_round_trips():
    rng = np.random.default_rng(6)
    kvs = InMemoryKVS()
    rs = RStore(RStoreConfig(capacity=2048, batch_size=4), kvs=kvs, device="cpu")
    rs.init_root({k: _pay(rng) for k in range(10)})
    rs.flush()
    snap = rs.snapshot()
    q0 = kvs.stats.n_queries
    res = snap.execute([Q.record(0, 999), Q.evolution(888)])
    assert kvs.stats.n_queries == q0
    assert res.batch.kvs_queries == 0


# ---------------------------------------------- device-KVS free list (satellite)
def test_device_kvs_relocation_reclaims_slots():
    kvs = ShardedDeviceKVS(slot_bytes=64, n_slots=8, device="cpu")
    kvs.put("a", b"x" * 60)                   # 1 slot
    kvs.put("b", b"y" * 130)                  # 3 slots (spanning)
    high = kvs.high_water_slots
    assert high == 4 and kvs.free_slots == 0
    kvs.put("a", b"x" * 200)                  # grows to 4 slots: relocates
    assert kvs.free_slots == 1                # old single slot reclaimed
    kvs.put("c", b"z" * 10)                   # first-fit reuses the hole
    assert kvs.free_slots == 0
    assert kvs.high_water_slots == high + 4   # no growth for c
    kvs.put("b", b"y" * 40)                   # shrink in place: frees tail
    assert kvs.free_slots == 2
    assert kvs.multiget(["a", "b", "c"]) == [b"x" * 200, b"y" * 40, b"z" * 10]


def test_device_kvs_overwrite_churn_does_not_leak():
    kvs = ShardedDeviceKVS(slot_bytes=64, n_slots=8, device="cpu")
    rng = np.random.default_rng(8)
    blobs = {}
    for step in range(120):
        key = f"k{step % 10}"
        blobs[key] = _pay(rng, int(rng.integers(1, 260)))
        kvs.put(key, blobs[key])
    assert kvs.multiget(list(blobs)) == list(blobs.values())
    # bounded: never more slots than worst-case live + reclaimable holes
    assert kvs.high_water_slots - kvs.free_slots <= 10 * 5


def test_device_kvs_growing_value_reuses_coalesced_extents():
    """A repeatedly-growing value must not strand its old extents: released
    neighbours coalesce (and trim the high-water mark), so the footprint
    stays near the live size instead of doubling per relocation."""
    kvs = ShardedDeviceKVS(slot_bytes=64, n_slots=4, device="cpu")
    for i in range(1, 30):
        kvs.put("g", b"x" * (64 * i))
    assert kvs.high_water_slots - kvs.free_slots == 29      # live slots only
    assert kvs.high_water_slots <= 2 * 29
    assert kvs.get("g") == b"x" * (64 * 29)


def test_device_kvs_multiput_one_round_trip():
    kvs = ShardedDeviceKVS(slot_bytes=64, n_slots=8, device="cpu")
    rng = np.random.default_rng(9)
    items = [(f"k{i}", _pay(rng, int(rng.integers(1, 200)))) for i in range(15)]
    kvs.multiput(items)
    assert kvs.stats.n_put_queries == 1
    assert kvs.stats.n_values_put == 15
    assert kvs.multiget([k for k, _ in items]) == [v for _, v in items]


# --------------------------------------------- mesh-aware shard placement
# The port places tables on a list of devices (``devices=``), not on a JAX
# mesh: table j lives on ``devices[j % len(devices)]``.  Four CPU devices
# stand in for the reference's 4 x 2 debug mesh.
def test_make_sharded_backend_mesh_placement():
    """Each shard's table must land on its own device; the store must stay
    exact through the device-sharded router."""
    from repro_torch.launch.mesh import make_sharded_backend

    devices = [torch.device("cpu")] * 4
    kvs = make_sharded_backend(n_shards=4, devices=devices, slot_bytes=1024,
                               n_slots=16)
    assert len(kvs.shards) == 4
    assert [s.device for s in kvs.shards] == devices

    rng = np.random.default_rng(13)
    rs = RStore(RStoreConfig(algorithm="depth_first", capacity=1024,
                             batch_size=10**9), kvs=kvs, device="cpu")
    vids = _session_workload(rs, rng, n_versions=8, n_keys=20)
    assert kvs.stats.n_put_queries == sum(
        1 for s in kvs.shards if s.stats.n_put_queries)
    for v in (vids[0], vids[-1]):
        got = rs.get_version(v)[0]
        m = rs.graph.members(v)
        keys = rs.graph.store.keys()
        assert got == {int(keys[r]): rs.graph.store.payload(int(r))
                       for r in m}


def test_make_sharded_backend_more_shards_than_devices():
    from repro_torch.launch.mesh import make_sharded_backend

    kvs = make_sharded_backend(n_shards=4, devices=["cpu", "cpu"],
                               slot_bytes=256, n_slots=4)
    assert len(kvs.shards) == 4
    items = [(f"k{i}", bytes([i]) * 40) for i in range(12)]
    kvs.multiput(items)
    assert kvs.multiget([k for k, _ in items]) == [v for _, v in items]


def test_make_sharded_backend_meshless():
    """One device for every shard (the reference's ``mesh=None``)."""
    from repro_torch.launch.mesh import make_sharded_backend

    kvs = make_sharded_backend(n_shards=3, devices=["cpu"], slot_bytes=256,
                               n_slots=4)
    kvs.multiput([("a", b"x" * 10), ("b", b"y" * 300)])
    assert kvs.multiget(["b", "a"]) == [b"y" * 300, b"x" * 10]


# ------------------------------------- incremental storage stats (satellite)
@pytest.mark.parametrize("k", [1, 3])
def test_stored_chunk_bytes_tracked_without_fetch(k):
    rng = np.random.default_rng(10)
    kvs = InMemoryKVS()
    rs = RStore(RStoreConfig(capacity=1024, batch_size=3, k=k), kvs=kvs, device="cpu")
    v = rs.init_root({kk: _pay(rng) for kk in range(30)})
    for i in range(5):
        v = rs.commit([v], adds={40 + i: _pay(rng)})
    rs.flush()
    q0 = kvs.stats.n_queries
    stats = rs.storage_stats()
    assert kvs.stats.n_queries == q0          # no sizing fetch
    actual = sum(len(kvs._d[f"chunk/{c}"]) for c in range(rs.n_chunks))
    assert stats["stored_chunk_bytes"] == actual


# ------------------------------------------------- checkpointer group commits
def test_checkpointer_commit_many_single_group_flush():
    from repro_torch.train.checkpoint import VersionedCheckpointer

    kvs = ShardedKVS([InMemoryKVS() for _ in range(4)])
    rs = RStore(RStoreConfig(capacity=1 << 16, batch_size=10**9), kvs=kvs, device="cpu")
    ck = VersionedCheckpointer(store=rs, block_bytes=512)
    rng = np.random.default_rng(12)
    states = [{"w": rng.normal(size=(32, 8)).astype(np.float32)}]
    for _ in range(3):
        states.append({"w": states[-1]["w"] + 1.0})
    vids = ck.commit_many(states)
    assert vids == [0, 1, 2, 3]
    # chain parentage: each version hangs off the previous one
    assert all(rs.graph.parents[v] == (v - 1,) for v in vids[1:])
    # the whole chain reached the backend as ONE multiput per shard touched
    assert all(s.stats.n_put_queries <= 1 for s in kvs.shards)
    assert kvs.stats.n_put_queries == sum(
        s.stats.n_put_queries for s in kvs.shards)
    # no-op: must not open a writer or flush pending state
    rts = kvs.stats.n_put_queries
    assert ck.commit_many([]) == []
    assert kvs.stats.n_put_queries == rts
    got = ck.restore(vids[-1])
    np.testing.assert_array_equal(got["w"], states[-1]["w"])


# ------------------------------------------------ columnar commit semantics
def test_merge_parents_sharing_exclusive_key_pull_once():
    """Two merge parents both exclusively holding a pk must contribute ONE
    live record (earlier parent wins) — the seed pulled both, creating a
    phantom duplicate that dels could not fully remove."""
    rng = np.random.default_rng(15)
    rs = RStore(RStoreConfig(capacity=2048, batch_size=10**9), device="cpu")
    v0 = rs.init_root({k: _pay(rng) for k in range(3)})
    p1 = _pay(rng)
    v1 = rs.commit([v0], adds={10: p1})
    v2 = rs.commit([v0], adds={10: _pay(rng)})
    v3 = rs.commit([v0, v1, v2], adds={})
    keys = rs.graph.store.keys()[rs.graph.members(v3)]
    assert sorted(keys.tolist()) == [0, 1, 2, 10]     # pk 10 exactly once
    assert rs.get_version(v3)[0][10] == p1            # earlier parent wins
    v4 = rs.commit([v3], adds={}, dels=[10])
    assert sorted(rs.get_version(v4)[0]) == [0, 1, 2]  # fully deleted


def test_columnar_commit_error_semantics_match_seed():
    rng = np.random.default_rng(11)
    rs = RStore(RStoreConfig(capacity=2048, batch_size=10**9), device="cpu")
    v0 = rs.init_root({k: _pay(rng) for k in range(10)})
    with pytest.raises(KeyError, match="absent"):
        rs.commit([v0], adds={}, dels=[999])
    with pytest.raises(ValueError, match="both added and deleted"):
        rs.commit([v0], adds={5: _pay(rng)}, dels=[5])
    with pytest.raises(ValueError, match="out of range"):
        rs.commit([v0], adds={-3: _pay(rng)})
    # failed wrapper commits must not wedge the writer slot
    v1 = rs.commit([v0], adds={10: _pay(rng)}, dels=[0])
    assert sorted(rs.get_version(v1)[0]) == list(range(1, 11))
