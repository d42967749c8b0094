"""End-to-end RStore behaviour: ingest → chunking → queries are *exact*
against the version-graph oracle, across algorithms, compression levels,
online batching, merges, and the sharded device KVS."""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.core import RStore, RStoreConfig, datagen
from repro_torch.core.index import varint_decode, varint_encode
from repro_torch.core.kvs import InMemoryKVS, ShardedDeviceKVS


def _pay(rng, n=100):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _oracle(rs, vid):
    m = rs.graph.members(vid)
    keys = rs.graph.store.keys()
    return {int(keys[r]): rs.graph.store.payload(int(r)) for r in m}


def _build_branched(rs, rng, n_keys=40):
    v0 = rs.init_root({k: _pay(rng) for k in range(n_keys)})
    v1 = rs.commit([v0], adds={3: _pay(rng), n_keys: _pay(rng)}, dels=[7])
    v2 = rs.commit([v0], adds={3: _pay(rng), n_keys + 1: _pay(rng)}, dels=[2])
    v3 = rs.commit([v1], adds={}, dels=[2])
    v4 = rs.commit([v2], adds={3: _pay(rng)})
    v5 = rs.commit([v3, v4], adds={n_keys + 10: _pay(rng)})
    return [v0, v1, v2, v3, v4, v5]


@pytest.mark.parametrize("algo", ["bottom_up", "shingle", "depth_first",
                                  "breadth_first"])
@pytest.mark.parametrize("k", [1, 3])
def test_queries_exact(algo, k):
    rng = np.random.default_rng(11)
    rs = RStore(RStoreConfig(algorithm=algo, capacity=1024, batch_size=4, k=k), device="cpu")
    vids = _build_branched(rs, rng)
    for v in vids:
        got, _ = rs.get_version(v)
        assert got == _oracle(rs, v)
    # point
    got, _ = rs.get_record(vids[3], 3)
    assert got == _oracle(rs, vids[3])[3]
    # range
    got, _ = rs.get_range(vids[4], 10, 20)
    assert got == {k_: v for k_, v in _oracle(rs, vids[4]).items() if 10 <= k_ <= 20}
    # evolution: one record per origin version of key 3
    evo, _ = rs.get_evolution(3)
    assert [o for o, _ in evo] == [0, 1, 2, 4]


def test_absent_record_returns_none():
    rng = np.random.default_rng(1)
    rs = RStore(RStoreConfig(batch_size=2), device="cpu")
    v0 = rs.init_root({1: _pay(rng), 2: _pay(rng)})
    v1 = rs.commit([v0], adds={}, dels=[2])
    got, _ = rs.get_record(v1, 2)
    assert got is None
    got, _ = rs.get_record(v1, 999)
    assert got is None


def test_online_batches_match_oracle_incrementally():
    """Many small batches: every flush keeps all past versions exact."""
    rng = np.random.default_rng(5)
    rs = RStore(RStoreConfig(algorithm="bottom_up", capacity=2048, batch_size=5), device="cpu")
    vid = rs.init_root({k: _pay(rng) for k in range(60)})
    history = [vid]
    for i in range(23):
        vid = rs.commit([vid], adds={int(rng.integers(0, 60)): _pay(rng),
                                     100 + i: _pay(rng)})
        history.append(vid)
        if i % 7 == 0:
            for v in history[:: max(1, len(history) // 4)]:
                got, _ = rs.get_version(v)
                assert got == _oracle(rs, v)
    for v in history:
        got, _ = rs.get_version(v)
        assert got == _oracle(rs, v)


def test_chunked_retrieval_uses_one_roundtrip_per_table():
    """The too-many-queries fix: Q1 costs O(1) KVS round-trips, not O(m)."""
    rng = np.random.default_rng(2)
    rs = RStore(RStoreConfig(algorithm="bottom_up", capacity=4096, batch_size=500), device="cpu")
    vid = rs.init_root({k: _pay(rng) for k in range(300)})
    rs.flush()
    _, stats = rs.get_version(vid)
    assert stats.kvs_queries <= 2          # chunks + maps, each one multiget
    assert stats.chunks_fetched >= 5


def test_sharded_device_kvs_backend():
    """Same exactness through the device-array KVS."""
    rng = np.random.default_rng(3)
    rs = RStore(RStoreConfig(algorithm="depth_first", capacity=1024,
                             batch_size=3),
                kvs=ShardedDeviceKVS(slot_bytes=2048, n_slots=64, device="cpu"), device="cpu")
    vids = _build_branched(rs, rng)
    for v in vids:
        got, _ = rs.get_version(v)
        assert got == _oracle(rs, v)


def test_sharded_kvs_roundtrip_and_spanning_slots():
    kvs = ShardedDeviceKVS(slot_bytes=64, n_slots=4, device="cpu")
    rng = np.random.default_rng(0)
    blobs = {f"k{i}": rng.integers(0, 256, int(rng.integers(1, 300)),
                                   dtype=np.uint8).tobytes() for i in range(20)}
    for k, v in blobs.items():
        kvs.put(k, v)
    got = kvs.multiget(list(blobs))
    assert got == list(blobs.values())
    assert kvs.stats.n_queries == 1


@given(st.lists(st.integers(0, 2**40), min_size=0, max_size=60))
def test_varint_roundtrip(xs):
    arr = np.asarray(sorted(xs), dtype=np.int64)
    np.testing.assert_array_equal(varint_decode(varint_encode(arr)), arr)


def test_index_compression_shrinks():
    g = datagen.generate(datagen.DatasetSpec(n_versions=100, n_base_records=500,
                                             pct_update=0.05, seed=6))
    from repro_torch.core.index import Projections
    from repro_torch.core.partition import BottomUpPartitioner
    part = BottomUpPartitioner().partition(g, 8192)
    proj = Projections.build(g, part)
    raw = proj.raw_size()
    comp = proj.compressed_size()
    assert comp["version_chunks_bytes"] < raw["version_chunks_bytes"] / 3


def test_compression_reduces_stored_bytes():
    """§3.4: with highly-similar payloads (small P_d), k>1 + delta encoding
    must store fewer bytes than k=1."""
    spec = datagen.DatasetSpec(n_versions=40, n_base_records=80, seed=7,
                               payloads=True, p_d=0.02, record_size=512,
                               pct_update=0.2, frac_modify=1.0,
                               frac_insert=0.0, frac_delete=0.0)

    def build(k):
        g = datagen.generate(spec)
        rs = RStore(RStoreConfig(algorithm="bottom_up", capacity=8192, k=k,
                                 batch_size=10**9), device="cpu")
        rs.graph = g
        rs._grow_r2c()
        rs.build()
        return rs

    s1 = build(1).storage_stats()["stored_chunk_bytes"]
    s5 = build(5).storage_stats()["stored_chunk_bytes"]
    assert s5 < s1 * 0.7


def test_storage_dedupe():
    """Records shared across versions are stored once (§2.2 requirement 1)."""
    rng = np.random.default_rng(8)
    rs = RStore(RStoreConfig(capacity=4096, batch_size=100), device="cpu")
    vid = rs.init_root({k: _pay(rng, 200) for k in range(100)})
    for i in range(10):                      # touch 1 record per version
        vid = rs.commit([vid], adds={0: _pay(rng, 200)})
    rs.flush()
    stats = rs.storage_stats()
    # logical data = 11 versions × 100 records; stored ≈ 110 unique records
    assert stats["raw_unique_bytes"] <= 200 * 111
    assert stats["stored_chunk_bytes"] < 1.5 * stats["raw_unique_bytes"]
