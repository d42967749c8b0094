"""Plan/execute session API: batched results must be byte-identical to the
sequential ``get_*`` wrappers, a whole mixed batch must cost exactly one KVS
round trip, and reads must not mutate store state."""
import numpy as np
import pytest

from repro_torch.core import Q, RStore, RStoreConfig
from repro_torch.core.api import Snapshot
from repro_torch.core.kvs import InMemoryKVS


def _pay(rng, n=100):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _build_branched(rs, rng, n_keys=40):
    v0 = rs.init_root({k: _pay(rng) for k in range(n_keys)})
    v1 = rs.commit([v0], adds={3: _pay(rng), n_keys: _pay(rng)}, dels=[7])
    v2 = rs.commit([v0], adds={3: _pay(rng), n_keys + 1: _pay(rng)}, dels=[2])
    v3 = rs.commit([v1], adds={}, dels=[2])
    v4 = rs.commit([v2], adds={3: _pay(rng)})
    v5 = rs.commit([v3, v4], adds={n_keys + 10: _pay(rng)})
    return [v0, v1, v2, v3, v4, v5]


def _mixed_queries(vids, rng, n=64, n_keys=40):
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


# ----------------------------------------------------------- equivalence
@pytest.mark.parametrize("algo", ["bottom_up", "shingle", "depth_first"])
@pytest.mark.parametrize("k", [1, 3])
def test_batched_equals_sequential(algo, k):
    """Batched execute across roots, deltas, merges, k>1 builds must match
    the per-query wrappers byte for byte."""
    rng = np.random.default_rng(11)
    rs = RStore(RStoreConfig(algorithm=algo, capacity=1024, batch_size=4, k=k), device="cpu")
    vids = _build_branched(rs, rng)
    qs = _mixed_queries(vids, rng)
    res = rs.snapshot().execute(qs)
    for q, r in zip(qs, res):
        if q.kind == "version":
            assert r.value == rs.get_version(q.vid)[0]
        elif q.kind == "record":
            assert r.value == rs.get_record(q.vid, q.pk)[0]
        elif q.kind == "range":
            assert r.value == rs.get_range(q.vid, q.key_lo, q.key_hi)[0]
        elif q.kind == "evolution":
            assert r.value == rs.get_evolution(q.pk)[0]


def test_multi_point_records_query():
    rng = np.random.default_rng(4)
    rs = RStore(RStoreConfig(capacity=1024, batch_size=4), device="cpu")
    vids = _build_branched(rs, rng)
    res = rs.snapshot().execute([Q.records(vids[5], [0, 3, 5, 7, 9999])])
    got = res[0].value
    expect = {}
    for pk in (0, 3, 5, 7, 9999):
        rec, _ = rs.get_record(vids[5], pk)
        if rec is not None:
            expect[pk] = rec
    assert got == expect
    assert 9999 not in got          # absent keys omitted, not None-valued


# --------------------------------------------------------- round trips
def test_64_query_batch_is_one_kvs_round_trip():
    """The acceptance criterion: 64 mixed queries → exactly 1 InMemoryKVS
    round trip (the sequential path pays ≥ 1 per query; the seed paid 2)."""
    rng = np.random.default_rng(2)
    kvs = InMemoryKVS()
    rs = RStore(RStoreConfig(algorithm="bottom_up", capacity=2048,
                             batch_size=8), kvs=kvs, device="cpu")
    vids = _build_branched(rs, rng)
    rs.flush()
    snap = rs.snapshot()
    qs = _mixed_queries(vids, rng, n=64)

    q0 = kvs.stats.n_queries
    res = snap.execute(qs)
    assert kvs.stats.n_queries - q0 == 1
    assert res.batch.kvs_queries == 1
    assert len(res) == 64

    # sequential single-query sessions: one round trip each
    q0 = kvs.stats.n_queries
    for q in qs:
        snap.execute([q])
    assert kvs.stats.n_queries - q0 >= 64


def test_batch_stats_attribute_shared_bytes_once():
    rng = np.random.default_rng(3)
    kvs = InMemoryKVS()
    rs = RStore(RStoreConfig(capacity=2048, batch_size=8), kvs=kvs, device="cpu")
    vids = _build_branched(rs, rng)
    rs.flush()
    # same Q1 five times: candidates identical, fetched once
    b0 = kvs.stats.bytes_fetched
    res = rs.snapshot().execute([Q.version(vids[0])] * 5)
    fetched = kvs.stats.bytes_fetched - b0
    assert res.batch.bytes_fetched == fetched
    # per-query stats each see the full candidate bytes (attribution),
    # but the backend only moved them once
    assert res[0].stats.bytes_fetched == fetched
    assert sum(r.stats.bytes_fetched for r in res) == 5 * fetched
    assert all(r.value == res[0].value for r in res)


def test_empty_batch_and_empty_candidates():
    rng = np.random.default_rng(5)
    kvs = InMemoryKVS()
    rs = RStore(RStoreConfig(capacity=2048, batch_size=8), kvs=kvs, device="cpu")
    vids = _build_branched(rs, rng)
    rs.flush()
    snap = rs.snapshot()
    assert list(snap.execute([])) == []
    q0 = kvs.stats.n_queries
    res = snap.execute([Q.record(vids[0], 12345), Q.evolution(54321)])
    assert kvs.stats.n_queries == q0      # nothing to fetch → 0 round trips
    assert res[0].value is None
    assert res[1].value == []


# ----------------------------------------------------- snapshot semantics
def test_snapshot_reads_do_not_flush_with_auto_flush_off():
    rng = np.random.default_rng(6)
    rs = RStore(RStoreConfig(capacity=2048, batch_size=100, auto_flush=False), device="cpu")
    v0 = rs.init_root({k: _pay(rng) for k in range(20)})
    with pytest.raises(RuntimeError):
        rs.snapshot()                     # unflushed deltas must not flush
    assert rs.pending                     # ...and must still be pending
    rs.flush()
    snap = rs.snapshot()
    v1 = rs.commit([v0], adds={0: _pay(rng)})
    got = snap.execute([Q.version(v0)])[0].value
    assert set(got) == set(range(20))
    assert rs.pending == [v1]             # the read did not flush v1
    with pytest.raises(RuntimeError):
        rs.get_version(v1)                # wrappers refuse too


def test_snapshot_invalidated_by_full_rebuild():
    """A full build() repartitions chunk storage; a snapshot from before
    must fail loudly rather than read rewritten chunks against stale ids."""
    rng = np.random.default_rng(12)
    rs = RStore(RStoreConfig(capacity=512, batch_size=100, k=3), device="cpu")
    v0 = rs.init_root({k: _pay(rng) for k in range(30)})
    rs.flush()
    snap = rs.snapshot()
    assert len(snap.execute([Q.version(v0)])[0].value) == 30
    rs.commit([v0], adds={0: _pay(rng)})
    rs.get_version(v0)                    # k>1: auto-flush → full rebuild
    with pytest.raises(RuntimeError, match="rebuild"):
        snap.execute([Q.version(v0)])
    assert len(rs.snapshot().execute([Q.version(v0)])[0].value) == 30


def test_snapshot_survives_online_flush():
    """k=1 online flushes only append chunks — old snapshots stay valid."""
    rng = np.random.default_rng(13)
    rs = RStore(RStoreConfig(capacity=2048, batch_size=1), device="cpu")
    v0 = rs.init_root({k: _pay(rng) for k in range(20)})
    snap = rs.snapshot()
    for i in range(5):
        rs.commit([v0], adds={100 + i: _pay(rng)})   # batch_size=1: flushes
    got = snap.execute([Q.version(v0)])[0].value
    assert set(got) == set(range(20))


def test_auto_flush_wrappers_keep_seed_behaviour():
    rng = np.random.default_rng(7)
    rs = RStore(RStoreConfig(capacity=2048, batch_size=100), device="cpu")   # auto_flush=True
    v0 = rs.init_root({k: _pay(rng) for k in range(20)})
    got, stats = rs.get_version(v0)       # implicit flush, like the seed
    assert len(got) == 20
    assert not rs.pending
    assert stats.kvs_queries == 1         # single interleaved multiget now


# -------------------------------------------------------------- satellites
def test_storage_stats_does_not_reset_kvs_counters():
    rng = np.random.default_rng(8)
    kvs = InMemoryKVS()
    rs = RStore(RStoreConfig(capacity=2048, batch_size=8), kvs=kvs, device="cpu")
    vids = _build_branched(rs, rng)
    rs.flush()
    rs.get_version(vids[0])
    before = kvs.stats.snapshot()
    assert before.n_queries > 0
    stats = rs.storage_stats()
    assert stats["stored_chunk_bytes"] > 0
    after = kvs.stats
    assert after.n_queries == before.n_queries        # not polluted
    assert after.bytes_fetched == before.bytes_fetched  # not reset


def test_candidates_range_sorted_lookup_matches_scan():
    rng = np.random.default_rng(9)
    rs = RStore(RStoreConfig(capacity=1024, batch_size=4), device="cpu")
    vids = _build_branched(rs, rng, n_keys=60)
    rs.flush()
    proj = rs.proj
    for lo, hi in [(0, 5), (10, 40), (59, 61), (100, 200), (-5, 2)]:
        expect = sorted(pk for pk in proj.key_chunks if lo <= pk <= hi)
        got = proj.keys_in_range(lo, hi).tolist()
        assert got == expect
        want = proj.candidates(vids[0], expect, device="cpu")
        have = proj.candidates_range(vids[0], lo, hi, device="cpu")
        np.testing.assert_array_equal(want, have)


def test_candidates_batch_matches_single():
    rng = np.random.default_rng(10)
    rs = RStore(RStoreConfig(capacity=1024, batch_size=4), device="cpu")
    vids = _build_branched(rs, rng)
    rs.flush()
    proj = rs.proj
    items = [(vids[i % len(vids)], [int(rng.integers(0, 45))])
             for i in range(10)]
    batch = proj.candidates_batch(items, device="cpu")
    for (vid, pks), ids in zip(items, batch):
        np.testing.assert_array_equal(ids, proj.candidates(vid, pks, device="cpu"))
