"""Unified query planner: plan IR validation, composite predicate pushdown
(one fused bitmap-VM launch + one interleaved multiget per batch), index-only
and metadata-only aggregates at zero chunk-payload fetches, plan-time
refusal of retired versions, batch-wide leaf dedupe, and explain()."""
import numpy as np
import pytest

from repro_torch.core import (InMemoryKVS, Q, RStore, RStoreConfig, ShardedKVS,
                              keep_last, struct_extractor)
from repro_torch.kernels import ops

N_SHARDS = 4
EXT = struct_extractor({"color": (0, 1), "size": (1, 1)})


def _mk(pk: int, color: int, size: int = 0) -> bytes:
    return bytes([color, size % 251]) + bytes([pk % 251]) * 24


def _make_store(**cfg_kw):
    kvs = ShardedKVS([InMemoryKVS() for _ in range(N_SHARDS)])
    rs = RStore(RStoreConfig(capacity=1 << 9, batch_size=4, **cfg_kw), kvs=kvs, device="cpu")
    rs.create_index("color", EXT)
    rs.create_index("size", EXT)
    return rs


def _ingest(rs, n_pks=60, n_versions=6):
    vids = []
    with rs.writer() as w:
        v = w.init_root({pk: _mk(pk, pk % 5, pk % 11) for pk in range(n_pks)})
        vids.append(v)
        for i in range(n_versions):
            v = w.commit([v], adds={pk: _mk(pk, (pk + i) % 5, (pk + i) % 11)
                                    for pk in range(i, n_pks, 7)})
            vids.append(v)
    return vids


def _oracle(snap, vid, pred):
    full = snap.execute([Q.version(vid)])[0].value
    return {pk: p for pk, p in full.items() if pred(EXT(p))}


@pytest.fixture()
def store():
    rs = _make_store()
    vids = _ingest(rs)
    return rs, vids, rs.snapshot()


# --------------------------------------------------------- composite results
def test_and_matches_two_session_intersection_byte_identical(store):
    rs, vids, snap = store
    v = vids[-1]
    comp = Q.and_(Q.where(v, "color", 2), Q.where_range(v, "size", 3, 7))
    got = snap.execute([comp])[0].value
    a = snap.execute([Q.where(v, "color", 2)])[0].value
    b = snap.execute([Q.where_range(v, "size", 3, 7)])[0].value
    want = {pk: p for pk, p in a.items() if pk in b and b[pk] == p}
    assert got == want
    assert got == _oracle(snap, v, lambda f: f["color"] == 2
                          and 3 <= f["size"] <= 7)
    assert got                                  # non-vacuous


def test_composite_and_is_one_launch_one_multiget(store):
    rs, vids, snap = store
    v = vids[-1]
    comp = Q.and_(Q.where(v, "color", 1), Q.where_range(v, "size", 2, 9))
    launches0 = ops.BITMAP_LAUNCHES
    res = snap.execute([comp])
    assert ops.BITMAP_LAUNCHES - launches0 == 1
    # one interleaved multiget => at most one round trip per shard
    assert 1 <= res.batch.kvs_queries <= N_SHARDS


def test_or_and_not_match_oracle(store):
    rs, vids, snap = store
    v = vids[-2]
    got_or = snap.execute([Q.or_(Q.where(v, "color", 0),
                                 Q.where(v, "color", 3))])[0].value
    assert got_or == _oracle(snap, v, lambda f: f["color"] in (0, 3))
    got_not = snap.execute(
        [Q.and_(Q.version(v), Q.not_(Q.where(v, "color", 0)))])[0].value
    assert got_not == _oracle(snap, v, lambda f: f["color"] != 0)
    assert got_or and got_not


def test_nested_composite_with_pk_predicates(store):
    rs, vids, snap = store
    v = vids[-1]
    comp = Q.and_(Q.range(v, 10, 40),
                  Q.or_(Q.where(v, "color", 2),
                        Q.and_(Q.where(v, "color", 4),
                               Q.not_(Q.records(v, [12, 19])))))
    got = snap.execute([comp])[0].value
    full = snap.execute([Q.version(v)])[0].value
    want = {pk: p for pk, p in full.items()
            if 10 <= pk <= 40 and (EXT(p)["color"] == 2 or
                                   (EXT(p)["color"] == 4
                                    and pk not in (12, 19)))}
    assert got == want and got


# -------------------------------------------------------------- construction
def test_composite_rejects_mixed_versions(store):
    rs, vids, snap = store
    with pytest.raises(ValueError, match="share one version"):
        Q.and_(Q.where(vids[0], "color", 1), Q.where(vids[1], "color", 1))


def test_composite_rejects_evolution_and_arity():
    with pytest.raises(ValueError, match="predicate"):
        Q.and_(Q.evolution(3), Q.evolution(4))
    with pytest.raises(ValueError, match="at least 2"):
        Q.and_(Q.version(0))
    with pytest.raises(ValueError, match="predicate"):
        Q.count(Q.evolution(3))


def test_retired_version_refused_at_plan_time(store):
    rs, vids, snap = store
    rs.retain(keep_last(2))
    snap = rs.snapshot()
    dead, live = vids[0], vids[-1]
    with pytest.raises(KeyError, match="retired"):
        snap.plan_batch([Q.and_(Q.where(dead, "color", 1),
                                Q.where(dead, "color", 2))])
    with pytest.raises(KeyError, match="retired"):
        snap.plan_batch([Q.count(Q.version(dead))])
    assert snap.execute([Q.version(live)])[0].value   # live ones still fine


def test_where_without_index_raises_at_plan_time(store):
    rs, vids, snap = store
    with pytest.raises(KeyError, match="weight"):
        snap.plan_batch([Q.distinct(vids[-1], "weight")])


# ------------------------------------------------------ index-only aggregates
def test_count_exists_distinct_zero_payload_fetches(store):
    rs, vids, snap = store
    v = vids[-1]
    full = snap.execute([Q.version(v)])[0].value
    res = snap.execute([Q.count(Q.where(v, "color", 2)),
                        Q.exists(Q.where(v, "color", 2)),
                        Q.exists(Q.where(v, "color", 200)),
                        Q.distinct(v, "color")])
    assert res[0].value == sum(1 for p in full.values()
                               if EXT(p)["color"] == 2) > 0
    assert res[1].value is True
    assert res[2].value is False
    assert res[3].value == sorted({EXT(p)["color"] for p in full.values()})
    for r in res:
        assert r.stats.payload_round_trips == 0, r.stats
        assert r.stats.payload_chunks_fetched == 0, r.stats
    assert res.batch.payload_round_trips == 0


def test_count_composite_index_only(store):
    rs, vids, snap = store
    v = vids[-1]
    full = snap.execute([Q.version(v)])[0].value
    q = Q.count(Q.and_(Q.where(v, "color", 1), Q.where_range(v, "size", 0, 5)))
    r = snap.execute([q])
    assert r[0].value == sum(1 for p in full.values()
                             if EXT(p)["color"] == 1 and EXT(p)["size"] <= 5)
    assert r.batch.payload_round_trips == 0


def test_metadata_count_costs_zero_kvs_queries(store):
    rs, vids, snap = store
    v = vids[-1]
    full = snap.execute([Q.version(v)])[0].value
    res = snap.execute([Q.count(Q.version(v)),
                        Q.count(Q.range(v, 5, 25)),
                        Q.exists(Q.records(v, [3, 9]))])
    assert res[0].value == len(full)
    assert res[1].value == sum(1 for pk in full if 5 <= pk <= 25)
    assert res[2].value is True
    assert res.batch.kvs_queries == 0
    assert res.batch.chunks_fetched == 0


# ------------------------------------------------------------- batch behavior
def test_batch_shares_one_launch_and_dedupes_leaves(store):
    rs, vids, snap = store
    v = vids[-1]
    shared = Q.where(v, "color", 2)
    launches0 = ops.BITMAP_LAUNCHES
    res = snap.execute([shared,
                        Q.and_(shared, Q.where_range(v, "size", 3, 7)),
                        Q.count(shared),
                        Q.version(v)])
    assert ops.BITMAP_LAUNCHES - launches0 == 1
    assert res.batch.kvs_queries <= N_SHARDS
    # the dedup'd fetch never pulls a chunk twice: batch total == union
    pqs = snap.plan_batch([shared, Q.and_(shared,
                                          Q.where_range(v, "size", 3, 7)),
                           Q.version(v)])
    union = np.unique(np.concatenate([pq.cand for pq in pqs]))
    assert res.batch.payload_chunks_fetched <= len(union)
    assert res[0].value == _oracle(snap, v, lambda f: f["color"] == 2)


def test_plan_backcompat_returns_candidate_arrays(store):
    rs, vids, snap = store
    v = vids[-1]
    plans = snap.plan([Q.version(v), Q.where(v, "color", 1)])
    assert isinstance(plans, list) and len(plans) == 2
    for cand in plans:
        assert isinstance(cand, np.ndarray)
    assert len(plans[1]) <= len(plans[0])


def test_normalize_flattens_and_cancels_double_negation(store):
    rs, vids, snap = store
    v = vids[-1]
    a, b = Q.where(v, "color", 1), Q.where(v, "color", 2)
    nested = Q.or_(Q.or_(a, b), Q.not_(Q.not_(a)))
    got = snap.execute([nested])[0].value
    assert got == snap.execute([Q.or_(a, b)])[0].value


def test_legacy_kinds_still_route_through_planner(store):
    rs, vids, snap = store
    v = vids[-1]
    full = snap.execute([Q.version(v)])[0].value
    res = snap.execute([Q.record(v, 4), Q.records(v, [1, 2, 999]),
                        Q.range(v, 50, 55), Q.evolution(7)])
    assert res[0].value == full[4]
    assert res[1].value == {1: full[1], 2: full[2]}
    assert res[2].value == {pk: p for pk, p in full.items() if 50 <= pk <= 55}
    evo = res[3].value
    assert [p for _, p in evo][-1] == full[7]


# ------------------------------------------------------------------- explain
def test_explain_reports_mode_and_costs(store):
    rs, vids, snap = store
    v = vids[-1]
    ex = snap.explain([Q.and_(Q.where(v, "color", 2),
                              Q.where_range(v, "size", 3, 7)),
                       Q.count(Q.where(v, "color", 2)),
                       Q.count(Q.version(v))])
    assert [e["mode"] for e in ex] == ["fetch", "index_only", "metadata"]
    for e in ex:
        assert {"plan", "predicted_chunks", "predicted_payload_chunks",
                "predicted_round_trips", "predicted_bytes",
                "predicted_seconds"} <= set(e)
    assert "and" in ex[0]["plan"] and "where" in ex[0]["plan"]
    assert ex[0]["predicted_payload_chunks"] > 0
    assert ex[1]["predicted_payload_chunks"] == 0
    assert ex[2]["predicted_chunks"] == ex[2]["predicted_round_trips"] == 0
    # predictions are honest for the fetch plan: chunk count matches measure
    got = snap.execute([Q.and_(Q.where(v, "color", 2),
                               Q.where_range(v, "size", 3, 7))])
    assert ex[0]["predicted_chunks"] == got[0].stats.chunks_fetched
