"""Secondary attribute indexes: varint vectorization regression, the
Projections.sorted_keys dirty-flag contract, SecondaryIndex unit behaviour
(postings, bucket persistence, staging), Q.where / Q.where_range planning
through the shared bitmap-kernel launch with exact post-filtering, and
coherence across flush / build / compaction / retention / drop_index /
CachingKVS."""
import numpy as np
import pytest

from repro_torch.core import (CachingKVS, InMemoryKVS, Q, RStore, RStoreConfig,
                              SecondaryIndex, ShardedKVS, keep_last,
                              struct_extractor)
from repro_torch.core import index as index_mod
from repro_torch.core.index import Projections, varint_decode, varint_encode
from repro_torch.core.secondary import datagen_extractor


# ---------------------------------------------------------------- varint sat.
def _varint_encode_ref(arr) -> bytes:
    """The original per-element/per-byte loop — the byte-format oracle the
    vectorized encoder must match exactly."""
    arr = np.asarray(arr, dtype=np.int64)
    out = bytearray()
    prev = 0
    for x in arr.tolist():
        d = x - prev
        prev = x
        while True:
            b = d & 0x7F
            d >>= 7
            if d:
                out.append(b | 0x80)
            else:
                out.append(b)
                break
    return bytes(out)


def test_varint_empty_input():
    assert varint_encode(np.empty(0, np.int64)) == b""
    assert len(varint_decode(b"")) == 0
    assert varint_decode(b"").dtype == np.int64


def test_varint_roundtrip_random():
    rng = np.random.default_rng(0)
    for _ in range(50):
        n = int(rng.integers(1, 200))
        arr = np.sort(rng.integers(0, 1 << int(rng.integers(3, 40)), size=n))
        enc = varint_encode(arr)
        assert np.array_equal(varint_decode(enc), arr)


def test_varint_byte_format_and_size_parity_with_reference():
    rng = np.random.default_rng(1)
    cases = [np.array([0]), np.array([127]), np.array([128]),
             np.array([0, 0, 0]), np.arange(1000) * 129]
    for _ in range(30):
        n = int(rng.integers(1, 100))
        cases.append(np.sort(rng.integers(0, 1 << 35, size=n)))
    for arr in cases:
        enc = varint_encode(np.asarray(arr, np.int64))
        ref = _varint_encode_ref(arr)
        assert enc == ref                      # identical bytes => identical size
        assert np.array_equal(varint_decode(enc), np.asarray(arr, np.int64))


def test_varint_decode_discards_trailing_incomplete_group():
    enc = varint_encode(np.array([5, 300], dtype=np.int64))
    # continuation bit set on the final byte => incomplete group, dropped
    assert np.array_equal(varint_decode(enc + b"\x81"),
                          np.array([5, 300], dtype=np.int64))


# -------------------------------------------------- sorted_keys dirty flag
def test_sorted_keys_cache_survives_chunk_extension_of_existing_keys():
    """The documented invariant: the cache covers the key *set*, so adding
    chunks to existing keys must neither invalidate nor corrupt it — while
    a genuinely new key must show up."""
    p = Projections(version_chunks={}, key_chunks={}, n_chunks=4)
    p.extend_keys(np.array([3, 1]), np.array([0, 1]))
    first = p.sorted_keys()
    assert first.tolist() == [1, 3]

    # same key set, more chunks: cache object is reused, still correct
    p.extend_keys(np.array([3]), np.array([2]))
    again = p.sorted_keys()
    assert again is first
    assert again.tolist() == [1, 3]
    assert p.key_chunks[3].tolist() == [0, 2]

    # a new key dirties the cache (the old len-based heuristic could only
    # catch this by accident of counting)
    p.extend_keys(np.array([2]), np.array([3]))
    assert p.sorted_keys().tolist() == [1, 2, 3]


# ------------------------------------------------------------ struct extractor
def test_struct_extractor_reads_little_endian_fields():
    ext = struct_extractor({"a": (0, 2), "b": (2, 4)})
    payload = (513).to_bytes(2, "little") + (70000).to_bytes(4, "little") + b"xx"
    assert ext(payload) == {"a": 513, "b": 70000}


def test_struct_extractor_short_payload_omits_field():
    ext = struct_extractor({"a": (0, 2), "b": (2, 4)})
    assert ext(b"\x07\x00\x01") == {"a": 7}    # "b" doesn't fit
    assert ext(b"") == {}


def test_struct_extractor_rejects_bad_spec():
    with pytest.raises(ValueError):
        struct_extractor({"a": (-1, 2)})
    with pytest.raises(ValueError):
        struct_extractor({"a": (0, 9)})


def test_datagen_extractor_layout():
    ext = datagen_extractor(2)
    payload = (11).to_bytes(4, "little") + (22).to_bytes(4, "little") + b"rest"
    assert ext(payload) == {"f0": 11, "f1": 22}


def test_datagen_attr_fields_are_extractable():
    from repro_torch.core import DatasetSpec, generate

    spec = DatasetSpec(n_versions=6, n_base_records=30, payloads=True,
                       attr_fields=2, attr_cardinality=17, seed=3)
    graph = generate(spec)
    ext = datagen_extractor(2)
    seen = set()
    for rid in range(len(graph.store)):
        vals = ext(graph.store.payload(rid))
        assert set(vals) == {"f0", "f1"}
        assert all(0 <= v < spec.attr_cardinality for v in vals.values())
        seen.update(vals.values())
    assert len(seen) > 1               # values actually vary across records


# ------------------------------------------------------- SecondaryIndex unit
def _color(payload: bytes) -> dict:
    return {"color": payload[0]}


def test_secondary_index_add_remove_rebuild():
    idx = SecondaryIndex("color", _color, n_buckets=2)
    payloads = {0: b"\x01aa", 1: b"\x02bb", 2: b"\x01cc"}
    idx.add_chunks([(0, np.array([0, 1])), (1, np.array([2]))],
                   payloads.__getitem__)
    assert idx.postings_for(1).tolist() == [0, 1]
    assert idx.postings_for(2).tolist() == [0]
    assert idx.postings_for(99).tolist() == []
    assert [p.tolist() for p in idx.postings_in_range(1, 2)] == [[0, 1], [0]]

    idx.remove_chunks([0])
    assert idx.postings_for(1).tolist() == [1]
    assert idx.postings_for(2).tolist() == []  # value vanished entirely

    idx.rebuild({5: np.array([1])}, payloads.__getitem__)
    assert idx.postings_for(2).tolist() == [5]
    assert idx.postings_for(1).tolist() == []


def test_bucket_blob_roundtrip():
    idx = SecondaryIndex("c", _color, n_buckets=1)
    idx.postings = {7: np.array([0, 5, 6], np.int64),
                    -3: np.array([2], np.int64)}
    blob = idx._encode_bucket(0)
    dec = SecondaryIndex.decode_bucket(blob)
    assert set(dec) == {7, -3}
    assert dec[7].tolist() == [0, 5, 6]
    assert dec[-3].tolist() == [2]


def test_stage_writes_drains_dirty_and_deletes_emptied_buckets():
    idx = SecondaryIndex("color", _color, n_buckets=2)
    idx.add_chunks([(0, np.array([0]))], {0: b"\x03x"}.__getitem__)  # value 3 -> bucket 1
    writes, dels = idx.stage_writes()
    assert [k for k, _ in writes] == ["idx2/color/1"] and dels == []
    assert idx.stage_writes() == ([], [])      # drained

    idx.remove_chunks([0])                     # bucket 1 now empty
    writes, dels = idx.stage_writes()
    assert writes == [] and dels == ["idx2/color/1"]
    # deleting a never-stored bucket never emits a key (no spurious deletes)
    assert idx.stage_writes() == ([], [])


def test_index_load_roundtrips_persisted_postings():
    kvs = InMemoryKVS()
    idx = SecondaryIndex("color", _color, n_buckets=3)
    chunk_records = {0: np.array([0, 1]), 1: np.array([2])}
    payloads = {0: b"\x01a", 1: b"\x05b", 2: b"\x01c"}
    idx.add_chunks(sorted(chunk_records.items()), payloads.__getitem__)
    writes, _ = idx.stage_writes()
    kvs.multiput(writes)

    loaded = SecondaryIndex.load(kvs, "color", _color, chunk_records,
                                 payloads.__getitem__, n_buckets=3)
    assert set(loaded.postings) == set(idx.postings)
    for v in idx.postings:
        assert np.array_equal(loaded.postings[v], idx.postings[v])
    assert loaded.stored_bytes() == idx.stored_bytes() > 0
    # reverse map rebuilt too (compaction-ready)
    assert loaded.chunk_values[0].tolist() == [1, 5]


# ----------------------------------------------------------- store integration
def _mk(pk: int, color: int) -> bytes:
    return bytes([color]) + bytes([pk % 251]) * 24


def _make_store(cache_bytes=0, **cfg_kw):
    kvs = ShardedKVS([InMemoryKVS() for _ in range(4)])
    if cache_bytes:
        kvs = CachingKVS(kvs, cache_bytes=cache_bytes)
    cfg = RStoreConfig(capacity=1 << 9, batch_size=4, **cfg_kw)
    return RStore(cfg, kvs=kvs, device="cpu")


def _ingest(rs, n_pks=40, n_versions=6):
    vids = []
    with rs.writer() as w:
        v = w.init_root({pk: _mk(pk, pk % 5) for pk in range(n_pks)})
        vids.append(v)
        for i in range(n_versions):
            v = w.commit([v], adds={pk: _mk(pk, (pk + i) % 5)
                                    for pk in range(i, n_pks, 7)})
            vids.append(v)
    return vids


def _oracle(snap, ext, vid, pred):
    full = snap.execute([Q.version(vid)])[0].value
    return {pk: p for pk, p in full.items() if pred(ext(p)["color"])}


EXT = struct_extractor({"color": (0, 1)})


def test_where_matches_full_scan_oracle():
    rs = _make_store()
    rs.create_index("color", EXT)
    vids = _ingest(rs)
    snap = rs.snapshot()
    for vid in vids:
        for c in range(5):
            got = snap.execute([Q.where(vid, "color", c)])[0].value
            assert got == _oracle(snap, EXT, vid, lambda v: v == c)
        got = snap.execute([Q.where_range(vid, "color", 1, 3)])[0].value
        assert got == _oracle(snap, EXT, vid, lambda v: 1 <= v <= 3)


def test_create_index_after_ingest_indexes_existing_chunks():
    rs = _make_store()
    vids = _ingest(rs)
    rs.flush()
    rs.create_index("color", EXT)              # late registration
    snap = rs.snapshot()
    got = snap.execute([Q.where(vids[-1], "color", 2)])[0].value
    assert got == _oracle(snap, EXT, vids[-1], lambda v: v == 2)


def test_where_unknown_value_returns_empty_without_fetches():
    rs = _make_store()
    rs.create_index("color", EXT)
    vids = _ingest(rs)
    snap = rs.snapshot()
    r = snap.execute([Q.where(vids[-1], "color", 200)])[0]
    assert r.value == {} and r.stats.chunks_fetched == 0


def test_where_without_index_raises_keyerror_naming_attr():
    rs = _make_store()
    vids = _ingest(rs)
    with pytest.raises(KeyError, match="size"):
        rs.snapshot().execute([Q.where(vids[0], "size", 1)])


def test_create_index_requires_payloads_and_unique_attr():
    rs = _make_store(store_payloads=False)
    with pytest.raises(RuntimeError, match="store_payloads"):
        rs.create_index("color", EXT)
    rs = _make_store()
    rs.create_index("color", EXT)
    with pytest.raises(ValueError, match="already exists"):
        rs.create_index("color", EXT)


def test_drop_index_gcs_keys_and_disables_queries():
    rs = _make_store()
    rs.create_index("color", EXT)
    vids = _ingest(rs)
    rs.flush()
    assert any(k.startswith("idx2/") for s in rs.kvs.shards for k in s._d)
    rs.drop_index("color")
    assert not any(k.startswith("idx2/") for s in rs.kvs.shards for k in s._d)
    with pytest.raises(KeyError):
        rs.snapshot().execute([Q.where(vids[0], "color", 1)])
    with pytest.raises(KeyError):
        rs.drop_index("color")


def test_mixed_batch_shares_one_kernel_launch_and_one_fetch():
    rs = _make_store()
    rs.create_index("color", EXT)
    vids = _ingest(rs)
    snap = rs.snapshot()

    launches0 = index_mod.kops.BITMAP_LAUNCHES
    res = snap.execute([Q.where(vids[-1], "color", 2),
                        Q.where_range(vids[-1], "color", 0, 1),
                        Q.record(vids[-1], 3),
                        Q.range(vids[-1], 0, 9),
                        Q.version(vids[0])])
    # primary+secondary share ONE fused bitmap-program launch
    assert index_mod.kops.BITMAP_LAUNCHES - launches0 == 1
    # ONE interleaved multiget for the whole session (4 shards => <= 4 RTs,
    # sharded stats count per-shard round trips; assert batch-level count)
    assert res.batch.kvs_queries <= 4
    assert res[0].value == _oracle(snap, EXT, vids[-1], lambda v: v == 2)


def test_where_coherent_through_retention_and_compaction():
    rs = _make_store()
    rs.create_index("color", EXT)
    vids = _ingest(rs, n_versions=8)
    rs.retain(keep_last(3))
    rep = rs.compact(liveness_threshold=1.0)
    assert rep.mode == "pass"
    snap = rs.snapshot()
    for vid in vids[-3:]:
        for c in range(5):
            got = snap.execute([Q.where(vid, "color", c)])[0].value
            assert got == _oracle(snap, EXT, vid, lambda v: v == c)
    # retired version: loud at plan time
    with pytest.raises(KeyError, match="retired"):
        snap.execute([Q.where(vids[0], "color", 1)])
    # zero orphaned idx2/ keys after the pass
    idx = rs._indexes["color"]
    in_kvs = {k for s in rs.kvs.shards for k in s._d if k.startswith("idx2/")}
    assert set(idx.stored_keys()) == in_kvs
    live = set(rs._chunk_records)
    for p in idx.postings.values():
        assert set(p.tolist()) <= live


def test_snapshot_refresh_repins_indexes_after_compaction():
    rs = _make_store()
    rs.create_index("color", EXT)
    vids = _ingest(rs, n_versions=8)
    snap = rs.snapshot()
    rs.retain(keep_last(3))
    rs.compact(liveness_threshold=1.0)
    with pytest.raises(RuntimeError, match="refresh"):
        snap.execute([Q.where(vids[-1], "color", 2)])
    snap.refresh()
    got = snap.execute([Q.where(vids[-1], "color", 2)])[0].value
    assert got == _oracle(rs.snapshot(), EXT, vids[-1], lambda v: v == 2)


def test_where_coherent_through_full_build():
    rs = _make_store()
    rs.create_index("color", EXT)
    vids = _ingest(rs)
    before = rs.snapshot().execute([Q.where(vids[-1], "color", 3)])[0].value
    rs.build()
    after = rs.snapshot().execute([Q.where(vids[-1], "color", 3)])[0].value
    assert after == before
    in_kvs = {k for s in rs.kvs.shards for k in s._d if k.startswith("idx2/")}
    assert set(rs._indexes["color"].stored_keys()) == in_kvs


def test_warm_cached_where_scan_is_zero_read_round_trips():
    rs = _make_store(cache_bytes=1 << 22)
    rs.create_index("color", EXT)
    vids = _ingest(rs)
    snap = rs.snapshot()
    q = [Q.where(vids[-1], "color", 2)]
    cold = snap.execute(q)
    assert cold.batch.kvs_queries >= 1
    warm = snap.execute(q)
    assert warm.batch.kvs_queries == 0         # all from cache
    assert warm[0].value == cold[0].value


def test_cached_where_coherent_across_compaction_epoch():
    rs = _make_store(cache_bytes=1 << 22)
    rs.create_index("color", EXT)
    vids = _ingest(rs, n_versions=8)
    snap = rs.snapshot()
    expect = {c: snap.execute([Q.where(vids[-1], "color", c)])[0].value
              for c in range(5)}               # cache now warm
    rs.retain(keep_last(3))
    rs.compact(liveness_threshold=1.0)         # invalidates superseded keys
    snap = rs.snapshot()
    for c in range(5):
        got = snap.execute([Q.where(vids[-1], "color", c)])[0].value
        assert got == expect[c]


def test_storage_stats_price_secondary_indexes():
    rs = _make_store()
    rs.create_index("color", EXT)
    _ingest(rs)
    rs.flush()
    st = rs.storage_stats()
    assert st["secondary_index_bytes"] > 0
    rep = st["secondary_indexes"]["color"]
    assert rep["n_values"] == 5 and rep["stored_bytes"] > 0


def test_selective_where_fetches_fewer_chunks_than_full_version():
    """The headline win: a selective predicate touches a fraction of the
    version's span (the bench gates this at <=25% on a bigger workload)."""
    rng = np.random.default_rng(7)
    rs = _make_store()
    ext = struct_extractor({"tag": (0, 2)})
    rs.create_index("tag", ext)
    payload = lambda tag: int(tag).to_bytes(2, "little") + b"z" * 40
    with rs.writer() as w:
        v = w.init_root({pk: payload(rng.integers(0, 500))
                         for pk in range(600)})
    snap = rs.snapshot()
    full = snap.execute([Q.version(v)])[0]
    tag = int(ext(next(iter(full.value.values())))["tag"])
    flt = snap.execute([Q.where(v, "tag", tag)])[0]
    assert flt.value == {pk: p for pk, p in full.value.items()
                         if ext(p)["tag"] == tag}
    assert 0 < flt.stats.chunks_fetched <= 0.25 * full.stats.chunks_fetched
