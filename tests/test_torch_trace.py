"""The port's own tracer (``repro_torch.trace``) on a tiny store on the CPU.

A lookup wave at k=1 through ``StoreQueryEngine.serve``, one k=3 version read
through ``Snapshot.execute`` and one writer session of a few versions run with
the tracer on.  Their spans form a tree inside each request, self times add
up to the roots' durations, the span names are the documented ones and the
counters equal what the store reports.  With the tracer off nothing is
recorded and the answers are the traced run's.
"""
from collections import defaultdict

import numpy as np
import pytest

import repro_torch.core as T
from repro_torch import trace
from repro_torch.serve.engine import StoreQueryEngine

N_BASE = 96
RECORD = 40
READ_SPANS = {"read.request", "read.plan", "read.gather", "device.wait",
              "read.parse.chunk", "read.parse.map", "read.decode",
              "read.decode.inflate", "read.decode.delta", "read.answer"}
WRITE_SPANS = {"write.stage", "write.flush", "write.partition",
               "write.chunks", "write.maps", "write.put"}


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    trace.collect()
    yield
    trace.disable()
    trace.collect()


def _versions(seed: int, n: int):
    """A linear chain: the root, then ``n`` commits each rewriting a bounded
    span of a tenth of the live records and adding one."""
    rng = np.random.default_rng(seed)
    state = {pk: rng.integers(0, 256, RECORD, dtype=np.uint8).tobytes()
             for pk in range(N_BASE)}
    out = [(-1, dict(state), [])]
    for vid in range(1, n + 1):
        adds = {}
        for pk in rng.choice(sorted(state), size=N_BASE // 10, replace=False):
            rec = bytearray(state[int(pk)])
            off = int(rng.integers(0, RECORD - 4))
            rec[off:off + 4] = rng.integers(0, 256, 4, dtype=np.uint8).tobytes()
            adds[int(pk)] = bytes(rec)
        adds[N_BASE + vid] = rng.integers(0, 256, RECORD,
                                          dtype=np.uint8).tobytes()
        state.update(adds)
        out.append((vid - 1, adds, []))
    return out


def _store(k: int, versions):
    kvs = T.ShardedKVS([T.ShardedDeviceKVS(slot_bytes=1024, device="cpu")
                        for _ in range(2)])
    rs = T.RStore(T.RStoreConfig(capacity=1024, k=k), kvs, device="cpu")
    _session(rs, versions)
    if k > 1:
        rs.build()
    return rs


def _session(rs, versions) -> None:
    with rs.writer(flush_on_close=rs.config.k == 1) as w:
        for parent, adds, dels in versions:
            if parent < 0:
                w.init_root(adds)
            else:
                w.commit([parent], adds, dels)


def _check_tree(spans):
    """Parents enclose their children in one request; per request, the
    self times sum to the roots' durations.  Returns the spans by request."""
    by_id = {s.id: s for s in spans}
    by_req = defaultdict(list)
    for s in spans:
        assert s.start <= s.end
        by_req[s.request].append(s)
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.request == s.request, (p, s)
            assert p.start <= s.start and s.end <= p.end, (p, s)
    for req, group in by_req.items():
        roots = sum(s.end - s.start for s in group if s.parent is None)
        assert roots > 0
        assert sum(trace.self_times(group).values()) == pytest.approx(
            roots, rel=1e-9, abs=1e-12)
    return by_req


def _wave(v: int):
    return [T.Q.record(v, 3), T.Q.records(v, [1, 5, 9, 40]),
            T.Q.range(v, 10, 30), T.Q.evolution(7)]


def test_a_lookup_wave_is_one_request_of_the_documented_spans():
    rs = _store(1, _versions(1, 6))
    engine = StoreQueryEngine(rs)
    trace.enable()
    batch = engine.serve(_wave(5))
    trace.disable()
    spans, counters = trace.collect()
    (group,) = _check_tree(spans).values()
    roots = [s for s in group if s.parent is None]
    assert [s.name for s in roots] == ["read.request"]
    # k=1: singleton sub-chunks, so no delta level to decode
    assert {s.name for s in spans} == READ_SPANS - {"read.decode.delta"}
    assert counters["records_returned"] == batch.batch.records_returned > 0
    assert counters["records_decoded"] >= counters["records_returned"]
    n_decode = sum(s.name == "read.decode" for s in spans)
    assert counters["chunks_decoded"] == n_decode
    assert n_decode <= batch.batch.payload_chunks_fetched
    assert sum(s.name == "read.answer" for s in spans) == len(_wave(5))


def test_a_k3_version_read_counts_every_fetched_chunk():
    versions = _versions(2, 6)
    rs = _store(3, versions)
    snap = rs.snapshot()
    trace.enable()
    batch = snap.execute([T.Q.version(6)])
    trace.disable()
    spans, counters = trace.collect()
    (group,) = _check_tree(spans).values()
    assert [s.name for s in group if s.parent is None] == ["read.request"]
    assert {s.name for s in spans} == READ_SPANS
    stats = batch.batch
    assert counters["chunks_decoded"] == \
        stats.payload_chunks_fetched - stats.irrelevant_chunks > 0
    assert counters["records_returned"] == stats.records_returned == \
        len(batch[0].value)
    # one inflate and at most one delta a chunk, however many sub-chunks
    # and records it holds
    n = counters["chunks_decoded"]
    assert sum(s.name == "read.decode.inflate" for s in spans) == n
    assert 0 < sum(s.name == "read.decode.delta" for s in spans) <= n
    assert counters["records_decoded"] >= stats.records_returned


def test_a_writer_session_is_one_request_and_counts_its_map_rewrites(
        monkeypatch):
    versions = _versions(3, 9)
    rs = _store(1, versions[:6])
    first_new = rs.n_chunks
    put = []
    inner = rs.kvs.multiput
    monkeypatch.setattr(rs.kvs, "multiput",
                        lambda items: (put.extend(k for k, _ in items),
                                       inner(items))[1])
    trace.enable()
    _session(rs, versions[6:])
    trace.disable()
    spans, counters = trace.collect()
    (group,) = _check_tree(spans).values()
    roots = [s.name for s in group if s.parent is None]
    assert roots == ["write.stage"] * len(versions[6:]) + ["write.flush"]
    assert {s.name for s in spans} == WRITE_SPANS
    old_maps = [k for k in put
                if k.startswith("map/") and int(k[4:]) < first_new]
    assert counters["maps_rebuilt"] == len(old_maps) > 0
    kids = {s.name for s in spans
            if s.parent == next(r.id for r in group
                                if r.name == "write.flush")}
    assert kids == {"write.partition", "write.chunks", "write.maps",
                    "write.put"}


@pytest.mark.parametrize("k", [1, 3])
def test_off_records_nothing_and_answers_the_same(k):
    rs = _store(k, _versions(4, 5))
    engine = StoreQueryEngine(rs)
    trace.enable()
    traced = [r.value for r in engine.serve(_wave(4) + [T.Q.version(3)])]
    trace.disable()
    spans, _ = trace.collect()
    assert spans
    plain = [r.value for r in engine.serve(_wave(4) + [T.Q.version(3)])]
    assert trace.ACTIVE is None
    assert trace.collect() == ([], {})
    assert plain == traced


def test_requests_get_their_own_ids_and_the_timeline_nests():
    rs = _store(1, _versions(5, 4))
    engine = StoreQueryEngine(rs)
    trace.enable()
    engine.serve(_wave(2))
    rs.snapshot().execute(_wave(3))
    trace.disable()
    spans, _ = trace.collect()
    by_req = _check_tree(spans)
    assert len(by_req) == 2
    line = trace.timeline(spans, "outside")
    assert len(line) == 2 * len(spans)
    assert [t for t, _ in line] == sorted(t for t, _ in line)
    # the innermost open span: a root's name at its start, "outside" at its
    # end, and every name in between is a span of the requests
    assert line[0][1] == "read.request" and line[-1][1] == "outside"
    assert {n for _, n in line} <= READ_SPANS | {"outside"}


def test_a_span_left_by_an_error_is_closed_with_its_caller():
    rs = _store(1, _versions(6, 3))
    snap = rs.snapshot()
    trace.enable()
    with pytest.raises(KeyError):
        snap.execute([T.Q.version(99)])
    assert trace.ACTIVE.stack == []
    snap.execute([T.Q.version(2)])
    trace.disable()
    spans, _ = trace.collect()
    _check_tree(spans)


@pytest.mark.parametrize("k", [1, 3])
def test_subchunks_parsed_counts_every_parsed_chunks_sub_chunks(k,
                                                                monkeypatch):
    """``subchunks_parsed`` is the sum of the header's sub-chunk count over
    the chunks a batch parsed; with the tracer off nothing is recorded."""
    import struct

    from repro_torch.core import chunkstore
    rs = _store(k, _versions(7, 5))
    engine = StoreQueryEngine(rs)
    n_subs = []
    parse = chunkstore.StoredChunk.from_bytes

    def counting(buf):
        n_subs.append(struct.unpack_from("<III", buf, 0)[2])
        return parse(buf)
    monkeypatch.setattr(chunkstore.StoredChunk, "from_bytes",
                        staticmethod(counting))
    queries = _wave(4) + [T.Q.version(3)]
    trace.enable()
    traced = [r.value for r in engine.serve(queries)]
    trace.disable()
    spans, counters = trace.collect()
    assert counters["subchunks_parsed"] == sum(n_subs) > 0
    assert sum(s.name == "read.parse.chunk" for s in spans) == len(n_subs)
    if k == 1:
        assert counters["subchunks_parsed"] >= counters["records_decoded"]
    else:
        assert counters["subchunks_parsed"] < counters["records_decoded"]
    del n_subs[:]
    assert [r.value for r in engine.serve(queries)] == traced
    assert n_subs and trace.collect() == ([], {})
