"""A deployment added as data: a configuration of the ``replicated`` stack and
a mix of the ``gateway`` kind (several clients through the program's
``IngestGateway``), both new files in a copy of the benchmark's folders,
with entries in a ``BENCHMARK.json``-shaped dict.  The whole run agrees with
the reference, read back from every replica, and the control and a planted
fault are caught; no file the benchmark has is touched.  A cell of that
deployment at its planned names, with a reader of its own, keeps to every
contract check and leaves the tiny cells' metrics as they are."""
import contextlib
import copy
import json
import os
import shutil

import pytest

from portbench import test_portbench_cells as cells
from portbench.harness import registry, runner
from portbench.harness.observe import Observation
from portbench.test_portbench_cells import SEED
from portbench.test_portbench_registry import (_copy_bench, cells_are_found,
                                               keeps_to_the_contract)

DEPLOYMENT = os.path.join(registry.BENCH_DIR, "testdata",
                          "replicated_gateway")
NAME = "a2-k1-r2-test.gateway-test"
TINY = {"n_base_records": 1024}


def _files(top):
    return {os.path.relpath(os.path.join(dp, f), top)
            for dp, dirs, fs in os.walk(top) for f in fs
            if "__pycache__" not in dp}


def deployment(tmp_path) -> registry.Cell:
    dst = _copy_bench(tmp_path)
    new = _files(DEPLOYMENT)
    assert not new & _files(registry.BENCH_DIR)      # only new files
    shutil.copytree(DEPLOYMENT, dst, dirs_exist_ok=True)
    bench = registry.load_benchmark()
    bench["configs"].append({
        "name": "a2-k1-r2-test", "source": "test",
        "file": "portbench/configs/a2-k1-r2-test.json",
        "reduced": ["n_base_records"], "why": "test"})
    bench["workloads"].append({"name": NAME, "config": "a2-k1-r2-test",
                               "traffic": "gateway-test", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "ingest_records_per_s":
            m["workloads"].append(NAME)
    return registry.find_cell(NAME, bench=bench, bench_dir=str(dst))


def _flip_reads_of(monkeypatch, T, tables):
    """Reads from ``tables`` altered: the first byte of each value."""
    real = T.ShardedDeviceKVS.multiget
    bad = {id(t) for t in tables}

    def multiget(self, keys):
        got = real(self, keys)
        if id(self) not in bad:
            return got
        return [bytes([v[0] ^ 0xFF]) + v[1:] for v in got]
    monkeypatch.setattr(T.ShardedDeviceKVS, "multiget", multiget)


@pytest.mark.parametrize("fault", [None, "stale", "altered",
                                   "second_replica_altered"])
def test_a_deployment_of_new_files_runs_and_is_checked(tmp_path, monkeypatch,
                                                       fault):
    import repro_torch.core as T
    before = {p: os.path.getmtime(os.path.join(registry.BENCH_DIR, p))
              for p in _files(registry.BENCH_DIR)}
    c = deployment(tmp_path)
    assert c.stack.__name__.endswith("replicated")
    assert c.kind.__name__.endswith("gateway")
    assert {m["name"] for m in c.end_to_end} == {
        "ingest_records_per_s", "stored_per_raw", "setup_s"}
    copies = []
    reading_from = c.stack.reading_from

    def pinned(kvs, copy):
        copies.append(copy)
        if fault == "second_replica_altered" and copy == 1:
            with monkeypatch.context() as m:
                _flip_reads_of(m, T, [g.replicas[1] for g in kvs.shards])
                with reading_from(kvs, copy):
                    yield
        else:
            with reading_from(kvs, copy):
                yield
    monkeypatch.setattr(c.stack, "reading_from",
                        contextlib.contextmanager(pinned))
    planted = fault if fault in ("stale", "altered") else None
    out = runner.run_cell(c, SEED, 0.3, False, device="cpu", scale=TINY,
                          fault=planted)
    assert copies == [0, 1]                        # every replica read back
    if fault is None:
        assert out["correct"], out["checks"]
        assert out["attempted"] >= 2 and out["failed"] == 0
        # the two clients' newest versions, a sample of up to 2 of the
        # window's others, 4 keys' evolutions: from each of the two replicas
        others = min(2, out["attempted"] - 2)
        assert out["checks"]["answers_checked"]["value"] == \
            2 * (2 + others + 4)
        assert set(out["metrics"]) == {"ingest_records_per_s",
                                       "stored_per_raw", "setup_s"}
    else:
        assert not out["correct"]
        assert out["checks"]["mismatched_answers"]["value"] > 0
    after = {p: os.path.getmtime(os.path.join(registry.BENCH_DIR, p))
             for p in _files(registry.BENCH_DIR)}
    assert {p: t for p, t in after.items() if p in before} == before


def test_the_gateway_kind_writes_a_line_for_each_client():
    """From the loaded chain's head, each client's versions follow its own
    last one."""
    kind = registry.load_kind("gateway")
    config = registry.load_config("a2-k1-r2-test", DEPLOYMENT)
    mix = registry.load_mix("gateway-test", DEPLOYMENT)
    parents, loaded = kind.plan({**config, **TINY}, mix, 0.01)
    assert loaded == 3 and parents[:2] == [0, 1]
    assert parents[2:6] == [2, 2, 3, 4]
    assert all(parents[v - 1] == v - 2 for v in range(loaded + 2,
                                                       len(parents) + 1))


# the cell the replicated gateway-ingest deployment is planned as, and a
# reader of its own
NEXT = "a2-k1-r2.gateway_ingest"
READER = "gateway_commit_ms.gateway_ingest"


def _put(entries: list, entry: dict) -> None:
    """``entry`` in place of any entry of its name (a later benchmark may
    hold it already), else at the end."""
    entries[:] = [e for e in entries if e["name"] != entry["name"]] + [entry]


def next_cell(tmp_path):
    """A copy of the benchmark with the planned cell added as data alone: a
    configuration file, a mix file, a reader file and their entries.
    Returns the ``BENCHMARK.json``-shaped dict and the copy's folder."""
    dst = _copy_bench(tmp_path)
    cfg = json.loads((dst / "configs" / "a2-k1.json").read_text())
    cfg.update(name="a2-k1-r2", stack="replicated", shards=4, replicas=2,
               write_quorum=1, n_base_records=2048,
               data=dict(cfg["data"], topology="tree"))
    (dst / "configs" / "a2-k1-r2.json").write_text(json.dumps(cfg))
    (dst / "traffic" / "gateway_ingest.json").write_text(json.dumps({
        "kind": "gateway", "clients": 4, "warm_versions": 2,
        "headroom_records_per_s": 60000,
        "readback": {"versions": 3, "evolution_keys": 8}}))
    (dst / "metrics" / (READER + ".py")).write_text(
        'SPANS = {"repro_torch.serve.ingest_gateway:IngestGateway.commit":'
        ' "gateway.commit"}\n\n\ndef read(obs):\n'
        '    return obs.span_ms("gateway.commit")\n')
    bench = registry.load_benchmark()
    _put(bench["configs"], {"name": "a2-k1-r2", "source": cfg["source"],
                            "file": "portbench/configs/a2-k1-r2.json",
                            "reduced": cfg["reduced"], "why": "test"})
    _put(bench["workloads"], {"name": NEXT, "config": "a2-k1-r2",
                              "traffic": "gateway_ingest", "chips": 1,
                              "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "ingest_records_per_s" and NEXT not in m["workloads"]:
            m["workloads"].append(NEXT)
    _put(bench["per_layer"], {"name": READER, "unit": "ms",
                              "better": "lower", "source": "host_clock",
                              "layer": "ingest gateway (test)",
                              "moves": "ingest_records_per_s",
                              "workloads": [NEXT]})
    return bench, str(dst)


def test_the_next_cell_is_data_alone(tmp_path):
    bench, bench_dir = next_cell(tmp_path)
    added = _files(bench_dir) - _files(registry.BENCH_DIR)
    assert added <= {"configs/a2-k1-r2.json", "traffic/gateway_ingest.json",
                     f"metrics/{READER}.py"}
    keeps_to_the_contract(bench, bench_dir)
    cells_are_found(bench, bench_dir)


def test_a_tiny_cell_keeps_to_its_own_mix(tmp_path, monkeypatch):
    """The gateway reader moves the ingest cells' metric, but no tiny cell
    of the one-writer mix picks it up; outside a gateway window it reads
    nothing."""
    bench, bench_dir = next_cell(tmp_path)
    parent = cells.cell("a2-k1", "ingest")
    monkeypatch.setattr(registry, "load_benchmark",
                        lambda: copy.deepcopy(bench))
    c = cells.cell("a2-k1", "ingest")
    assert READER not in c.readers and set(c.readers) == set(parent.readers)
    reader = registry.load_reader(READER, bench_dir)
    assert reader.read(Observation(units=16)) is None


def test_the_next_cell_runs_correct_from_both_replicas(tmp_path,
                                                       monkeypatch):
    bench, bench_dir = next_cell(tmp_path)
    c = registry.find_cell(NEXT, bench=bench, bench_dir=bench_dir)
    assert set(c.readers) == {READER}
    copies = []
    reading_from = c.stack.reading_from

    def recorded(kvs, copy):
        copies.append(copy)
        with reading_from(kvs, copy):
            yield
    monkeypatch.setattr(c.stack, "reading_from",
                        contextlib.contextmanager(recorded))
    out = runner.run_cell(c, SEED, 0.3, True, device="cpu")
    assert out["correct"], out["checks"]
    assert copies == [0, 1]                        # every replica read back
    # the 4 clients' newest versions, up to 3 of the window's others and 8
    # keys' evolutions, from each of the two replicas
    others = min(3, out["attempted"] - 4)
    assert out["checks"]["answers_checked"]["value"] == 2 * (4 + others + 8)
    assert out["metrics"][READER]["value"] > 0
