"""A deployment added as files: a replicated stack, a traffic kind of several
clients through the program's ``IngestGateway``, its configuration and its
mix, all new files in a copy of the benchmark's folders, with entries in a
``BENCHMARK.json``-shaped dict.  The whole run agrees with the reference,
read back from every replica, and the control and a planted fault are
caught; no file the benchmark has is touched."""
import contextlib
import os
import shutil

import pytest

from portbench.harness import registry, runner
from portbench.test_portbench_cells import SEED
from portbench.test_portbench_registry import _copy_bench

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
    kind = registry.load_kind("gateway", DEPLOYMENT)
    config = registry.load_config("a2-k1-r2-test", DEPLOYMENT)
    mix = registry.load_mix("gateway-test", DEPLOYMENT)
    parents, loaded = kind.plan({**config, **TINY}, mix, 0.01)
    assert loaded == 3 and parents[:2] == [0, 1]
    assert parents[2:6] == [2, 2, 3, 4]
    assert all(parents[v - 1] == v - 2 for v in range(loaded + 2,
                                                       len(parents) + 1))
