"""Discovery by name, and ``BENCHMARK.json`` against the benchmark's
contract: a configuration, a mix and a metric added as files are found
without an edit to any file that is there."""
import json
import os
import re
import shutil

import pytest

from portbench.harness import registry, runner

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def cells_are_found(bench: dict, bench_dir: str) -> None:
    """Each cell of ``bench`` found under ``bench_dir`` with its pieces: the
    stack and the traffic kind each from the file its name gives, whatever
    the name (``registry`` refuses a module without its functions)."""
    for w in bench["workloads"]:
        c = registry.find_cell(w["name"], bench=bench, bench_dir=bench_dir)
        assert c.config["name"] == w["config"]
        stack = c.config.get("stack", registry.DEFAULT_STACK)
        assert c.stack.__file__ == os.path.join(bench_dir, "stacks",
                                                stack + ".py")
        assert c.kind.__file__ == os.path.join(bench_dir, "kinds",
                                               c.mix["kind"] + ".py")
        assert set(c.readers) == {m["name"] for m in c.per_layer}
        assert any(m["name"] == "setup_s" for m in c.end_to_end)
        assert len(c.end_to_end) >= 2 and c.per_layer


def test_every_cell_is_found_with_its_pieces():
    cells_are_found(registry.load_benchmark(), registry.BENCH_DIR)


# what registry.load_stack and load_kind ask of a module
NEEDS = {"stacks": ("build", "copies", "reading_from"),
         "kinds": ("plan", "prepare", "window", "written", "readback",
                   "measure")}
PLUG_INS = sorted((folder, f[:-3]) for folder in NEEDS
                  for f in os.listdir(os.path.join(registry.BENCH_DIR, folder))
                  if f.endswith(".py"))


@pytest.mark.parametrize("folder,name", PLUG_INS,
                         ids=[f"{f}/{n}" for f, n in PLUG_INS])
def test_each_kind_and_stack_loads_with_its_functions(folder, name):
    load = {"stacks": registry.load_stack, "kinds": registry.load_kind}
    mod = load[folder](name)
    assert mod.__file__ == os.path.join(registry.BENCH_DIR, folder,
                                        name + ".py")
    assert all(callable(getattr(mod, f)) for f in NEEDS[folder])


def keeps_to_the_contract(bench: dict, bench_dir: str) -> None:
    """``bench``, with its configurations' files under ``bench_dir``,
    against the benchmark's contract."""
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(bench, indent=1)) <= 64 << 10
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in bench[key]}) == len(bench[key]), key
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(bench["workloads"]) * 14 + 2 <= 43200
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        cfg = registry.load_config(c["name"], bench_dir)
        assert cfg["source"] == c["source"] and len(c["source"]) <= 200
        assert set(c["reduced"]) <= set(cfg) and cfg["reduced"] == c["reduced"]
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])
        names.add(c["name"])
    used = {w["config"] for w in bench["workloads"]}
    assert used == names
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m.get("workloads", []):
            assert "workloads" not in e2e[m["moves"]] or \
                w in e2e[m["moves"]]["workloads"]
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_benchmark_json_keeps_to_the_contract():
    path = os.path.join(registry.ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 << 10
    keeps_to_the_contract(registry.load_benchmark(), registry.BENCH_DIR)


def _copy_bench(tmp_path):
    dst = tmp_path / "portbench"
    for sub in ("configs", "traffic", "metrics", "kinds", "stacks"):
        shutil.copytree(os.path.join(registry.BENCH_DIR, sub), dst / sub)
    return dst


def test_a_new_config_mix_and_metric_need_only_new_files(tmp_path):
    before = {p: os.path.getmtime(os.path.join(dp, p))
              for dp, _, fs in os.walk(registry.BENCH_DIR) for p in fs}
    dst = _copy_bench(tmp_path)
    cfg = json.loads((dst / "configs" / "a2-k1.json").read_text())
    cfg.update(name="a2-k1-small", n_base_records=512, n_versions=4,
               data=dict(cfg["data"], pct_update=0.10))
    (dst / "configs" / "a2-k1-small.json").write_text(json.dumps(cfg))
    (dst / "traffic" / "points.json").write_text(json.dumps({
        "kind": "read", "requests": 64, "warm_requests": 1,
        "wave": [{"query": "record", "count": 5},
                 {"query": "evolution", "count": 1}]}))
    (dst / "metrics" / "waves.points.py").write_text(
        "def read(obs):\n    return obs.units\n")
    bench = registry.load_benchmark()
    bench["workloads"].append({"name": "a2-k1-small.points",
                               "config": "a2-k1-small", "traffic": "points",
                               "chips": 1, "why": "test"})
    bench["end_to_end"][0].setdefault("workloads", []).append(
        "a2-k1-small.points")
    bench["per_layer"].append({"name": "waves.points", "unit": "waves",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "read_p95_ms",
                               "workloads": ["a2-k1-small.points"]})
    c = registry.find_cell("a2-k1-small.points", bench=bench,
                           bench_dir=str(dst))
    assert set(c.readers) == {"waves.points"}
    out = runner.run_cell(c, 3, 0.2, True, device="cpu")
    assert out["correct"] and out["metrics"]["waves.points"]["value"] > 0
    e2e = runner.run_cell(c, 3, 0.2, False, device="cpu")
    assert set(e2e["metrics"]) == {"read_p95_ms", "stored_per_raw",
                                   "setup_s"}
    after = {p: os.path.getmtime(os.path.join(dp, p))
             for dp, _, fs in os.walk(registry.BENCH_DIR) for p in fs}
    assert {p: t for p, t in after.items() if p in before} == before
