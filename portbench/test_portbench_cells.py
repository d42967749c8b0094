"""Each configuration under each traffic mix, at a tiny size on the CPU: the
whole run (set-up, window, read-back, check) agrees with the reference, and
the control and every planted fault make ``correct`` come out false."""
import itertools

import numpy as np
import pytest

from portbench.harness import faults, gen, registry, runner

TINY = {"n_base_records": 1024, "n_versions": 6}
CONFIGS = ("a2-k1", "a2-k3")
MIXES = ("lookup", "snapshot", "ingest")
SEED = 2**31 + 11          # seeds may exceed 32 signed bits


def cell(config: str, mix: str) -> registry.Cell:
    """A cell of ``config`` under ``mix`` with every per-layer metric that a
    cell of ``mix`` in ``BENCHMARK.json`` reports."""
    bench = registry.load_benchmark()
    moves = {"lookup": "read_p95_ms", "snapshot": "read_records_per_s",
             "ingest": "ingest_records_per_s"}[mix]
    name = f"{config}.{mix}"
    of_mix = {w["name"] for w in bench["workloads"] if w["traffic"] == mix}
    bench["workloads"] = [{"name": name, "config": config, "traffic": mix,
                           "chips": 1, "why": "test"}]
    for m in bench["end_to_end"]:
        if m["name"] == moves:
            m["workloads"] = [name]
    bench["per_layer"] = [dict(m, workloads=[name]) for m in bench["per_layer"]
                          if of_mix & set(m.get("workloads", ()))
                          and not m["name"].startswith("xor_delta_roofline")]
    return registry.find_cell(name, bench=bench)


@pytest.mark.parametrize("config,mix", list(itertools.product(CONFIGS, MIXES)))
@pytest.mark.parametrize("trace", [False, True])
def test_run_agrees_with_the_reference(config, mix, trace):
    out = runner.run_cell(cell(config, mix), SEED, 0.2, trace, device="cpu",
                          scale=TINY)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["checks"]["answers_checked"]["value"] > 0
    assert list(out)[-1] == "checks"
    c = cell(config, mix)
    want = ({m["name"] for m in c.per_layer if not m["name"].startswith(
        ("device_idle", "bitmap_vm_roofline"))} if trace
        else {m["name"] for m in c.end_to_end})
    assert set(out["metrics"]) == want
    for m in out["metrics"].values():
        assert m["value"] == m["value"]          # a number, not NaN


@pytest.mark.parametrize("config,mix", [("a2-k1", "lookup"),
                                        ("a2-k3", "snapshot"),
                                        ("a2-k1", "ingest"),
                                        ("a2-k1", "snapshot")])
@pytest.mark.parametrize("fault", faults.FAULTS)
def test_control_and_faults_are_caught(config, mix, fault):
    out = runner.run_cell(cell(config, mix), SEED + 1, 0.2, False,
                          device="cpu", scale=TINY, fault=fault)
    assert not out["correct"]
    chk = out["checks"]
    assert chk["mismatched_answers"]["value"] > 0 or \
        chk["failed_requests"]["value"] > 0


def test_same_seed_same_work():
    """The op log and the requests come from the seed alone."""
    mix = registry.load_mix("lookup")
    data = registry.load_config("a2-k3")["data"]
    a, b, c = (gen.make_chain(data, 256, 5, s) for s in (SEED, SEED, 7))
    assert (a.payloads == b.payloads).all() and a.max_key == b.max_key
    assert a.payloads.shape != c.payloads.shape or \
        (a.payloads != c.payloads).any()
    assert gen.read_requests(mix, a, SEED, 32) == \
        gen.read_requests(mix, b, SEED, 32)
    assert gen.read_requests(mix, a, SEED, 32) != \
        gen.read_requests(mix, a, 7, 32)


@pytest.mark.parametrize("key,value", [("update_dist", "zipf"),
                                       ("topology", "dag"),
                                       ("family", "B"),
                                       ("frac_insert", 0.5)])
def test_a_shape_the_generator_does_not_make_is_refused(key, value):
    data = dict(registry.load_config("a2-k1")["data"], **{key: value})
    with pytest.raises(ValueError, match=key):
        gen.make_chain(data, 64, 3, SEED)


def test_versions_spread_evenly_over_any_window():
    rng = gen.rng_for(SEED, 2)
    v = gen.versions_of(64, 230, rng)
    counts = np.bincount(v, minlength=64)
    # 230 / 64 = 3.6 a version; independent draws would give 0 to 9
    assert counts.min() >= 2 and counts.max() <= 5


@pytest.mark.card
@pytest.mark.parametrize("config,mix", [("a2-k1", "lookup"),
                                        ("a2-k3", "snapshot"),
                                        ("a2-k1", "ingest")])
def test_on_the_card_sound_and_control(config, mix):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    c = cell(config, mix)
    out = runner.run_cell(c, SEED, 1.0, True, device="cuda", scale=TINY)
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
    bad = runner.run_cell(c, SEED, 1.0, False, device="cuda", scale=TINY,
                          fault="stale")
    assert not bad["correct"]
