"""Property-based end-to-end test: for ANY random commit workload (branched
parents, random add/modify/delete mixes, random batch sizes and algorithms),
every query class returns exactly what the version-graph oracle says — and
for ANY interleaving of commits, retention pruning, and compaction passes,
retained versions stay byte-identical and the KVS holds no orphaned keys."""
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from repro_torch.core import CachingKVS, Q, RStore, RStoreConfig, keep_last
from repro_torch.core.kvs import InMemoryKVS, ShardedKVS
from repro_torch.core.replica import (FaultInjectingKVS, RecoveryManager,
                                      ReplicatedKVS)


@st.composite
def workload(draw):
    n_commits = draw(st.integers(2, 8))
    ops = []
    for _ in range(n_commits):
        ops.append({
            "parent_choice": draw(st.integers(0, 10**6)),
            "second_parent": draw(st.booleans()),
            "mods": draw(st.lists(st.integers(0, 24), min_size=0, max_size=4)),
            "inserts": draw(st.lists(st.integers(25, 40), min_size=0,
                                     max_size=3)),
            "dels": draw(st.lists(st.integers(0, 24), min_size=0, max_size=2)),
        })
    return {
        "algorithm": draw(st.sampled_from(["bottom_up", "depth_first",
                                           "shingle"])),
        "k": draw(st.sampled_from([1, 3])),
        "batch": draw(st.integers(1, 6)),
        "capacity": draw(st.sampled_from([256, 1024, 4096])),
        # backend: single in-memory store or the hash-sharded router —
        # results must be identical either way
        "n_shards": draw(st.sampled_from([0, 2, 4])),
        "ops": ops,
        "seed": draw(st.integers(0, 2**31 - 1)),
    }


@given(workload())
@settings(max_examples=12, deadline=None,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large])
def test_random_workload_queries_exact(w):
    rng = np.random.default_rng(w["seed"])

    def pay():
        return rng.integers(0, 256, int(rng.integers(16, 96)),
                            dtype=np.uint8).tobytes()

    kvs = (InMemoryKVS() if w["n_shards"] == 0 else
           ShardedKVS([InMemoryKVS() for _ in range(w["n_shards"])]))
    rs = RStore(RStoreConfig(algorithm=w["algorithm"], capacity=w["capacity"],
                             k=w["k"], batch_size=w["batch"]), kvs=kvs, device="cpu")
    vids = [rs.init_root({pk: pay() for pk in range(12)})]

    for op in w["ops"]:
        parent = vids[op["parent_choice"] % len(vids)]
        pmap_keys = set(
            rs.graph.store.keys()[rs.graph.members(parent)].tolist())
        adds = {pk: pay() for pk in set(op["mods"]) | set(op["inserts"])}
        dels = [pk for pk in set(op["dels"])
                if pk in pmap_keys and pk not in adds]
        parents = [parent]
        if op["second_parent"] and len(vids) > 1:
            other = vids[(op["parent_choice"] // 7) % len(vids)]
            if other != parent:
                parents.append(other)
        vids.append(rs.commit(parents, adds=adds, dels=dels))

    keys_arr = rs.graph.store.keys()

    # Q1 everywhere
    for v in vids:
        got, _ = rs.get_version(v)
        m = rs.graph.members(v)
        want = {int(keys_arr[r]): rs.graph.store.payload(int(r)) for r in m}
        assert got == want

    # Q-point / Q2 / Q3 on the last version
    v = vids[-1]
    m = rs.graph.members(v)
    live = {int(keys_arr[r]): int(r) for r in m}
    for pk in list(live)[:3]:
        got, _ = rs.get_record(v, pk)
        assert got == rs.graph.store.payload(live[pk])
    got, _ = rs.get_record(v, 10_000)
    assert got is None
    rng_got, _ = rs.get_range(v, 5, 15)
    assert rng_got == {pk: rs.graph.store.payload(r)
                       for pk, r in live.items() if 5 <= pk <= 15}
    some_key = next(iter(live)) if live else 0
    evo, _ = rs.get_evolution(some_key)
    origins = [o for o, _ in evo]
    want_origins = sorted(
        {int(rs.graph.store.origin_versions()[r])
         for r in range(len(rs.graph.store))
         if int(keys_arr[r]) == some_key},
        key=lambda x: rs.graph.versions.index(x))
    assert origins == want_origins


# ---------------------------------------------------- compaction & retention
@st.composite
def maintenance_workload(draw):
    """Interleaved streams of commit waves, retention prunings, and
    compaction passes."""
    steps = []
    for _ in range(draw(st.integers(2, 6))):
        kind = draw(st.sampled_from(["commits", "commits", "retain",
                                     "compact"]))
        if kind == "commits":
            steps.append(("commits", draw(st.integers(1, 6))))
        elif kind == "retain":
            steps.append(("retain", draw(st.integers(1, 8))))
        else:
            steps.append(("compact", draw(st.floats(0.3, 1.0))))
    return {
        "algorithm": draw(st.sampled_from(["bottom_up", "depth_first",
                                           "shingle"])),
        "k": draw(st.sampled_from([1, 1, 3])),
        "batch": draw(st.integers(1, 6)),
        "capacity": draw(st.sampled_from([512, 2048])),
        "n_shards": draw(st.sampled_from([0, 3])),
        "steps": steps,
        "seed": draw(st.integers(0, 2**31 - 1)),
    }


def _all_kvs_keys(kvs):
    if isinstance(kvs, ShardedKVS):
        out = set()
        for s in kvs.shards:
            out |= set(s._d)
        return out
    return set(kvs._d)


@given(maintenance_workload())
@settings(max_examples=12, deadline=None,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large])
def test_retention_compaction_interleavings_exact(w):
    """After ANY interleaving of commits, retention prunings, and compaction
    passes: (a) every retained version reconstructs byte-identically to its
    pre-maintenance content, and (b) no KVS key is orphaned — the stored key
    set is exactly {chunk/i, map/i} for the chunk ids the index references."""
    rng = np.random.default_rng(w["seed"])

    def pay():
        return rng.integers(0, 256, int(rng.integers(16, 96)),
                            dtype=np.uint8).tobytes()

    kvs = (InMemoryKVS() if w["n_shards"] == 0 else
           ShardedKVS([InMemoryKVS() for _ in range(w["n_shards"])]))
    rs = RStore(RStoreConfig(algorithm=w["algorithm"], capacity=w["capacity"],
                             k=w["k"], batch_size=w["batch"]), kvs=kvs, device="cpu")
    v = rs.init_root({pk: pay() for pk in range(10)})
    vids = [v]
    # oracle: payload map of every version at commit time (immutable)
    oracle = {}

    def snap_oracle(vid):
        m = rs.graph.members(vid)
        ks = rs.graph.store.keys()[m]
        oracle[vid] = {int(k): rs.graph.store.payload(int(r))
                       for k, r in zip(ks, m)}

    snap_oracle(v)
    for kind, arg in w["steps"]:
        if kind == "commits":
            for _ in range(arg):
                parent = vids[-1]
                adds = {int(rng.integers(0, 10)): pay()}
                if rng.integers(0, 2):
                    adds[10 + int(rng.integers(0, 20))] = pay()
                v = rs.commit([parent], adds=adds)
                vids.append(v)
                snap_oracle(v)
        elif kind == "retain":
            retired = rs.retain(keep_last(arg))
            vids = [x for x in vids if x not in set(retired)]
        else:
            rs.compact(liveness_threshold=arg)
        rs.graph.check_invariants()

    rs.flush()
    keys_arr = rs.graph.store.keys()
    # (a) every retained version is byte-identical to its commit-time content
    for vid in vids:
        got, _ = rs.get_version(vid)
        assert got == oracle[vid], f"version {vid} diverged"
    # (b) no orphaned (or missing) KVS keys
    want = set()
    for cid in rs._chunk_records:
        want |= {f"chunk/{cid}", f"map/{cid}"}
    assert _all_kvs_keys(kvs) == want
    # evolution of any key returns only records live in a retained version
    live_rids = set()
    for vid in vids:
        live_rids |= set(rs.graph.members(vid).tolist())
    pk = int(next(iter(oracle[vids[-1]])))
    evo, _ = rs.get_evolution(pk)
    stored_rids = {int(r) for rids in rs._chunk_records.values() for r in rids}
    want_evo = sorted(
        {int(rs.graph.store.origin_versions()[r])
         for r in stored_rids & live_rids if int(keys_arr[r]) == pk},
        key=lambda x: rs.graph.versions.index(x))
    assert [o for o, _ in evo] == want_evo


# ------------------------------------------------- replication under faults
@st.composite
def fault_plan(draw):
    """A replicated backend shape plus a random fault schedule: per-op
    transient/timeout probabilities and optionally one hard replica kill
    partway through the workload."""
    return {
        "R": draw(st.sampled_from([2, 3])),
        "n_shards": draw(st.sampled_from([1, 3])),
        "p_transient": draw(st.sampled_from([0.0, 0.15, 0.3])),
        "p_timeout": draw(st.sampled_from([0.0, 0.15])),
        "kill": draw(st.booleans()),
        "kill_step": draw(st.integers(0, 5)),
        "seed": draw(st.integers(0, 2**31 - 1)),
    }


def _run_steps(rs, rng, steps, on_step, probe=None):
    """Drive the maintenance-workload step stream against ``rs``; call
    ``on_step(i)`` before each step (fault-schedule hook) and ``probe(vids)``
    after each step (mid-run read hook — both runs of a comparison must pass
    the same probe shape so their flush timing stays identical)."""
    v = rs.init_root({pk: rng.integers(0, 256, int(rng.integers(16, 96)),
                                       dtype=np.uint8).tobytes()
                      for pk in range(10)})
    vids = [v]
    for i, (kind, arg) in enumerate(steps):
        on_step(i)
        if kind == "commits":
            for _ in range(arg):
                adds = {int(rng.integers(0, 10)): rng.integers(
                    0, 256, int(rng.integers(16, 96)),
                    dtype=np.uint8).tobytes()}
                if rng.integers(0, 2):
                    adds[10 + int(rng.integers(0, 20))] = rng.integers(
                        0, 256, int(rng.integers(16, 96)),
                        dtype=np.uint8).tobytes()
                vids.append(rs.commit([vids[-1]], adds=adds))
        elif kind == "retain":
            retired = set(rs.retain(keep_last(arg)))
            vids = [x for x in vids if x not in retired]
        else:
            rs.compact(liveness_threshold=arg)
        if probe is not None:
            probe(vids)
    rs.flush()
    return vids


def _check_replicated_faulty(w, fp):
    """Body of test_replicated_faulty_backend_byte_identical, callable with
    concrete (workload, fault-plan) dicts — also exercised by
    test_replicated_faulty_fixed_examples below when hypothesis is absent."""
    cfg = dict(algorithm=w["algorithm"], capacity=w["capacity"], k=w["k"],
               batch_size=w["batch"])
    R, n_shards = fp["R"], fp["n_shards"]

    rs0 = RStore(RStoreConfig(**cfg), kvs=InMemoryKVS(), device="cpu")
    vids0 = _run_steps(rs0, np.random.default_rng(w["seed"]), w["steps"],
                       lambda i: None)

    groups = [ReplicatedKVS(
        [FaultInjectingKVS(InMemoryKVS(), seed=fp["seed"] + i * R + r,
                           p_transient=fp["p_transient"],
                           p_timeout=fp["p_timeout"])
         for r in range(R)], write_quorum=1) for i in range(n_shards)]
    kvs1 = groups[0] if n_shards == 1 else ShardedKVS(groups)
    rs1 = RStore(RStoreConfig(**cfg), kvs=kvs1, device="cpu")
    kill_at = fp["kill_step"] % len(w["steps"]) if fp["kill"] else None

    def on_step(i):
        if i == kill_at:
            for g in groups:
                g.replicas[0].kill()

    vids1 = _run_steps(rs1, np.random.default_rng(w["seed"]), w["steps"],
                       on_step)

    # identical interleaving → identical retained versions, byte-identical
    # content for every query class
    assert vids1 == vids0
    for vid in vids0:
        assert rs1.get_version(vid)[0] == rs0.get_version(vid)[0]
    v = vids0[-1]
    pk = next(iter(rs0.get_version(v)[0]))
    assert rs1.get_record(v, pk)[0] == rs0.get_record(v, pk)[0]
    assert rs1.get_range(v, 0, 15)[0] == rs0.get_range(v, 0, 15)[0]
    assert rs1.get_evolution(pk)[0] == rs0.get_evolution(pk)[0]

    # recovery: revive the killed replicas, rebuild, and require every
    # replica of every group to converge byte-identically with an empty
    # repair log (missed GC deletes must not resurrect chunks)
    if kill_at is not None:
        for g in groups:
            g.replicas[0].revive()
    RecoveryManager(kvs1).recover_all()
    for g in groups:
        want = dict(g.replicas[0].inner.scan())
        for idx, r in enumerate(g.replicas):
            assert dict(r.inner.scan()) == want
            assert g.pending_repairs(idx) == 0
    # the replicated run stores exactly the same logical key set as the
    # fault-free run
    assert set().union(*(dict(g.replicas[0].inner.scan())
                         for g in groups)) == set(rs0.kvs._d)


@given(maintenance_workload(), fault_plan())
@settings(max_examples=8, deadline=None,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large])
def test_replicated_faulty_backend_byte_identical(w, fp):
    """The SAME commit/retain/compact interleaving, run once on a plain
    in-memory backend and once on a replicated backend with a random fault
    schedule (injected transients/timeouts, optionally one replica of every
    group hard-killed mid-run), must return byte-identical results for every
    query — and after revive + recover_all every replica converges to the
    same key/value set with empty repair logs."""
    _check_replicated_faulty(w, fp)


# fixed corner examples so the contract is still exercised when hypothesis
# is unavailable (conftest shims @given into a skip)
_FAULT_EXAMPLES = [
    # flaky replicas, no kill, single replicated shard
    ({"algorithm": "bottom_up", "k": 1, "batch": 3, "capacity": 512,
      "n_shards": 0, "seed": 7,
      "steps": [("commits", 4), ("retain", 3), ("commits", 3),
                ("compact", 0.6)]},
     {"R": 2, "n_shards": 1, "p_transient": 0.3, "p_timeout": 0.15,
      "kill": False, "kill_step": 0, "seed": 11}),
    # hard kill before the compact step, sharded router, R=3
    ({"algorithm": "shingle", "k": 3, "batch": 2, "capacity": 2048,
      "n_shards": 0, "seed": 19,
      "steps": [("commits", 5), ("retain", 4), ("compact", 1.0),
                ("commits", 2)]},
     {"R": 3, "n_shards": 3, "p_transient": 0.15, "p_timeout": 0.0,
      "kill": True, "kill_step": 2, "seed": 23}),
    # kill at step 0: the whole workload runs degraded
    ({"algorithm": "depth_first", "k": 1, "batch": 4, "capacity": 512,
      "n_shards": 0, "seed": 31,
      "steps": [("commits", 3), ("compact", 0.4), ("retain", 2),
                ("commits", 2)]},
     {"R": 2, "n_shards": 3, "p_transient": 0.0, "p_timeout": 0.15,
      "kill": True, "kill_step": 0, "seed": 37}),
]


@pytest.mark.parametrize("w,fp", _FAULT_EXAMPLES,
                         ids=["flaky", "kill-mid", "kill-start"])
def test_replicated_faulty_fixed_examples(w, fp):
    _check_replicated_faulty(w, fp)


# ------------------------------------------------------ chunk cache coherence
@st.composite
def cache_plan(draw):
    """CachingKVS shapes: budgets from eviction-churn-tiny to everything-fits,
    with and without the tiny-blob admission bypass."""
    return {
        "cache_bytes": draw(st.sampled_from([1 << 12, 1 << 16, 4 << 20])),
        "always_admit_bytes": draw(st.sampled_from([0, 4096])),
    }


def _check_cached_coherent(w, fp, cp):
    """Body of test_cached_reads_byte_identical_under_interleavings, callable
    with concrete (workload, fault-plan, cache-plan) dicts — also exercised
    by test_cached_coherence_fixed_examples when hypothesis is absent."""
    cfg = dict(algorithm=w["algorithm"], capacity=w["capacity"], k=w["k"],
               batch_size=w["batch"])
    R, n_shards = fp["R"], fp["n_shards"]

    # oracle: plain uncached in-memory backend, probed after every step
    probes0 = []
    rs0 = RStore(RStoreConfig(**cfg), kvs=InMemoryKVS(), device="cpu")

    def probe0(vids):
        got, _ = rs0.get_version(vids[-1])
        pk = next(iter(got)) if got else 0
        probes0.append((got, rs0.get_evolution(pk)[0]))

    vids0 = _run_steps(rs0, np.random.default_rng(w["seed"]), w["steps"],
                       lambda i: None, probe=probe0)

    # subject: CachingKVS over a replicated (optionally sharded, optionally
    # faulty/killed) backend, same interleaving, same probes
    groups = [ReplicatedKVS(
        [FaultInjectingKVS(InMemoryKVS(), seed=fp["seed"] + i * R + r,
                           p_transient=fp["p_transient"],
                           p_timeout=fp["p_timeout"])
         for r in range(R)], write_quorum=1) for i in range(n_shards)]
    kvs1 = CachingKVS(groups[0] if n_shards == 1 else ShardedKVS(groups),
                      cache_bytes=cp["cache_bytes"],
                      always_admit_bytes=cp["always_admit_bytes"])
    rs1 = RStore(RStoreConfig(**cfg), kvs=kvs1, device="cpu")
    kill_at = fp["kill_step"] % len(w["steps"]) if fp["kill"] else None
    probes1 = []

    def on_step(i):
        if i == kill_at:
            for g in groups:
                g.replicas[0].kill()

    def probe1(vids):
        got, _ = rs1.get_version(vids[-1])
        pk = next(iter(got)) if got else 0
        probes1.append((got, rs1.get_evolution(pk)[0]))
        # the byte budget is an invariant, not a steady-state property
        assert kvs1.cached_bytes <= kvs1.cache_bytes

    vids1 = _run_steps(rs1, np.random.default_rng(w["seed"]), w["steps"],
                       on_step, probe=probe1)

    # identical interleaving → identical version ids, and every mid-run
    # probe through the cache was byte-identical to the uncached oracle
    assert vids1 == vids0
    assert probes1 == probes0
    # final state: every retained version + every query class byte-identical
    for vid in vids0:
        assert rs1.get_version(vid)[0] == rs0.get_version(vid)[0]
    v = vids0[-1]
    pk = next(iter(rs0.get_version(v)[0]))
    assert rs1.get_record(v, pk)[0] == rs0.get_record(v, pk)[0]
    assert rs1.get_range(v, 0, 15)[0] == rs0.get_range(v, 0, 15)[0]
    assert rs1.get_evolution(pk)[0] == rs0.get_evolution(pk)[0]
    # the cache was actually exercised, and the budget still holds
    assert kvs1.stats.n_cache_hits + kvs1.stats.n_cache_misses > 0
    assert kvs1.cached_bytes <= kvs1.cache_bytes


@given(maintenance_workload(), fault_plan(), cache_plan())
@settings(max_examples=8, deadline=None,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large])
def test_cached_reads_byte_identical_under_interleavings(w, fp, cp):
    """For ANY interleaving of commit waves, retention prunings, compaction
    passes, and replica kills, reads through a CachingKVS (any budget, any
    admission tuning) are byte-identical to an uncached oracle run — both
    mid-run after every step and at the end for every query class — and the
    cache never exceeds its byte budget."""
    _check_cached_coherent(w, fp, cp)


# fixed corner examples so the coherence contract is still exercised when
# hypothesis is unavailable (conftest shims @given into a skip)
_CACHE_EXAMPLES = [
    # tiny budget: constant eviction/admission churn across a compact pass
    ({"algorithm": "bottom_up", "k": 1, "batch": 3, "capacity": 512,
      "n_shards": 0, "seed": 43,
      "steps": [("commits", 4), ("compact", 0.6), ("commits", 3),
                ("retain", 3), ("compact", 1.0)]},
     {"R": 2, "n_shards": 1, "p_transient": 0.0, "p_timeout": 0.0,
      "kill": False, "kill_step": 0, "seed": 47},
     {"cache_bytes": 1 << 12, "always_admit_bytes": 0}),
    # big budget, flaky sharded replicas, kill mid-run: warm cache must stay
    # coherent through failover + retention + compaction
    ({"algorithm": "shingle", "k": 1, "batch": 2, "capacity": 2048,
      "n_shards": 0, "seed": 53,
      "steps": [("commits", 5), ("retain", 4), ("compact", 0.8),
                ("commits", 2)]},
     {"R": 2, "n_shards": 3, "p_transient": 0.15, "p_timeout": 0.15,
      "kill": True, "kill_step": 1, "seed": 59},
     {"cache_bytes": 4 << 20, "always_admit_bytes": 4096}),
    # k>1: compaction falls back to a full rebuild — the layout-epoch hook
    # (not incremental invalidation) carries the coherence load
    ({"algorithm": "depth_first", "k": 3, "batch": 4, "capacity": 1024,
      "n_shards": 0, "seed": 61,
      "steps": [("commits", 4), ("compact", 0.5), ("retain", 2),
                ("commits", 2), ("compact", 1.0)]},
     {"R": 3, "n_shards": 1, "p_transient": 0.0, "p_timeout": 0.15,
      "kill": True, "kill_step": 0, "seed": 67},
     {"cache_bytes": 1 << 16, "always_admit_bytes": 4096}),
]


@pytest.mark.parametrize("w,fp,cp", _CACHE_EXAMPLES,
                         ids=["tiny-budget", "kill-warm", "k3-rebuild"])
def test_cached_coherence_fixed_examples(w, fp, cp):
    _check_cached_coherent(w, fp, cp)


# --------------------------------------------- secondary index coherence
def _tag_extractor(payload: bytes) -> dict:
    # low cardinality (4 values) so postings stay dense across random payloads
    return {"tag": payload[0] % 4}


def _check_secondary_coherent(w, fp):
    """Body of test_secondary_index_byte_identical_under_interleavings,
    callable with concrete (workload, fault-plan) dicts — also exercised by
    test_secondary_fixed_examples when hypothesis is absent."""
    cfg = dict(algorithm=w["algorithm"], capacity=w["capacity"], k=w["k"],
               batch_size=w["batch"])
    R, n_shards = fp["R"], fp["n_shards"]

    # oracle: plain in-memory, UNINDEXED store — every Q.where answer is
    # checked against a brute-force full-version scan + exact filter here
    probes0 = []
    rs0 = RStore(RStoreConfig(**cfg), kvs=InMemoryKVS(), device="cpu")

    def probe0(vids):
        full, _ = rs0.get_version(vids[-1])
        probes0.append([{pk: p for pk, p in full.items()
                         if _tag_extractor(p)["tag"] == t}
                        for t in range(4)])

    vids0 = _run_steps(rs0, np.random.default_rng(w["seed"]), w["steps"],
                       lambda i: None, probe=probe0)

    # subject: indexed store over a replicated (optionally sharded,
    # optionally faulty/killed) backend, same interleaving, same probes —
    # but answered through the secondary index
    groups = [ReplicatedKVS(
        [FaultInjectingKVS(InMemoryKVS(), seed=fp["seed"] + i * R + r,
                           p_transient=fp["p_transient"],
                           p_timeout=fp["p_timeout"])
         for r in range(R)], write_quorum=1) for i in range(n_shards)]
    kvs1 = groups[0] if n_shards == 1 else ShardedKVS(groups)
    rs1 = RStore(RStoreConfig(**cfg), kvs=kvs1, device="cpu")
    rs1.create_index("tag", _tag_extractor, n_buckets=3)
    kill_at = fp["kill_step"] % len(w["steps"]) if fp["kill"] else None
    probes1 = []

    def on_step(i):
        if i == kill_at:
            for g in groups:
                g.replicas[0].kill()

    def probe1(vids):
        res = rs1.snapshot().execute(
            [Q.where(vids[-1], "tag", t) for t in range(4)])
        probes1.append([r.value for r in res])

    vids1 = _run_steps(rs1, np.random.default_rng(w["seed"]), w["steps"],
                       on_step, probe=probe1)

    # identical interleaving → identical version ids, and every mid-run
    # filtered scan was byte-identical to the brute-force oracle
    assert vids1 == vids0
    assert probes1 == probes0

    # final sweep: where + where_range on the newest retained version
    snap = rs1.snapshot()
    full, _ = rs0.get_version(vids0[-1])
    for t in range(4):
        got = snap.execute([Q.where(vids0[-1], "tag", t)])[0].value
        assert got == {pk: p for pk, p in full.items()
                       if _tag_extractor(p)["tag"] == t}
    got = snap.execute([Q.where_range(vids0[-1], "tag", 1, 2)])[0].value
    assert got == {pk: p for pk, p in full.items()
                   if 1 <= _tag_extractor(p)["tag"] <= 2}

    # after one more compaction pass: zero orphaned idx2/ keys — the
    # backend's idx2/ key set is exactly the index's live bucket set, and
    # every posting references a stored chunk
    rs1.compact(liveness_threshold=1.0)
    idx = rs1._indexes["tag"]
    stored_idx_keys = {k for k, _ in kvs1.scan() if k.startswith("idx2/")}
    assert stored_idx_keys == set(idx.stored_keys())
    live_cids = set(rs1._chunk_records)
    for postings in idx.postings.values():
        assert set(postings.tolist()) <= live_cids


@given(maintenance_workload(), fault_plan())
@settings(max_examples=8, deadline=None,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large])
def test_secondary_index_byte_identical_under_interleavings(w, fp):
    """For ANY interleaving of commit waves, retention prunings, compaction
    passes, and replica kills, `Q.where` through a secondary index is
    byte-identical to a brute-force full-scan oracle — mid-run after every
    step and at the end (where + where_range) — and a compaction pass leaves
    zero orphaned idx2/ keys in the backend."""
    _check_secondary_coherent(w, fp)


# fixed corner examples so the contract is still exercised when hypothesis
# is unavailable (conftest shims @given into a skip)
_SECONDARY_EXAMPLES = [
    # retention + two compact passes on a replicated shard: postings must
    # shed retired chunks without orphaning buckets
    ({"algorithm": "bottom_up", "k": 1, "batch": 3, "capacity": 512,
      "n_shards": 0, "seed": 71,
      "steps": [("commits", 4), ("compact", 0.6), ("retain", 3),
                ("commits", 3), ("compact", 1.0)]},
     {"R": 2, "n_shards": 1, "p_transient": 0.15, "p_timeout": 0.0,
      "kill": False, "kill_step": 0, "seed": 73}),
    # k>1 (index maintenance rides the full-rebuild path) + replica kill
    # mid-run on a sharded router
    ({"algorithm": "shingle", "k": 3, "batch": 2, "capacity": 2048,
      "n_shards": 0, "seed": 79,
      "steps": [("commits", 5), ("retain", 4), ("compact", 1.0),
                ("commits", 2)]},
     {"R": 3, "n_shards": 3, "p_transient": 0.0, "p_timeout": 0.15,
      "kill": True, "kill_step": 1, "seed": 83}),
]


@pytest.mark.parametrize("w,fp", _SECONDARY_EXAMPLES,
                         ids=["retain-compact", "k3-kill"])
def test_secondary_fixed_examples(w, fp):
    _check_secondary_coherent(w, fp)


# --------------------------------------------- async ingest interleavings
@st.composite
def async_schedule(draw):
    """Random stage/drain/read/retain/compact/kill schedules driven through
    a BackgroundFlusher on replicated flaky backends."""
    steps = []
    for _ in range(draw(st.integers(3, 8))):
        kind = draw(st.sampled_from(["stage", "stage", "stage", "drain",
                                     "read", "retain", "compact", "kill"]))
        if kind == "stage":
            steps.append(("stage", draw(st.integers(1, 4))))
        elif kind == "retain":
            steps.append(("retain", draw(st.integers(2, 8))))
        elif kind == "compact":
            steps.append(("compact", draw(st.floats(0.3, 1.0))))
        else:
            steps.append((kind, 0))
    return {
        "algorithm": draw(st.sampled_from(["bottom_up", "depth_first"])),
        "capacity": draw(st.sampled_from([512, 2048])),
        "watermark": draw(st.sampled_from([2, 4, 10**9])),
        "n_sessions": draw(st.sampled_from([1, 2, 3])),
        "R": draw(st.sampled_from([2, 3])),
        "n_shards": draw(st.sampled_from([1, 3])),
        "p_transient": draw(st.sampled_from([0.0, 0.2])),
        "p_timeout": draw(st.sampled_from([0.0, 0.15])),
        "steps": steps,
        "seed": draw(st.integers(0, 2**31 - 1)),
    }


def _drive_async_schedule(rs, rng, plan, on_step=lambda i: None):
    """Drive one stage/drain/read/retain/compact/kill schedule against
    ``rs``.  With a flusher attached, stages go through ``n_sessions``
    concurrent WriteSessions round-robin; without one (the synchronous-
    flush oracle) the same flat commit sequence goes through the facade
    with a flush at every drain point.  Identical op order -> identical
    version ids, so the two runs are directly comparable."""
    is_async = rs.flusher is not None
    n_sessions = plan["n_sessions"]
    watermark = plan["watermark"]

    def pay():
        return rng.integers(0, 256, int(rng.integers(16, 96)),
                            dtype=np.uint8).tobytes()

    records = {pk: pay() for pk in range(10)}
    if is_async:
        with rs.writer() as boot:
            root = boot.init_root(records)
        sessions = [rs.writer() for _ in range(n_sessions)]
    else:
        root = rs.init_root(records)
        sessions = None
    heads = [root] * n_sessions
    vids, reads, turn = [root], [], 0
    # lag model: version-watermark drains fire deterministically, so the
    # flusher's staged count is exactly predictable step by step
    expected_staged = 1 if is_async else None
    if is_async and expected_staged >= watermark:
        expected_staged = 0

    for i, (kind, arg) in enumerate(plan["steps"]):
        on_step(i)
        if kind == "stage":
            for _ in range(arg):
                j = turn % n_sessions
                turn += 1
                adds = {int(rng.integers(0, 10)): pay()}
                if rng.integers(0, 2):
                    adds[10 + int(rng.integers(0, 20))] = pay()
                if is_async:
                    v = sessions[j].commit([heads[j]], adds=adds)
                    expected_staged += 1
                    if expected_staged >= watermark:
                        expected_staged = 0
                    assert rs.flusher.staged_versions == expected_staged
                else:
                    v = rs.commit([heads[j]], adds=adds)
                heads[j] = v
                vids.append(v)
        elif kind == "drain":
            rs.barrier()
            if is_async:
                expected_staged = 0
        elif kind == "read":
            got, _ = rs.get_version(vids[-1])   # fresh snapshot: drains
            reads.append(got)
            if is_async:
                expected_staged = 0
        elif kind == "retain":
            retired = set(rs.retain(keep_last(arg)))
            vids = [x for x in vids if x not in retired]
            heads = [h if h not in retired else vids[-1] for h in heads]
            if is_async:
                expected_staged = 0
        elif kind == "compact":
            rs.compact(liveness_threshold=arg)
            if is_async:
                expected_staged = 0
        # "kill" is a schedule marker: on_step injects it in the subject run
        rs.graph.check_invariants()
    if is_async:
        for s in sessions:
            s.close()
    rs.barrier()
    return vids, reads


def _check_async_interleaving(plan):
    """Body of test_async_ingest_interleavings_byte_identical, callable with
    a concrete schedule dict — also exercised by the fixed examples below
    when hypothesis is absent."""
    from repro_torch.core import RetryPolicy

    cfg = dict(algorithm=plan["algorithm"], capacity=plan["capacity"], k=1,
               batch_size=10**9)
    # oracle: synchronous flush on a plain in-memory backend
    rs0 = RStore(RStoreConfig(**cfg), kvs=InMemoryKVS(), device="cpu")
    vids0, reads0 = _drive_async_schedule(
        rs0, np.random.default_rng(plan["seed"]), plan)

    # subject: BackgroundFlusher over replicated flaky (optionally killed)
    # shards.  Per-replica retries inside the group absorb scheduled
    # faults (max_consecutive_faults=2 < max_retries), so drains converge.
    R, n_shards = plan["R"], plan["n_shards"]
    groups = [ReplicatedKVS(
        [FaultInjectingKVS(InMemoryKVS(), seed=plan["seed"] + i * R + r,
                           p_transient=plan["p_transient"],
                           p_timeout=plan["p_timeout"])
         for r in range(R)], write_quorum=1) for i in range(n_shards)]
    kvs1 = groups[0] if n_shards == 1 else ShardedKVS(groups)
    rs1 = RStore(RStoreConfig(**cfg), kvs=kvs1, device="cpu")
    rs1.attach_flusher(max_staged_versions=plan["watermark"],
                       retry=RetryPolicy(max_retries=4))
    kill_steps = [i for i, (k, _) in enumerate(plan["steps"]) if k == "kill"]

    def on_step(i):
        if i in kill_steps:
            for g in groups:
                g.replicas[0].kill()

    vids1, reads1 = _drive_async_schedule(
        rs1, np.random.default_rng(plan["seed"]), plan, on_step)

    # identical interleaving -> identical version ids; every mid-run read
    # and every retained version byte-identical to the synchronous oracle
    assert vids1 == vids0
    assert reads1 == reads0
    for vid in vids0:
        assert rs1.get_version(vid)[0] == rs0.get_version(vid)[0]
    v = vids0[-1]
    pk = next(iter(rs0.get_version(v)[0]))
    assert rs1.get_evolution(pk)[0] == rs0.get_evolution(pk)[0]
    assert rs1.get_range(v, 0, 15)[0] == rs0.get_range(v, 0, 15)[0]
    # drained state is fully durable: zero lag, zero replay
    ing = rs1.storage_stats()["ingest"]
    assert ing["staleness_lag"] == 0 and ing["pending_replay_writes"] == 0

    # recovery: zero lost/duplicated versions after recover_all — every
    # replica of every group converges byte-identically with empty repair
    # logs, and every retained version still reads back exactly
    if kill_steps:
        for g in groups:
            g.replicas[0].revive()
    RecoveryManager(kvs1).recover_all()
    for g in groups:
        want = dict(g.replicas[0].inner.scan())
        for idx, r in enumerate(g.replicas):
            assert dict(r.inner.scan()) == want
            assert g.pending_repairs(idx) == 0
    for vid in vids0:
        assert rs1.get_version(vid)[0] == rs0.get_version(vid)[0]


@given(async_schedule())
@settings(max_examples=8, deadline=None,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large])
def test_async_ingest_interleavings_byte_identical(plan):
    """For ANY interleaving of concurrent-session stages, watermark/explicit
    drains, reads, retention prunings, compaction passes, and replica kills,
    async ingest through a BackgroundFlusher returns byte-identical results
    to the synchronous-flush oracle, its staged-version count follows the
    watermark model exactly, and after revive + recover_all no version is
    lost or duplicated on any replica."""
    _check_async_interleaving(plan)


# fixed corner examples so the contract is still exercised when hypothesis
# is unavailable (conftest shims @given into a skip)
_ASYNC_EXAMPLES = [
    # timeout-mid-drain: heavy ack-lost schedule while watermark drains are
    # in flight — replay idempotence carries the run
    {"algorithm": "bottom_up", "capacity": 512, "watermark": 2,
     "n_sessions": 2, "R": 2, "n_shards": 1,
     "p_transient": 0.0, "p_timeout": 0.3, "seed": 101,
     "steps": [("stage", 3), ("drain", 0), ("stage", 4), ("read", 0),
               ("stage", 2), ("drain", 0)]},
    # kill-between-buffers: one buffer drains healthy, replica 0 of every
    # group dies, the next buffer drains through failover
    {"algorithm": "depth_first", "capacity": 2048, "watermark": 10**9,
     "n_sessions": 3, "R": 2, "n_shards": 3,
     "p_transient": 0.15, "p_timeout": 0.0, "seed": 103,
     "steps": [("stage", 4), ("drain", 0), ("kill", 0), ("stage", 4),
               ("drain", 0), ("read", 0)]},
    # compact-during-stage: compaction (and retention) hit while versions
    # are still staged — the drain barrier must land them first
    {"algorithm": "bottom_up", "capacity": 512, "watermark": 10**9,
     "n_sessions": 2, "R": 3, "n_shards": 1,
     "p_transient": 0.2, "p_timeout": 0.15, "seed": 107,
     "steps": [("stage", 4), ("compact", 0.6), ("stage", 3), ("retain", 4),
               ("stage", 2), ("read", 0), ("compact", 1.0)]},
]


@pytest.mark.parametrize("plan", _ASYNC_EXAMPLES,
                         ids=["timeout-mid-drain", "kill-between-buffers",
                              "compact-during-stage"])
def test_async_ingest_fixed_examples(plan):
    _check_async_interleaving(plan)


# ------------------------------------------ composite planner coherence
def _attr2_extractor(payload: bytes) -> dict:
    # two low-cardinality attrs so composite predicates stay non-vacuous
    # across random payloads
    return {"tag": payload[0] % 4, "hue": payload[1] % 3}


def _composite_probes(full):
    """Brute-force full-scan answers for the composite probe battery."""
    def f(pred):
        return {pk: p for pk, p in full.items() if pred(_attr2_extractor(p))}

    return [
        f(lambda a: a["tag"] == 1 and a["hue"] == 2),            # and_
        f(lambda a: a["tag"] == 0 or a["tag"] == 3),             # or_
        f(lambda a: a["tag"] != 2),                              # not_
        f(lambda a: a["hue"] <= 1 and a["tag"] != 0),            # nested
        sum(1 for p in full.values()
            if _attr2_extractor(p)["tag"] == 1),                 # count
        sorted({_attr2_extractor(p)["hue"] for p in full.values()}),
    ]


def _check_composite_planner_coherent(w, fp):
    """Body of test_composite_plans_byte_identical_under_interleavings,
    callable with concrete (workload, fault-plan) dicts — also exercised by
    test_composite_planner_fixed_examples when hypothesis is absent."""
    cfg = dict(algorithm=w["algorithm"], capacity=w["capacity"], k=w["k"],
               batch_size=w["batch"])
    R, n_shards = fp["R"], fp["n_shards"]

    # oracle: plain in-memory, UNINDEXED store — every composite answer is
    # checked against a brute-force full-version scan + exact filter
    probes0 = []
    rs0 = RStore(RStoreConfig(**cfg), kvs=InMemoryKVS(), device="cpu")

    def probe0(vids):
        full, _ = rs0.get_version(vids[-1])
        probes0.append(_composite_probes(full))

    vids0 = _run_steps(rs0, np.random.default_rng(w["seed"]), w["steps"],
                       lambda i: None, probe=probe0)

    # subject: doubly-indexed store over a replicated (optionally sharded,
    # optionally faulty/killed) backend, same interleaving — answered
    # through planned composite trees and index-only aggregates
    groups = [ReplicatedKVS(
        [FaultInjectingKVS(InMemoryKVS(), seed=fp["seed"] + i * R + r,
                           p_transient=fp["p_transient"],
                           p_timeout=fp["p_timeout"])
         for r in range(R)], write_quorum=1) for i in range(n_shards)]
    kvs1 = groups[0] if n_shards == 1 else ShardedKVS(groups)
    rs1 = RStore(RStoreConfig(**cfg), kvs=kvs1, device="cpu")
    rs1.create_index("tag", _attr2_extractor, n_buckets=3)
    rs1.create_index("hue", _attr2_extractor, n_buckets=3)
    kill_at = fp["kill_step"] % len(w["steps"]) if fp["kill"] else None
    probes1 = []

    def on_step(i):
        if i == kill_at:
            for g in groups:
                g.replicas[0].kill()

    def probe1(vids):
        v = vids[-1]
        res = rs1.snapshot().execute([
            Q.and_(Q.where(v, "tag", 1), Q.where(v, "hue", 2)),
            Q.or_(Q.where(v, "tag", 0), Q.where(v, "tag", 3)),
            Q.and_(Q.version(v), Q.not_(Q.where(v, "tag", 2))),
            Q.and_(Q.where_range(v, "hue", 0, 1),
                   Q.not_(Q.where(v, "tag", 0))),
            Q.count(Q.where(v, "tag", 1)),
            Q.distinct(v, "hue"),
        ])
        # the aggregates answered index-only: zero chunk-payload traffic
        assert res[4].stats.payload_round_trips == 0
        assert res[5].stats.payload_round_trips == 0
        probes1.append([r.value for r in res])

    vids1 = _run_steps(rs1, np.random.default_rng(w["seed"]), w["steps"],
                       on_step, probe=probe1)

    # identical interleaving → identical version ids, and every mid-run
    # composite plan was byte-identical to the brute-force oracle
    assert vids1 == vids0
    assert probes1 == probes0

    # retired versions are refused at PLAN time, live ones still answer
    retired = [vid for vid in range(rs1.graph.num_versions)
               if rs1.graph.is_retired(vid)]
    snap = rs1.snapshot()
    if retired:
        dead = retired[0]
        with pytest.raises(KeyError, match="retired"):
            snap.plan_batch([Q.and_(Q.where(dead, "tag", 1),
                                    Q.where(dead, "hue", 2))])
    full, _ = rs0.get_version(vids0[-1])
    got = snap.execute([Q.and_(Q.version(vids0[-1]),
                               Q.not_(Q.where(vids0[-1], "tag", 2)))])
    assert got[0].value == {pk: p for pk, p in full.items()
                            if _attr2_extractor(p)["tag"] != 2}


@given(maintenance_workload(), fault_plan())
@settings(max_examples=8, deadline=None,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large])
def test_composite_plans_byte_identical_under_interleavings(w, fp):
    """For ANY interleaving of commit waves, retention prunings, compaction
    passes, and replica kills on a replicated flaky backend, every planned
    composite tree (and_/or_/not_ over where/where_range/version) is
    byte-identical to a brute-force full-scan oracle — mid-run after every
    step and at the end — aggregates answer index-only with zero
    chunk-payload round trips, and retired versions are refused at plan
    time."""
    _check_composite_planner_coherent(w, fp)


# fixed corner examples so the contract is still exercised when hypothesis
# is unavailable (conftest shims @given into a skip)
_COMPOSITE_EXAMPLES = [
    # retention retires versions mid-run (plan-time refusal has real
    # retired vids to refuse) + transient faults on a replicated shard
    ({"algorithm": "bottom_up", "k": 1, "batch": 3, "capacity": 512,
      "n_shards": 0, "seed": 131,
      "steps": [("commits", 4), ("retain", 2), ("commits", 3),
                ("compact", 0.6), ("commits", 2)]},
     {"R": 2, "n_shards": 1, "p_transient": 0.15, "p_timeout": 0.0,
      "kill": False, "kill_step": 0, "seed": 137}),
    # k>1 rebuild path + replica kill mid-run on a sharded router with
    # timeouts: composite plans must survive failover reads
    ({"algorithm": "shingle", "k": 3, "batch": 2, "capacity": 2048,
      "n_shards": 0, "seed": 139,
      "steps": [("commits", 5), ("compact", 1.0), ("retain", 4),
                ("commits", 2)]},
     {"R": 3, "n_shards": 3, "p_transient": 0.0, "p_timeout": 0.15,
      "kill": True, "kill_step": 2, "seed": 149}),
]


@pytest.mark.parametrize("w,fp", _COMPOSITE_EXAMPLES,
                         ids=["retain-refusal", "k3-kill-failover"])
def test_composite_planner_fixed_examples(w, fp):
    _check_composite_planner_coherent(w, fp)
