"""The version tree: the generator gives each existing cell the op log and
the requests that the chain generator gave it, byte for byte; a tree keeps a
live set for each branch; and the reference replay answers every query at
every version of a seeded tree as a plain dict replay does."""
import hashlib

import numpy as np
import pytest

from portbench.harness import gen, registry
from portbench.reference import store as ref
from portbench.test_portbench_cells import SEED, TINY

SECONDS = 0.2              # the ingest op log's length follows the window's

# sha256 of each cell's op log (payloads, root, every commit's parent,
# keys, payload ids and deletes), its requests (the window's and the
# warm-up's; an ingest cell's read-back after 1 and 2 sessions) and the
# versions set-up loads, at TINY and SEED: computed with the chain
# generator's harness (gen.make_chain, gen.read_requests and the ingest
# set-up inside runner.run_cell) before the version tree replaced it
CHAIN_DIGESTS = {
    "a2-k1.lookup":
        "4d1978a8b6baebec664ffb405be7cc8e57c3d00b7396f6281d1b20036cbe5df5",
    "a2-k3.snapshot":
        "8e240b66d6563144a252c94ba3cf2a574a340a01b8ad5f24782ad5d05093f24b",
    "a2-k1.ingest":
        "78938dc7ff774926528dffd2b3a37c6a54c2b09aae60b77b235fe089fc908685",
    "a2-k1.snapshot":
        "b804d3780f7400180b4f879d30cafd5648cc1ee993c453e56d5223c9ee91ae5b",
}


def _digest_log(h, log):
    h.update(np.int64([log.record_size, log.n_base, log.max_key,
                       log.n_versions]).tobytes())
    h.update(np.ascontiguousarray(log.payloads).tobytes())
    h.update(log.root_keys.astype(np.int64).tobytes())
    h.update(log.root_pids.astype(np.int64).tobytes())
    for c in log.commits:
        h.update(np.int64([c.vid, c.parent, len(c.keys),
                           len(c.dels)]).tobytes())
        for a in (c.keys, c.pids, c.dels):
            h.update(np.asarray(a, np.int64).tobytes())


def cell_digest(cell: registry.Cell, topology: str) -> str:
    config = {**cell.config, **TINY}
    data = dict(config["data"], topology=topology)
    parents, loaded = cell.kind.plan(config, cell.mix, SECONDS)
    assert parents == [v - 1 for v in range(1, len(parents) + 1)]
    log = gen.make_log(data, int(config["n_base_records"]), parents, SEED)
    h = hashlib.sha256()
    _digest_log(h, log)
    if cell.mix["kind"] == "read":
        timed, warm = cell.kind.requests(cell.mix, log, SEED)
        h.update(repr(timed).encode())
        h.update(repr(warm).encode())
    else:
        S = int(cell.mix["session_versions"])
        for units in (S, 2 * S):
            h.update(repr(cell.kind.readback_queries(
                cell.mix, log, SEED, loaded, loaded + units - 1)).encode())
    h.update(repr(loaded).encode())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(CHAIN_DIGESTS))
@pytest.mark.parametrize("topology", ["linear_chain", "tree"])
def test_each_cell_gets_the_chain_generators_work(name, topology):
    """Every parent the version before: the tree generator makes the chain's
    op log, requests and load, whether the data says chain or tree."""
    cell = registry.find_cell(name)
    assert cell_digest(cell, topology) == CHAIN_DIGESTS[name]


def test_a_chain_refuses_parents_that_branch():
    data = registry.load_config("a2-k1")["data"]
    with pytest.raises(ValueError, match="topology"):
        gen.make_log(data, 64, [0, 0, 1], SEED)
    with pytest.raises(ValueError, match="parent"):
        gen.make_log(dict(data, topology="tree"), 64, [0, 2], SEED)


def _brute(log):
    """Each version's records as a dict of key to payload id, replayed from
    its parent's."""
    states = [dict(zip(log.root_keys.tolist(), log.root_pids.tolist()))]
    for c in log.commits:
        s = dict(states[c.parent])
        for k in c.dels.tolist():
            del s[k]
        s.update(zip(c.keys.tolist(), c.pids.tolist()))
        states.append(s)
    return states


@pytest.mark.parametrize("config", ["a2-k1", "a2-k3"])
def test_each_branch_keeps_its_own_live_set(config):
    """A commit modifies and deletes only records live at its parent, and
    inserts keys no branch has had."""
    data = dict(registry.load_config(config)["data"], topology="tree",
                pct_update=0.2)
    parents = [0, 0, 1, 2, 1, 0, 5, 3, 3]
    log = gen.make_log(data, 128, parents, SEED)
    states, seen = _brute(log), set(log.root_keys.tolist())
    for c in log.commits:
        live = states[c.parent]
        mods = [k for k in c.keys.tolist() if k in live]
        new = [k for k in c.keys.tolist() if k not in live]
        assert set(c.dels.tolist()) <= set(live) and len(mods) > 0
        assert not seen & set(new)
        seen |= set(new)
        if data["p_d"] is not None:        # a span of the parent's copy
            R = log.record_size
            span = max(1, int(R * data["p_d"]))
            for k, p in zip(c.keys.tolist(), c.pids.tolist()):
                if k in live:
                    diff = np.flatnonzero(log.payloads[p] !=
                                          log.payloads[live[k]])
                    assert len(diff) == 0 or diff[-1] - diff[0] < span
    assert [c.parent for c in log.commits] == parents


def _random_tree(seed: int, n_versions: int = 40, pool: int = 60):
    """A seeded tree over a small key pool: every commit modifies, deletes
    and inserts, and inserts reuse keys deleted before."""
    rng = np.random.default_rng(seed)
    states = [{k: k for k in range(pool // 2)}]
    n_pay = pool // 2
    commits = []
    for vid in range(1, n_versions):
        parent = int(rng.integers(0, vid))
        s = dict(states[parent])
        live = np.array(sorted(s))
        dead = np.array(sorted(set(range(pool)) - set(s)))
        mods = rng.choice(live, size=min(3, len(live)), replace=False)
        rest = np.setdiff1d(live, mods)
        dels = rng.choice(rest, size=min(2, len(rest)), replace=False)
        ins = rng.choice(dead, size=min(3, len(dead)), replace=False)
        keys = np.concatenate([mods, ins]).astype(np.int64)
        pids = np.arange(n_pay, n_pay + len(keys), dtype=np.int64)
        n_pay += len(keys)
        for k in dels.tolist():
            del s[k]
        s.update(zip(keys.tolist(), pids.tolist()))
        states.append(s)
        commits.append((vid, parent, keys, pids, dels.astype(np.int64)))
    payloads = np.random.default_rng(seed + 1).integers(
        0, 256, size=(n_pay, 8), dtype=np.uint8)
    return states, commits, payloads


@pytest.mark.parametrize("seed", [SEED, 7])
def test_the_replay_answers_from_each_versions_lineage(seed):
    states, commits, payloads = _random_tree(seed)
    pool = 60
    reinserted = {k for vid, parent, ks, _, _ in commits
                  for k in ks.tolist() if k not in states[parent]
                  and any(k in states[v] for v in range(parent))}
    assert reinserted                 # the tree reinserts deleted keys
    root = (np.arange(pool // 2, dtype=np.int64),
            np.arange(pool // 2, dtype=np.int64))
    rep = ref.Replay(root, commits, payloads)

    def pay(p):
        return payloads[p].tobytes()

    for v, s in enumerate(states):
        keys, pids = ref.answer(rep, ("version", v))
        assert keys.tolist() == sorted(s)
        assert pids.tolist() == [s[k] for k in sorted(s)]
        assert ref.same({k: pay(p) for k, p in s.items()}, ("version", v),
                        (keys, pids), payloads)
        for k in range(pool + 2):
            want = pay(s[k]) if k in s else None
            assert ref.answer(rep, ("record", v, k)) == want
        for lo, hi in [(0, 9), (10, 40), (35, pool + 5)]:
            assert ref.answer(rep, ("range", v, lo, hi)) == \
                {k: pay(p) for k, p in s.items() if lo <= k <= hi}
    for k in range(pool):
        want = [(0, pay(k))] if k < pool // 2 else []
        want += [(vid, pay(p)) for vid, _, ks, ps, _ in commits
                 for kk, p in zip(ks.tolist(), ps.tolist()) if kk == k]
        assert ref.answer(rep, ("evolution", k)) == want


def test_the_replay_refuses_a_parent_after_its_child():
    root = (np.arange(4, dtype=np.int64), np.arange(4, dtype=np.int64))
    empty = np.zeros(0, np.int64)
    with pytest.raises(ValueError, match="parent"):
        ref.Replay(root, [(1, 0, empty, empty, empty),
                          (2, 2, empty, empty, empty)],
                   np.zeros((4, 8), np.uint8))
