"""Version graph, types, datagen, and cost-model tests (unit + property)."""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.core import costmodel, datagen
from repro_torch.core.types import (CompositeKey, pack_ck, pack_ck_array, unpack_ck,
                                    unpack_ck_array)


# -------------------------------------------------------------------- types
@given(st.integers(0, 2**31 - 1), st.integers(0, 2**31 - 1))
def test_composite_key_roundtrip(k, v):
    assert unpack_ck(pack_ck(k, v)) == (k, v)


def test_composite_key_rejects_out_of_range():
    with pytest.raises(ValueError):
        pack_ck(2**31, 0)


@given(st.lists(st.tuples(st.integers(0, 2**31 - 1), st.integers(0, 2**20)),
                min_size=1, max_size=50))
def test_composite_key_array_roundtrip(pairs):
    ks = np.array([p[0] for p in pairs], dtype=np.int64)
    vs = np.array([p[1] for p in pairs], dtype=np.int64)
    k2, v2 = unpack_ck_array(pack_ck_array(ks, vs))
    np.testing.assert_array_equal(ks, k2)
    np.testing.assert_array_equal(vs, v2)


def test_composite_key_uniqueness():
    assert pack_ck(1, 2) != pack_ck(2, 1)
    assert CompositeKey(3, 4).packed() == pack_ck(3, 4)


# ------------------------------------------------------------------ datagen
@pytest.mark.parametrize("branch,merge", [(0.0, 0.0), (0.15, 0.0), (0.1, 0.1)])
def test_generated_graph_invariants(branch, merge):
    spec = datagen.DatasetSpec(n_versions=60, n_base_records=200,
                               pct_update=0.1, branch_prob=branch,
                               merge_prob=merge, seed=5)
    g = datagen.generate(spec)
    g.check_invariants()
    assert g.num_versions == 60
    stats = datagen.dataset_stats(g)
    assert stats["unique_records"] >= 200
    # dedupe must pay: total logical bytes >> unique bytes for small updates
    assert stats["total_bytes"] > 3 * stats["unique_bytes"]


def test_generation_is_deterministic():
    spec = datagen.DatasetSpec(n_versions=30, n_base_records=100, seed=9,
                               payloads=True, p_d=0.1)
    g1, g2 = datagen.generate(spec), datagen.generate(spec)
    np.testing.assert_array_equal(g1.store.cks, g2.store.cks)
    assert g1.store.payload(5) == g2.store.payload(5)


def test_chain_dataset_is_chain():
    g = datagen.generate(datagen.DatasetSpec(n_versions=40, branch_prob=0.0,
                                             n_base_records=50))
    assert g.avg_depth() == 39
    assert len(g.leaves()) == 1


def test_bounded_change_payloads():
    spec = datagen.DatasetSpec(n_versions=20, n_base_records=50, seed=2,
                               payloads=True, p_d=0.05, pct_update=0.2,
                               frac_modify=1.0, frac_insert=0.0, frac_delete=0.0)
    g = datagen.generate(spec)
    origins = g.store.origin_versions()
    keys = g.store.keys()
    # find a modified record and its parent record: same key, parent version
    changed = 0
    for rid in range(len(g.store)):
        if origins[rid] == 0:
            continue
        parent_v = g.tree_parent(int(origins[rid]))
        # parent record = same key live at parent version
        pm = g.members(parent_v)
        pk = keys[rid]
        prid = [r for r in pm if keys[r] == pk]
        if not prid:
            continue
        a, b = g.store.payload(int(prid[0])), g.store.payload(rid)
        if len(a) == len(b):
            diff = sum(x != y for x, y in zip(a, b))
            assert diff <= max(1, int(0.05 * len(a))) + 1
            changed += 1
        if changed > 10:
            break
    assert changed > 0


# ------------------------------------------------------- membership algebra
@given(st.integers(0, 10_000))
@settings(max_examples=15, deadline=None)
def test_delta_algebra(seed):
    """Δ+ ∩ Δ− = ∅; member(child) = (member(parent) \\ Δ−) ∪ Δ+;
    reversing an edge swaps Δ+/Δ− (the paper's symmetry)."""
    spec = datagen.DatasetSpec(n_versions=25, n_base_records=80,
                               pct_update=0.15, branch_prob=0.2, seed=seed)
    g = datagen.generate(spec)
    for v in g.versions[1:]:
        d = g.tree_delta[v]
        p = g.tree_parent(v)
        assert np.intersect1d(d.adds, d.dels).size == 0
        recon = np.union1d(np.setdiff1d(g.members(p), d.dels), d.adds)
        np.testing.assert_array_equal(recon, g.members(v))
        r = d.reversed()
        np.testing.assert_array_equal(r.adds, d.dels)
        back = np.union1d(np.setdiff1d(g.members(v), r.dels), r.adds)
        np.testing.assert_array_equal(back, g.members(p))


def test_record_version_csr_consistent():
    g = datagen.generate(datagen.DatasetSpec(n_versions=30, n_base_records=60,
                                             branch_prob=0.2, seed=3))
    indptr, vids = g.record_version_csr()
    # rebuild memberships from CSR and compare
    rebuilt = {v: [] for v in g.versions}
    for r in range(len(g.store)):
        for v in vids[indptr[r]:indptr[r + 1]]:
            rebuilt[int(v)].append(r)
    for v, m in g.memberships().items():
        np.testing.assert_array_equal(np.sort(rebuilt[v]), m)


# ---------------------------------------------------------------- costmodel
def test_costmodel_table1_orderings():
    w = costmodel.Workload(n=100, m_v=1000, d=0.05, c=0.3, s=200, s_c=4000)
    ind = costmodel.independent_chunking(w)
    dl = costmodel.delta(w)
    sc = costmodel.subchunk(w)
    sa = costmodel.single_address(w)
    rs = costmodel.rstore(w, span_factor=1.3)
    # storage: independent is worst; delta/subchunk compress best
    assert ind["storage"] > sa["storage"] > dl["storage"]
    assert dl["storage"] == sc["storage"]
    # version retrieval #queries: chunked ≪ single-address
    assert rs["version_queries"] < sa["version_queries"] / 10
    # point queries: delta is catastrophically worse (fetches half the chain)
    assert dl["point_bytes"] > 50 * rs["point_bytes"]
    assert dl["point_queries"] == w.n / 2 and rs["point_queries"] == 1
