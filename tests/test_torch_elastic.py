"""Elastic restore (``repro_torch.train.elastic``): a checkpoint restored
onto a mesh, as the reference's ``tests/test_train_system.py`` restores it,
and on 4 gloo ranks onto a (2, 2) and a (1, 4) mesh."""
import pickle

import pytest
import torch
import torch.distributed as dist

import torch_mesh_workers as W
from repro_torch import tree as T
from repro_torch.configs import ARCHS
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.train.checkpoint import VersionedCheckpointer
from repro_torch.train.elastic import restore_for_mesh
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_step import init_state


@pytest.fixture
def small_setup():
    """The reference tests' ``small_setup``: smollm-360m reduced, f32."""
    cfg = ARCHS["smollm-360m"].reduced()
    cfg = cfg.__class__(**{**cfg.__dict__, "dtype": "float32",
                           "remat": "none"})
    opt = make_optimizer(cfg)
    state = init_state(cfg, opt, torch.Generator().manual_seed(0), "cpu")
    return cfg, opt, state


def test_elastic_restore_to_different_mesh(small_setup):
    """test_train_system.py:140: restored onto ``make_debug_mesh(1, 1)``
    (a gloo world of one, started by the call), every leaf equals the
    committed state; params carry the rules' placements, the optimizer
    state is replicated."""
    cfg, opt, state = small_setup
    ckpt = VersionedCheckpointer(device="cpu")
    v0 = ckpt.commit(state, parents=())
    try:
        mesh = make_debug_mesh(1, 1, device="cpu")
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        new_state = restore_for_mesh(ckpt, v0, state, cfg, opt, mesh)
        for a, b in zip(T.leaves(state), T.leaves(new_state)):
            assert torch.equal(b.full_tensor(), a) and b.dtype == a.dtype
        assert any(p.is_shard() for d in T.leaves(new_state["params"])
                   for p in d.placements)
        assert all(p.is_replicate() for d in T.leaves(new_state["opt"])
                   for p in d.placements)
    finally:
        dist.destroy_process_group()


def test_debug_mesh_needs_a_world_of_its_size():
    with pytest.raises(ValueError, match="world of 4"):
        try:
            make_debug_mesh(1, 1, device="cpu")
            make_debug_mesh(2, 2, device="cpu")
        finally:
            dist.destroy_process_group()


def test_elastic_restore_on_four_ranks(small_setup, tmp_path):
    """One checkpoint, pickled as the training launcher keeps it, restored
    on 4 gloo ranks onto a (2, 2) and a (1, 4) mesh: every rank's local
    shards are its slices of the full state (rank by rank, mesh dim by
    mesh dim) and ``full_tensor()`` equals it bit for bit."""
    cfg, opt, state = small_setup
    ckpt = VersionedCheckpointer(device="cpu")
    v0 = ckpt.commit(state, parents=())
    ckpt.rs.flush()
    inp = tmp_path / "ckpt.pkl"
    inp.write_bytes(pickle.dumps((ckpt, v0, state, cfg, opt)))
    W.spawn(W.elastic_worker, 4, str(inp), str(tmp_path / "checked"))
    n_leaves = len(T.leaves(state))
    for rank in range(4):
        checked = pickle.loads((tmp_path / f"checked.{rank}").read_bytes())
        assert [c[:2] for c in checked] == [((2, 2), n_leaves),
                                            ((1, 4), n_leaves)]
        assert all(n > 0 for _, _, n in checked)   # shards were checked
