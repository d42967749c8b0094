"""The port's sharding rules (``repro_torch.sharding.rules``) against the
reference's, leaf by leaf, on the meshes the reference runs and its tests
use: (1, 4), (2, 4), and the reference's 16×16 pod and 2×16×16 pods.

The port's meshes are ``DeviceMesh``es over a fake process group of their
world size; the reference's are ``jax.sharding.AbstractMesh``es of the same
shape.  For every architecture, under both rule profiles, every leaf of the
param tree, the optimizer state, the decode caches and a batch must get the
reference's partition spec, DTensor placements that say the same, and the
reference's ``NamedSharding.shard_shape`` as its local shard.
"""
import math

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as R_ARCHS
from repro.configs import SHAPES as R_SHAPES
from repro.data.pipeline import batch_spec as r_batch_spec
from repro.models.model import abstract_cache as r_abstract_cache
from repro.models.model import cache_defs as r_cache_defs
from repro.models.model import param_defs as r_param_defs
from repro.sharding import rules as RR
from repro.train.optimizer import make_optimizer as r_make_optimizer
from repro.train.train_step import abstract_state as r_abstract_state
from repro_torch import tree as T
from repro_torch.configs import ARCHS
from repro_torch.data.pipeline import batch_spec
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import _make_mesh
from repro_torch.models.layers import is_def, tree_pspecs
from repro_torch.models.model import abstract_cache, cache_defs, param_defs
from repro_torch.sharding import rules as R
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_step import abstract_state

MESHES = [((1, 4), ("data", "model")), ((2, 4), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
PROFILES = {"default": (R.default_rules, RR.default_rules),
            "dp_only": (R.dp_only_rules, RR.dp_only_rules)}


@pytest.fixture(scope="module", params=MESHES,
                ids=lambda m: "x".join(map(str, m[0])))
def meshes(request):
    """(the port's DeviceMesh on a fake group, the reference's
    AbstractMesh) of one shape."""
    shape, names = request.param
    with fake_world(math.prod(shape)):
        yield _make_mesh(shape, names, "cpu"), AbstractMesh(shape, names)


def _envs(meshes, profile):
    mesh, amesh = meshes
    ours, theirs = PROFILES[profile]
    return R.MeshEnv(mesh, ours(mesh)), RR.MeshEnv(amesh, theirs(amesh))


def _same_leaves(env, got, want):
    """Port leaves (DTensors) against reference ShapeDtypeStructs: shape,
    the placements of the reference's spec, and its shard shape."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        sh = w.sharding          # None: unsharded (the optimizer's step)
        spec = tuple(sh.spec) if sh is not None else ()
        spec += (None,) * (len(w.shape) - len(spec))
        assert tuple(g.placements) == env.placements(spec), (g, spec)
        assert tuple(g.to_local().shape) == \
            tuple(sh.shard_shape(w.shape) if sh is not None else w.shape)


@pytest.mark.parametrize("profile", list(PROFILES))
@pytest.mark.parametrize("name", list(R_ARCHS))
def test_specs_and_shards_equal_reference(meshes, profile, name):
    env, renv = _envs(meshes, profile)
    cfg, rcfg = ARCHS[name], R_ARCHS[name]
    # spec_for, def by def: params and every decode cache the shapes make
    dec = R_SHAPES["decode_32k"]
    pairs = [(param_defs(cfg), r_param_defs(rcfg)),
             (cache_defs(cfg, dec.global_batch, dec.seq_len),
              r_cache_defs(rcfg, dec.global_batch, dec.seq_len)),
             (cache_defs(cfg, 1, 524288), r_cache_defs(rcfg, 1, 524288))]
    for ours, theirs in pairs:
        a = T.leaves(ours, is_leaf=is_def)
        b = jax.tree.leaves(theirs,
                            is_leaf=lambda x: hasattr(x, "axes"))
        assert [(d.shape, d.axes) for d in a] == \
            [(d.shape, d.axes) for d in b]
        for d in a:
            assert env.spec_for(d.shape, d.axes) == \
                tuple(renv.spec_for(d.shape, d.axes)), d
    # tree_pspecs are the placements of those specs
    for d, pl in zip(T.leaves(param_defs(cfg), is_leaf=is_def),
                     T.leaves(tree_pspecs(param_defs(cfg), env),
                              is_leaf=lambda x: isinstance(x, tuple))):
        assert pl == env.placements(env.spec_for(d.shape, d.axes))
    # the abstract leaves: train state, decode caches, a train batch
    opt, ropt = make_optimizer(cfg), r_make_optimizer(rcfg)
    _same_leaves(env, T.leaves(abstract_state(cfg, opt, env)),
                 jax.tree.leaves(r_abstract_state(rcfg, ropt, renv)))
    _same_leaves(env, T.leaves(abstract_cache(cfg, dec.global_batch,
                                              dec.seq_len, env)),
                 jax.tree.leaves(r_abstract_cache(rcfg, dec.global_batch,
                                                  dec.seq_len, renv)))
    tr = R_SHAPES["train_4k"]
    _same_leaves(env, T.leaves(batch_spec(cfg, tr.global_batch, tr.seq_len,
                                          env)),
                 jax.tree.leaves(r_batch_spec(rcfg, tr.global_batch,
                                              tr.seq_len, renv)))


def test_rules_drop_indivisible_assignments(meshes):
    """test_perf_features.py:92, on every mesh of the module."""
    mesh, amesh = meshes
    env = R.MeshEnv(mesh, R.default_rules(mesh))
    tp = env.axis_size("model")
    for heads in (15, 16):
        spec = env.spec_for((960, heads, 64), ("embed", "heads", "head_dim"))
        assert spec[1] == ("model" if heads % tp == 0 else None)
        assert spec == tuple(RR.MeshEnv(amesh, RR.default_rules(amesh))
                             .spec_for((960, heads, 64),
                                       ("embed", "heads", "head_dim")))


def test_dp_only_rules_use_all_axes_for_batch(meshes):
    """test_perf_features.py:104: dp_only shards the batch over every mesh
    axis and drops tensor parallelism; the rules equal the reference's."""
    mesh, amesh = meshes
    rules = R.dp_only_rules(mesh)
    assert rules["batch"] == tuple(mesh.mesh_dim_names)
    assert rules["mlp"] == ()
    assert rules == RR.dp_only_rules(amesh)
    assert R.default_rules(mesh) == RR.default_rules(amesh)


def test_constrain_and_sharding_for(meshes):
    """``sharding_for`` gives one placement per mesh dim; ``constrain``
    redistributes a DTensor to them, passes a plain tensor through, and
    does nothing outside an env."""
    mesh, _ = meshes
    x = torch.empty((64, 8, 32), device="meta")
    assert R.constrain(x, "batch", None, None) is x
    with R.mesh_env(mesh) as env:
        assert R.current_env() is env
        assert R.constrain(x, "batch", None, None) is x
        d = env.abstract((64, 8, 32), (None, None, None), torch.float32)
        got = R.constrain(d, "batch", None, "act_heads")
        assert tuple(got.placements) == env.sharding_for(
            (64, 8, 32), ("batch", None, "act_heads"))
        assert len(got.placements) == mesh.ndim
        want = list(got.shape)
        for entry, n in zip(env.spec_for(got.shape, ("batch", None,
                                                     "act_heads")),
                            range(3)):
            if entry is not None:
                names = (entry,) if isinstance(entry, str) else entry
                want[n] //= math.prod(env.axis_size(a) for a in names)
        assert list(got.to_local().shape) == want
    assert R.current_env() is None


def test_placements_follow_mesh_order(meshes):
    """A dim sharded over several axes lists them in mesh order (pod, data,
    model): DTensor shards left to right over mesh dims, which is JAX's
    major-to-minor order only then; another order is refused."""
    from torch.distributed.tensor import Replicate, Shard
    mesh, _ = meshes
    env = R.MeshEnv(mesh, R.default_rules(mesh))
    names = tuple(mesh.mesh_dim_names)
    n = math.prod(env.axis_size(a) for a in names)
    assert env.spec_for((n, 4), ("attn_batch", None)) == (names, None)
    assert env.placements((names, None)) == (Shard(0),) * len(names)
    assert env.placements((None, None)) == (Replicate(),) * len(names)
    assert env.local_shape((n, 4), ("attn_batch", None)) == (1, 4)
    with pytest.raises(AssertionError):
        env.placements((names[::-1], None))
