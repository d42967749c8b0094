"""The port's expert-parallel MoE (``layers.moe_shard_map``) on 8 gloo ranks
as a (2, 4) and a (2, 2, 2) mesh, against the port's ``moe`` and the
reference's ``moe_shard_map`` on a (2, 4) mesh of 8 host devices.

Mirrors ``tests/test_perf_features.py``'s ``moe_shard_map`` tests (the
output within 2e-4, the gradients within 5e-3 of ``moe``), adds the
reference's own ``moe_shard_map`` at capacity factor 1.25, where tokens drop
per data shard, and the fallbacks to ``moe``.  One spawn of the 8 ranks
serves every case.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_workers as W
from repro.configs import ARCHS as R_ARCHS
from repro.launch.mesh import _make_mesh
from repro.models import layers as RL
from repro.sharding.rules import mesh_env as r_mesh_env
from repro_torch import tree as T
from repro_torch.configs import ARCHS
from repro_torch.interop import state_from_reference
from repro_torch.models import layers as L


def _cfgs(**kw):
    """granite-moe reduced, f32, in both packages."""
    out = []
    for archs in (R_ARCHS, ARCHS):
        cfg = archs["granite-moe-1b-a400m"].reduced()
        out.append(dataclasses.replace(cfg, **{"dtype": "float32", **kw}))
    return out


def _case(seed, **kw):
    """(reference cfg, port cfg, reference params, port params, x)."""
    cfg_r, cfg_t = _cfgs(**kw)
    p = RL.tree_init(RL.moe_defs(cfg_r, 1), jax.random.PRNGKey(seed),
                     jnp.float32)
    p = jax.tree.map(lambda a: a[0], p)
    x = jax.random.normal(jax.random.PRNGKey(seed + 1),
                          (4, 16, cfg_r.d_model), jnp.float32)
    pt = state_from_reference(jax.tree.map(np.asarray, p), "cpu")
    return cfg_r, cfg_t, p, pt, x, torch.from_numpy(np.asarray(x).copy())


CASES = {
    # the reference tests' drop-free case
    "cf8": dict(seed=0, capacity_factor=8.0, n_experts=8),
    # capacity 1.25: choices drop per (data shard, expert)
    "cf1.25": dict(seed=2, capacity_factor=1.25, n_experts=8),
    # 6 experts do not divide the 4-way model axis: moe itself
    "e6": dict(seed=4, capacity_factor=8.0, n_experts=6),
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case through the 8 ranks once: rank 0's results by (mesh,
    case)."""
    d = tmp_path_factory.mktemp("moe_ranks")
    made = {k: _case(**v) for k, v in CASES.items()}
    torch.save({k: (c[1], c[3], c[5]) for k, c in made.items()},
               d / "in.pt")
    W.spawn(W.moe_worker, 8, str(d / "in.pt"), str(d / "out.pt"))
    return made, torch.load(d / "out.pt")


def _moe_and_grads(cfg, p, x):
    leaves = [t.clone().requires_grad_(True) for t in T.leaves(p) + [x]]
    y, aux = L.moe(T.unflatten_like(p, leaves[:-1]), leaves[-1], cfg)
    grads = torch.autograd.grad((y * y).sum() + aux, leaves)
    return y.detach(), aux.detach(), grads


def test_moe_shard_map_matches_oracle(ranks):
    """test_perf_features.py:31 on 8 gloo ranks: from plain tensors and
    from DTensor params, within 2e-4 of ``moe``."""
    made, res = ranks
    _, cfg, _, p, _, x = made["cf8"]
    want, aux, _ = _moe_and_grads(cfg, p, x)
    for k in ("y", "y_dt"):
        np.testing.assert_allclose(res["2x4", "cf8"][k].numpy(),
                                   want.numpy(), rtol=2e-4, atol=2e-4)
    for k in ("aux", "aux_dt"):
        np.testing.assert_allclose(float(res["2x4", "cf8"][k]),
                                   float(aux), rtol=2e-4, atol=2e-4)


def test_moe_shard_map_gradients_flow(ranks):
    """test_perf_features.py:47 on 8 gloo ranks: the gradients of
    sum(y * y) + aux with respect to every param and the tokens within 5e-3
    of ``moe``'s (the FSDP gathers' reduce-scatter, the model axis's sum)."""
    made, res = ranks
    _, cfg, _, p, _, x = made["cf8"]
    _, _, want = _moe_and_grads(cfg, p, x)
    assert len(res["2x4", "cf8"]["grads"]) == len(want) == 6
    for a, b in zip(res["2x4", "cf8"]["grads"], want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-3,
                                   atol=5e-3)


def test_moe_shard_map_matches_reference_with_drops(ranks):
    """At capacity factor 1.25 each (data shard, expert) keeps its own
    capacity: the port on 8 gloo ranks equals the reference's
    ``moe_shard_map`` on 8 host devices within 2e-4 (output) and 1e-5
    (aux), and differs from the drop-free ``moe``."""
    made, res = ranks
    cfg_r, cfg, p_r, p, x_r, x = made["cf1.25"]
    with r_mesh_env(_make_mesh((2, 4), ("data", "model"))):
        want, aux = jax.jit(lambda p, x: RL.moe_shard_map(p, x, cfg_r))(
            p_r, x_r)
    for k in ("y", "y_dt"):
        np.testing.assert_allclose(res["2x4", "cf1.25"][k].numpy(),
                                   np.asarray(want), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(res["2x4", "cf1.25"]["aux"]),
                               float(aux), rtol=1e-5)
    free, _, _ = _moe_and_grads(dataclasses.replace(cfg,
                                                    capacity_factor=8.0),
                                p, x)
    assert float((res["2x4", "cf1.25"]["y"] - free).abs().max()) > 1e-3


def test_moe_shard_map_indivisible_experts_is_moe(ranks):
    """6 experts over a 4-way model axis: exactly ``moe``'s output."""
    made, res = ranks
    _, cfg, _, p, _, x = made["e6"]
    want, aux, _ = _moe_and_grads(cfg, p, x)
    assert torch.equal(res["2x4", "e6"]["y"], want)
    assert torch.equal(res["2x4", "e6"]["aux"], aux)


def test_moe_shard_map_on_pods_gathers_in_mesh_order(ranks):
    """On a (2, 2, 2) mesh of (pod, data, model) the FSDP shards of a dim
    sharded over (pod, data) are laid out pod-major, and the port gathers
    the data axis first: the output is ``moe``'s within 2e-4 and the
    gradients within 5e-3.  (The reference gathers pod first: on 8 host
    devices its output is 5.9e-3 from ``moe``'s.)"""
    made, res = ranks
    _, cfg, _, p, _, x = made["cf8"]
    want, aux, grads = _moe_and_grads(cfg, p, x)
    for k in ("y", "y_dt"):
        np.testing.assert_allclose(res["2x2x2", "cf8"][k].numpy(),
                                   want.numpy(), rtol=2e-4, atol=2e-4)
    for a, b in zip(res["2x2x2", "cf8"]["grads"], grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-3,
                                   atol=5e-3)


def test_moe_shard_map_without_env_is_moe():
    """No mesh env: exactly ``moe``'s output and aux."""
    _, cfg, _, p, _, x = _case(**CASES["cf8"])
    y, aux = L.moe_shard_map(p, x, cfg)
    want, want_aux = L.moe(p, x, cfg)
    assert torch.equal(y, want) and torch.equal(aux, want_aux)
