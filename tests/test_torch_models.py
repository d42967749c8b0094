"""The port's model stack against the reference package, on the CPU: the
config language and the registry field for field, the synthetic pipeline
bit for bit, the param trees of every architecture, and the dense layers,
the loss and its gradients on shared weights within stated tolerances.
Weights go from the reference to the port through
``repro_torch.interop.state_from_reference``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.configs.registry import OPTIMIZED as R_OPTIMIZED
from repro.configs import SHAPES as R_SHAPES
from repro.configs import cells as r_cells
from repro.data.pipeline import synthetic_batch as r_batch
from repro.models import layers as RL
from repro.models.model import build_model as r_build
from repro.models.model import init_params as r_init
from repro.models.model import param_defs as r_defs
from repro_torch import tree as T
from repro_torch.configs import ARCHS, SHAPES, cells
from repro_torch.configs.registry import OPTIMIZED
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.interop import state_from_reference, state_to_numpy
from repro_torch.models import layers as L
from repro_torch.models.model import build_model, init_params, param_defs

CPU = "cpu"


def small(name="smollm-360m", **kw):
    """The reference tests' ``small_setup`` config (reduced, f32, no remat)
    in both packages."""
    out = []
    for archs in (R_ARCHS, ARCHS):
        cfg = archs[name].reduced()
        out.append(cfg.__class__(**{**cfg.__dict__, "dtype": "float32",
                                    "remat": "none", **kw}))
    return out


def to_t(a):
    return torch.from_numpy(np.array(a, copy=True))


def rng_arr(seed, shape, scale=1.0, dtype=np.float32):
    return (np.random.default_rng(seed).normal(0, scale, shape)
            .astype(dtype))


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("name", list(R_ARCHS))
def test_arch_config_equals_reference(name):
    ref, port = R_ARCHS[name], ARCHS[name]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == dataclasses.asdict(ref.reduced())
    for a, b in ((port, ref), (port.reduced(), ref.reduced())):
        assert a.param_count() == b.param_count()
        assert a.active_param_count() == b.active_param_count()
        assert a.layer_plan() == b.layer_plan()
        assert a.scan_period() == b.scan_period()
        assert (a.padded_vocab, a.d_inner, a.ssm_heads, a.d_ff_e) == \
            (b.padded_vocab, b.d_inner, b.ssm_heads, b.d_ff_e)
    assert port.torch_dtype == {"bfloat16": torch.bfloat16,
                                "float32": torch.float32}[ref.dtype]


def test_registry_and_shapes_equal_reference():
    assert list(ARCHS) == list(R_ARCHS)
    assert OPTIMIZED == R_OPTIMIZED
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in R_SHAPES.items()}
    assert cells(ARCHS) == r_cells(R_ARCHS)
    from repro_torch.configs import granite_moe_1b_a400m, smollm_360m
    assert smollm_360m.CONFIG is ARCHS["smollm-360m"]
    assert granite_moe_1b_a400m.CONFIG is ARCHS["granite-moe-1b-a400m"]


# ------------------------------------------------------------------ pipeline
@pytest.mark.parametrize("name", ["smollm-360m", "internvl2-26b",
                                  "whisper-base"])
def test_synthetic_batch_bit_equal(name):
    """dense, vlm and encdec batches equal the reference's bit for bit."""
    cfg_r, cfg_t = R_ARCHS[name].reduced(), ARCHS[name].reduced()
    for step in (0, 7, 10_003, 2**29):
        a = r_batch(cfg_r, step, 3, 24, as_numpy=True)
        b = synthetic_batch(cfg_t, step, 3, 24, device=CPU, as_numpy=True)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k].view(np.uint8),
                                          b[k].view(np.uint8))


# ---------------------------------------------------------------- param defs
@pytest.mark.parametrize("name", list(R_ARCHS))
def test_param_defs_equal_reference(name):
    cfg_r, cfg_t = R_ARCHS[name], ARCHS[name]
    ref = jax.tree_util.tree_flatten_with_path(
        r_defs(cfg_r), is_leaf=lambda x: isinstance(x, RL.ParamDef))[0]
    port = T.leaves_with_paths(param_defs(cfg_t), is_leaf=L.is_def)
    assert [jax.tree_util.keystr(p) for p, _ in ref] == \
        ["".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]" for k in p)
         for p, _ in port]
    assert [(d.shape, d.axes, d.init, d.scale) for _, d in ref] == \
        [(d.shape, d.axes, d.init, d.scale) for _, d in port]


def test_init_params_seeded_and_shaped():
    _, cfg = small()
    a = init_params(cfg, torch.Generator().manual_seed(3), CPU)
    b = init_params(cfg, torch.Generator().manual_seed(3), CPU)
    defs = T.leaves(param_defs(cfg), is_leaf=L.is_def)
    for d, x, y in zip(defs, T.leaves(a), T.leaves(b)):
        assert tuple(x.shape) == d.shape and x.dtype == torch.float32
        assert torch.equal(x, y)
        if d.init == "ones":
            assert torch.equal(x, torch.ones_like(x))
    assert float(a["embed"].std()) == pytest.approx(0.02, rel=0.1)


# -------------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_forward_and_backward_match_reference(dtype):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    x = jnp.asarray(rng_arr(0, (2, 5, 64))).astype(jdt)
    s = jnp.asarray(1 + rng_arr(1, (64,), 0.1)).astype(jdt)
    g = jnp.asarray(rng_arr(2, (2, 5, 64))).astype(jdt)
    y_r, vjp = jax.vjp(lambda a, b: RL.rmsnorm(a, b, 1e-5), x, s)
    dx_r, ds_r = vjp(g)
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    xt = to_t(f32(x)).to(tdt).requires_grad_(True)
    st = to_t(f32(s)).to(tdt).requires_grad_(True)
    y_t = L.rmsnorm(xt, st, 1e-5)
    dx_t, ds_t = torch.autograd.grad(y_t, (xt, st), to_t(f32(g)).to(tdt))
    assert y_t.dtype == dx_t.dtype == ds_t.dtype == tdt
    # f32: atol 1e-5; bf16: one bf16 ulp of the largest value
    for r, t in ((y_r, y_t), (dx_r, dx_t), (ds_r, ds_t)):
        r = f32(r)
        t = t.detach().to(torch.float32).numpy()
        atol = 1e-5 if dtype == "float32" else float(np.abs(r).max()) * 2**-7
        np.testing.assert_allclose(t, r, rtol=0, atol=atol)


def test_rope_matches_reference():
    x = rng_arr(3, (2, 12, 4, 16))
    for pos in (np.arange(12, dtype=np.int32),
                np.stack([np.arange(12), np.arange(12) + 5]).astype(np.int32)):
        r = np.asarray(RL.rope(jnp.asarray(x), jnp.asarray(pos), 1e4))
        t = L.rope(to_t(x), to_t(pos), 1e4).numpy()
        np.testing.assert_allclose(t, r, rtol=0, atol=1e-5)


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_attention_matches_reference(qkv_bias):
    cfg_r, cfg_t = small(qkv_bias=qkv_bias, n_kv_heads=2)
    defs = r_defs(cfg_r)["blocks"][0]["attn"]
    p = {k: rng_arr(10 + i, d.shape[1:], 0.2)
         for i, (k, d) in enumerate(sorted(defs.items()))}
    p["norm"] = 1 + p["norm"]
    x = rng_arr(4, (2, 16, cfg_r.d_model))
    r, _ = RL.attention({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), cfg_r, mode="train")
    t, _ = L.attention({k: to_t(v) for k, v in p.items()}, to_t(x), cfg_t,
                       mode="train")
    np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=0, atol=1e-5)


@pytest.mark.parametrize("act", ["silu_glu", "gelu"])
def test_mlp_matches_reference(act):
    cfg_r, cfg_t = small(act=act)
    defs = r_defs(cfg_r)["blocks"][0]["mlp"]
    p = {k: rng_arr(20 + i, d.shape[1:], 0.2)
         for i, (k, d) in enumerate(sorted(defs.items()))}
    x = rng_arr(5, (2, 16, cfg_r.d_model))
    r = RL.mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
               cfg_r)
    t = L.mlp({k: to_t(v) for k, v in p.items()}, to_t(x), cfg_t)
    np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=0, atol=1e-5)


# -------------------------------------------------------------- model, loss
@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_grads_match_reference(remat):
    """Model.loss at rtol 1e-5, its gradients at rtol 1e-4 / atol 1e-6, on
    the reference's initial weights (batch 4 × 64)."""
    cfg_r, cfg_t = small(remat=remat)
    params = r_init(cfg_r, jax.random.PRNGKey(0))
    batch = r_batch(cfg_r, 0, 4, 64)
    loss_r, g_r = jax.value_and_grad(r_build(cfg_r).loss)(params, batch)
    pt = state_from_reference(jax.tree.map(np.asarray, params), CPU)
    leaves = [p.requires_grad_(True) for p in T.leaves(pt)]
    loss_t = build_model(cfg_t).loss(
        T.unflatten_like(pt, leaves),
        {k: to_t(v) for k, v in batch.items()})
    g_t = torch.autograd.grad(loss_t, leaves)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_r), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(g_r), g_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-6)


def test_train_logits_shape_and_tied_head():
    cfg_r, cfg_t = small()
    params = init_params(cfg_t, torch.Generator().manual_seed(0), CPU)
    batch = synthetic_batch(cfg_t, 0, 2, 16, device=CPU)
    logits, aux = build_model(cfg_t).train_logits(params, batch)
    assert tuple(logits.shape) == (2, 16, cfg_t.padded_vocab)
    assert float(aux) == 0.0 and torch.isfinite(logits).all()
    assert "lm_head" not in params            # smollm ties its embeddings
    untied = small(tie_embeddings=False)[1]
    assert "lm_head" in init_params(untied, torch.Generator(), CPU)


def test_padded_vocab_is_masked_like_the_reference():
    cfg_r, cfg_t = small(vocab_size=500)       # padded to 512
    params = r_init(cfg_r, jax.random.PRNGKey(1))
    batch = r_batch(cfg_r, 3, 2, 16)
    r = float(r_build(cfg_r).loss(params, batch))
    t = float(build_model(cfg_t).loss(
        state_from_reference(jax.tree.map(np.asarray, params), CPU),
        {k: to_t(v) for k, v in batch.items()}))
    assert t == pytest.approx(r, rel=1e-5)


def test_shard_map_moe_raises_naming_item_3():
    """The expert-parallel MoE needs a device mesh: it raises
    NotImplementedError naming the sharding slice, never another code
    path."""
    cfg = small("granite-moe-1b-a400m", moe_impl="shard_map")[1]
    params = init_params(cfg, torch.Generator().manual_seed(0), CPU)
    batch = synthetic_batch(cfg, 0, 2, 16, device=CPU)
    with pytest.raises(NotImplementedError, match="ROADMAP item 3"):
        build_model(cfg).loss(params, batch)


def test_state_interop_round_trips_bf16():
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": [np.int32(7), np.asarray(jnp.asarray([1.5, -2.25],
                                                      jnp.bfloat16))]}
    t = state_from_reference(tree, CPU)
    assert t["b"][1].dtype == torch.bfloat16 and t["b"][0].dtype == torch.int32
    back = state_to_numpy(t)
    np.testing.assert_array_equal(back["a"], tree["a"])
    assert back["b"][0] == 7
    np.testing.assert_array_equal(back["b"][1], [1.5, -2.25])
