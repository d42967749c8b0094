"""The port's serving stack on the CPU: the reference's model-zoo suite
(``tests/test_models.py``) and its engine case
(``tests/test_train_system.py``) run against the port, then module by
module against the reference's JAX functions on shared seeded inputs
(attention's prefill and decode modes, blockwise attention, MoE, the SSD
scan and mixer, every architecture's prefill and decode, the abstract
param and cache trees), the remat policies, and the versioned model
registry of ``examples/serve_demo.py``.  Weights go from the reference to the port through
``repro_torch.interop.state_from_reference``; tolerances are stated per
check."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import ARCHS as R_ARCHS
from repro.data.pipeline import synthetic_batch as r_batch
from repro.models import layers as RL
from repro.models import model as RM
from repro.serve.engine import Engine as REngine
from repro_torch import tree as T
from repro_torch.configs import ARCHS
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.interop import state_from_reference
from repro_torch.models import config as mcfg
from repro_torch.models import layers as L
from repro_torch.models.model import (abstract_cache, abstract_params,
                                      build_model, init_params, zero_cache)
from repro_torch.serve.engine import Engine
from repro_torch.train.checkpoint import VersionedCheckpointer
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_step import init_state, make_train_step

CPU = "cpu"


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def to_t(a):
    return torch.from_numpy(np.array(a, copy=True))


def rng_arr(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(0, scale, shape)
            .astype(np.float32))


def make_batch(cfg, B, S, seed):
    """Seeded random tokens plus the family's stub inputs, on the CPU."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))
             .astype(np.int32)}
    if cfg.family == "vlm":
        batch["prefix_embeds"] = rng.normal(
            0, 1, (B, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(0, 1, (B, S, cfg.d_model)) \
            .astype(np.float32)
    return {k: to_t(v) for k, v in batch.items()}


def small(name, **kw):
    """A reduced config (f32, no remat) in both packages."""
    out = []
    for archs in (R_ARCHS, ARCHS):
        cfg = archs[name].reduced()
        out.append(cfg.__class__(**{**cfg.__dict__, "dtype": "float32",
                                    "remat": "none", **kw}))
    return out


def shared_params(cfg_r, seed):
    """The reference's initial params, and the same weights in the port."""
    params = RM.init_params(cfg_r, jax.random.PRNGKey(seed))
    return params, state_from_reference(jax.tree.map(np.asarray, params), CPU)


def close(t, r, atol, rtol=0.0):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(r), rtol=rtol,
                               atol=atol)


# ===================================== the reference's suites, on the port
@pytest.mark.parametrize("name", list(ARCHS))
def test_arch_smoke_train_step(name):
    """Reduced config: one forward + grad step; shapes and finiteness."""
    cfg = ARCHS[name].reduced()
    model = build_model(cfg)
    params = init_params(cfg, _gen(0), CPU)
    batch = make_batch(cfg, 2, 32, 0)

    logits, aux = model.train_logits(params, batch)
    S_out = 32 + (cfg.n_prefix_embeds if cfg.family == "vlm" else 0)
    assert tuple(logits.shape) == (2, S_out, cfg.padded_vocab)
    assert torch.isfinite(logits).all()

    leaves = [p.requires_grad_(True) for p in T.leaves(params)]
    loss = model.loss(T.unflatten_like(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert np.isfinite(float(loss.detach()))
    gnorm = sum(float(torch.sum(torch.square(g.to(torch.float32))))
                for g in grads if g is not None)
    assert np.isfinite(gnorm) and gnorm > 0


@pytest.mark.parametrize("name", list(ARCHS))
def test_arch_decode_matches_full_forward(name):
    """prefill(S0) + teacher-forced decode of the rest == full forward.

    This exercises KV caches, the SSD chunk-scan ↔ step-recurrence duality,
    conv state carry, and cross-attention caches in one shot."""
    cfg = ARCHS[name].reduced()
    model = build_model(cfg)
    params = init_params(cfg, _gen(1), CPU)
    B, S, S0 = 2, 32, 16
    batch = make_batch(cfg, B, S, 1)

    full_logits, _ = model.train_logits(params, batch)
    full_logits = full_logits.numpy()[..., :cfg.vocab_size]

    pre_batch = dict(batch)
    pre_batch["tokens"] = batch["tokens"][:, :S0]
    # enc-dec/vlm: frontend context stays full-length
    logits0, caches = model.prefill(params, pre_batch)
    P = cfg.n_prefix_embeds if cfg.family == "vlm" else 0

    np.testing.assert_allclose(logits0.numpy()[:, 0, :cfg.vocab_size],
                               full_logits[:, P + S0 - 1], rtol=2e-2,
                               atol=2e-3)

    for t in range(S0, min(S0 + 4, S)):
        tok = batch["tokens"][:, t:t + 1]
        nxt, caches = model.decode_step(params, caches, tok, t + P)
        want = np.argmax(full_logits[:, P + t], axis=-1)
        np.testing.assert_array_equal(nxt.numpy(), want)


def test_blockwise_attention_matches_dense():
    B, S, Hkv, G, dh = 2, 64, 2, 3, 16
    q = to_t(rng_arr(0, (B, S, Hkv, G, dh)))
    k = to_t(rng_arr(1, (B, S, Hkv, dh)))
    v = to_t(rng_arr(2, (B, S, Hkv, dh)))
    for causal in (True, False):
        dense = L._dense_attention(q, k, v, causal=causal, q_offset=0)
        for qb, kb in [(16, 16), (32, 64), (64, 16)]:
            blk = L._blockwise_attention(q, k, v, causal=causal,
                                         q_block=qb, kv_block=kb)
            np.testing.assert_allclose(blk.numpy(), dense.numpy(),
                                       rtol=2e-5, atol=2e-5)


def _ssd_inputs(seed, B=2, S=32, H=3, P=8, N=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(0, 1, (B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.normal(0, 1, (H,)) * 0.3)).astype(np.float32)
    Bm = rng.normal(0, 1, (B, S, N)).astype(np.float32)
    Cm = rng.normal(0, 1, (B, S, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def test_ssd_chunk_scan_matches_recurrence():
    """Chunked SSD == naive per-step state recurrence (the duality)."""
    xs, dts, As, Bs, Cs = _ssd_inputs(3)
    B, S, H, P = xs.shape
    N = Bs.shape[-1]
    for chunk in (4, 8, 16, 32):
        y, final = L._ssd_chunk_scan(*map(to_t, (xs, dts, As, Bs, Cs)), chunk)
        # naive recurrence
        state = np.zeros((B, H, P, N), np.float32)
        ys = np.zeros((B, S, H, P), np.float32)
        for t in range(S):
            decay = np.exp(dts[:, t] * As)                       # (B,H)
            contrib = np.einsum("bn,bh,bhp->bhpn", Bs[:, t], dts[:, t], xs[:, t])
            state = state * decay[..., None, None] + contrib
            ys[:, t] = np.einsum("bn,bhpn->bhp", Cs[:, t], state)
        np.testing.assert_allclose(y.numpy(), ys, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(final.numpy(), state, rtol=2e-4, atol=2e-4)


def _moe_params(cfg, seed):
    p = L.tree_init(L.moe_defs(cfg, 1), _gen(seed), torch.float32, CPU)
    return T.tree_map(lambda a: a[0], p)          # strip layer axis


def test_moe_matches_dense_oracle_when_capacity_unbounded():
    """Scatter-dispatch MoE == dense one-hot einsum dispatch (no drops)."""
    cfg = ARCHS["granite-moe-1b-a400m"].reduced()
    cfg = mcfg.ModelConfig(**{**cfg.__dict__, "capacity_factor": 10.0})
    p = _moe_params(cfg, 4)
    x = to_t(rng_arr(5, (2, 16, cfg.d_model)))

    got, aux = L.moe(p, x, cfg)

    # oracle: dense dispatch
    h = L.rmsnorm(x, p["norm"], cfg.norm_eps).reshape(-1, cfg.d_model)
    probs = torch.softmax(h @ p["router"], dim=-1)
    gate, eid = torch.topk(probs, cfg.moe_top_k)
    gate = gate / gate.sum(-1, keepdim=True)
    up = torch.einsum("td,edf->tef", h, p["wu"])
    act = F.silu(torch.einsum("td,edf->tef", h, p["wg"])) * up
    out_all = torch.einsum("tef,efd->ted", act, p["wd"])        # every expert
    sel = torch.gather(out_all, 1, eid[..., None].expand(-1, -1, cfg.d_model))
    want = x + (sel * gate[..., None]).sum(1).reshape(x.shape)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_moe_capacity_drops_tokens():
    """With capacity_factor → tiny, overflow tokens must be dropped, not
    mis-routed (output stays finite and bounded)."""
    cfg = ARCHS["granite-moe-1b-a400m"].reduced()
    cfg = mcfg.ModelConfig(**{**cfg.__dict__, "capacity_factor": 0.05})
    p = _moe_params(cfg, 0)
    x = to_t(rng_arr(1, (2, 16, cfg.d_model)))
    got, aux = L.moe(p, x, cfg)
    assert torch.isfinite(got).all()
    assert float(aux) >= 0


def test_rope_preserves_norm_and_relativity():
    x = to_t(rng_arr(0, (1, 8, 2, 16)))
    y = L.rope(x, torch.arange(8), 1e4)
    np.testing.assert_allclose(torch.linalg.norm(y, dim=-1).numpy(),
                               torch.linalg.norm(x, dim=-1).numpy(),
                               rtol=1e-5)
    # relative property: <rope(q,i), rope(k,j)> depends only on i-j
    q = to_t(rng_arr(1, (1, 1, 1, 16)))
    k = to_t(rng_arr(2, (1, 1, 1, 16)))

    def dot_at(i, j):
        qi = L.rope(q, torch.tensor([i]), 1e4)
        kj = L.rope(k, torch.tensor([j]), 1e4)
        return float(torch.sum(qi * kj))
    assert abs(dot_at(3, 1) - dot_at(7, 5)) < 1e-4


@pytest.mark.parametrize("name", list(ARCHS))
def test_param_counts_match_assignment(name):
    expected = {
        "mamba2-130m": 0.13e9, "internlm2-20b": 20e9, "smollm-360m": 0.36e9,
        "qwen2.5-32b": 32e9, "stablelm-1.6b": 1.6e9, "whisper-base": 0.074e9,
        "jamba-1.5-large-398b": 398e9, "granite-moe-1b-a400m": 1.3e9,
        "kimi-k2-1t-a32b": 1000e9, "internvl2-26b": 20.9e9}[name]
    got = ARCHS[name].param_count()
    assert 0.55 * expected <= got <= 1.45 * expected, got


def test_engine_generation_matches_stepwise():
    _, cfg = small("smollm-360m")
    model = build_model(cfg)
    params = init_params(cfg, _gen(0), CPU)
    eng = Engine(cfg, params, max_len=128)
    batch = {"tokens": synthetic_batch(cfg, 0, 2, 16, device=CPU)["tokens"]}
    toks = eng.generate(batch, steps=5)
    assert tuple(toks.shape) == (2, 5)
    # manual decode must agree
    logits, caches = model.prefill(params, batch, max_len=128)
    cur = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    manual = [cur[:, 0]]
    pos = 16
    for i in range(4):
        nxt, caches = model.decode_step(params, caches, cur, pos)
        manual.append(nxt)
        cur = nxt[:, None]
        pos += 1
    assert torch.equal(toks, torch.stack(manual, 1))
    with pytest.raises(ValueError, match="exceeds cache capacity"):
        eng.generate(batch, steps=128 - 16 + 1)


# ====================================== against the reference, module by module
def _attn_params(cfg_r, seed):
    defs = RM.param_defs(cfg_r)["blocks"][0]["attn"]
    p = {k: rng_arr(seed + i, d.shape[1:], 0.2)
         for i, (k, d) in enumerate(sorted(defs.items()))}
    p["norm"] = 1 + p["norm"]
    return p


@pytest.mark.parametrize("mode", ["prefill", "decode", "decode_tensor_pos",
                                  "cross_prefill", "cross_decode"])
def test_attention_modes_match_reference(mode):
    """Attention's prefill and decode modes, self and cross, at atol 1e-5:
    the output and the cache each returns (decode's written in place)."""
    cfg_r, cfg_t = small("smollm-360m", qkv_bias=True, n_kv_heads=2)
    p = _attn_params(cfg_r, 30)
    B, Hkv, dh = 2, cfg_r.n_kv_heads, cfg_r.head_dim
    kw_r, kw_t = {}, {}
    if mode == "prefill":
        x = rng_arr(1, (B, 16, cfg_r.d_model))
        kw_r = kw_t = {"mode": "prefill"}
    elif mode.startswith("decode"):
        x = rng_arr(1, (B, 1, cfg_r.d_model))
        cache = {"k": rng_arr(2, (B, 24, Hkv, dh)),
                 "v": rng_arr(3, (B, 24, Hkv, dh))}
        pos = 9
        kw_r = {"mode": "decode", "pos": pos,
                "cache": {k: jnp.asarray(v) for k, v in cache.items()}}
        kw_t = {"mode": "decode", "cache": {k: to_t(v) for k, v in cache.items()},
                "pos": torch.tensor(pos) if mode == "decode_tensor_pos" else pos}
    elif mode == "cross_prefill":
        x = rng_arr(1, (B, 16, cfg_r.d_model))
        kv = rng_arr(4, (B, 20, cfg_r.d_model))
        kw_r = {"mode": "prefill", "kv_x": jnp.asarray(kv)}
        kw_t = {"mode": "prefill", "kv_x": to_t(kv)}
    else:
        x = rng_arr(1, (B, 1, cfg_r.d_model))
        cache = {"k": rng_arr(5, (B, 20, Hkv, dh)),
                 "v": rng_arr(6, (B, 20, Hkv, dh))}
        kw_r = {"mode": "decode", "pos": 3, "is_cross": True,
                "cache": {k: jnp.asarray(v) for k, v in cache.items()}}
        kw_t = {"mode": "decode", "pos": 3, "is_cross": True,
                "cache": {k: to_t(v) for k, v in cache.items()}}
    r, rc = RL.attention({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), cfg_r, **kw_r)
    t, tc = L.attention({k: to_t(v) for k, v in p.items()}, to_t(x), cfg_t,
                        **kw_t)
    close(t, r, 1e-5)
    assert sorted(tc) == sorted(rc) == ["k", "v"]
    for k in ("k", "v"):
        close(tc[k], rc[k], 1e-5)
    if mode.startswith("decode"):
        assert tc["k"] is kw_t["cache"]["k"]          # written in place


def test_dense_attention_bf16_softmax_matches_reference():
    """``softmax_dtype=bf16`` materializes the logits in bf16 as the
    reference does; the result agrees to within one bf16 ulp of the
    largest output (2^-7 relative)."""
    q, k, v = (rng_arr(s, sh) for s, sh in ((7, (2, 12, 2, 2, 16)),
                                             (8, (2, 12, 2, 16)),
                                             (9, (2, 12, 2, 16))))
    mask = np.random.default_rng(10).random((2, 12)) < 0.8
    mask[:, 0] = True
    r = RL._dense_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                            q_offset=0, kv_len_mask=jnp.asarray(mask),
                            softmax_dtype=jnp.bfloat16)
    t = L._dense_attention(*map(to_t, (q, k, v)), causal=True,
                           kv_len_mask=to_t(mask),
                           softmax_dtype=torch.bfloat16)
    close(t, r, float(np.abs(np.asarray(r)).max()) * 2**-7)


@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_attention_matches_reference(causal):
    q = rng_arr(11, (2, 64, 2, 3, 16))
    k = rng_arr(12, (2, 64, 2, 16))
    v = rng_arr(13, (2, 64, 2, 16))
    for qb, kb in [(16, 16), (32, 64), (64, 16)]:
        r = RL._blockwise_attention(*map(jnp.asarray, (q, k, v)),
                                    causal=causal, q_block=qb, kv_block=kb)
        t = L._blockwise_attention(*map(to_t, (q, k, v)), causal=causal,
                                   q_block=qb, kv_block=kb)
        close(t, r, 2e-5)


def test_blockwise_model_matches_reference():
    """``attn_impl="blockwise"`` through the whole model (2 × 2 blocks of 16
    at 32 tokens): the loss at rtol 1e-5 and prefill's logits at atol 1e-4
    against the reference on its weights."""
    cfg_r, cfg_t = small("smollm-360m", attn_impl="blockwise",
                         attn_block_q=16, attn_block_kv=16)
    pr, pt = shared_params(cfg_r, 3)
    batch = r_batch(cfg_r, 2, 2, 32, as_numpy=True)
    loss_r = float(RM.build_model(cfg_r).loss(pr, batch))
    loss_t = float(build_model(cfg_t).loss(pt, {k: to_t(v) for k, v in
                                                batch.items()}))
    assert loss_t == pytest.approx(loss_r, rel=1e-5)
    lr, _ = RM.build_model(cfg_r).prefill(pr, batch)
    lt, _ = build_model(cfg_t).prefill(pt, {k: to_t(v) for k, v in
                                            batch.items()})
    close(lt, lr, 1e-4)


@pytest.mark.parametrize("capacity_factor", [8.0, 0.05])
def test_moe_matches_reference(capacity_factor):
    """Output and aux loss at atol 2e-4, with no drops (8.0, the reduced
    configs' factor) and with most choices dropped (0.05)."""
    cfg_r, cfg_t = small("granite-moe-1b-a400m",
                         capacity_factor=capacity_factor)
    defs = RM.param_defs(cfg_r)["blocks"][0]["moe"]
    p = {k: rng_arr(40 + i, d.shape[1:], 0.2)
         for i, (k, d) in enumerate(sorted(defs.items()))}
    x = rng_arr(14, (2, 16, cfg_r.d_model))
    r, ra = RL.moe({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                   cfg_r)
    t, ta = L.moe({k: to_t(v) for k, v in p.items()}, to_t(x), cfg_t)
    close(t, r, 2e-4)
    close(ta, ra, 2e-4)


@pytest.mark.parametrize("init", [False, True])
def test_ssd_chunk_scan_matches_reference(init):
    x, dt, A, Bm, Cm = _ssd_inputs(15)
    st = rng_arr(16, (2, 3, 8, 4)) if init else None
    for chunk in (4, 32):
        ry, rs = RL._ssd_chunk_scan(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                                    chunk, None if st is None
                                    else jnp.asarray(st))
        ty, ts = L._ssd_chunk_scan(*map(to_t, (x, dt, A, Bm, Cm)), chunk,
                                   None if st is None else to_t(st))
        close(ty, ry, 2e-4)
        close(ts, rs, 2e-4)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_ssm_block_matches_reference(mode):
    """The Mamba2 mixer in each mode at atol 2e-4 (its cache too)."""
    cfg_r, cfg_t = small("mamba2-130m")
    defs = RM.param_defs(cfg_r)["blocks"][0]["ssm"]
    p = {k: rng_arr(50 + i, d.shape[1:], 0.2)
         for i, (k, d) in enumerate(sorted(defs.items()))}
    p["A_log"] = p["A_log"] * 0.5
    B, S = 2, 1 if mode == "decode" else 32
    x = rng_arr(17, (B, S, cfg_r.d_model))
    cache = None
    if mode == "decode":
        H, P = cfg_r.ssm_heads, cfg_r.ssm_head_dim
        N = cfg_r.ssm_groups * cfg_r.ssm_state
        cache = {"state": rng_arr(18, (B, H, P, N)),
                 "conv": rng_arr(19, (B, cfg_r.conv_width - 1,
                                      cfg_r.d_inner + 2 * N))}
    r, rc = RL.ssm_block({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), cfg_r, mode=mode,
                         cache=None if cache is None else
                         {k: jnp.asarray(v) for k, v in cache.items()})
    t, tc = L.ssm_block({k: to_t(v) for k, v in p.items()}, to_t(x), cfg_t,
                        mode=mode, cache=None if cache is None else
                        {k: to_t(v) for k, v in cache.items()})
    close(t, r, 2e-4)
    assert (tc is None) == (rc is None) == (mode == "train")
    for k in (tc or {}):
        close(tc[k], rc[k], 2e-4)


def _r_decode_logits(cfg, params, caches, tokens, pos):
    """The reference's ``decode_step`` up to its logits."""
    x = jnp.take(params["embed"], tokens, axis=0)
    if cfg.family == "encdec":
        x = x + jax.lax.dynamic_slice_in_dim(params["pos_embed"], pos, 1)[None]
        x, new, _ = RM._decoder_with_cross(cfg, params, x, None,
                                           mode="decode", caches=caches,
                                           pos=pos)
        new = list(new) + [caches[-1]]
    else:
        x, new, _ = RM.forward_blocks(cfg, params["blocks"], x,
                                      mode="decode", caches=caches, pos=pos)
    return RM._mask_padded_vocab(cfg, RM._logits(cfg, params, x)), new


@pytest.mark.parametrize("name", list(R_ARCHS))
def test_prefill_and_decode_match_reference(name):
    """Model.prefill's logits and every cache leaf (structure, shapes,
    dtypes; values at atol 1e-4), then 4 teacher-forced decode steps
    (tokens equal, logits at atol 1e-4), on the reference's weights; the
    VLM decodes at ``pos + P`` as the reference's test does."""
    cfg_r = R_ARCHS[name].reduced()
    cfg_t = ARCHS[name].reduced()
    pr, pt = shared_params(cfg_r, 1)
    batch = r_batch(cfg_r, 0, 2, 32, as_numpy=True)
    S0 = 16
    pre = dict(batch, tokens=batch["tokens"][:, :S0])
    lr, cr = jax.jit(RM.build_model(cfg_r).prefill)(
        pr, {k: jnp.asarray(v) for k, v in pre.items()})
    model = build_model(cfg_t)
    lt, ct = model.prefill(pt, {k: to_t(v) for k, v in pre.items()})
    close(lt, lr, 1e-4)
    rp = jax.tree_util.tree_flatten_with_path(cr)[0]
    tp = T.leaves_with_paths(ct)
    assert [jax.tree_util.keystr(p) for p, _ in rp] == \
        ["".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]" for k in p)
         for p, _ in tp]
    for (_, a), (_, b) in zip(rp, tp):
        assert a.shape == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        close(b, a, 1e-4)

    P = cfg_r.n_prefix_embeds if cfg_r.family == "vlm" else 0
    step = jax.jit(lambda p, c, t, pos: _r_decode_logits(cfg_r, p, c, t, pos))
    for t in range(S0, S0 + 4):
        tok = batch["tokens"][:, t:t + 1]
        l1, cr = step(pr, cr, jnp.asarray(tok), t + P)
        l2, ct = model.decode_logits(pt, ct, to_t(tok), t + P)
        close(l2, l1, 1e-4)
        np.testing.assert_array_equal(
            torch.argmax(l2[:, -1], -1).numpy(),
            np.argmax(np.asarray(l1)[:, -1], -1))


@pytest.mark.parametrize("name", list(R_ARCHS))
def test_abstract_params_and_cache_match_reference(name):
    """``abstract_params``/``abstract_cache`` (meta tensors) at full size:
    the reference's shapes and dtypes leaf for leaf (the SSM state f32,
    K/V and conv in the model dtype, the enc-dec cross slot last)."""
    cfg_r, cfg_t = R_ARCHS[name], ARCHS[name]
    for r, t in ((RM.abstract_params(cfg_r), abstract_params(cfg_t)),
                 (RM.abstract_cache(cfg_r, 8, 4096),
                  abstract_cache(cfg_t, 8, 4096))):
        rl = jax.tree_util.tree_flatten_with_path(r)[0]
        tl = T.leaves_with_paths(t)
        assert len(rl) == len(tl)
        for (_, a), (_, b) in zip(rl, tl):
            assert b.device.type == "meta"
            assert a.shape == tuple(b.shape)
            assert str(a.dtype) == str(b.dtype).replace("torch.", "")
    z = zero_cache(ARCHS[name].reduced(), 2, 8, CPU)
    assert all(not x.any() for x in T.leaves(z))


@pytest.mark.parametrize("remat", ["dots", "dots_nb"])
def test_remat_dots_policies_match_none(remat):
    """Selective checkpointing changes what the backward keeps, not what it
    computes: loss and grads equal remat="none"'s bit for bit (granite-moe
    reduced: projections, attention scores and expert matmuls)."""
    out = []
    for policy in ("none", remat):
        cfg = small("granite-moe-1b-a400m", remat=policy)[1]
        params = init_params(cfg, _gen(2), CPU)
        batch = synthetic_batch(cfg, 0, 2, 32, device=CPU)
        leaves = [p.requires_grad_(True) for p in T.leaves(params)]
        loss = build_model(cfg).loss(T.unflatten_like(params, leaves), batch)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


# ============================================ the versioned model registry
def test_model_registry_restores_and_serves():
    """``examples/serve_demo.py`` at reduced size: commit the init state as
    v0, 5 AdamW steps (batch 4 × 64), commit v1; each restore is one KVS
    round trip and gives the committed params bit for bit, and the engine
    serves the same tokens from them as from the params in memory — and,
    for v0, as the reference's engine on the same weights."""
    cfg_r, cfg = small("granite-moe-1b-a400m")
    model = build_model(cfg)
    opt = make_optimizer(cfg)
    step = make_train_step(model, opt)
    pr, _ = shared_params(cfg_r, 0)
    state = init_state(cfg, opt, _gen(0), CPU)
    state["params"] = state_from_reference(jax.tree.map(np.asarray, pr), CPU)
    ckpt = VersionedCheckpointer(device=CPU)
    states = [state]
    v0 = ckpt.commit(state, parents=(), tag="init")
    for i in range(5):
        state, _ = step(state, synthetic_batch(cfg, i, 4, 64, device=CPU))
    states.append(state)
    v1 = ckpt.commit(state, parents=(v0,), tag="tuned")

    prompts = {"tokens": synthetic_batch(cfg, 0, 4, 32, device=CPU)["tokens"]}
    kvs_stats = ckpt.rs.kvs.stats
    served = []
    for vid, want in zip((v0, v1), states):
        q0 = kvs_stats.n_queries
        params = ckpt.restore(vid, like=state)["params"]
        assert kvs_stats.n_queries - q0 == 1
        for a, b in zip(T.leaves(params), T.leaves(want["params"])):
            assert a.dtype == b.dtype and torch.equal(a, b)
        toks = Engine(cfg, params, max_len=32 + 16 + 8).generate(prompts, 16)
        assert torch.equal(toks, Engine(cfg, want["params"], max_len=56)
                           .generate(prompts, 16))
        served.append(toks)
    ref = REngine(cfg_r, pr, max_len=56).generate(
        {"tokens": jnp.asarray(prompts["tokens"].numpy())}, steps=16)
    np.testing.assert_array_equal(served[0].numpy(), np.asarray(ref))
