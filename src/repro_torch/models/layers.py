"""Model building blocks on the reference's param-def system, in PyTorch.

Parameters are declared as ``ParamDef(shape, logical_axes)`` trees, as in
the reference package's ``models/layers.py``; ``tree_init`` makes them
concrete from an explicit ``torch.Generator`` on a device, and
``tree_abstract`` describes them as tensors on the ``meta`` device.  Every
block is a function of the param tree and the activations.

Blocks: RMSNorm (with the reference's hand-written backward), RoPE, GQA
attention (dense, blockwise online-softmax, and the prefill/decode cache
modes, self and cross), the SwiGLU/GELU MLP, top-k MoE with capacity-bounded
scatter dispatch, and the Mamba2 SSD mixer as a chunked scan.  The sharded
halves of the reference (``tree_pspecs``, ``moe_shard_map``) need a device
mesh and come with the sharding slice (ROADMAP item 3).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import tree as T
from .config import ModelConfig

NEG = -1e30     # the reference's mask value (softmax logits, padded vocab)


# ---------------------------------------------------------------- param defs
@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"        # normal | ones | zeros | small_normal
    scale: float = 0.02

    def abstract(self, dtype: torch.dtype) -> torch.Tensor:
        """The leaf's shape and dtype as a tensor on the ``meta`` device
        (no storage)."""
        return torch.empty(self.shape, dtype=dtype, device="meta")

    def initialize(self, generator: torch.Generator, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        x = torch.randn(self.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x * self.scale).to(dtype)


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def tree_abstract(defs, dtype: torch.dtype):
    """``meta`` tensors for a def tree (shapes and dtypes, no storage)."""
    return T.tree_map(lambda d: d.abstract(dtype), defs, is_leaf=is_def)


def tree_init(defs, generator: torch.Generator, dtype: torch.dtype,
              device: torch.device):
    """Concrete tensors for a def tree, drawn from ``generator`` leaf by
    leaf in flattening order."""
    return T.tree_map(lambda d: d.initialize(generator, dtype, device), defs,
                      is_leaf=is_def)


# --------------------------------------------------------------------- norms
class _RMSNorm(torch.autograd.Function):
    """RMSNorm with the reference's memory-lean backward (``_rmsnorm_bwd``):
    every (B,S,D) boundary tensor in the input dtype, only the (B,S,1) row
    statistics in f32."""

    @staticmethod
    def forward(ctx, x, scale, eps: float):
        xf = x.to(torch.float32)
        rstd = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
        ctx.save_for_backward(x, scale, rstd)
        return (xf * rstd).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        x, scale, rstd = ctx.saved_tensors
        f32 = torch.float32
        xn = (x.to(f32) * rstd).to(x.dtype)                  # normalized
        gs = g * scale
        dscale = (g.to(f32) * xn.to(f32)).reshape(-1, x.shape[-1]) \
            .sum(dim=0).to(scale.dtype)
        c = (gs.to(f32) * xn.to(f32)).mean(dim=-1, keepdim=True)
        dx = ((gs.to(f32) - xn.to(f32) * c) * rstd).to(x.dtype)
        return dx, dscale, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return _RMSNorm.apply(x, scale, eps)


# ---------------------------------------------------------------------- RoPE
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, dh); positions: (S,) or (B, S)."""
    dh = x.shape[-1]
    half = dh // 2
    # the reference's float64 frequencies, made on x's device: a host
    # array would cost a synchronizing copy per call
    i = torch.arange(half, dtype=torch.float64, device=x.device)
    freqs = (1.0 / (theta ** (i / half))).to(torch.float32)
    ang = positions[..., None].to(torch.float32) * freqs       # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                         # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- attention
def attn_defs(cfg: ModelConfig, L: int) -> Dict[str, ParamDef]:
    D, Hq, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    d = {
        "norm": ParamDef((L, D), ("layers", None), init="ones"),
        "wq": ParamDef((L, D, Hq, dh), ("layers", "embed", "heads", "head_dim")),
        "wk": ParamDef((L, D, Hkv, dh), ("layers", "embed", "kv_heads", "head_dim")),
        "wv": ParamDef((L, D, Hkv, dh), ("layers", "embed", "kv_heads", "head_dim")),
        "wo": ParamDef((L, Hq, dh, D), ("layers", "heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        d["bq"] = ParamDef((L, Hq, dh), ("layers", "heads", "head_dim"), init="zeros")
        d["bk"] = ParamDef((L, Hkv, dh), ("layers", "kv_heads", "head_dim"), init="zeros")
        d["bv"] = ParamDef((L, Hkv, dh), ("layers", "kv_heads", "head_dim"), init="zeros")
    return d


def _split_heads_q(q: torch.Tensor, Hkv: int) -> torch.Tensor:
    # (B, S, Hq, dh) -> (B, S, Hkv, G, dh)
    B, S, Hq, dh = q.shape
    return q.reshape(B, S, Hkv, Hq // Hkv, dh)


def _sm_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.attn_softmax_dtype == "bf16" else torch.float32


def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python number: a tensor times it
    computes what the reference's tensor times a ``dtype`` scalar does."""
    return torch.tensor(value, dtype=dtype).item()


def _dense_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                     kv_len_mask: Optional[torch.Tensor] = None,
                     softmax_dtype: torch.dtype = torch.float32):
    """q: (B,Sq,Hkv,G,dh); k/v: (B,Skv,Hkv,dh).  Returns (B,Sq,Hkv,G,dh).

    As the reference does it: logits and the ``-1e30`` masks in
    ``softmax_dtype`` (the dtype of the materialized S×S tensors), the
    softmax itself in f32."""
    dh = q.shape[-1]
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q, k).to(softmax_dtype)
    logits = logits * _in_dtype(1.0 / math.sqrt(dh), softmax_dtype)
    Sq, Skv = q.shape[1], k.shape[1]
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + q_offset
        ki = torch.arange(Skv, device=q.device)[None, :]
        logits = logits.masked_fill(qi < ki, NEG)
    if kv_len_mask is not None:                        # (B, Skv) bool
        logits = logits.masked_fill(~kv_len_mask[:, None, None, None, :], NEG)
    probs = torch.softmax(logits.to(torch.float32), dim=-1).to(q.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs, v)


def _blockwise_attention(q, k, v, *, causal: bool, q_block: int,
                         kv_block: int):
    """Flash-style online-softmax attention: a loop over q blocks (outer)
    and kv blocks (inner) with the reference's f32 carries (running max,
    running sum, accumulator), O(Sq·dh + qb·kb) live memory."""
    B, Sq, Hkv, G, dh = q.shape
    Skv = k.shape[1]
    qb = min(q_block, Sq)
    kb = min(kv_block, Skv)
    assert Sq % qb == 0 and Skv % kb == 0
    nq, nk = Sq // qb, Skv // kb
    scale = 1.0 / math.sqrt(dh)
    f32 = torch.float32
    out = []
    for qi in range(nq):
        q_i = q[:, qi * qb:(qi + 1) * qb]
        m = torch.full((B, Hkv, G, qb), -math.inf, dtype=f32, device=q.device)
        l = torch.zeros((B, Hkv, G, qb), dtype=f32, device=q.device)
        acc = torch.zeros((B, Hkv, G, qb, dh), dtype=f32, device=q.device)
        for kj in range(nk):
            k_j = k[:, kj * kb:(kj + 1) * kb]
            v_j = v[:, kj * kb:(kj + 1) * kb]
            s = torch.einsum("bqhgd,bkhd->bhgqk", q_i, k_j).to(f32) * scale
            if causal:
                qidx = qi * qb + torch.arange(qb, device=q.device)[:, None]
                kidx = kj * kb + torch.arange(kb, device=q.device)[None, :]
                s = s.masked_fill(qidx < kidx, NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(q.dtype), v_j).to(f32)
            m = m_new
        blk = (acc / l[..., None]).to(q.dtype)               # (B,Hkv,G,qb,dh)
        out.append(blk.permute(0, 3, 1, 2, 4))               # (B,qb,Hkv,G,dh)
    return torch.cat(out, dim=1)


def attention(p, x: torch.Tensor, cfg: ModelConfig, *, causal: bool = True,
              mode: str = "train", cache: Optional[dict] = None, pos=None,
              kv_x: Optional[torch.Tensor] = None, is_cross: bool = False,
              positions: Optional[torch.Tensor] = None):
    """Pre-norm GQA attention block.  Returns (residual_out, new_cache).

    modes: "train"/"prefill": full sequence; prefill also returns the K/V
    cache ``{"k", "v"}`` (B, S, Hkv, dh).  "decode": one step (S == 1)
    against ``cache`` at position ``pos`` (a Python int or a 0-d tensor);
    the step's K/V are written into ``cache`` in place (the counterpart of
    the reference's donated cache) and attention covers positions
    ``<= pos``.  ``kv_x``/``is_cross`` switch to cross-attention (keys and
    values from encoder states; in decode the cache holds the precomputed
    cross K/V, never updated).
    """
    B, S, D = x.shape
    Hq, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    cross = is_cross or kv_x is not None
    if cross and cache is not None and mode == "decode":
        k, v = cache["k"], cache["v"]          # precomputed cross K/V
        new_cache = cache
    else:
        src = kv_x if cross else h
        k = torch.einsum("bsd,dhk->bshk", src, p["wk"])
        v = torch.einsum("bsd,dhk->bshk", src, p["wv"])
        if "bk" in p:
            k, v = k + p["bk"], v + p["bv"]
        new_cache = None

    if mode == "decode":
        pos = int(pos)
    if positions is None:
        positions = (torch.arange(S, dtype=torch.int32, device=x.device)
                     if mode != "decode" else
                     torch.full((1,), pos, dtype=torch.int32, device=x.device))
    if cfg.use_rope and not cross:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    qg = _split_heads_q(q, Hkv)
    sm = _sm_dtype(cfg)
    if mode == "decode" and not cross:
        # write into the cache, attend over the valid prefix
        k_cache, v_cache = cache["k"], cache["v"]
        k_cache[:, pos] = k[:, 0].to(k_cache.dtype)
        v_cache[:, pos] = v[:, 0].to(v_cache.dtype)
        new_cache = {"k": k_cache, "v": v_cache}
        Skv = k_cache.shape[1]
        valid = (torch.arange(Skv, device=x.device) <= pos)[None, :] \
            .expand(B, Skv)
        out = _dense_attention(qg, k_cache, v_cache, causal=False,
                               kv_len_mask=valid, softmax_dtype=sm)
    elif mode == "decode" and cross:
        out = _dense_attention(qg, k, v, causal=False, softmax_dtype=sm)
    elif cfg.attn_impl == "blockwise" and mode in ("train", "prefill") \
            and not cross:
        out = _blockwise_attention(qg, k, v, causal=causal,
                                   q_block=cfg.attn_block_q,
                                   kv_block=cfg.attn_block_kv)
    else:
        out = _dense_attention(qg, k, v, causal=causal and not cross,
                               softmax_dtype=sm)

    if mode == "prefill":
        new_cache = {"k": k, "v": v}   # cross prefill caches encoder K/V too
    out = out.reshape(B, S, Hq, dh)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return x + y, new_cache


# ----------------------------------------------------------------------- MLP
def mlp_defs(cfg: ModelConfig, L: int) -> Dict[str, ParamDef]:
    D, Fd = cfg.d_model, cfg.d_ff
    d = {"norm": ParamDef((L, D), ("layers", None), init="ones"),
         "wu": ParamDef((L, D, Fd), ("layers", "embed", "mlp")),
         "wd": ParamDef((L, Fd, D), ("layers", "mlp", "embed"))}
    if cfg.act == "silu_glu":
        d["wg"] = ParamDef((L, D, Fd), ("layers", "embed", "mlp"))
    return d


def mlp(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    up = torch.einsum("bsd,df->bsf", h, p["wu"])
    if cfg.act == "silu_glu":
        up = F.silu(torch.einsum("bsd,df->bsf", h, p["wg"])) * up
    else:
        up = F.gelu(up, approximate="tanh")      # jax.nn.gelu's default
    y = torch.einsum("bsf,fd->bsd", up, p["wd"])
    return x + y


# ----------------------------------------------------------------------- MoE
def moe_defs(cfg: ModelConfig, L: int) -> Dict[str, ParamDef]:
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.d_ff_e
    return {
        "norm": ParamDef((L, D), ("layers", None), init="ones"),
        "router": ParamDef((L, D, E), ("layers", "embed", "experts")),
        "wg": ParamDef((L, E, D, Fe), ("layers", "experts", "embed", "expert_mlp")),
        "wu": ParamDef((L, E, D, Fe), ("layers", "experts", "embed", "expert_mlp")),
        "wd": ParamDef((L, E, Fe, D), ("layers", "experts", "expert_mlp", "embed")),
    }


def moe(p, x: torch.Tensor, cfg: ModelConfig
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k MoE with capacity-bounded scatter dispatch.  Returns
    (out, aux_loss).

    Each token's k choices get a position within their expert from a stable
    sort of the expert ids; a choice past the expert's capacity is dropped
    (its row lands in the overflow slot ``cap``, zeroed, and its gate is
    masked).  Dispatch and combine are an ``index_put_`` and a gather, the
    scatter-adds ``index_put_(accumulate=True)``, which is deterministic on
    the card under ``torch.use_deterministic_algorithms``.
    """
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.moe_top_k
    T_ = B * S
    dev = x.device
    h = rmsnorm(x, p["norm"], cfg.norm_eps).reshape(T_, D)

    logits = torch.einsum("td,de->te", h, p["router"]).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate, eid = torch.topk(probs, K, dim=-1, sorted=True)        # (T, K)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    # ---- position within expert via sort --------------------------------
    cap = max(int(math.ceil(T_ * K / E * cfg.capacity_factor)), K)
    flat_e = eid.reshape(-1)                                     # (T*K,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, torch.arange(E, device=dev),
                               right=False)
    pos_sorted = torch.arange(T_ * K, device=dev) - first[sorted_e]
    pos = torch.zeros_like(pos_sorted).index_put_((order,), pos_sorted) \
        .reshape(T_, K)
    keep = pos < cap                                             # capacity drop
    pos_c = torch.where(keep, pos, cap)                          # overflow slot

    # ---- dispatch: (E, cap+1, D) scatter ---------------------------------
    xk = h[:, None, :].expand(T_, K, D) * keep[..., None].to(x.dtype)
    buf = torch.zeros((E, cap + 1, D), dtype=x.dtype, device=dev)
    buf = buf.index_put_((flat_e, pos_c.reshape(-1)), xk.reshape(T_ * K, D),
                         accumulate=True)[:, :cap]

    # ---- expert computation ---------------------------------------------
    up = torch.einsum("ecd,edf->ecf", buf, p["wu"])
    up = F.silu(torch.einsum("ecd,edf->ecf", buf, p["wg"])) * up
    out_buf = torch.einsum("ecf,efd->ecd", up, p["wd"])

    # ---- combine: gather back --------------------------------------------
    got = out_buf[flat_e, torch.clamp(pos_c, max=cap - 1).reshape(-1)]
    got = got.reshape(T_, K, D) * (gate * keep).to(x.dtype)[..., None]
    y = got.sum(dim=1).reshape(B, S, D)

    # ---- load-balance aux loss (Switch-style) -----------------------------
    frac_tokens = torch.zeros(E, dtype=torch.float32, device=dev).index_put_(
        (flat_e,), torch.full((T_ * K,), 1.0 / (T_ * K), device=dev),
        accumulate=True)
    mean_prob = probs.mean(dim=0)
    aux = cfg.router_aux_coef * E * torch.sum(frac_tokens * mean_prob)
    return x + y, aux


# ------------------------------------------------------------------ SSD/SSM
def ssm_defs(cfg: ModelConfig, L: int) -> Dict[str, ParamDef]:
    D = cfg.d_model
    d_in, H = cfg.d_inner, cfg.ssm_heads
    GN = cfg.ssm_groups * cfg.ssm_state
    return {
        "norm": ParamDef((L, D), ("layers", None), init="ones"),
        "in_z": ParamDef((L, D, d_in), ("layers", "embed", "ssm_proj")),
        "in_x": ParamDef((L, D, d_in), ("layers", "embed", "ssm_proj")),
        "in_B": ParamDef((L, D, GN), ("layers", "embed", None)),
        "in_C": ParamDef((L, D, GN), ("layers", "embed", None)),
        "in_dt": ParamDef((L, D, H), ("layers", "embed", "ssm_heads")),
        "conv_x": ParamDef((L, cfg.conv_width, d_in), ("layers", None, "ssm_proj"),
                           init="small_normal", scale=0.1),
        "conv_B": ParamDef((L, cfg.conv_width, GN), ("layers", None, None),
                           init="small_normal", scale=0.1),
        "conv_C": ParamDef((L, cfg.conv_width, GN), ("layers", None, None),
                           init="small_normal", scale=0.1),
        "A_log": ParamDef((L, H), ("layers", "ssm_heads"), init="zeros"),
        "Dskip": ParamDef((L, H), ("layers", "ssm_heads"), init="ones"),
        "dt_bias": ParamDef((L, H), ("layers", "ssm_heads"), init="zeros"),
        "gate_norm": ParamDef((L, d_in), ("layers", "ssm_proj"), init="ones"),
        "out": ParamDef((L, d_in, D), ("layers", "ssm_proj", "embed")),
    }


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C); w: (W, C) depthwise causal conv (a cross-correlation
    over the left-padded input, as the reference's ``conv_general_dilated``)."""
    W, C = w.shape
    xp = F.pad(x.transpose(1, 2), (W - 1, 0))                   # (B, C, S+W-1)
    return F.conv1d(xp, w.t()[:, None, :], groups=C).transpose(1, 2)


def _ssd_chunk_scan(x, dt, A, Bm, Cm, chunk: int, init_state=None):
    """Chunked SSD (state-space duality) scan.

    x: (B,S,H,P); dt: (B,S,H) f32 (post-softplus); A: (H,) negative f32;
    Bm/Cm: (B,S,N) (single group broadcast over heads).
    Returns (y (B,S,H,P), final_state (B,H,P,N) f32).  The chunks run in a
    loop (the reference's ``lax.scan``) with the state carried in f32;
    products that mix the f32 decays with ``x``'s dtype are taken in f32,
    as the reference's type promotion takes them.  The inclusive cumsum of
    the decays is a product with the lower-triangular ones matrix:
    ``torch.cumsum`` of floats has no deterministic CUDA path, and serving
    runs under ``torch.use_deterministic_algorithms``.
    """
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    assert S % Q == 0
    nc = S // Q
    f32, xdt = torch.float32, x.dtype
    state = (torch.zeros((B, H, P, N), dtype=f32, device=x.device)
             if init_state is None else init_state)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    ys = []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        x_c, dt_c, B_c, C_c = x[:, sl], dt[:, sl], Bm[:, sl], Cm[:, sl]
        dA = dt_c * A                                        # (B,Q,H) <= 0
        cs = torch.einsum("qk,bkh->bqh", tri.to(f32), dA)    # inclusive cumsum
        # inter-chunk: contribution of the carried state
        y_off = torch.einsum("bqn,bhpn->bqhp", C_c, state.to(xdt)) \
            * torch.exp(cs)[..., None].to(xdt)
        # intra-chunk (masked decay kernel)
        att = torch.einsum("bqn,bkn->bqk", C_c, B_c)         # (B,Q,Q)
        Ld = cs[:, :, None, :] - cs[:, None, :, :]           # (B,Q,K,H)
        w = att[..., None] * torch.where(tri[None, :, :, None], torch.exp(Ld),
                                         0.0).to(xdt)
        w = w * dt_c.to(xdt)[:, None, :, :]
        y_in = torch.einsum("bqkh,bkhp->bqhp", w, x_c)
        # state update
        decay_end = torch.exp(cs[:, -1:, :] - cs)            # (B,Q,H)
        contrib = torch.einsum("bqn,bqh,bqhp->bhpn", B_c.to(f32),
                               dt_c * decay_end, x_c.to(f32))
        state = state * torch.exp(cs[:, -1, :])[:, :, None, None] + contrib
        ys.append(y_in + y_off)
    return torch.cat(ys, dim=1), state


def ssm_block(p, x: torch.Tensor, cfg: ModelConfig, *, mode: str = "train",
              cache: Optional[dict] = None):
    """Mamba2 (SSD) mixer.  Returns (residual_out, new_cache).

    prefill returns the cache ``{"state": (B,H,P,N) f32, "conv": (B,W-1,C)}``
    (the final state and the last ``W - 1`` pre-conv rows); decode takes it
    and returns the next one (a new state and the shifted conv history).
    """
    B, S, D = x.shape
    d_in, H, P = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    N = cfg.ssm_groups * cfg.ssm_state
    W = cfg.conv_width
    f32 = torch.float32
    h = rmsnorm(x, p["norm"], cfg.norm_eps)

    z = torch.einsum("bsd,de->bse", h, p["in_z"])
    xs = torch.einsum("bsd,de->bse", h, p["in_x"])
    Bm = torch.einsum("bsd,dn->bsn", h, p["in_B"])
    Cm = torch.einsum("bsd,dn->bsn", h, p["in_C"])
    dt = torch.einsum("bsd,dh->bsh", h, p["in_dt"])

    A = -torch.exp(p["A_log"].to(f32))                       # (H,)
    dt = F.softplus(dt.to(f32) + p["dt_bias"].to(f32))

    if mode == "decode":
        conv_cat = torch.cat([xs, Bm, Cm], dim=-1)           # (B,1,C)
        hist = torch.cat([cache["conv"], conv_cat], dim=1)   # (B,W,C)
        wcat = torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]], dim=-1)
        conv_out = F.silu(torch.einsum("bwc,wc->bc", hist, wcat)[:, None, :])
        xs2 = conv_out[..., :d_in]
        Bm2 = conv_out[..., d_in:d_in + N]
        Cm2 = conv_out[..., d_in + N:]
        xh = xs2.reshape(B, H, P)
        dA = torch.exp(dt[:, 0] * A)                         # (B,H)
        contrib = torch.einsum("bn,bh,bhp->bhpn", Bm2[:, 0].to(f32), dt[:, 0],
                               xh.to(f32))
        state = cache["state"] * dA[..., None, None] + contrib
        y = torch.einsum("bn,bhpn->bhp", Cm2[:, 0], state.to(x.dtype))
        y = (y + p["Dskip"].to(x.dtype)[None, :, None] * xh).to(x.dtype)
        y = y.reshape(B, 1, d_in)
        new_cache = {"state": state, "conv": hist[:, 1:]}
    else:
        raw = torch.cat([xs, Bm, Cm], dim=-1)                # pre-conv inputs
        xs = F.silu(_causal_depthwise_conv(xs, p["conv_x"]))
        Bm = F.silu(_causal_depthwise_conv(Bm, p["conv_B"]))
        Cm = F.silu(_causal_depthwise_conv(Cm, p["conv_C"]))
        xh = xs.reshape(B, S, H, P)
        y, final_state = _ssd_chunk_scan(xh, dt, A, Bm, Cm, cfg.ssm_chunk)
        y = y + p["Dskip"].to(x.dtype)[None, None, :, None] * xh
        y = y.reshape(B, S, d_in)
        new_cache = None
        if mode == "prefill":
            new_cache = {"state": final_state, "conv": raw[:, -(W - 1):]}

    y = y * F.silu(z[:, :y.shape[1]])
    y = rmsnorm(y, p["gate_norm"], cfg.norm_eps).to(x.dtype)
    out = torch.einsum("bse,ed->bsd", y, p["out"])
    return x + out, new_cache
