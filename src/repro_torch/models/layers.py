"""Model building blocks on the reference's param-def system, in PyTorch.

Parameters are declared as ``ParamDef(shape, logical_axes)`` trees, as in
the reference package's ``models/layers.py``; ``tree_init`` makes them
concrete from an explicit ``torch.Generator`` on a device.  Every block is a
function of the param tree and the activations.

This module holds the dense subset that training needs: RMSNorm (with the
reference's hand-written backward), RoPE, GQA attention in ``train`` mode
(dense, causal) and the SwiGLU/GELU MLP.  The MoE dispatch, the Mamba2 SSD
mixer, blockwise attention and the prefill/decode cache modes are the next
slice's work (ROADMAP item 5): they raise ``NotImplementedError`` here and
never fall back to another code path.  The defs of every family are here,
so ``param_defs`` builds the reference's tree for every architecture.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import tree as T
from .config import ModelConfig

_ITEM5 = ("is not ported yet: it comes with the models and serving slice "
          "(ROADMAP item 5)")


# ---------------------------------------------------------------- param defs
@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"        # normal | ones | zeros | small_normal
    scale: float = 0.02

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
    freqs = torch.as_tensor(1.0 / (theta ** (np.arange(0, half) / half)),
                            dtype=torch.float32, device=x.device)
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


def _dense_attention(q, k, v):
    """Causal attention.  q: (B,Sq,Hkv,G,dh); k/v: (B,Skv,Hkv,dh).  Returns
    (B,Sq,Hkv,G,dh).

    As the reference does it: f32 logits, the -1e30 causal mask and a
    softmax in f32."""
    dh = q.shape[-1]
    f32 = torch.float32
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q, k).to(f32)
    logits = logits * np.float32(1.0 / math.sqrt(dh))
    Sq, Skv = q.shape[1], k.shape[1]
    qi = torch.arange(Sq, device=q.device)[:, None]
    ki = torch.arange(Skv, device=q.device)[None, :]
    logits = torch.where(qi >= ki, logits,
                         torch.tensor(-1e30, dtype=f32, device=q.device))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs, v)


def attention(p, x: torch.Tensor, cfg: ModelConfig, *, mode: str = "train"):
    """Pre-norm causal GQA self-attention block in ``train`` mode.  Returns
    (residual_out, None), as the reference's ``attention`` does in that
    mode."""
    if mode != "train":
        raise NotImplementedError(f"attention mode={mode!r} {_ITEM5}")
    if cfg.attn_impl == "blockwise":
        raise NotImplementedError(f"blockwise attention {_ITEM5}")
    B, S, D = x.shape
    Hq, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", h, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", h, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    out = _dense_attention(_split_heads_q(q, Hkv), k, v)
    out = out.reshape(B, S, Hq, dh)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return x + y, None


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


def moe(p, x: torch.Tensor, cfg: ModelConfig):
    raise NotImplementedError(f"the MoE block {_ITEM5}")


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


def ssm_block(p, x: torch.Tensor, cfg: ModelConfig, *, mode: str = "train"):
    raise NotImplementedError(f"the SSD (Mamba2) mixer {_ITEM5}")
