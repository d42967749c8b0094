"""Model assembly: config → params / train loss / prefill / decode, in
PyTorch.

Layers are stacked per *position-in-period* (the reference package's
``models/model.py`` layout, so the param trees are the same) and the stacked
groups run in a Python loop where the reference scans them.  Heterogeneous
patterns (Jamba's attn/ssm 1:7 interleave with alternating dense/MoE FFN)
unroll the period inside each group.  One card, no mesh: the reference's
sharding constraints have nothing to do here.

Caches mirror the param structure: per position, stacked over groups.
Prefill builds them; decode writes each step's K/V into them in place (the
counterpart of the reference's donated caches) and replaces the SSM state
and conv history in place.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as ckpt

from .. import tree as T
from ..device import DeviceLike, resolve_device
from .config import ModelConfig
from .layers import (NEG, ParamDef, attention, attn_defs, mlp, mlp_defs, moe,
                     moe_defs, rmsnorm, ssm_block, ssm_defs, tree_abstract,
                     tree_init)

Params = Dict[str, Any]


# ---------------------------------------------------------------- param defs
def _block_defs(cfg: ModelConfig, plan, G: int) -> List[Dict[str, Any]]:
    """Param defs per position within the scan period, stacked over G groups."""
    out = []
    for mixer, ffn in plan:
        d: Dict[str, Any] = {}
        if mixer == "attn":
            d["attn"] = attn_defs(cfg, G)
        else:
            d["ssm"] = ssm_defs(cfg, G)
        if ffn == "dense":
            d["mlp"] = mlp_defs(cfg, G)
        elif ffn == "moe":
            d["moe"] = moe_defs(cfg, G)
        out.append(d)
    return out


def param_defs(cfg: ModelConfig) -> Params:
    D, Vp = cfg.d_model, cfg.padded_vocab
    defs: Params = {
        "embed": ParamDef((Vp, D), ("vocab", "embed"), scale=0.02),
        "final_norm": ParamDef((D,), (None,), init="ones"),
        "blocks": _block_defs(cfg, cfg.layer_plan(), cfg.n_groups_scan),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((D, Vp), ("embed", "vocab"), scale=0.02)
    if cfg.family == "encdec":
        enc_plan = [("attn", "dense")] * 1
        defs["enc_blocks"] = _block_defs(cfg, enc_plan, cfg.n_encoder_layers)
        defs["enc_final_norm"] = ParamDef((D,), (None,), init="ones")
        defs["cross_blocks"] = [{"attn": attn_defs(cfg, cfg.n_groups_scan)}]
        defs["pos_embed"] = ParamDef((32768, D), (None, "embed"), scale=0.01)
    return defs


def abstract_params(cfg: ModelConfig):
    """The param tree as ``meta`` tensors (shapes and dtypes, no storage)."""
    return tree_abstract(param_defs(cfg), cfg.torch_dtype)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = None):
    """Random params on ``device`` (``None`` = the card), drawn from
    ``generator`` (which must live on that device type)."""
    return tree_init(param_defs(cfg), generator, cfg.torch_dtype,
                     resolve_device(device))


# ---------------------------------------------------------------- cache defs
def cache_defs(cfg: ModelConfig, batch: int, cache_len: int
               ) -> List[Dict[str, Any]]:
    """Decode-cache structure mirroring the block structure (per position,
    stacked over groups)."""
    G = cfg.n_groups_scan
    Hkv, dh = cfg.n_kv_heads, cfg.head_dim
    d_in = cfg.d_inner if cfg.ssm_state else 0
    N = cfg.ssm_groups * cfg.ssm_state
    out = []
    for mixer, _ in cfg.layer_plan():
        if mixer == "attn":
            out.append({"attn": {
                "k": ParamDef((G, batch, cache_len, Hkv, dh),
                              ("layers", "batch", "cache_seq", None, None)),
                "v": ParamDef((G, batch, cache_len, Hkv, dh),
                              ("layers", "batch", "cache_seq", None, None)),
            }})
        else:
            out.append({"ssm": {
                "state": ParamDef((G, batch, cfg.ssm_heads, cfg.ssm_head_dim, N),
                                  ("layers", "batch", "ssm_heads", None, None)),
                "conv": ParamDef((G, batch, cfg.conv_width - 1, d_in + 2 * N),
                                 ("layers", "batch", None, None)),
            }})
    return out


def abstract_cache(cfg: ModelConfig, batch: int, cache_len: int):
    """The decode caches as ``meta`` tensors.  The SSM recurrent state is
    f32; K/V and conv caches are in the model dtype.  Keyed by name, never
    by shape (head_dim can coincide with ssm_state, both 128 in jamba)."""
    tree = []
    for c in cache_defs(cfg, batch, cache_len):
        tree.append({mix: {name: d.abstract(torch.float32 if name == "state"
                                            else cfg.torch_dtype)
                           for name, d in sub.items()}
                     for mix, sub in c.items()})
    if cfg.family == "encdec":
        shape = (cfg.n_groups_scan, batch, cross_len(cfg, cache_len),
                 cfg.n_kv_heads, cfg.head_dim)
        tree.append({"cross": {
            n: torch.empty(shape, dtype=cfg.torch_dtype, device="meta")
            for n in ("k", "v")}})
    return tree


def zero_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device: DeviceLike = None):
    """Zeroed decode caches on ``device`` (``None`` = the card)."""
    dev = resolve_device(device)
    return T.tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                            device=dev),
                      abstract_cache(cfg, batch, cache_len))


def cross_len(cfg: ModelConfig, cache_len: int) -> int:
    """Encoder context length for decode (whisper 30 s ≈ 1500 frames stub)."""
    return min(1500, cache_len)


# ------------------------------------------------------------------- remat
_MM = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_BMM = torch.ops.aten.bmm.default


def _save_dots(batched: bool):
    """Selective-checkpoint policy: save matmul outputs, recompute the rest.

    ``torch.einsum`` lowers every contraction to ``bmm`` over the product of
    its batch dimensions, which is 1 where the contraction has none (a
    projection ``bsd,df->bsf``).  JAX's ``checkpoint_dots`` saves every
    ``dot_general``: here every ``mm``/``addmm``/``bmm``.  Its
    ``checkpoint_dots_with_no_batch_dims`` saves the dots without batch
    dimensions: here ``mm``/``addmm`` and the ``bmm`` of batch 1 (attention
    scores and expert matmuls are recomputed)."""
    def policy(ctx, op, *args, **kwargs):
        if op in _MM or (op is _BMM and (batched or args[0].shape[0] == 1)):
            return ckpt.CheckpointPolicy.MUST_SAVE
        return ckpt.CheckpointPolicy.PREFER_RECOMPUTE
    return policy


def _remat(cfg: ModelConfig, fn):
    """``fn`` (one group's body) under ``cfg.remat``, when autograd records:
    "none" keeps every activation, "full" recomputes the group in the
    backward (the reference's ``nothing_saveable``), "dots"/"dots_nb" save
    the matmul outputs named in :func:`_save_dots`."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw: Dict[str, Any] = {"use_reentrant": False}
    if cfg.remat in ("dots", "dots_nb"):
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts,
            _save_dots(batched=cfg.remat == "dots"))
    return functools.partial(ckpt.checkpoint, fn, **kw)


# ------------------------------------------------------------------- forward
def _apply_block(cfg: ModelConfig, bp, x, mode: str, cache, pos, aux):
    new_cache = {}
    if "attn" in bp:
        c = cache.get("attn") if cache else None
        x, nc = attention(bp["attn"], x, cfg, causal=True, mode=mode,
                          cache=c, pos=pos)
        if nc is not None:
            new_cache["attn"] = nc
    else:
        c = cache.get("ssm") if cache else None
        x, nc = ssm_block(bp["ssm"], x, cfg, mode=mode, cache=c)
        if nc is not None:
            new_cache["ssm"] = nc
    if "mlp" in bp:
        x = mlp(bp["mlp"], x, cfg)
    elif "moe" in bp:
        if cfg.moe_impl == "shard_map":
            raise NotImplementedError(
                "moe_impl='shard_map' needs a device mesh: it comes with the "
                "sharding slice (ROADMAP item 3)")
        x, a = moe(bp["moe"], x, cfg)
        aux = aux + a
    return x, new_cache, aux


def _index_tree(tree, g: int):
    if isinstance(tree, dict):
        return {k: _index_tree(v, g) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_index_tree(v, g) for v in tree]
    return tree[g]


def _stack_groups(per_group: List[List[Dict[str, Any]]]):
    """Per-group cache lists → one list of caches stacked over groups (the
    layout of the reference's scan outputs)."""
    return [T.tree_map(lambda *ls: torch.stack(ls), *(cs[i] for cs in per_group))
            for i in range(len(per_group[0]))]


def _write_back(dst, src) -> None:
    """Copy a decode step's new cache leaves into the group's views of the
    stacked caches (K/V leaves were written in place already)."""
    for d, s in zip(T.leaves(dst), T.leaves(src)):
        if s is not d:
            d.copy_(s)


def forward_blocks(cfg: ModelConfig, blocks, x, *, mode: str, caches=None,
                   pos=None):
    """Run the stacked block groups.  Returns (x, caches, aux_loss).

    - train: no caches in or out.
    - prefill: no caches in; per-group caches stacked over groups out.
    - decode: ``caches`` in; they are updated in place and returned.
    """
    plan = cfg.layer_plan()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def group(x, aux, bps, cs):
        new_cs = []
        for i in range(len(plan)):
            x, nc, aux = _apply_block(cfg, bps[i], x, mode,
                                      cs[i] if cs else None, pos, aux)
            new_cs.append(nc)
        return x, aux, new_cs

    run = _remat(cfg, group)
    emitted = []
    for g in range(cfg.n_groups_scan):
        bps = _index_tree(blocks, g)
        cs = _index_tree(caches, g) if caches is not None else None
        x, aux, new_cs = run(x, aux, bps, cs)
        if caches is not None:
            _write_back(cs, new_cs)
        elif mode == "prefill":
            emitted.append(new_cs)
    if caches is not None:
        return x, caches, aux
    return x, (_stack_groups(emitted) if mode == "prefill" else None), aux


def _logits(cfg: ModelConfig, params, x):
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.einsum("bsd,dv->bsv", x, head)


def _mask_padded_vocab(cfg: ModelConfig, logits):
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    v = torch.arange(logits.shape[-1], device=logits.device)
    return logits.masked_fill(v >= cfg.vocab_size, NEG)


# ------------------------------------------------------------------ encoders
def _encode(cfg: ModelConfig, params, frames):
    """Whisper-style encoder over pre-embedded frames (conv frontend stub)."""
    x = frames + params["pos_embed"][: frames.shape[1]][None]

    def group(x, bp):
        x, _ = attention(bp["attn"], x, cfg, causal=False, mode="train")
        return mlp(bp["mlp"], x, cfg)

    run = _remat(cfg, group)
    for g in range(cfg.n_encoder_layers):
        x = run(x, _index_tree(params["enc_blocks"][0], g))
    return rmsnorm(x, params["enc_final_norm"], cfg.norm_eps)


def _decoder_with_cross(cfg: ModelConfig, params, x, enc_out, *, mode: str,
                        caches=None, pos=None):
    """Decoder groups with cross-attention after each self-attention block
    (enc-dec family).  Returns (x, caches, aux): prefill's per-block caches
    carry the encoder K/V under ``"_cross"``; decode takes the self caches
    followed by the ``{"cross": ...}`` slot and returns the self caches,
    updated in place."""
    plan = cfg.layer_plan()
    use_cache = caches is not None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def group(x, aux, bps, cbp, cs, xc):
        new_cs = []
        for i in range(len(plan)):
            x, nc, aux = _apply_block(cfg, bps[i], x, mode,
                                      cs[i] if use_cache else None, pos, aux)
            if mode == "decode":
                x, _ = attention(cbp, x, cfg, mode="decode", cache=xc,
                                 pos=pos, is_cross=True)
            else:
                x, nxc = attention(cbp, x, cfg, mode=mode, kv_x=enc_out)
                if mode == "prefill":
                    nc = dict(nc)
                    nc["_cross"] = nxc
            new_cs.append(nc)
        return x, aux, new_cs

    run = _remat(cfg, group)
    emitted = []
    for g in range(cfg.n_groups_scan):
        bps = _index_tree(params["blocks"], g)
        cbp = _index_tree(params["cross_blocks"][0]["attn"], g)
        cs = _index_tree(caches[:-1], g) if use_cache else None
        xc = _index_tree(caches[-1]["cross"], g) if use_cache else None
        x, aux, new_cs = run(x, aux, bps, cbp, cs, xc)
        if use_cache:
            _write_back(cs, new_cs)
        elif mode == "prefill":
            emitted.append(new_cs)
    if use_cache:
        return x, caches[:-1], aux
    return x, (_stack_groups(emitted) if mode == "prefill" else None), aux


def _pad_attn_caches(caches, max_len: Optional[int]):
    """Pad attention K/V caches' sequence axis with decode headroom.

    Cache leaves are (G, B, S, Hkv, dh); cross caches keep encoder length."""
    if caches is None:
        return None
    out = []
    for c in caches:
        if "attn" in c:
            k, v = c["attn"]["k"], c["attn"]["v"]
            tgt = max_len if max_len is not None else 2 * k.shape[2]
            pad = max(0, tgt - k.shape[2])
            c = dict(c)
            c["attn"] = {"k": F.pad(k, (0, 0, 0, 0, 0, pad)),
                         "v": F.pad(v, (0, 0, 0, 0, 0, pad))}
        out.append(c)
    return out


# ------------------------------------------------------------------ the API
class Model:
    """Bundled callables for one architecture."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def _embed(self, params, batch):
        x = params["embed"][batch["tokens"]]
        if self.cfg.family == "vlm":
            x = torch.cat([batch["prefix_embeds"].to(x.dtype), x], dim=1)
        return x

    # ---------------------------------------------------------------- train
    def train_logits(self, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        x = self._embed(params, batch)
        if cfg.family == "encdec":
            enc = _encode(cfg, params, batch["frames"].to(x.dtype))
            x = x + params["pos_embed"][: x.shape[1]][None]
            x, _, aux = _decoder_with_cross(cfg, params, x, enc, mode="train")
        else:
            x, _, aux = forward_blocks(cfg, params["blocks"], x, mode="train")
        return _logits(cfg, params, x), aux

    def loss(self, params, batch) -> torch.Tensor:
        cfg = self.cfg
        logits, aux = self.train_logits(params, batch)
        tokens = batch["tokens"]
        if cfg.family == "vlm":
            P = cfg.n_prefix_embeds
            logits = logits[:, P - 1:-1] if P > 0 else logits[:, :-1]
            targets = tokens
        else:
            logits, targets = logits[:, :-1], tokens[:, 1:]
        logits = _mask_padded_vocab(cfg, logits.to(torch.float32))
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
        return (logz - gold).mean() + aux

    # -------------------------------------------------------------- prefill
    def prefill(self, params, batch, max_len: Optional[int] = None):
        """Full-sequence forward producing last-token logits + caches.

        ``max_len`` pads attention KV caches with headroom for subsequent
        decode steps (defaults to 2× the prompt length)."""
        cfg = self.cfg
        x = self._embed(params, batch)
        if cfg.family == "encdec":
            enc = _encode(cfg, params, batch["frames"].to(x.dtype))
            x = x + params["pos_embed"][: x.shape[1]][None]
            x, caches, _ = _decoder_with_cross(cfg, params, x, enc,
                                               mode="prefill")
            # split the per-block "_cross" cache out into the trailing slot
            cross = ({"cross": {"k": caches[0]["_cross"]["k"],
                                "v": caches[0]["_cross"]["v"]}}
                     if "_cross" in caches[0] else None)
            caches = [{k: v for k, v in c.items() if k != "_cross"}
                      for c in caches]
            if cross is not None:
                caches.append(cross)
        else:
            x, caches, _ = forward_blocks(cfg, params["blocks"], x,
                                          mode="prefill")
        caches = _pad_attn_caches(caches, max_len)
        logits = _logits(cfg, params, x[:, -1:])
        return _mask_padded_vocab(cfg, logits), caches

    # --------------------------------------------------------------- decode
    def decode_logits(self, params, caches, tokens, pos):
        """One decode step's masked logits (B, 1, V) and caches: tokens
        (B, 1) at absolute position ``pos`` (a Python int or a 0-d tensor).
        Consumes ``caches``: they are updated in place and returned."""
        cfg = self.cfg
        x = params["embed"][tokens]
        if cfg.family == "encdec":
            p = int(pos)
            x = x + params["pos_embed"][p:p + 1][None]
            x, new_caches, _ = _decoder_with_cross(
                cfg, params, x, None, mode="decode", caches=caches, pos=pos)
            new_caches = list(new_caches) + [caches[-1]]
        else:
            x, new_caches, _ = forward_blocks(cfg, params["blocks"], x,
                                              mode="decode", caches=caches,
                                              pos=pos)
        return _mask_padded_vocab(cfg, _logits(cfg, params, x)), new_caches

    def decode_step(self, params, caches, tokens, pos):
        """One greedy decode step: tokens (B, 1) at absolute position
        ``pos`` → (next tokens (B,) int32, caches).  Consumes ``caches``
        (see :meth:`decode_logits`)."""
        logits, caches = self.decode_logits(params, caches, tokens, pos)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), caches


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
