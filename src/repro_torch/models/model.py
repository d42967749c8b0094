"""Model assembly: config → params / train loss, in PyTorch.

Layers are stacked per *position-in-period* (the reference package's
``models/model.py`` layout, so the param trees are the same) and the stacked
groups run in a Python loop where the reference scans them.  One card, no
mesh: the reference's sharding constraints have nothing to do here.

This slice carries the dense family's train forward and loss.  Prefill,
decode and the enc-dec/VLM forwards come with the models and serving slice
(ROADMAP item 5) and raise ``NotImplementedError`` until then.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.utils.checkpoint

from ..device import DeviceLike, resolve_device
from .config import ModelConfig
from .layers import (_ITEM5, ParamDef, attention, attn_defs, mlp, mlp_defs,
                     moe, moe_defs, rmsnorm, ssm_block, ssm_defs, tree_init)

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


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = None):
    """Random params on ``device`` (``None`` = the card), drawn from
    ``generator`` (which must live on that device type)."""
    return tree_init(param_defs(cfg), generator, cfg.torch_dtype,
                     resolve_device(device))


# ------------------------------------------------------------------- forward
def _apply_block(cfg: ModelConfig, bp, x):
    if "attn" in bp:
        x, _ = attention(bp["attn"], x, cfg, mode="train")
    else:
        x, _ = ssm_block(bp["ssm"], x, cfg, mode="train")
    if "mlp" in bp:
        x = mlp(bp["mlp"], x, cfg)
    elif "moe" in bp:
        x, _ = moe(bp["moe"], x, cfg)
    return x


def forward_blocks(cfg: ModelConfig, blocks, x, *, mode: str):
    """Run the stacked block groups in ``train`` mode.  Returns
    (x, None, aux_loss) as the reference's ``forward_blocks`` does there.

    ``remat="full"`` recomputes each group in the backward
    (``torch.utils.checkpoint``, the reference's ``nothing_saveable``);
    ``"none"`` keeps every activation."""
    if mode != "train":
        raise NotImplementedError(f"forward_blocks mode={mode!r} {_ITEM5}")
    if cfg.remat not in ("none", "full"):
        raise NotImplementedError(f"remat={cfg.remat!r} {_ITEM5}")
    G = cfg.n_groups_scan

    def group(x, bps):
        for bp in bps:
            x = _apply_block(cfg, bp, x)
        return x

    for g in range(G):
        bps = [_index_tree(bp, g) for bp in blocks]
        if cfg.remat == "full":
            x = torch.utils.checkpoint.checkpoint(group, x, bps,
                                                  use_reentrant=False)
        else:
            x = group(x, bps)
    return x, None, torch.zeros((), dtype=torch.float32, device=x.device)


def _index_tree(tree, g: int):
    if isinstance(tree, dict):
        return {k: _index_tree(v, g) for k, v in tree.items()}
    return tree[g]


def _logits(cfg: ModelConfig, params, x):
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.einsum("bsd,dv->bsv", x, head)


def _mask_padded_vocab(cfg: ModelConfig, logits):
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    v = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(v < cfg.vocab_size, logits,
                       torch.tensor(-1e30, dtype=logits.dtype,
                                    device=logits.device))


# ------------------------------------------------------------------ the API
class Model:
    """Bundled callables for one architecture."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def train_logits(self, params, batch):
        cfg = self.cfg
        if cfg.family in ("encdec", "vlm"):
            raise NotImplementedError(f"the {cfg.family} forward {_ITEM5}")
        x = params["embed"][batch["tokens"]]
        x, _, aux = forward_blocks(cfg, params["blocks"], x, mode="train")
        return _logits(cfg, params, x), aux

    def loss(self, params, batch) -> torch.Tensor:
        cfg = self.cfg
        logits, aux = self.train_logits(params, batch)
        tokens = batch["tokens"]
        logits, targets = logits[:, :-1], tokens[:, 1:]
        logits = _mask_padded_vocab(cfg, logits.to(torch.float32))
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
        return (logz - gold).mean() + aux

    def prefill(self, params, batch, max_len=None):
        raise NotImplementedError(f"prefill {_ITEM5}")

    def decode_step(self, params, caches, tokens, pos):
        raise NotImplementedError(f"decode {_ITEM5}")


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
