"""Optimizers: AdamW and factored Adafactor, in PyTorch.

State trees mirror the parameter tree, as in the reference package's
``train/optimizer.py``; the update is the reference's step for step in f32,
its bias corrections and decay f32 powers of the step.  Updates are
functional: they return new tensors and leave their inputs as they were.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import tree as T


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"             # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95                # adafactor: decay exponent handled below
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_rms: float = 1.0           # adafactor update clipping


def _is_factorable(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def _zeros(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=like.device)


class Optimizer:
    def __init__(self, cfg: OptConfig):
        self.cfg = cfg

    def init(self, params):
        c = self.cfg
        leaf = T.leaves(params)[0]
        step = torch.zeros((), dtype=torch.int32, device=leaf.device)
        if c.name == "adamw":
            return {"mu": T.tree_map(lambda p: _zeros(p.shape, p), params),
                    "nu": T.tree_map(lambda p: _zeros(p.shape, p), params),
                    "step": step}
        if c.name == "adafactor":
            def vr(p):
                return _zeros(p.shape[:-1] if _is_factorable(p.shape)
                              else p.shape, p)

            def vc(p):
                return _zeros(p.shape[:-2] + p.shape[-1:]
                              if _is_factorable(p.shape) else (1,), p)
            return {"vr": T.tree_map(vr, params),
                    "vc": T.tree_map(vc, params), "step": step}
        raise ValueError(c.name)

    @torch.no_grad()
    def update(self, grads, state, params):
        c = self.cfg
        f32 = torch.float32
        step = state["step"] + 1
        stepf = step.to(f32)

        def pick(out, i):
            return T.tree_map(lambda t: t[i], out,
                              is_leaf=lambda x: isinstance(x, tuple))

        if c.name == "adamw":
            bc1 = 1.0 - torch.pow(torch.tensor(c.b1, dtype=f32,
                                               device=step.device), stepf)
            bc2 = 1.0 - torch.pow(torch.tensor(c.b2, dtype=f32,
                                               device=step.device), stepf)

            def upd(p, g, m, v):
                g32 = g.to(f32)
                m = c.b1 * m + (1 - c.b1) * g32
                v = c.b2 * v + (1 - c.b2) * g32 * g32
                # the sqrt in f64, rounded to f32: correctly rounded, as
                # the reference's is (PyTorch's CPU f32 sqrt is not)
                u = (m / bc1) / (torch.sqrt((v / bc2).double()).to(f32)
                                 + c.eps)
                u = u + c.weight_decay * p.to(f32)
                return (p.to(f32) - c.lr * u).to(p.dtype), m, v

            out = T.tree_map(upd, params, grads, state["mu"], state["nu"])
            return pick(out, 0), {"mu": pick(out, 1), "nu": pick(out, 2),
                                  "step": step}

        # ---- adafactor ----
        decay = 1.0 - torch.pow(stepf, -0.8)

        def upd(p, g, vr, vc):
            g32 = g.to(f32)
            g2 = g32 * g32 + 1e-30
            if _is_factorable(p.shape):
                vr = decay * vr + (1 - decay) * g2.mean(dim=-1)
                vc = decay * vc + (1 - decay) * g2.mean(dim=-2)
                denom = vr.mean(dim=-1, keepdim=True)
                vhat = (vr[..., None] / torch.clamp(denom[..., None],
                                                    min=1e-30)) \
                    * vc[..., None, :]
                u = g32 * torch.rsqrt(vhat + c.eps)
            else:
                vr = decay * vr + (1 - decay) * g2
                u = g32 * torch.rsqrt(vr + c.eps)
            rms = torch.sqrt((u * u).mean() + 1e-30)
            u = u / torch.clamp(rms / c.clip_rms, min=1.0)
            u = u + c.weight_decay * p.to(f32)
            return (p.to(f32) - c.lr * u).to(p.dtype), vr, vc

        out = T.tree_map(upd, params, grads, state["vr"], state["vc"])
        return pick(out, 0), {"vr": pick(out, 1), "vc": pick(out, 2),
                              "step": step}


def make_optimizer(model_cfg, lr: float = 3e-4) -> Optimizer:
    return Optimizer(OptConfig(name=model_cfg.optimizer, lr=lr))
