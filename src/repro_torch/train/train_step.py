"""The train step: loss → grads → optimizer update.

State is the reference's plain tree ``{"params": …, "opt": {"mu", "nu",
"step"}}`` of tensors, so the RStore checkpointer treats it as the reference
treats its pytree.  The step is functional: it returns a new state and
leaves the one it was given as it was.
"""
from __future__ import annotations

import torch

from .. import tree as T
from ..device import DeviceLike, resolve_device
from ..models.config import ModelConfig
from ..models.model import Model, abstract_params, init_params, param_defs
from .optimizer import Optimizer


def make_train_step(model: Model, opt: Optimizer):
    def train_step(state, batch):
        params = state["params"]
        leaves = [p.detach().requires_grad_(True) for p in T.leaves(params)]
        live = T.unflatten_like(params, leaves)
        loss = model.loss(live, batch)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                                   for g in grads))
            new_params, new_opt = opt.update(
                T.unflatten_like(params, list(grads)), state["opt"],
                T.unflatten_like(params, [p.detach() for p in leaves]))
        metrics = {"loss": loss.detach().to(torch.float32), "grad_norm": gnorm}
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def init_state(cfg: ModelConfig, opt: Optimizer, generator: torch.Generator,
               device: DeviceLike = None):
    """Random params from ``generator`` and a fresh optimizer state, on
    ``device`` (``None`` = the card)."""
    params = init_params(cfg, generator, resolve_device(device))
    return {"params": params, "opt": opt.init(params)}


def abstract_state(cfg: ModelConfig, opt: Optimizer, env=None):
    """The train state as ``meta`` tensors (with ``env``, ``DTensor``s of
    ``meta`` shards): the dry run's inputs."""
    return {"params": abstract_params(cfg, env),
            "opt": opt.abstract_state(param_defs(cfg), env)}
