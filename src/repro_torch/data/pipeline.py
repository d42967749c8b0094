"""Deterministic synthetic data pipeline.

Tokens are a pure function of (step, position) via a counter-mode hash, so
the pipeline is stateless, skip-ahead (restart at step k never replays), and
identical across hosts and across packages: every batch equals the reference
package's ``data/pipeline.py`` bit for bit.

The hash is uint32 arithmetic that wraps.  PyTorch has no usable uint32
multiply, so words are held in int64 in [0, 2^32) and each product is taken
in 16-bit halves of the constant (no partial product reaches 2^48) and
masked back to 32 bits.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.config import ModelConfig

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for int64 ``x`` in [0, 2^32) and a uint32 ``c``."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cheap counter-mode integer hash (xorshift-mult), on uint32 values
    held in int64."""
    x = _mul32(a & _M32, 0x9E3779B9) ^ _mul32(b & _M32, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _unit(h: torch.Tensor) -> torch.Tensor:
    """uint32 hash → float32 in [-0.5, 0.5), as the reference converts it."""
    return h.to(torch.float32) / np.float32(2**32) - np.float32(0.5)


def synthetic_batch(cfg: ModelConfig, step: int, batch: int, seq: int,
                    device: DeviceLike = None,
                    as_numpy: bool = False) -> Dict[str, torch.Tensor]:
    """Batch for ``step``: tokens plus any modality-stub inputs, made on
    ``device`` (``None`` = the card)."""
    dev = resolve_device(device)
    i64 = dict(dtype=torch.int64, device=dev)
    rows = (torch.arange(batch, **i64)[:, None] + step * batch) & _M32
    cols = torch.arange(seq, **i64)[None, :]
    toks = (_hash2(rows, cols) % cfg.vocab_size).to(torch.int32)
    out: Dict[str, torch.Tensor] = {"tokens": toks}
    if cfg.family == "vlm":
        P = cfg.n_prefix_embeds
        pe = _hash2(rows[:, :, None],
                    torch.arange(P * cfg.d_model, **i64)
                    .reshape(1, P, cfg.d_model))
        out["prefix_embeds"] = _unit(pe)
    if cfg.family == "encdec":
        fr = _hash2(rows[:, :, None],
                    torch.arange(seq * cfg.d_model, **i64)
                    .reshape(1, seq, cfg.d_model) % 2**31)
        out["frames"] = _unit(fr)
    if as_numpy:
        out = {k: v.cpu().numpy() for k, v in out.items()}
    return out
