"""Update/gradient compression built on the store's delta machinery.

1. ``xor_delta_stats`` — how sparse consecutive parameter *updates* are at
   block granularity (the signal the checkpointer's dedupe exploits): the
   two buffers are viewed as rows of 32-bit words where they lie and go
   through one ``xor_delta`` launch there (the CUDA kernel for tensors on
   the card, the plain version for CPU tensors).

2. ``compress_update`` / ``decompress_update`` — 8-bit quantization with
   per-block scales for gradient exchange; ``compressed_allreduce_error_
   feedback`` exchanges the dequantized update with
   ``torch.distributed.all_reduce`` and keeps the quantization residual
   (error feedback), as the reference does with ``psum``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..kernels import deltaenc


def xor_delta_stats(prev: torch.Tensor, new: torch.Tensor,
                    block_bytes: int = 1 << 16) -> Dict[str, float]:
    """Fraction of changed words/blocks between two flat buffers (tensors
    of any dtype on one device), rows of ``block_bytes``."""
    pb = prev.detach().reshape(-1).view(torch.uint8)
    nb = new.detach().reshape(-1).view(torch.uint8)
    n = min(pb.numel(), nb.numel()) & ~3
    words = n // 4
    rows = max(1, words // (block_bytes // 4))
    w = (words // rows) or 1
    pw = pb[:rows * w * 4].view(torch.int32).reshape(rows, w)
    nw = nb[:rows * w * 4].view(torch.int32).reshape(rows, w)
    _, changed = deltaenc.xor_delta(pw, nw)
    return {
        "changed_word_fraction": int(changed.sum()) / max(1, rows * w),
        "changed_block_fraction": int((changed > 0).sum()) / rows,
    }


def compress_update(u: torch.Tensor, block: int = 256
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization with per-block max scales
    (``torch.round`` rounds half to even, as ``jnp.round`` does)."""
    flat = u.reshape(-1)
    pad = (-flat.shape[0]) % block
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block).to(torch.float32)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(blocks / torch.clamp(scale, min=1e-12)),
                    -127, 127).to(torch.int8)
    return q, scale


def decompress_update(q: torch.Tensor, scale: torch.Tensor, shape, dtype
                      ) -> torch.Tensor:
    out = (q.to(torch.float32) * scale).reshape(-1)
    n = math.prod(int(s) for s in shape)
    return out[:n].reshape(tuple(shape)).to(dtype)


def compressed_allreduce_error_feedback(u: torch.Tensor,
                                        residual: torch.Tensor,
                                        group: Optional[dist.ProcessGroup]
                                        = None):
    """Quantize (u + residual), all-reduce the dequantized update over
    ``group``, return the mean update and the new residual."""
    target = u + residual
    q, scale = compress_update(target)
    deq = decompress_update(q, scale, u.shape, torch.float32)
    new_residual = target - deq
    summed = deq.clone()
    dist.all_reduce(summed, group=group)
    return summed / dist.get_world_size(group), new_residual
