"""Plain PyTorch versions of the hand-written kernels (the correctness
references).

Each function mirrors its kernel's contract exactly (same shapes and
dtypes) using only high-level tensor ops.  The wrappers in ``bitmap.py`` /
``deltaenc.py`` run these for CPU tensors; ``chip_smoke.py`` holds every
CUDA kernel bit-exact against them on the card.

Words are held as ``torch.int32``: bitwise AND/OR/XOR/ANDNOT on int32 are
bit-identical to uint32, which PyTorch supports for few ops.  Popcount is
the SWAR bit-twiddle in int64, masked to 32 bits.  Convert at the numpy
boundary with ``.view(np.int32)`` / ``.view(np.uint32)``.
"""
from __future__ import annotations

from typing import Tuple

import torch

_M32 = 0xFFFFFFFF


def xor_delta_ref(parent: torch.Tensor, child: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, W) int32 ×2 → (delta (N, W) int32, nonzero words per row (N,))."""
    delta = parent ^ child
    counts = (delta != 0).sum(dim=1, dtype=torch.int32)
    return delta, counts


def popcount32_ref(v: torch.Tensor) -> torch.Tensor:
    """Per-word popcount of int32 words (read as uint32) → int64."""
    x = v.to(torch.int64) & _M32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def bitmap_vm_ref(regs: torch.Tensor, prog: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S, W) int32 registers, (P, 4) int32 ``(op, dst, lhs, rhs)`` stream
    with op in {0: AND, 1: OR, other: ANDNOT} → (final registers, per-row
    popcounts (S,) int32).  P == 0 passes the register file through."""
    out = regs.clone()
    for op, dst, lhs, rhs in prog.reshape(-1, 4).tolist():
        a, b = out[lhs], out[rhs]
        out[dst] = a & b if op == 0 else (a | b if op == 1 else a & ~b)
    counts = popcount32_ref(out).sum(dim=1).to(torch.int32)
    return out, counts
