"""Plain PyTorch versions of the hand-written kernels (the correctness
references).

Each function mirrors its kernel's contract exactly (same shapes and
dtypes) using only high-level tensor ops.  The wrappers in ``bitmap.py`` /
``deltaenc.py`` / ``minhash.py`` run these for CPU tensors;
``chip_smoke.py`` holds every CUDA kernel bit-exact against them on the card.

Words are held as ``torch.int32``: bitwise AND/OR/XOR/ANDNOT on int32 are
bit-identical to uint32, which PyTorch supports for few ops.  Popcount is
the SWAR bit-twiddle in int64, masked to 32 bits.  The min-hash is not
sign-blind (a signed min would let every hash >= 2^31 win), so it is
computed and minimised in int64 on values in [0, 2^32) and only the result
is stored as int32 bit patterns.  Convert at the numpy boundary with
``.view(np.int32)`` / ``.view(np.uint32)``.
"""
from __future__ import annotations

from typing import Tuple

import torch

_M32 = 0xFFFFFFFF
PAD_VERSION = -1            # padding / skipped entry of a version list


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) → the same 32 bits as int32."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _hash(a: int, b: int, v: torch.Tensor) -> torch.Tensor:
    """``(a * v + b) mod 2^32`` for uint32 ``a``, ``b`` and int64 ``v`` in
    [0, 2^32), without leaving int64: ``a`` is split into 16-bit halves so
    no product exceeds 2^48."""
    lo = (a & 0xFFFF) * v
    hi = (((a >> 16) * v) & 0xFFFF) << 16
    return (lo + hi + b) & _M32


def _params(a: torch.Tensor, b: torch.Tensor):
    return ([int(x) & _M32 for x in a.tolist()],
            [int(x) & _M32 for x in b.tolist()])


def minhash_ref(versions_padded: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """(R, D) int32 rows padded with -1, (L,) int32 hash parameters (uint32
    bit patterns) → (L, R) int32 min-hashes (uint32 bit patterns); a row
    with no entry gives 0xFFFFFFFF."""
    R, D = versions_padded.shape
    av, bv = _params(a, b)
    out = torch.full((len(av), R), _M32, dtype=torch.int64,
                     device=versions_padded.device)
    if D:
        valid = versions_padded != PAD_VERSION
        v = versions_padded.to(torch.int64) & _M32
        for l, (al, bl) in enumerate(zip(av, bv)):
            out[l] = torch.where(valid, _hash(al, bl, v), _M32).amin(dim=1)
    return _as_i32(out)


def minhash_csr_ref(indptr: torch.Tensor, col: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """The same function read straight off a CSR: row ``r`` is
    ``col[indptr[r]:indptr[r + 1]]`` (int64 ``indptr``, int32 ``col``;
    entries equal to -1 are skipped, as padding is).  Returns (L, R)."""
    R = indptr.numel() - 1
    av, bv = _params(a, b)
    out = torch.full((len(av), R), _M32, dtype=torch.int64, device=col.device)
    if R <= 0:
        return _as_i32(out)
    lo, hi = int(indptr[0]), int(indptr[-1])
    rows = torch.repeat_interleave(
        torch.arange(R, device=col.device), indptr[1:] - indptr[:-1])
    seg = col[lo:hi]
    valid = seg != PAD_VERSION
    v = seg.to(torch.int64) & _M32
    for l, (al, bl) in enumerate(zip(av, bv)):
        out[l].scatter_reduce_(0, rows, torch.where(valid, _hash(al, bl, v),
                                                    _M32), reduce="amin")
    return _as_i32(out)


def xor_delta_ref(parent: torch.Tensor, child: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, W) int32 ×2 → (delta (N, W) int32, nonzero words per row (N,))."""
    delta = parent ^ child
    counts = (delta != 0).sum(dim=1, dtype=torch.int32)
    return delta, counts


def xor_delta_ragged_ref(parent: torch.Tensor, child: torch.Tensor,
                         row_off: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat (T,) int32 ×2 and an (n + 1,) int64 CSR of word offsets
    (``row_off[0] == 0``, ``row_off[-1] == T``) → (delta (T,) int32,
    nonzero words per row (n,) int32)."""
    delta = parent ^ child
    seen = torch.zeros(delta.numel() + 1, dtype=torch.int64,
                       device=delta.device)
    seen[1:] = torch.cumsum(delta != 0, dim=0)
    return delta, (seen[row_off[1:]] - seen[row_off[:-1]]).to(torch.int32)


def popcount32_ref(v: torch.Tensor) -> torch.Tensor:
    """Per-word popcount of int32 words (read as uint32) → int64."""
    x = v.to(torch.int64) & _M32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def and_popcount_ref(bitmaps: torch.Tensor, row: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, W) int32 AND a (1, W) row (broadcast) or an (N, W) batch
    (pairwise) → (anded (N, W) int32, per-row popcounts (N,) int32)."""
    anded = bitmaps & row
    return anded, popcount32_ref(anded).sum(dim=1).to(torch.int32)


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
