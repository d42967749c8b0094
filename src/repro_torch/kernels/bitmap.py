"""Index-ANDing and the bitmap VM (§2.4) over chunk-membership bitmaps.

Record/range retrieval intersects the two lossy projections (key→chunks and
version→chunks); with chunk membership as bitmaps (one bit per chunk) that
is a bitwise AND, and the candidate count a popcount.  ``and_popcount`` ANDs
an (N, W) batch of bitmaps against one shared (1, W) row or an (N, W) batch
of rows (pairwise) and counts the bits of every result row.

The bitmap VM: one launch evaluates a whole batch's predicate trees.

Composite predicates (``Q.and_``/``Q.or_``/``Q.not_`` trees planned by
``core/plan.py``) compile to a small *bitmap program*: an (S, W) register
file of 32-bit words (leaf rows — OR'd posting lists and version bitmaps —
followed by zeroed instruction outputs) and a (P, 4) int32 instruction
stream ``(opcode, dst, lhs, rhs)`` with opcodes AND / OR / ANDNOT executed in
order (``regs[dst] = op(regs[lhs], regs[rhs])``).  The final register file
and per-row popcounts come back together; an empty program passes the
register file through.

``and_popcount`` and ``bitmap_vm`` launch the hand-written CUDA kernels
(``csrc/and_popcount.cu``, ``csrc/bitmap_vm.cu``) for CUDA tensors and run
the plain versions (``ref.and_popcount_ref``, ``ref.bitmap_vm_ref``) for CPU
tensors; they never fall back from one to the other.  ``AND_LAUNCHES`` and
``LAUNCHES`` count kernel launches only.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import ref

# bitmap-VM opcodes (prog[:, 0])
OP_AND = 0
OP_OR = 1
OP_ANDNOT = 2

# CUDA kernel launches since import: bitmap_vm, and_popcount
LAUNCHES = 0
AND_LAUNCHES = 0


def and_popcount(bitmaps: torch.Tensor, row: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """AND (N, W) int32 bitmaps against a (1, W) row (broadcast) or an
    (N, W) batch (pairwise).  Returns (anded (N, W) int32, per-row
    popcounts (N,) int32) on the inputs' device."""
    if bitmaps.dtype != torch.int32 or bitmaps.dim() != 2:
        raise ValueError(f"bitmaps must be (N, W) int32, got "
                         f"{tuple(bitmaps.shape)} {bitmaps.dtype}")
    N, W = bitmaps.shape
    if row.dtype != torch.int32 or tuple(row.shape) not in ((1, W), (N, W)):
        raise ValueError(f"row must be (1, {W}) or ({N}, {W}) int32, got "
                         f"{tuple(row.shape)} {row.dtype}")
    if row.device != bitmaps.device:
        raise ValueError(f"bitmaps on {bitmaps.device} but row on "
                         f"{row.device}")
    if bitmaps.device.type == "cpu":
        return ref.and_popcount_ref(bitmaps, row)
    if bitmaps.device.type != "cuda":
        raise ValueError(f"unsupported device {bitmaps.device}")
    if not (bitmaps.is_contiguous() and row.is_contiguous()):
        raise ValueError("bitmaps and row must be contiguous")
    out = torch.empty_like(bitmaps)
    cnt = torch.empty(N, dtype=torch.int32, device=bitmaps.device)
    if N == 0:
        return out, cnt
    stride = W if row.shape[0] == N and N != 1 else 0
    from . import _build
    global AND_LAUNCHES
    with torch.cuda.device(bitmaps.device):
        rc = _build.library().and_popcount_launch(
            bitmaps.data_ptr(), row.data_ptr(), out.data_ptr(),
            cnt.data_ptr(), N, W, stride,
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "and_popcount")
    AND_LAUNCHES += 1
    return out, cnt


def _check(regs: torch.Tensor, prog: torch.Tensor) -> None:
    if regs.dtype != torch.int32 or regs.dim() != 2:
        raise ValueError(f"regs must be (S, W) int32, got {tuple(regs.shape)} "
                         f"{regs.dtype}")
    if prog.dtype != torch.int32 or prog.dim() != 2 or prog.shape[1] != 4:
        raise ValueError(f"prog must be (P, 4) int32, got {tuple(prog.shape)} "
                         f"{prog.dtype}")
    if prog.device != regs.device:
        raise ValueError(f"regs on {regs.device} but prog on {prog.device}")


def bitmap_vm(regs: torch.Tensor, prog: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Execute a bitmap program over an (S, W) int32 register file.

    Row operands must lie in [0, S) (``ops.bitmap_vm_batch`` checks them on
    the host).  Returns (final registers (S, W) int32, per-row popcounts
    (S,) int32) on the input's device.
    """
    _check(regs, prog)
    if regs.device.type == "cpu":
        return ref.bitmap_vm_ref(regs, prog)
    if regs.device.type != "cuda":
        raise ValueError(f"unsupported device {regs.device}")
    if not (regs.is_contiguous() and prog.is_contiguous()):
        raise ValueError("regs and prog must be contiguous")
    if prog.data_ptr() % 16:
        raise ValueError("prog must be 16-byte aligned")
    S, W = regs.shape
    out = torch.empty_like(regs)
    cnt = torch.zeros(S, dtype=torch.int32, device=regs.device)
    if regs.numel() == 0:
        return out, cnt
    from . import _build
    global LAUNCHES
    with torch.cuda.device(regs.device):
        rc = _build.library().bitmap_vm_launch(
            regs.data_ptr(), prog.data_ptr(), out.data_ptr(), cnt.data_ptr(),
            S, W, prog.shape[0], torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "bitmap_vm")
    LAUNCHES += 1
    return out, cnt
