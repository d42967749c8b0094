"""The bitmap VM (§2.4): one launch evaluates a whole batch's predicate trees.

Composite predicates (``Q.and_``/``Q.or_``/``Q.not_`` trees planned by
``core/plan.py``) compile to a small *bitmap program*: an (S, W) register
file of 32-bit words (leaf rows — OR'd posting lists and version bitmaps —
followed by zeroed instruction outputs) and a (P, 4) int32 instruction
stream ``(opcode, dst, lhs, rhs)`` with opcodes AND / OR / ANDNOT executed in
order (``regs[dst] = op(regs[lhs], regs[rhs])``).  The final register file
and per-row popcounts come back together; an empty program passes the
register file through.

``bitmap_vm`` launches the hand-written CUDA kernel (``csrc/bitmap_vm.cu``)
for CUDA tensors and runs the plain version (``ref.bitmap_vm_ref``) for CPU
tensors; it never falls back from one to the other.  ``LAUNCHES`` counts
kernel launches only.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import ref

# bitmap-VM opcodes (prog[:, 0])
OP_AND = 0
OP_OR = 1
OP_ANDNOT = 2

# CUDA kernel launches since import
LAUNCHES = 0


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
