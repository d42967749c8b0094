"""XOR-delta record encoding (§3.4 record-level compression).

Sub-chunk compression delta-encodes each record against its version-tree
parent.  For fixed-width payloads the delta is a word-wise XOR — zero words
mark unchanged bytes, which the zlib pass over the sub-chunk exploits.
Decode is the same XOR (an involution), so one kernel serves both
directions.

``xor_delta`` takes (N, W) rows and ``xor_delta_ragged`` rows of any
lengths in flat buffers (an int64 CSR of word offsets, one row per pair).
Both launch the hand-written CUDA kernel (``csrc/xor_delta.cu``) for CUDA
tensors and run the plain versions (``ref.xor_delta_ref``,
``ref.xor_delta_ragged_ref``) for CPU tensors; they never fall back from one
to the other.  ``LAUNCHES`` counts kernel launches only.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import ref

# CUDA kernel launches since import
LAUNCHES = 0


def xor_delta(parent: torch.Tensor, child: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, W) int32 parent/child → (delta (N, W) int32, nonzero words per
    row (N,) int32) on the inputs' device."""
    if parent.shape != child.shape or parent.dim() != 2:
        raise ValueError(f"parent/child must be equal (N, W); got "
                         f"{tuple(parent.shape)} and {tuple(child.shape)}")
    if parent.dtype != torch.int32 or child.dtype != torch.int32:
        raise ValueError(f"parent/child must be int32, got {parent.dtype}, "
                         f"{child.dtype}")
    if parent.device != child.device:
        raise ValueError(f"parent on {parent.device} but child on "
                         f"{child.device}")
    if parent.device.type == "cpu":
        return ref.xor_delta_ref(parent, child)
    if parent.device.type != "cuda":
        raise ValueError(f"unsupported device {parent.device}")
    if not (parent.is_contiguous() and child.is_contiguous()):
        raise ValueError("parent and child must be contiguous")
    N, W = parent.shape
    delta = torch.empty_like(parent)
    cnt = torch.empty(N, dtype=torch.int32, device=parent.device)
    if N == 0:
        return delta, cnt
    _launch("xor_delta_launch", parent, parent.data_ptr(), child.data_ptr(),
            delta.data_ptr(), cnt.data_ptr(), N, W)
    return delta, cnt


def xor_delta_ragged(parent: torch.Tensor, child: torch.Tensor,
                     row_off: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat (T,) int32 parent/child words and an (n + 1,) int64 CSR of word
    offsets (row ``r`` is words ``row_off[r]:row_off[r + 1]``; nondecreasing,
    ``row_off[0] == 0``, ``row_off[-1] == T``) → (delta (T,) int32, nonzero
    words per row (n,) int32) on the inputs' device."""
    if parent.shape != child.shape or parent.dim() != 1:
        raise ValueError(f"parent/child must be equal (T,); got "
                         f"{tuple(parent.shape)} and {tuple(child.shape)}")
    if parent.dtype != torch.int32 or child.dtype != torch.int32:
        raise ValueError(f"parent/child must be int32, got {parent.dtype}, "
                         f"{child.dtype}")
    if row_off.dtype != torch.int64 or row_off.dim() != 1 or \
            row_off.numel() < 1:
        raise ValueError(f"row_off must be (n + 1,) int64, got "
                         f"{tuple(row_off.shape)} {row_off.dtype}")
    if not parent.device == child.device == row_off.device:
        raise ValueError(f"parent on {parent.device}, child on "
                         f"{child.device}, row_off on {row_off.device}")
    if parent.device.type == "cpu":
        return ref.xor_delta_ragged_ref(parent, child, row_off)
    if parent.device.type != "cuda":
        raise ValueError(f"unsupported device {parent.device}")
    if not (parent.is_contiguous() and child.is_contiguous()
            and row_off.is_contiguous()):
        raise ValueError("parent, child and row_off must be contiguous")
    n = row_off.numel() - 1
    delta = torch.empty_like(parent)
    cnt = torch.empty(n, dtype=torch.int32, device=parent.device)
    if n == 0:
        return delta, cnt
    _launch("xor_delta_ragged_launch", parent, parent.data_ptr(),
            child.data_ptr(), delta.data_ptr(), cnt.data_ptr(),
            row_off.data_ptr(), n, parent.numel())
    return delta, cnt


def _launch(entry: str, like: torch.Tensor, *args) -> None:
    from . import _build
    global LAUNCHES
    with torch.cuda.device(like.device):
        rc = getattr(_build.library(), entry)(
            *args, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "xor_delta")
    LAUNCHES += 1
