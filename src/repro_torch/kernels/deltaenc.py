"""XOR-delta record encoding (§3.4 record-level compression).

Sub-chunk compression delta-encodes each record against its version-tree
parent.  For fixed-width payloads the delta is a word-wise XOR — zero words
mark unchanged bytes, which the zlib pass over the sub-chunk exploits.
Decode is the same XOR (an involution), so one kernel serves both
directions.

``xor_delta`` launches the hand-written CUDA kernel (``csrc/xor_delta.cu``)
for CUDA tensors and runs the plain version (``ref.xor_delta_ref``) for CPU
tensors; it never falls back from one to the other.  ``LAUNCHES`` counts
kernel launches only.
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
    vec = int(W % 4 == 0 and all(t.data_ptr() % 16 == 0
                                 for t in (parent, child, delta)))
    from . import _build
    global LAUNCHES
    with torch.cuda.device(parent.device):
        rc = _build.library().xor_delta_launch(
            parent.data_ptr(), child.data_ptr(), delta.data_ptr(),
            cnt.data_ptr(), N, W, vec, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "xor_delta")
    LAUNCHES += 1
    return delta, cnt
