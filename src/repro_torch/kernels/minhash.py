"""Min-hash shingles of ragged version lists (§3.1).

The SHINGLE partitioner computes, for every record, ``L`` min-hashes of the
set of versions the record belongs to under the multiply-shift family
``h_l(v) = a_l · v + b_l (mod 2^32)``, and sorts records by them.

``minhash`` launches the hand-written CUDA kernel (``csrc/minhash.cu``) for
CUDA tensors and runs the plain version (``ref.minhash_csr_ref``) for CPU
tensors; it never falls back from one to the other.  It reads the
record→version CSR as it is (a segmented min), where the reference kernel
needs it scattered into padded tiles.  ``LAUNCHES`` counts kernel launches
only.
"""
from __future__ import annotations

import torch

from . import ref

# CUDA kernel launches since import
LAUNCHES = 0


def minhash(indptr: torch.Tensor, col: torch.Tensor, a: torch.Tensor,
            b: torch.Tensor) -> torch.Tensor:
    """Min-hash every CSR row.

    Args:
      indptr: (R+1,) int64 row pointers into ``col``.
      col: (nnz,) int32 entries; -1 entries are skipped (padding).
      a, b: (L,) int32 hash parameters (uint32 bit patterns).
    Returns:
      (L, R) int32 min-hashes (uint32 bit patterns) on the inputs' device;
      an empty row gives 0xFFFFFFFF.
    """
    if indptr.dtype != torch.int64 or indptr.dim() != 1 or indptr.numel() < 1:
        raise ValueError(f"indptr must be (R+1,) int64, got "
                         f"{tuple(indptr.shape)} {indptr.dtype}")
    if col.dtype != torch.int32 or col.dim() != 1:
        raise ValueError(f"col must be (nnz,) int32, got {tuple(col.shape)} "
                         f"{col.dtype}")
    if (a.dtype != torch.int32 or b.dtype != torch.int32 or a.dim() != 1
            or a.shape != b.shape):
        raise ValueError(f"a, b must be equal (L,) int32, got "
                         f"{tuple(a.shape)} {a.dtype}, {tuple(b.shape)} "
                         f"{b.dtype}")
    devs = {t.device for t in (indptr, col, a, b)}
    if len(devs) != 1:
        raise ValueError(f"indptr, col, a, b on several devices: {devs}")
    if col.device.type == "cpu":
        return ref.minhash_csr_ref(indptr, col, a, b)
    if col.device.type != "cuda":
        raise ValueError(f"unsupported device {col.device}")
    if not all(t.is_contiguous() for t in (indptr, col, a, b)):
        raise ValueError("indptr, col, a and b must be contiguous")
    R, L = indptr.numel() - 1, a.numel()
    out = torch.empty((L, R), dtype=torch.int32, device=col.device)
    if R == 0 or L == 0:
        return out
    from . import _build
    global LAUNCHES
    with torch.cuda.device(col.device):
        rc = _build.library().minhash_launch(
            indptr.data_ptr(), col.data_ptr(), a.data_ptr(), b.data_ptr(),
            out.data_ptr(), R, L, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "minhash")
    LAUNCHES += 1
    return out
