"""NumPy-facing entry points for the kernels, with the contracts of the
reference package's ``kernels/ops.py``.

Each entry takes host arrays or bytes, moves them to ``device`` (``None``
means the card; ``"cpu"`` runs the plain versions), runs the kernel wrapper
once and brings the result back.  Words cross the numpy boundary as uint32
and are held as int32 on the device (bit-identical for AND/OR/XOR/ANDNOT).
The reference pads to the TPU's (8, 128) tiling; the hand-written kernels
take any shape, so nothing here pads, and the results are equal.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import trace
from ..device import DeviceLike, resolve_device
from . import bitmap as _bitmap
from . import deltaenc as _deltaenc
from . import minhash as _minhash

# One xor_delta launch covers at most this many bytes of each input; a
# larger batch of pairs is split into several launches.
PAIRS_MAX_BYTES = 1 << 28


def _to_device(words: np.ndarray, device: torch.device) -> torch.Tensor:
    host = np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
    if not host.flags.writeable:        # torch.from_numpy wants writable memory
        host = host.copy()
    return torch.from_numpy(host).to(device)


def _to_host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def _results(words: torch.Tensor, counts: torch.Tensor
             ) -> Tuple[np.ndarray, np.ndarray]:
    """A launch's words and counts on the host.  The copies wait for the
    launch (they are the host's ``device.wait`` spans)."""
    return _to_host(words), counts.cpu().numpy()


# ------------------------------------------------------------------ minhash
def hash_family(n_hashes: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Multiply-shift universal hash family: odd multipliers + offsets."""
    rng = np.random.default_rng(seed)
    a = (rng.integers(0, 2**32, size=n_hashes, dtype=np.uint32) | 1).astype(np.uint32)
    b = rng.integers(0, 2**32, size=n_hashes, dtype=np.uint32)
    return a, b


def minhash_csr(indptr: np.ndarray, col: np.ndarray, a: np.ndarray,
                b: np.ndarray, *, device: DeviceLike = None) -> np.ndarray:
    """Min-hash ragged CSR rows in one launch.  Returns (R, L) uint32;
    empty rows → 0xFFFFFFFF.  ``col`` is cast to int32 on the host, as the
    reference's padded blocks hold it."""
    dev = resolve_device(device)
    ptr = torch.from_numpy(np.ascontiguousarray(indptr, dtype=np.int64))
    ent = torch.from_numpy(np.ascontiguousarray(col).astype(np.int32))
    out = _minhash.minhash(ptr.to(dev), ent.to(dev), _to_device(a, dev),
                           _to_device(b, dev))
    return np.ascontiguousarray(_to_host(out).T)


def minhash_padded(versions_padded: np.ndarray, a: np.ndarray, b: np.ndarray,
                   *, device: DeviceLike = None) -> np.ndarray:
    """Min-hash (R, D) rows padded with -1.  Returns (R, L) uint32.  The
    rows go to the same kernel as a CSR of uniform degree D (the kernel
    skips the -1 entries)."""
    R, D = versions_padded.shape
    indptr = np.arange(R + 1, dtype=np.int64) * D
    return minhash_csr(indptr, np.asarray(versions_padded).reshape(-1), a, b,
                       device=device)


# ---------------------------------------------------------------- xor delta
def xor_delta_batch(parent: np.ndarray, child: np.ndarray, *,
                    device: DeviceLike = None) -> Tuple[np.ndarray, np.ndarray]:
    """(N, W) uint32 batches → (delta (N, W) uint32, changed_words (N,))."""
    dev = resolve_device(device)
    d, cnt = _deltaenc.xor_delta(_to_device(parent, dev),
                                 _to_device(child, dev))
    tr = trace.ACTIVE
    return (_results(d, cnt) if tr is None
            else tr.call("device.wait", _results, d, cnt))


def xor_delta_pairs(parents: Sequence[bytes], children: Sequence[bytes], *,
                    device: DeviceLike = None
                    ) -> Tuple[List[bytes], np.ndarray]:
    """Delta-encode (or decode) many payload pairs in one launch.

    Pair ``i`` is ``(parents[i], children[i])`` of equal length; lengths may
    differ between pairs.  The pairs go to the ragged kernel as flat word
    buffers, each pair zero-padded to whole words only, with a CSR of word
    offsets.  Returns each pair's delta (of its own length) and its count of
    nonzero 32-bit words — the same values one :func:`xor_delta_bytes` call
    per pair gives.  Batches above ``PAIRS_MAX_BYTES`` are split into
    several launches.
    """
    if len(parents) != len(children):
        raise ValueError(f"{len(parents)} parents but {len(children)} children")
    lens = np.fromiter((len(p) for p in parents), dtype=np.int64,
                       count=len(parents))
    for i, c in enumerate(children):
        if len(c) != lens[i]:
            raise ValueError(f"pair {i}: parent has {lens[i]} bytes, child "
                             f"{len(c)}")
    dev = resolve_device(device)
    n = len(parents)
    if n == 0:
        return [], np.empty(0, dtype=np.int32)
    words = (lens + 3) // 4
    ends = np.cumsum(words)
    out: List[bytes] = []
    counts = np.empty(n, dtype=np.int32)
    lo = 0
    while lo < n:
        # at least one pair a launch, however long
        hi = max(lo + 1, int(np.searchsorted(
            ends, ends[lo] - words[lo] + PAIRS_MAX_BYTES // 4, "right")))
        off = np.zeros(hi - lo + 1, dtype=np.int64)
        np.cumsum(words[lo:hi], out=off[1:])
        total = int(off[-1])
        # parent words, child words (from a 16-byte boundary) and the
        # offsets in one host buffer: one copy to the device
        span = -(-total // 4) * 4
        host = np.zeros(2 * span + 2 * len(off), dtype=np.int32)
        host[:total] = _flat_words(parents[lo:hi], lens[lo:hi], words[lo:hi])
        host[span:span + total] = _flat_words(children[lo:hi], lens[lo:hi],
                                              words[lo:hi])
        host[2 * span:] = off.view(np.int32)
        buf = torch.from_numpy(host).to(dev)
        d, cnt = _deltaenc.xor_delta_ragged(
            buf[:total], buf[span:span + total],
            buf[2 * span:].view(torch.int64))
        tr = trace.ACTIVE
        d, cnt = (_results(d, cnt) if tr is None
                  else tr.call("device.wait", _results, d, cnt))
        flat = d.tobytes()
        out.extend(flat[4 * int(o):4 * int(o) + int(ln)]
                   for o, ln in zip(off[:-1], lens[lo:hi]))
        counts[lo:hi] = cnt
        lo = hi
    return out, counts


def _flat_words(bufs: Sequence[bytes], lens: np.ndarray,
                words: np.ndarray) -> np.ndarray:
    """Byte strings → one flat int32 word buffer, each zero-padded to
    ``words`` whole words."""
    if (lens % 4 == 0).all():
        raw = b"".join(bufs)
    else:
        raw = b"".join(b.ljust(4 * int(w), b"\0")
                       for b, w in zip(bufs, words.tolist()))
    return np.frombuffer(raw, dtype=np.int32)


def xor_delta_bytes(parent: bytes, child: bytes, *,
                    device: DeviceLike = None) -> Tuple[bytes, int]:
    """Delta-encode one payload against its parent (decode is the same
    call); the shorter input is zero-padded to the longer one's length."""
    w = max(len(parent), len(child))
    (d,), cnt = xor_delta_pairs([parent.ljust(w, b"\0")],
                                [child.ljust(w, b"\0")], device=device)
    return d, int(cnt[0])


# ------------------------------------------------------------------- bitmap
# Bitmap-plan launches since import (the index-AND and the bitmap VM).  The
# planner's one-launch-per-batch contract is asserted against deltas of this
# counter.
BITMAP_LAUNCHES = 0


def and_popcount_batch(bitmaps: np.ndarray, row: np.ndarray, *,
                       device: DeviceLike = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """AND (N, W) bitmaps against a row; returns (anded, popcounts).

    ``row`` is a single shared (W,)/(1, W) bitmap (broadcast against every
    bitmap — the single-query index-AND) or a pairwise (N, W) batch (row i
    ANDs bitmaps[i] — one kernel launch plans a whole query session).
    """
    global BITMAP_LAUNCHES
    BITMAP_LAUNCHES += 1
    N, W = bitmaps.shape
    row = np.asarray(row)
    if row.ndim == 1:
        row = row[None, :]
    if row.shape not in ((1, W), (N, W)):
        raise ValueError(f"row must be ({W},), (1, {W}) or ({N}, {W}); "
                         f"got {row.shape}")
    dev = resolve_device(device)
    anded, cnt = _bitmap.and_popcount(_to_device(bitmaps, dev),
                                      _to_device(row, dev))
    tr = trace.ACTIVE
    return (_results(anded, cnt) if tr is None
            else tr.call("device.wait", _results, anded, cnt))


def bitmap_vm_batch(regs: np.ndarray, prog: np.ndarray, *,
                    device: DeviceLike = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Run one bitmap program over an (S, W) uint32 register file.

    ``prog`` is (P, 4) int32 ``(opcode, dst, lhs, rhs)`` rows (opcodes
    ``bitmap.OP_AND`` / ``OP_OR`` / ``OP_ANDNOT``); an empty program is
    legal and passes the registers through.  Returns the final registers
    ``(S, W)`` uint32 and per-row popcounts ``(S,)`` int32.  One call = one
    launch, whatever the predicate-tree shape.
    """
    global BITMAP_LAUNCHES
    BITMAP_LAUNCHES += 1
    S, W = regs.shape
    prog = np.asarray(prog, dtype=np.int32).reshape(-1, 4)
    if len(prog) and (prog[:, 1:].min() < 0 or prog[:, 1:].max() >= S):
        raise ValueError(f"program row operand out of range [0, {S})")
    dev = resolve_device(device)
    out, cnt = _bitmap.bitmap_vm(_to_device(regs, dev),
                                 torch.from_numpy(np.ascontiguousarray(prog))
                                 .to(dev))
    tr = trace.ACTIVE
    return (_results(out, cnt) if tr is None
            else tr.call("device.wait", _results, out, cnt))
