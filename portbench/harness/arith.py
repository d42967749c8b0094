"""The benchmark's arithmetic: percentiles, spreads, busy unions and the
roofline of a kernel launch.

The peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit: HBM3
at 3.35 TB/s, and 67 T/s of 32-bit operations outside the tensor cores, the
rate that plain integer word operations get.  A launch's least time is the
larger of its bytes over the first and its word operations over the second.
Bytes and operations are counted from the launch's shapes: every input
byte read once, every output byte written once (the counts behind the
kernel table of ``PERF.md``).
"""
from __future__ import annotations

import math
import statistics
from typing import Iterable, List, Optional, Sequence, Tuple

PEAK_BYTES_PER_S = 3.35e12
PEAK_WORD_OPS_PER_S = 67e12


def nearest_rank(values: Sequence[float], pct: float) -> float:
    """The ``pct`` percentile by nearest rank: the smallest value with at
    least ``pct`` percent of all values at or below it."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    return s[max(0, math.ceil(pct / 100.0 * len(s)) - 1)]


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartiles as a share of the
    median (``statistics.quantiles``' default method)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def union_s(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by a set of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


def least_s(nbytes: float, nops: float) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, nops / PEAK_WORD_OPS_PER_S)


# ---------------------------------------------------------- launch costs
# Each takes the kernel wrapper's arguments and returns (bytes, word
# operations) of the launch it makes, or None where it launches nothing
# (CPU tensors run the plain version; empty shapes launch nothing).

def bitmap_vm_cost(regs, prog) -> Optional[Tuple[int, int]]:
    """(S, W) int32 registers and a (P, 4) program: registers read and the
    final registers written, the program read, S counts written; one
    operation per instruction and word, a popcount and a sum per word."""
    if regs.device.type != "cuda" or regs.numel() == 0:
        return None
    S, W = regs.shape
    P = prog.shape[0]
    return 2 * S * W * 4 + P * 16 + S * 4, P * W + 2 * S * W


def xor_delta_ragged_cost(parent, child, row_off
                          ) -> Optional[Tuple[int, int]]:
    """T words of parent and child read, T words of delta written, n counts
    written and n + 1 int64 offsets read; an XOR and a compare per word."""
    n = row_off.numel() - 1
    if parent.device.type != "cuda" or n == 0:
        return None
    T = parent.numel()
    return 3 * T * 4 + 4 * n + 8 * (n + 1), 2 * T

