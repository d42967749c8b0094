"""Analytical cost model (Table 1).

Closed-form storage / full-version / point-query costs for the four baseline
schemes under the paper's simplifying assumptions: a chain of ``n`` versions,
``m_v`` records per version, update fraction ``d``, compression ratio ``c``,
record size ``s``, chunk size ``s_c``.  ``bench_table1`` checks these against
the instrumented system.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

# §2.3 Cassandra-like request pricing: every batched round trip pays a fixed
# per-request overhead, every byte pays transfer time.  These two constants
# are THE system-wide simulated-cost calibration — KVSStats.simulated_seconds,
# the compaction trigger, and the chunk cache's admission rule all price
# traffic with them, so "is it worth a round trip?" means the same thing on
# every layer.
PER_QUERY_S = 5e-4
BANDWIDTH_BPS = 200e6


def fetch_seconds(n_queries: float, n_bytes: float,
                  per_query_s: float = PER_QUERY_S,
                  bandwidth_Bps: float = BANDWIDTH_BPS) -> float:
    """Simulated cost of fetching ``n_bytes`` in ``n_queries`` round trips —
    the Table-1 query-cost kernel (overhead + transfer) in one place."""
    return n_queries * per_query_s + n_bytes / bandwidth_Bps


@dataclass(frozen=True)
class Workload:
    n: int          # versions (chain)
    m_v: int        # records per version
    d: float        # fraction updated per version
    c: float        # compression ratio (c ≤ 1)
    s: float        # record size (bytes)
    s_c: float      # chunk size (bytes)


def independent_chunking(w: Workload) -> Dict[str, float]:
    """Every version stored independently, records packed into chunks."""
    return {
        "storage": w.n * w.m_v * w.s,
        "version_bytes": w.m_v * w.s,
        "version_queries": w.m_v * w.s / w.s_c,
        "point_bytes": w.s_c,
        "point_queries": 1,
    }


def delta(w: Workload) -> Dict[str, float]:
    return {
        "storage": w.m_v * w.s + w.c * w.d * (w.n - 1) * w.m_v * w.s,
        "version_bytes": w.m_v * w.s + w.c * w.d * (w.n - 1) * w.m_v * w.s / 2,
        "version_queries": w.n / 2,
        "point_bytes": w.m_v * w.s + w.c * w.d * (w.n - 1) * w.m_v * w.s / 2,
        "point_queries": w.n / 2,
    }


def subchunk(w: Workload) -> Dict[str, float]:
    return {
        "storage": w.m_v * w.s + w.c * w.d * (w.n - 1) * w.m_v * w.s,
        "version_bytes": w.m_v * (w.s + w.c * w.d * (w.n - 1) * w.s),
        "version_queries": w.m_v,
        "point_bytes": w.s + w.c * w.d * (w.n - 1) * w.s,
        "point_queries": 1,
    }


def single_address(w: Workload) -> Dict[str, float]:
    return {
        "storage": w.m_v * w.s + w.d * (w.n - 1) * w.m_v * w.s,
        "version_bytes": w.m_v * w.s,
        "version_queries": w.m_v * w.s / w.s,   # = m_v gets
        "point_bytes": w.s,
        "point_queries": 1,
    }


def rstore(w: Workload, span_factor: float = 1.0) -> Dict[str, float]:
    """RStore with dedupe + chunking: storage ≈ unique bytes; a version
    touches ≈ span_factor × (version bytes / chunk size) chunks (span_factor
    ≥ 1 measures partitioning quality — 1 is the information-theoretic
    floor)."""
    unique = w.m_v * w.s + w.d * (w.n - 1) * w.m_v * w.s
    vq = span_factor * w.m_v * w.s / w.s_c
    return {
        "storage": unique,
        "version_bytes": span_factor * w.m_v * w.s,
        "version_queries": vq,
        "point_bytes": w.s_c,
        "point_queries": 1,
    }


MODELS = {
    "independent_chunking": independent_chunking,
    "delta": delta,
    "subchunk": subchunk,
    "single_address": single_address,
    "rstore": rstore,
}
