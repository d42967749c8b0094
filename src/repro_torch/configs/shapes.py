"""Assigned input-shape cells and per-arch applicability."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

from ..models.config import ModelConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def runnable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether (arch × shape) is a runnable cell, with the skip reason.

    long_500k requires sub-quadratic attention: run for SSM/hybrid only —
    pure full-attention archs skip it (recorded in DESIGN.md).  No assigned
    arch is encoder-only, so decode shapes run everywhere else.
    """
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, "SKIP(full-attention)"
    return True, ""


def cells(archs: Dict[str, ModelConfig]) -> List[Tuple[str, str, bool, str]]:
    out = []
    for a, cfg in archs.items():
        for s, sh in SHAPES.items():
            ok, why = runnable(cfg, sh)
            out.append((a, s, ok, why))
    return out
