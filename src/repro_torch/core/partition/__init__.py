from .base import (ChunkPacker, Partitioner, key_spans, total_version_span,
                   version_spans)
from .baselines import DeltaBaseline, SingleAddressPartitioner, SubChunkPartitioner
from .bottom_up import BottomUpPartitioner
from .shingle import ShinglePartitioner
from .traversal import BFSPartitioner, DFSPartitioner

ALGORITHMS = {
    "bottom_up": BottomUpPartitioner,
    "shingle": ShinglePartitioner,
    "depth_first": DFSPartitioner,
    "breadth_first": BFSPartitioner,
    "single_address": SingleAddressPartitioner,
    "subchunk": SubChunkPartitioner,
    "delta": DeltaBaseline,
}

__all__ = [
    "ChunkPacker", "Partitioner", "version_spans", "total_version_span",
    "key_spans", "BottomUpPartitioner", "ShinglePartitioner", "DFSPartitioner",
    "BFSPartitioner", "SingleAddressPartitioner", "SubChunkPartitioner",
    "DeltaBaseline", "ALGORITHMS",
]
