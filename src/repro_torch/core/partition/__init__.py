from .base import (ChunkPacker, Partitioner, key_spans, total_version_span,
                   version_spans)
from .bottom_up import BottomUpPartitioner

# The other partitioners (shingle, traversal, baselines) come with later
# slices of the port.
ALGORITHMS = {
    "bottom_up": BottomUpPartitioner,
}

__all__ = [
    "ChunkPacker", "Partitioner", "version_spans", "total_version_span",
    "key_spans", "BottomUpPartitioner", "ALGORITHMS",
]
