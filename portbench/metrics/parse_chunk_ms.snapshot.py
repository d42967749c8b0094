"""Chunk store: the program's self ms a request in ``StoredChunk.from_bytes``
(span ``read.parse.chunk``: the chunk header, each sub-chunk's columns)."""
from portbench.harness import program

LAUNCHES = program.LAUNCHES
COUNTERS = program.COUNTERS


def read(obs):
    return program.span_ms(obs, "read.parse.chunk")
