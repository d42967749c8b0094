"""Chunk store: the program's self ms a wave in ``ChunkMap.from_bytes``
(span ``read.parse.map``: the keys and the inflated version bitmap)."""
from portbench.harness import program

LAUNCHES = program.LAUNCHES
COUNTERS = program.COUNTERS


def read(obs):
    return program.span_ms(obs, "read.parse.map")
