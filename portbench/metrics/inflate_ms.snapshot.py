"""Chunk store: self ms a request in the zlib pass of ``StoredChunk.payloads``
(span ``read.decode.inflate``, one a chunk: each sub-chunk inflated and cut
into its records or deltas)."""
from portbench.harness import program

LAUNCHES = program.LAUNCHES
COUNTERS = program.COUNTERS


def read(obs):
    return program.span_ms(obs, "read.decode.inflate")
