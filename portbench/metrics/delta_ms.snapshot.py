"""Chunk store: self ms a request in the level loop of ``StoredChunk.payloads``
(span ``read.decode.delta``, one a chunk: one ``xor_delta_pairs`` call a tree
level, less its ``device.wait``); 0 where chunks decode with no delta (k=1)."""
from portbench.harness import program

LAUNCHES = program.LAUNCHES
COUNTERS = program.COUNTERS


def read(obs):
    return program.span_ms(obs, "read.decode.delta", within="read.decode")
