"""Chunk store: the program's self microseconds in
``StoredChunk.from_bytes`` (span ``read.parse.chunk``) per sub-chunk it
parsed (counter ``subchunks_parsed``, a chunk's header count): the parse's
cost an entry of its sub-chunk directory, whatever the wave's size."""
from portbench.harness import program

LAUNCHES = program.LAUNCHES
COUNTERS = program.COUNTERS


def read(obs):
    ms = program.span_ms(obs, "read.parse.chunk")
    subs = program.counter(obs, "subchunks_parsed", within="read.parse.chunk")
    if ms is None or not subs:
        return None
    return 1e3 * ms * obs.units / subs
