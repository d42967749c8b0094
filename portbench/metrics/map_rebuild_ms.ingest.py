"""Group flush: self ms a version rebuilding the maps of old chunks that the
flushed versions reach (span ``write.maps``); 0 where a flush rebuilds none."""
from portbench.harness import program

LAUNCHES = program.LAUNCHES
COUNTERS = program.COUNTERS


def read(obs):
    return program.span_ms(obs, "write.maps", within="write.flush")
