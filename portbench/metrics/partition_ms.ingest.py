"""Group flush: self ms a version in the online partition and the layout
bookkeeping (r2c, projections) of the flush (span ``write.partition``)."""
from portbench.harness import program

LAUNCHES = program.LAUNCHES
COUNTERS = program.COUNTERS


def read(obs):
    return program.span_ms(obs, "write.partition")
