"""Group flush: self ms a version building the new chunks and their maps,
with the record-version CSR they are built from (span ``write.chunks``)."""
from portbench.harness import program

LAUNCHES = program.LAUNCHES
COUNTERS = program.COUNTERS


def read(obs):
    return program.span_ms(obs, "write.chunks")
