"""Group flush: old chunk maps rewritten a version (the program's
``maps_rebuilt`` counter): bytes rewritten that hold no new record."""
from portbench.harness import program

LAUNCHES = program.LAUNCHES
COUNTERS = program.COUNTERS


def read(obs):
    return obs.per_unit(program.counter(obs, "maps_rebuilt",
                                        within="write.flush"))
