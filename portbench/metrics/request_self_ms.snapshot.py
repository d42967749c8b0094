"""Front end: self ms a request of the program's ``read.request`` span
(``StoreQueryEngine.serve``: the freshness check, the split of the batch, the
bookkeeping of ``Snapshot.execute``), outside every layer below it."""
from portbench.harness import program

LAUNCHES = program.LAUNCHES
COUNTERS = program.COUNTERS


def read(obs):
    return program.span_ms(obs, "read.request")
