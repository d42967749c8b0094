"""Chunk store: records decoded per record returned (the program's
``records_decoded`` counter, a decoded chunk's every record, over
``records_returned``, the batches' ``QueryStats``): decode work no answer
uses."""
from portbench.harness import program

LAUNCHES = program.LAUNCHES
COUNTERS = program.COUNTERS


def read(obs):
    decoded = program.counter(obs, "records_decoded", within="read.request")
    returned = program.counter(obs, "records_returned", within="read.request")
    if decoded is None or not returned:
        return None
    return decoded / returned
