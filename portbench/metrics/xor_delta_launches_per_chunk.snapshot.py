"""Kernel ``xor_delta``: launches per decoded chunk (``deltaenc.LAUNCHES``
over the program's ``chunks_decoded`` counter).  One a tree level a chunk;
a decode batched over the request would make it one a level a request."""
from portbench.harness import program

LAUNCHES = program.LAUNCHES
COUNTERS = {**program.COUNTERS,
            "xor_delta": "repro_torch.kernels.deltaenc:LAUNCHES"}


def read(obs):
    chunks = program.counter(obs, "chunks_decoded", within="read.decode")
    launches = obs.counter("xor_delta")
    if not chunks or launches is None:
        return None
    return launches / chunks
