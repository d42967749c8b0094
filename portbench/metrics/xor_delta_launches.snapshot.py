"""Kernel ``xor_delta``: launches per request (the wrapper's ``LAUNCHES``
counter; 0 at k=1, where no record is delta-encoded)."""
COUNTERS = {"xor_delta": "repro_torch.kernels.deltaenc:LAUNCHES"}


def read(obs):
    return obs.per_unit(obs.counter("xor_delta"))
