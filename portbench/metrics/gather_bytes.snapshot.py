"""KVS: bytes the router fetched per request (``KVSStats.bytes_fetched``)."""
COUNTERS = {"bytes_fetched": "kvs:stats.bytes_fetched"}


def read(obs):
    return obs.per_unit(obs.counter("bytes_fetched"))
