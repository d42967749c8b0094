"""The default store stack, for a configuration that names none.

``config["shards"]`` KV nodes, each one ``ShardedDeviceKVS`` table of
``slot_bytes`` slots on the card, behind a ``ShardedKVS`` router, under one
``RStore`` with the configuration's store settings.  Each value is held
once.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict

from portbench.harness import store


def build(T, config: Dict, device):
    kvs = T.ShardedKVS([T.ShardedDeviceKVS(slot_bytes=int(config["slot_bytes"]),
                                           device=device)
                        for _ in range(int(config["shards"]))])
    return store.rstore(T, config, kvs, device), kvs


def copies(kvs) -> int:
    return 1


@contextmanager
def reading_from(kvs, copy: int):
    """The one copy serves every read as it is."""
    yield
