"""The replicated store stack, for a configuration whose ``stack`` is
``"replicated"``.

Replica groups: ``config["shards"]`` KV nodes, each a ``ReplicatedKVS``
of ``config["replicas"]`` ``ShardedDeviceKVS`` tables (``slot_bytes``
slots) on the card whose writes ``config["write_quorum"]`` of them
acknowledge, behind a ``ShardedKVS`` router, under one ``RStore`` with the
configuration's store settings.  Each replica of a group holds a copy of
every value; ``reading_from`` has reads served by one replica alone.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict

from portbench.harness import store


def build(T, config: Dict, device):
    def table():
        return T.ShardedDeviceKVS(slot_bytes=int(config["slot_bytes"]),
                                  device=device)
    kvs = T.ShardedKVS([
        T.ReplicatedKVS([table() for _ in range(int(config["replicas"]))],
                        write_quorum=int(config["write_quorum"]))
        for _ in range(int(config["shards"]))])
    return store.rstore(T, config, kvs, device), kvs


def copies(kvs) -> int:
    return len(kvs.shards[0].replicas)


@contextmanager
def reading_from(kvs, copy: int):
    """Every other replica of each group is marked down, so that replica
    ``copy`` serves each read (after its repair log, if any, is replayed);
    all are live again afterwards."""
    for group in kvs.shards:
        for i in range(len(group.replicas)):
            if i != copy:
                group.mark_down(i)
    try:
        yield
    finally:
        for group in kvs.shards:
            for i in range(len(group.replicas)):
                group.mark_live(i)
