"""RStore core, ported to PyTorch: a multi-version document store layered
over a key-value store, with its device steps on the card."""
from .api import BatchResult, Q, Query, QueryResult, QueryStats, Snapshot
from .ingest import RStore, RStoreConfig, WriteSession
from .kvs import (Backend, InMemoryKVS, KVSStats, ShardedDeviceKVS,
                  ShardedKVS)
from .types import Chunk, CompositeKey, Delta, Partitioning, Record
from .version_graph import DeltaIds, RecordStore, VersionGraph

__all__ = [
    "RStore", "RStoreConfig", "VersionGraph", "RecordStore", "DeltaIds",
    "CompositeKey", "Record", "Delta", "Chunk", "Partitioning",
    "Q", "Query", "QueryResult", "QueryStats", "BatchResult", "Snapshot",
    "WriteSession", "Backend", "InMemoryKVS", "KVSStats", "ShardedKVS",
    "ShardedDeviceKVS",
]
