"""RStore core, ported to PyTorch: a multi-version document store layered
over a key-value store, with its device steps on the card."""
from .api import BatchResult, Q, Query, QueryResult, QueryStats, Snapshot
from .cache import CachingKVS
from .compact import (CompactionReport, Compactor, LayoutHealth,
                      RetentionPolicy, keep_all, keep_last, keep_tagged,
                      measure_layout)
from .datagen import PAPER_DATASETS, DatasetSpec, dataset_stats, generate
from .flusher import BackgroundFlusher, DrainReport
from .ingest import RStore, RStoreConfig, WriteSession
from .kvs import (Backend, InMemoryKVS, KVSStats, ShardedDeviceKVS,
                  ShardedKVS)
from .replica import (BackendTimeout, BackendUnavailable, FaultInjectingKVS,
                      QuorumLost, RecoveryManager, RecoveryReport,
                      ReplicatedKVS, RetryPolicy, ShardDown,
                      TransientBackendError)
from .secondary import (AttributeExtractor, SecondaryIndex,
                        datagen_extractor, struct_extractor)
from .types import Chunk, CompositeKey, Delta, Partitioning, Record
from .version_graph import DeltaIds, RecordStore, VersionGraph

__all__ = [
    "RStore", "RStoreConfig", "VersionGraph", "RecordStore", "DeltaIds",
    "CompositeKey", "Record", "Delta", "Chunk", "Partitioning",
    "DatasetSpec", "PAPER_DATASETS", "generate", "dataset_stats",
    "Q", "Query", "QueryResult", "QueryStats", "BatchResult", "Snapshot",
    "WriteSession", "BackgroundFlusher", "DrainReport",
    "Backend", "InMemoryKVS", "KVSStats", "ShardedKVS",
    "ShardedDeviceKVS", "CachingKVS",
    "Compactor", "CompactionReport", "LayoutHealth", "RetentionPolicy",
    "keep_all", "keep_last", "keep_tagged", "measure_layout",
    "BackendUnavailable", "TransientBackendError", "BackendTimeout",
    "ShardDown", "QuorumLost", "FaultInjectingKVS", "RetryPolicy",
    "ReplicatedKVS", "RecoveryManager", "RecoveryReport",
    "AttributeExtractor", "SecondaryIndex", "struct_extractor",
    "datagen_extractor",
]
