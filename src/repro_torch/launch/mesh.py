"""Device-aware KVS shard placement for the store backend.

The model stack's meshes (``make_production_mesh``/``make_debug_mesh`` in
the JAX package) come with the sharding slice of this package; what the
store needs is here: which device each shard's slot table lives on.
"""
from __future__ import annotations

from typing import Optional, Sequence

from ..device import DeviceLike, resolve_device


def make_sharded_backend(n_shards: int = 4,
                         devices: Optional[Sequence[DeviceLike]] = None,
                         slot_bytes: int = 1 << 16, n_slots: int = 1024,
                         replication_factor: int = 1,
                         write_quorum: int | None = None,
                         retry=None,
                         cache_bytes: int | None = None,
                         cache_kw: dict | None = None):
    """Device-aware shard placement for the store backend.

    Returns a :class:`repro_torch.core.kvs.ShardedKVS` router over
    ``n_shards`` :class:`repro_torch.core.kvs.ShardedDeviceKVS` tables.
    Table ``j`` (of ``n_shards × R``) lives on ``devices[j % len(devices)]``,
    so with as many devices as tables a group commit's per-shard
    ``multiput`` and a session read's per-shard ``multiget`` land on
    disjoint devices; with fewer devices the placement wraps.  ``devices``
    of ``None`` means the card (:func:`repro_torch.device.resolve_device`);
    pass ``["cpu"]`` for a CPU run, or use
    ``ShardedKVS([InMemoryKVS()] * n)`` for a host-only backend.

    With ``replication_factor=R > 1`` each shard becomes a
    :class:`repro_torch.core.replica.ReplicatedKVS` group of R device
    tables, each replica on its own device when there are enough, so a
    replica death takes out one table, not the shard: reads fail over
    inside the group, writes keep landing with ``write_quorum`` acks
    (default 1 — availability-first), and
    :class:`repro_torch.core.replica.RecoveryManager` rebuilds lost replicas
    from the survivors.  ``retry`` is the group's
    :class:`repro_torch.core.replica.RetryPolicy` (default policy if None).

    With ``cache_bytes`` set, the router is topped with a
    :class:`repro_torch.core.cache.CachingKVS` chunk cache of that byte
    budget (``cache_kw`` passes through tuning knobs like
    ``always_admit_bytes``): hot chunks are then served at memory speed and
    a fully warm session ``multiget`` costs 0 device round trips.
    """
    from ..core.cache import CachingKVS
    from ..core.kvs import ShardedDeviceKVS, ShardedKVS
    from ..core.replica import ReplicatedKVS

    def finish(router):
        if cache_bytes:
            return CachingKVS(router, cache_bytes=cache_bytes,
                              **(cache_kw or {}))
        return router

    R = max(1, int(replication_factor))
    devs = ([resolve_device(None)] if devices is None
            else [resolve_device(d) for d in devices])
    if not devs:
        raise ValueError("devices must name at least one device")

    def make_table(j: int):
        return ShardedDeviceKVS(slot_bytes, n_slots,
                                device=devs[j % len(devs)])

    if R == 1:
        return finish(ShardedKVS([make_table(i) for i in range(n_shards)]))
    shards = []
    for i in range(n_shards):
        replicas = [make_table(i * R + r) for r in range(R)]
        shards.append(ReplicatedKVS(
            replicas, write_quorum=1 if write_quorum is None else write_quorum,
            retry=retry))
    return finish(ShardedKVS(shards))
