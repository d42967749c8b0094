"""Device meshes for the model stack, and device-aware KVS shard placement
for the store backend.

Defined as functions (never module-level constants) so importing this module
never touches process-group state.  A mesh is a
:class:`~torch.distributed.device_mesh.DeviceMesh` over the ranks of the
default process group, with the reference's axis names.

H100 node shapes stand in for the reference's TPU pods, at the reference's
chip counts: one "pod" is 256 GPUs as (32, 8) over ``("data", "model")``, two
are 512 as (2, 32, 8) over ``("pod", "data", "model")``.  The model axis is
one 8-GPU NVLink node: tensor parallelism exchanges activations every layer
and needs NVLink's bandwidth, while data parallelism and FSDP gathers cross
the slower InfiniBand between nodes.  The pod axis folds into data-parallel/
FSDP sharding via the default rules.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import DeviceLike, resolve_device

NODE_GPUS = 8
# (shape, axis names) of the production meshes, by ``multi_pod``
PRODUCTION_MESHES = {
    False: ((32, NODE_GPUS), ("data", "model")),
    True: ((2, 32, NODE_GPUS), ("pod", "data", "model")),
}


def _make_mesh(shape, axes, device_type: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` over the default process group, which must hold
    exactly ``prod(shape)`` ranks."""
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"a {tuple(shape)} mesh needs a world of "
                         f"{math.prod(shape)} ranks, not "
                         f"{dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """256 GPUs as (32 nodes, 8 GPUs) over ``("data", "model")``, or 512 as
    (2, 32, 8) over ``("pod", "data", "model")`` with ``multi_pod``.  The
    default process group must already hold that many ranks: one process
    per GPU, or a fake group (``launch/dryrun.py``, ``device_type="cpu"``)."""
    shape, axes = PRODUCTION_MESHES[multi_pod]
    return _make_mesh(shape, axes, device_type)


def make_debug_mesh(n_data: int = 1, n_model: int = 1,
                    device: DeviceLike = None) -> DeviceMesh:
    """Small mesh for local runs: ``(n_data, n_model)`` over ``("data",
    "model")`` on ``device``'s type (``None`` = the card).

    The (1, 1) mesh in a process with no process group starts a world of
    one (NCCL on the card, gloo on the CPU) over an in-process store, so it
    needs no port and no network.  Any other shape needs a process group of
    ``n_data * n_model`` ranks, started by the caller (one process per rank,
    e.g. ``torch.multiprocessing`` with a ``file://`` rendezvous)."""
    dev = resolve_device(device)
    if not dist.is_initialized() and n_data * n_model == 1:
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return _make_mesh((n_data, n_model), ("data", "model"), dev.type)


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
