"""Logical-axis → mesh-axis sharding rules (MaxText-style), on a
``torch.distributed`` device mesh.

Every parameter/activation dimension carries a *logical* axis name; rules map
it to zero or more mesh axes.  ``spec_for`` drops any assignment that does not
divide the dimension evenly (e.g. 15 attention heads over a 16-way model
axis), falling back to replication for that dim, so one rule set stays valid
across all 10 architectures.  The rules are the reference package's
``sharding/rules.py``, to the letter.

The mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh`; its
``mesh_dim_names`` play the role of JAX's axis names.  ``spec_for`` gives
the reference's partition spec as a plain tuple (per tensor dim ``None``, an
axis name, or a tuple of names), and ``sharding_for`` turns it into DTensor
placements, one per mesh dim.

A context-managed ``MeshEnv`` carries (mesh, rules) so model code can request
activation sharding constraints without threading mesh plumbing everywhere;
outside any env (unit tests, one card) constraints are no-ops.  Inside one,
plain tensors that meet a ``DTensor`` count as replicated over the mesh
(``implicit_replication``): the masks and iotas model code makes are the
same on every rank.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

Axes = Tuple[Optional[str], ...]
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]
MESH_ORDER = ("pod", "data", "model")


# Default logical→mesh rules.  "fsdp" axes shard weight rows (ZeRO-3 style);
# "tp" shards heads/hidden/vocab/experts; "dp" shards batch.  The pod axis
# folds into both dp and fsdp when present.
def default_rules(mesh: DeviceMesh) -> Dict[str, Tuple[str, ...]]:
    names = mesh.mesh_dim_names
    dp: Tuple[str, ...] = tuple(n for n in ("pod", "data") if n in names)
    tp: Tuple[str, ...] = ("model",) if "model" in names else ()
    return {
        "batch": dp,
        "fsdp": dp,
        "embed": dp,            # weight reduction dims → FSDP
        "vocab": tp,
        "heads": tp,
        "kv_heads": tp,
        "head_dim": (),
        "mlp": tp,
        "experts": tp,
        "expert_mlp": (),
        "ssm_heads": tp,
        "ssm_proj": tp,
        "layers": (),
        "seq": (),
        "cache_seq": tp,        # decode: shard KV cache sequence (flash-decode)
        "state": (),
        "conv": (),
        "capacity": dp,         # MoE dispatch buffer capacity dim
        "act_embed": (),        # activation hidden dim (replicated, 1D TP)
        "act_heads": tp,        # activation head dim
        "attn_batch": dp + tp,  # attention batch resharded over all axes
        "seq_sp": tp,           # sequence-parallel residual stream
    }


@dataclass
class MeshEnv:
    mesh: DeviceMesh
    rules: Dict[str, Tuple[str, ...]]

    def axis_size(self, name: str) -> int:
        return self.mesh.size(self.mesh.mesh_dim_names.index(name))

    def spec_for(self, shape: Sequence[int], axes: Axes) -> Spec:
        """The reference's ``PartitionSpec`` for ``shape`` as a tuple."""
        assert len(shape) == len(axes), (shape, axes)
        names = self.mesh.mesh_dim_names
        used: set = set()
        parts = []
        for dim, ax in zip(shape, axes):
            if ax is None:
                parts.append(None)
                continue
            mesh_axes = tuple(a for a in self.rules.get(ax, ())
                              if a in names and a not in used)
            size = math.prod(self.axis_size(a) for a in mesh_axes) \
                if mesh_axes else 1
            if mesh_axes and size > 0 and dim % size == 0:
                parts.append(mesh_axes if len(mesh_axes) > 1 else mesh_axes[0])
                used.update(mesh_axes)
            else:
                parts.append(None)     # indivisible → replicate this dim
        return tuple(parts)

    def placements(self, spec: Spec) -> Tuple[Placement, ...]:
        """DTensor placements of a spec: ``Shard(d)`` on every mesh dim
        that dim ``d``'s entry names, ``Replicate()`` elsewhere.  DTensor
        shards a dim over its mesh dims left to right, which is JAX's
        major-to-minor order only when the entry lists its axes in mesh
        order; the rules always do, and this asserts it."""
        names = self.mesh.mesh_dim_names
        out: list = [Replicate()] * len(names)
        for d, entry in enumerate(spec):
            if entry is None:
                continue
            entry = (entry,) if isinstance(entry, str) else entry
            idx = [names.index(a) for a in entry]
            assert idx == sorted(idx), (spec, names)
            for i in idx:
                out[i] = Shard(d)
        return tuple(out)

    def sharding_for(self, shape: Sequence[int], axes: Axes
                     ) -> Tuple[Placement, ...]:
        return self.placements(self.spec_for(shape, axes))

    def local_shape(self, shape: Sequence[int], axes: Axes) -> Tuple[int, ...]:
        """One rank's shard of ``shape`` (every assignment divides)."""
        out = list(shape)
        for d, entry in enumerate(self.spec_for(shape, axes)):
            if entry is not None:
                entry = (entry,) if isinstance(entry, str) else entry
                out[d] //= math.prod(self.axis_size(a) for a in entry)
        return tuple(out)

    def abstract(self, shape: Sequence[int], axes: Axes,
                 dtype: torch.dtype) -> DTensor:
        """A ``DTensor`` of ``shape`` whose local shard lies on the ``meta``
        device (no storage): the counterpart of a ``ShapeDtypeStruct`` with
        a ``NamedSharding``."""
        local = torch.empty(self.local_shape(shape, axes), dtype=dtype,
                            device="meta")
        return DTensor.from_local(
            local, self.mesh, self.sharding_for(shape, axes), run_check=False,
            shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride())


def abstract_leaf(shape: Sequence[int], axes: Axes, dtype: torch.dtype,
                  env: Optional[MeshEnv] = None) -> torch.Tensor:
    """``shape`` as a ``meta`` tensor, or with ``env`` as a ``DTensor`` of
    ``meta`` shards placed by the rules."""
    if env is None:
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    return env.abstract(shape, axes, dtype)


def dp_only_rules(mesh: DeviceMesh) -> Dict[str, Tuple[str, ...]]:
    """Pure data-parallel profile: batch over every mesh axis, FSDP weights
    over the data axes, no tensor parallelism.  The right regime for models
    whose per-layer shards would be tiny or whose head counts don't divide
    the TP width (e.g. smollm-360m) — avoids all activation resharding."""
    names = mesh.mesh_dim_names
    all_axes = tuple(n for n in MESH_ORDER if n in names)
    dp = tuple(n for n in ("pod", "data") if n in names)
    base = default_rules(mesh)
    base.update({
        "batch": all_axes,
        "fsdp": dp,
        "embed": dp,
        "vocab": (), "heads": (), "kv_heads": (), "mlp": (),
        "experts": (), "ssm_heads": (), "ssm_proj": (),
        "act_heads": (), "attn_batch": all_axes,
        "capacity": all_axes,
    })
    return base


def rules_for(cfg, mesh: DeviceMesh) -> Dict[str, Tuple[str, ...]]:
    profile = getattr(cfg, "sharding_profile", "default")
    if profile == "dp_only":
        return dp_only_rules(mesh)
    return default_rules(mesh)


_CURRENT: list = []


@contextlib.contextmanager
def mesh_env(mesh: DeviceMesh,
             rules: Optional[Dict[str, Tuple[str, ...]]] = None):
    names = mesh.mesh_dim_names
    assert names is not None and list(names) == [
        n for n in MESH_ORDER if n in names], names
    env = MeshEnv(mesh=mesh, rules={**default_rules(mesh), **(rules or {})})
    _CURRENT.append(env)
    try:
        with implicit_replication():
            yield env
    finally:
        _CURRENT.pop()


def current_env() -> Optional[MeshEnv]:
    return _CURRENT[-1] if _CURRENT else None


def constrain(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Activation sharding constraint by logical axes: a ``DTensor`` is
    redistributed to the rules' placements; a plain tensor, or any tensor
    outside an env, is returned as it is."""
    env = current_env()
    if env is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(env.mesh, env.sharding_for(x.shape, tuple(axes)))


def replicated(fn: Callable, *args):
    """``fn`` over ``args`` as whole tensors on every rank.  Plain tensors
    pass straight through; when any argument is a ``DTensor``, each one is
    gathered to a full replica, ``fn`` runs on the local replicas and every
    tensor it returns comes back as a replicated ``DTensor``.  For the
    routing steps DTensor has no sharding strategy for (``searchsorted``,
    ``index_put_``); results are unchanged and autograd flows through."""
    dts = [a for a in args if isinstance(a, DTensor)]
    if not dts:
        return fn(*args)
    mesh = dts[0].device_mesh
    rep = [Replicate()] * mesh.ndim
    local = [a.redistribute(mesh, rep).to_local() if isinstance(a, DTensor)
             else a for a in args]
    out = fn(*local)

    def wrap(t):
        return (DTensor.from_local(t, mesh, rep, run_check=False)
                if isinstance(t, torch.Tensor) else t)
    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)
