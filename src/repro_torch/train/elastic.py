"""Elastic restart: restore a checkpoint onto a *different* mesh.

RStore's chunk layout is mesh-independent (records are keyed by logical
tensor block, not by device), so growing/shrinking the cluster is: build the
new mesh → restore the latest version → ``distribute_tensor`` each param
with its placements under the new mesh's rules.  Partial restore (Q2) lets a
data-parallel-only rescale fetch just the blocks the new topology is
missing, though the default path restores everything.

Failure handling contract (``launch/train.py``):
  - commits are atomic at RStore index publish; a crash mid-commit leaves the
    previous version intact;
  - on restart the launcher calls ``restore_for_mesh`` on whatever devices are
    healthy; the deterministic data pipeline skips ahead to the stored step,
    so no samples repeat.

Every param is placed by ``tree_pspecs``; the optimizer state is replicated,
as the reference's ``device_put`` without a sharding leaves it.  Nothing is
placed by a fallback: ``spec_for`` already replicates every dim its rules do
not divide, so a failure to place a tensor is a fault and raises.
"""
from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, distribute_tensor

from .. import tree as T
from ..models.config import ModelConfig
from ..models.layers import tree_pspecs
from ..models.model import param_defs
from ..sharding.rules import MeshEnv, default_rules
from .checkpoint import VersionedCheckpointer
from .optimizer import Optimizer


def shard_state_for_mesh(state_host, cfg: ModelConfig, opt: Optimizer,
                         mesh: DeviceMesh) -> dict:
    """A state tree as ``DTensor``s on ``mesh``: params placed by the
    default rules, the optimizer state replicated.  Each rank passes the
    same full state (``distribute_tensor`` takes rank 0's)."""
    env = MeshEnv(mesh=mesh, rules=default_rules(mesh))
    rep = [Replicate()] * mesh.ndim
    return {
        "params": T.tree_map(lambda x, pl: distribute_tensor(x, mesh, pl),
                             state_host["params"],
                             tree_pspecs(param_defs(cfg), env)),
        "opt": T.tree_map(lambda x: distribute_tensor(x, mesh, rep),
                          state_host["opt"]),
    }


def restore_for_mesh(ckpt: VersionedCheckpointer, version: int, like_state,
                     cfg: ModelConfig, opt: Optimizer, mesh: DeviceMesh):
    """Q1 restore + reshard onto a (possibly different) mesh."""
    host_state = ckpt.restore(version, like=like_state)
    return shard_state_for_mesh(host_state, cfg, opt, mesh)
