"""Per-device cost of one step, counted while it runs on ``DTensor``s of
``meta`` shards, and its three-term roofline on the NVIDIA H100.

The reference compiles each dry-run cell with XLA and walks the partitioned
HLO (``benchmarks/hlo_analysis.py``).  Nothing here is compiled: the step
runs eagerly on a fake process group, every tensor a ``DTensor`` whose local
shard lies on the ``meta`` device, and :class:`CostMode` counts what each
rank would do:

- **FLOPs per device** from the local ops.  ``FlopCounterMode`` over
  ``DTensor``s sees the global op (a (8,16,64)·(64,128) einsum on a (2, 4)
  mesh counts 2,097,152, the unsharded count), so ``CostMode`` defers every
  ``DTensor`` op (``NotImplemented``, as ``CommDebugMode`` does) and counts
  the local ops DTensor runs on each rank's shards instead, with
  ``FlopCounterMode``'s own formulas; code that runs on local shards itself
  (the attention core, ``moe_shard_map``'s body) is counted as it runs.
  The global count beside it is ``FlopCounterMode``'s over the same step
  run unsharded (``launch/dryrun.py``).
- **Bytes per device**: each local op, views aside, reads its inputs and
  writes its outputs once.  Eager and unfused, so an upper bound on HBM
  traffic.
- **Collectives**: every collective the ranks would run (DTensor's
  redistributions, ``moe_shard_map``'s gathers), its count by kind and
  mesh axis (the dry run records ``CommDebugMode``'s total beside it) and
  its ring-model bytes per device:
  all-gather and all-to-all ``(n-1)/n`` of the full buffer, reduce-scatter
  ``(n-1)/n`` of its input, all-reduce ``2(n-1)/n``.

The layer groups run in a Python loop where the reference scans them, so a
deep model would trace every layer.  As ``hlo_analysis`` multiplies a scan
body by its trip count, the dry run traces the step at one and at two
groups and extrapolates linearly: ``c(G) = c(1) + (G - 1)(c(2) - c(1))``,
exact because every group is the same program.  Loops inside a layer (the
SSD's chunks; blockwise attention, which no registered configuration
selects) run in full.

Every time here is **modelled** from NVIDIA's H100 80GB HBM3 (SXM5, 700 W)
datasheet, never measured: 989.4 TFLOP/s dense bf16, 3.35 TB/s HBM3,
NVLink 450 GB/s per direction for groups over the ``model`` axis (one
8-GPU node), 50 GB/s (NDR InfiniBand, 400 Gb/s) for the other axes.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch._guards import detect_fake_mode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

PEAK_FLOPS = 989.4e12      # dense bf16 per GPU
HBM_BW = 3.35e12           # bytes/s per GPU
NVLINK_BW = 450e9          # bytes/s per GPU per direction, within a node
IB_BW = 50e9               # bytes/s per GPU, NDR InfiniBand between nodes
DATASHEET = ("modelled, not measured: NVIDIA H100 80GB HBM3 (SXM5, 700 W) "
             "datasheet, 989.4 TFLOP/s dense bf16, 3.35 TB/s HBM3, NVLink "
             "450 GB/s per direction (model axis), NDR InfiniBand 50 GB/s "
             "(other axes)")

_COLLECTIVE_NS = ("_c10d_functional", "_c10d_functional_autograd", "c10d")
_RING = {"all_gather": 1.0, "reduce_scatter": 1.0, "all_to_all": 1.0,
         "all_reduce": 2.0, "broadcast": 1.0}


def _kind(name: str):
    n = name.replace("_", "")
    for kind in ("allgather", "reducescatter", "allreduce", "alltoall",
                 "broadcast"):
        if kind in n:
            return {"allgather": "all_gather",
                    "reducescatter": "reduce_scatter",
                    "allreduce": "all_reduce", "alltoall": "all_to_all",
                    "broadcast": "broadcast"}[kind]
    return None


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


@dataclasses.dataclass
class Costs:
    """One traced step's counts (all per device but ``flops_global``;
    ``comm_debug_total`` is ``CommDebugMode``'s count of the same run's
    collectives, beside ``coll_counts``' own)."""
    flops_global: float = 0.0
    flops: float = 0.0
    bytes: float = 0.0
    coll_counts: Counter = dataclasses.field(default_factory=Counter)
    coll_bytes: Counter = dataclasses.field(default_factory=Counter)
    comm_debug_total: float = 0.0

    def extrapolate(self, two: "Costs", groups: int) -> "Costs":
        """``self`` traced at one group, ``two`` at two: the step at
        ``groups``."""
        def lin(a, b):
            return a + (groups - 1) * (b - a)
        keys = set(self.coll_counts) | set(two.coll_counts)
        bkeys = set(self.coll_bytes) | set(two.coll_bytes)
        return Costs(
            lin(self.flops_global, two.flops_global),
            lin(self.flops, two.flops), lin(self.bytes, two.bytes),
            Counter({k: lin(self.coll_counts[k], two.coll_counts[k])
                     for k in keys}),
            Counter({k: lin(self.coll_bytes[k], two.coll_bytes[k])
                     for k in bkeys}),
            lin(self.comm_debug_total, two.comm_debug_total))


class CostMode(TorchDispatchMode):
    """Counts the local work of every rank's step (see the module
    docstring); ``costs`` holds the totals."""

    def __init__(self, mesh: DeviceMesh):
        super().__init__()
        self.axis_of = {mesh.get_group(i).group_name: name
                        for i, name in enumerate(mesh.mesh_dim_names)}
        self.size_of = {name: mesh.size(i)
                        for i, name in enumerate(mesh.mesh_dim_names)}
        self.costs = Costs()

    def _group_axis(self, args) -> str:
        for a in tree_leaves(args):
            name = a if isinstance(a, str) else getattr(a, "group_name", None)
            if name in self.axis_of:
                return self.axis_of[name]
        return "world"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # count DTensor's local ops instead
        out = func(*args, **kwargs)
        if detect_fake_mode(args):
            return out      # DTensor's shape propagation, not a rank's work
        packet = func._overloadpacket
        c = self.costs
        if func.namespace in _COLLECTIVE_NS:
            kind = _kind(func.__name__)
            if kind is not None:
                axis = self._group_axis((args, kwargs))
                n = self.size_of.get(axis, 1)
                # the full buffer: the gathered output, the scattered
                # input, or the reduced tensor
                full = max(_nbytes(a) for a in (args, kwargs, out))
                c.coll_counts[f"{kind}/{axis}"] += 1
                c.coll_bytes[axis] += _RING[kind] * (n - 1) / n * full
            return out
        if packet in flop_registry:
            c.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if not getattr(func, "is_view", False):
            c.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def model_flops(cfg, shape_kind: str, seq: int, batch: int) -> float:
    """MODEL_FLOPS: 6·N_active·tokens for training, 2·N_active·tokens for
    inference (decode counts the new tokens only); the reference's
    ``benchmarks/roofline.py`` formula."""
    n_active = cfg.active_param_count()
    if shape_kind == "train":
        return 6.0 * n_active * seq * batch
    if shape_kind == "prefill":
        return 2.0 * n_active * seq * batch
    return 2.0 * n_active * batch          # decode: one token per sequence


@dataclasses.dataclass
class Roofline:
    costs: Costs
    model_flops_global: float
    n_gpus: int

    @property
    def t_compute(self) -> float:
        return self.costs.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.costs.bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return sum(b / (NVLINK_BW if axis == "model" else IB_BW)
                   for axis, b in self.costs.coll_bytes.items())

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)  # type: ignore[arg-type]

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / (per-device FLOPs × GPUs): remat and redundancy."""
        total = self.costs.flops * self.n_gpus
        return self.model_flops_global / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful model FLOP/s over the cluster's peak if the step took
        max(term) seconds (an MFU bound from the dry run)."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        return (self.model_flops_global / (self.n_gpus * PEAK_FLOPS * t)
                if t > 0 else 0.0)

    def to_dict(self) -> Dict:
        c = self.costs
        return {
            "flops_per_device": c.flops,
            "flops_global": c.flops_global,
            "bytes_per_device": c.bytes,
            "collective_bytes_per_device": dict(c.coll_bytes),
            "coll_counts": dict(c.coll_counts),
            "comm_debug_mode_total": c.comm_debug_total,
            "model_flops_global": self.model_flops_global,
            "n_gpus": self.n_gpus,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
            "hardware": DATASHEET,
        }
