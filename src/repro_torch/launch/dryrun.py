"""Multi-node dry run on the H100 model.

For every (architecture × input-shape × mesh) cell: build the production
mesh on a fake process group of its world size, make the step's state,
batch and caches as ``DTensor``s whose local shards lie on the ``meta``
device (no allocation), run the step once under ``launch/cost.py``'s
counters, and record per-device argument bytes, FLOPs, collectives and the
three-term roofline, all modelled on the H100 datasheet.  Nothing is
compiled, so the reference's ``--save-hlo`` has no counterpart.  Results
land in ``build/repro_torch/dryrun/<arch>__<shape>__<mesh>.json``.

Usage:
  python -m repro_torch.launch.dryrun --arch kimi-k2-1t-a32b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-existing]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import pathlib
import sys
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils.flop_counter import FlopCounterMode

from .. import tree as T
from ..configs import ARCHS, SHAPES, runnable
from ..data.pipeline import batch_spec
from ..models.model import abstract_cache, abstract_params, build_model
from ..sharding.rules import abstract_leaf, mesh_env, rules_for
from ..train.optimizer import make_optimizer
from ..train.train_step import abstract_state, make_train_step
from .cost import CostMode, Roofline, model_flops
from .mesh import PRODUCTION_MESHES, make_production_mesh

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / \
    "build" / "repro_torch" / "dryrun"


@contextlib.contextmanager
def fake_world(n_ranks: int):
    """A fake default process group of ``n_ranks`` (this process is rank
    0; collectives return at once), destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def build_cell(cfg, shape, env):
    """Returns (fn, args) for one cell: the step and its abstract inputs."""
    model = build_model(cfg)
    if shape.kind == "train":
        opt = make_optimizer(cfg)
        step = make_train_step(model, opt)
        state = abstract_state(cfg, opt, env)
        batch = batch_spec(cfg, shape.global_batch, shape.seq_len, env)
        return step, (state, batch)
    params = abstract_params(cfg, env)
    if shape.kind == "prefill":
        batch = batch_spec(cfg, shape.global_batch, shape.seq_len, env)
        fn = functools.partial(model.prefill, max_len=shape.seq_len)
        return fn, (params, batch)
    # decode: one new token against a seq_len cache, at its last position
    caches = abstract_cache(cfg, shape.global_batch, shape.seq_len, env)
    tokens = abstract_leaf((shape.global_batch, 1), ("batch", None),
                           torch.int32, env)
    pos = torch.tensor(shape.seq_len - 1, dtype=torch.int32)
    return model.decode_step, (params, caches, tokens, pos)


def local_bytes(tree) -> int:
    """Bytes one rank holds of a tree: the local shard of each ``DTensor``."""
    return sum((t.to_local() if isinstance(t, DTensor) else t).nbytes
               for t in T.leaves(tree) if isinstance(t, torch.Tensor))


def _trace(cfg, shape, env):
    """One run of the cell's step under the counters (``CostMode``, and
    ``CommDebugMode`` to hold its collective count against): (costs, bytes
    of the outputs one rank holds).  The global FLOPs come from
    ``FlopCounterMode`` over the same step run unsharded on ``meta``
    tensors: on ``DTensor``s it would count the parts that run on local
    shards (``_on_shards``, ``moe_shard_map``) at their local size."""
    fn, args = build_cell(cfg, shape, env)
    counter = CostMode(env.mesh)
    with CommDebugMode() as comm, counter:
        out = fn(*args)
    counter.costs.comm_debug_total = float(comm.get_total_counts())
    fn, args = build_cell(cfg, shape, None)
    with FlopCounterMode(display=False) as flops:
        fn(*args)
    counter.costs.flops_global = float(flops.get_total_flops())
    return counter.costs, local_bytes(out)


def measure_cell(cfg, shape, mesh: DeviceMesh) -> dict:
    """Memory and roofline of one cell on ``mesh`` (whose process group
    must exist): argument bytes from the full configuration's abstract
    inputs, costs traced at one and two layer groups and extrapolated to
    the configuration's depth (``launch/cost.py``).  A first trace at one
    group is thrown away: DTensor runs some ops of its own the first time
    it meets a sharding, which no rank's step would repeat."""
    groups = cfg.n_groups_scan
    period = cfg.scan_period()
    with mesh_env(mesh, rules=rules_for(cfg, mesh)) as env:
        _, args = build_cell(cfg, shape, env)
        arg_bytes = local_bytes(args)
        # donated as the reference donates them: the train state, the caches
        alias = local_bytes(args[0] if shape.kind == "train" else
                            args[1] if shape.kind == "decode" else ())
        del args
        one = dataclasses.replace(cfg, n_layers=period)
        _trace(one, shape, env)     # warm DTensor's caches: count no set-up
        c1, o1 = _trace(one, shape, env)
        if groups > 1:
            c2, o2 = _trace(dataclasses.replace(cfg, n_layers=2 * period),
                            shape, env)
            costs, out_bytes = c1.extrapolate(c2, groups), \
                o1 + (groups - 1) * (o2 - o1)
        else:
            costs, out_bytes = c1, o1
    mem = {"argument_size_in_bytes": arg_bytes,
           "output_size_in_bytes": out_bytes,
           "alias_size_in_bytes": alias,
           "temp_size_in_bytes": "not measured",
           "per_device_hbm_bytes_without_temp": arg_bytes + out_bytes - alias}
    roof = Roofline(costs, model_flops(cfg, shape.kind, shape.seq_len,
                                       shape.global_batch), mesh.size())
    return {"memory": mem, "roofline": roof.to_dict(),
            "groups": groups, "groups_traced": [1, 2] if groups > 1 else [1]}


def mesh_name(multi_pod: bool, optimized: bool) -> str:
    """``gpu32x8``, ``gpu2x32x8``; ``__opt`` with the optimized overrides."""
    shape = PRODUCTION_MESHES[multi_pod][0]
    return "gpu" + "x".join(map(str, shape)) + ("__opt" if optimized else "")


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: pathlib.Path = RESULTS_DIR, optimized: bool = False):
    from ..configs.registry import OPTIMIZED

    cfg = ARCHS[arch]
    shape = SHAPES[shape_name]
    if optimized:
        over = OPTIMIZED.get(arch, {}).get(shape.kind, {})
        if not over:
            return {"arch": arch, "shape": shape_name, "status": "skipped",
                    "reason": "no optimized overrides for this shape kind"}
        cfg = dataclasses.replace(cfg, **over)
    ok, why = runnable(cfg, shape)
    name = mesh_name(multi_pod, optimized)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"{arch}__{shape_name}__{name}.json"
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "mesh": name,
               "status": "skipped", "reason": why}
        out_path.write_text(json.dumps(rec, indent=2))
        print(f"[dryrun] {arch} × {shape_name} × {name}: {why}")
        return rec

    n_gpus = math.prod(PRODUCTION_MESHES[multi_pod][0])
    rec = {"arch": arch, "shape": shape_name, "mesh": name,
           "n_gpus": n_gpus, "status": "error"}
    t0 = time.time()
    try:
        with fake_world(n_gpus):
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
            rec.update(measure_cell(cfg, shape, mesh))
        rec.update(status="ok", trace_s=round(time.time() - t0, 2))
        roof, mem = rec["roofline"], rec["memory"]
        print(f"[dryrun] OK {arch} × {shape_name} × {name}: traced in "
              f"{rec['trace_s']:.1f}s, args/dev "
              f"{mem['argument_size_in_bytes'] / 2**30:.2f} GiB, bottleneck "
              f"{roof['bottleneck']}, roofline "
              f"{roof['roofline_fraction']:.3f} (modelled)")
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[dryrun] FAIL {arch} × {shape_name} × {name}: "
              f"{type(e).__name__}: {str(e)[:200]}")
    out_path.write_text(json.dumps(rec, indent=2))
    print(json.dumps({k: v for k, v in rec.items() if k != "traceback"}))
    return rec


def main():
    ap = argparse.ArgumentParser(
        description="Dry run of (architecture × shape × mesh) cells on a fake "
        "process group, modelled on the H100.  The reference's --save-hlo "
        "has no counterpart: nothing is compiled, so there is no HLO.")
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="2×32×8 mesh of 512 GPUs (default: 32×8, 256)")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="apply the per-arch §Perf winning overrides")
    ap.add_argument("--out-dir", default=str(RESULTS_DIR))
    args = ap.parse_args()

    out_dir = pathlib.Path(args.out_dir)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    if args.optimized:
        from ..configs.registry import OPTIMIZED
        # the §Perf winners are train/prefill optimizations; decode cells are
        # scoped out, as the reference scopes them
        cells = [(a, s) for a, s in cells
                 if SHAPES[s].kind in OPTIMIZED.get(a, {})]

    failures = 0
    for arch, shape in cells:
        for mp in meshes:
            name = mesh_name(mp, args.optimized)
            path = out_dir / f"{arch}__{shape}__{name}.json"
            if args.skip_existing and path.exists():
                st = json.loads(path.read_text()).get("status")
                if st in ("ok", "skipped"):
                    continue
            rec = run_cell(arch, shape, mp, out_dir=out_dir,
                           optimized=args.optimized)
            failures += rec["status"] == "error"
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
