"""Rank bodies of the port's multi-rank tests on the CPU (gloo), in a module
of their own so that spawned ranks import torch and ``repro_torch`` only.

Each body joins a ``file://`` rendezvous, builds its mesh, runs its cases
and destroys its process group; rank 0 saves what the test compares.
"""
from __future__ import annotations

import os
import time

import torch
import torch.multiprocessing as mp


def spawn(fn, nprocs: int, *args, timeout: float = 240.0) -> None:
    """Run ``fn(rank, nprocs, init, *args)`` in ``nprocs`` spawned
    processes (``init`` a ``file://`` rendezvous beside ``args[0]``); fails
    if any rank fails or the ranks outlive ``timeout`` seconds."""
    init = f"file://{os.path.abspath(str(args[0]))}.rdzv"
    ctx = mp.start_processes(fn, args=(nprocs, init) + args, nprocs=nprocs,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{nprocs} ranks still running after "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)


def _join(rank: int, world: int, init: str) -> None:
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)


MOE_MESHES = {"2x4": ((2, 4), ("data", "model")),
              "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


def moe_worker(rank: int, world: int, init: str, inp: str, out: str) -> None:
    """``moe_shard_map`` on each mesh of ``MOE_MESHES`` for each case of
    ``inp`` (name → (config, per-layer params, tokens)): its output and aux
    from plain global tensors, the gradients of ``sum(y * y) + aux`` with
    respect to the params and tokens, and its output from ``DTensor``
    params placed by the rules with batch-sharded tokens."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch import tree as T
    from repro_torch.models import layers as L
    from repro_torch.sharding.rules import mesh_env

    _join(rank, world, init)
    try:
        res = {}
        cases = torch.load(inp, weights_only=False)
        for (mesh_name, (shape, names)), (name, (cfg, p, x)) in (
                (m, c) for m in MOE_MESHES.items() for c in cases.items()):
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
            leaves = [t.clone().requires_grad_(True)
                      for t in T.leaves(p) + [x]]
            lp = T.unflatten_like(p, leaves[:-1])
            defs = {k: L.ParamDef(d.shape[1:], d.axes[1:])
                    for k, d in L.moe_defs(cfg, 1).items()}
            with mesh_env(mesh) as env:
                y, aux = L.moe_shard_map(lp, leaves[-1], cfg)
                grads = torch.autograd.grad((y * y).sum() + aux, leaves)
                dp = T.tree_map(lambda t, pl: distribute_tensor(t, mesh, pl),
                                p, L.tree_pspecs(defs, env))
                dx = distribute_tensor(x, mesh,
                                       env.sharding_for(x.shape,
                                                        ("batch", None, None)))
                y_dt, aux_dt = L.moe_shard_map(dp, dx, cfg)
                y_dt, aux_dt = y_dt.full_tensor(), aux_dt.full_tensor()
            res[mesh_name, name] = {"y": y.detach(), "aux": aux.detach(),
                         "grads": [g.detach() for g in grads],
                         "y_dt": y_dt, "aux_dt": aux_dt}
        if rank == 0:
            torch.save(res, out)
    finally:
        dist.destroy_process_group()


def elastic_worker(rank: int, world: int, init: str, inp: str,
                   out: str) -> None:
    """Restore the pickled checkpointer's version onto a (2, 2) and a
    (1, 4) mesh; every rank checks that each local shard is its slice of
    the full restored state and that ``full_tensor()`` equals it bit for
    bit, and writes ``out.<rank>`` with what it checked."""
    import pickle

    import torch.distributed as dist

    from repro_torch import tree as T
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.train.elastic import restore_for_mesh

    _join(rank, world, init)
    try:
        with open(inp, "rb") as f:
            ckpt, version, like, cfg, opt = pickle.load(f)
        full = ckpt.restore(version, like=like)
        checked = []
        for shape in ((2, 2), (1, 4)):
            mesh = make_debug_mesh(*shape, device="cpu")
            state = restore_for_mesh(ckpt, version, like, cfg, opt, mesh)
            n = 0
            for (path, d), h in zip(T.leaves_with_paths(state),
                                    T.leaves(full)):
                want = h
                for m, pl in enumerate(d.placements):
                    if pl.is_shard():
                        k = mesh.size(m)
                        want = want.chunk(k, dim=pl.dim)[
                            mesh.get_local_rank(m)]
                        n += 1
                assert torch.equal(d.to_local(), want), (shape, path)
                assert torch.equal(d.full_tensor(), h), (shape, path)
            checked.append((shape, len(T.leaves(state)), n))
        with open(f"{out}.{rank}", "wb") as f:
            pickle.dump(checked, f)
    finally:
        dist.destroy_process_group()
