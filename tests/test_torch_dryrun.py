"""The port's dry run (``launch/dryrun.py`` over ``launch/cost.py``) on the
CPU: reduced train, prefill and decode cells through ``run_cell`` on a fake
(2, 4) mesh (the production mesh's shape patched), against the reference's
compiled cells on a (2, 4) mesh of 8 host devices, and one full-size cell
on the 256-GPU mesh.

Per-device argument bytes must equal XLA's
``memory_analysis().argument_size_in_bytes``: both are the bytes of each
input's local shard, nothing padded.  The global FLOPs, extrapolated from
one and two traced layer groups, must equal ``FlopCounterMode`` of the same
step run unsharded on ``meta`` tensors at its full depth (3 groups).
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ARCHS as R_ARCHS
from repro.data.pipeline import batch_spec as r_batch_spec
from repro.launch.mesh import _make_mesh as r_make_mesh
from repro.models.model import abstract_cache as r_abstract_cache
from repro.models.model import abstract_params as r_abstract_params
from repro.models.model import build_model as r_build_model
from repro.sharding.rules import mesh_env as r_mesh_env
from repro.sharding.rules import rules_for as r_rules_for
from repro.train.optimizer import make_optimizer as r_make_optimizer
from repro.train.train_step import abstract_state as r_abstract_state
from repro.train.train_step import make_train_step as r_make_train_step
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod

CELLS = [("granite-moe-1b-a400m", ShapeSpec("train_s", "train", 32, 8)),
         ("granite-moe-1b-a400m", ShapeSpec("prefill_s", "prefill", 32, 8)),
         ("granite-moe-1b-a400m", ShapeSpec("decode_s", "decode", 32, 8)),
         ("mamba2-130m", ShapeSpec("train_s", "train", 32, 8)),
         ("mamba2-130m", ShapeSpec("decode_s", "decode", 32, 8)),
         ("whisper-base", ShapeSpec("prefill_s", "prefill", 32, 8))]


def _reduced(archs, name):
    """The reduced config at 3 layer groups (so the dry run extrapolates)."""
    cfg = archs[name].reduced()
    return dataclasses.replace(cfg, n_layers=3 * cfg.scan_period())


def _reference_arg_bytes(name, shape) -> int:
    """The reference's dry-run cell (``repro.launch.dryrun.build_cell``,
    whose module sets a 512-device platform when imported) compiled on a
    (2, 4) mesh of 8 host devices: XLA's per-device argument bytes."""
    cfg = _reduced(R_ARCHS, name)
    mesh = r_make_mesh((2, 4), ("data", "model"))
    B, S = shape.global_batch, shape.seq_len
    with r_mesh_env(mesh, rules=r_rules_for(cfg, mesh)) as env:
        model = r_build_model(cfg)
        if shape.kind == "train":
            opt = r_make_optimizer(cfg)
            fn = jax.jit(r_make_train_step(model, opt), donate_argnums=(0,))
            args = (r_abstract_state(cfg, opt, env),
                    r_batch_spec(cfg, B, S, env))
        elif shape.kind == "prefill":
            fn = jax.jit(functools.partial(model.prefill, max_len=S))
            args = (r_abstract_params(cfg, env), r_batch_spec(cfg, B, S, env))
        else:
            fn = jax.jit(model.decode_step, donate_argnums=(1,))
            args = (r_abstract_params(cfg, env),
                    r_abstract_cache(cfg, B, S, env),
                    jax.ShapeDtypeStruct((B, 1), jnp.int32,
                                         sharding=env.sharding_for(
                                             (B, 1), ("batch", None))),
                    jax.ShapeDtypeStruct((), jnp.int32))
        compiled = fn.lower(*args).compile()
    return compiled.memory_analysis().argument_size_in_bytes


@pytest.fixture(scope="module")
def measured(tmp_path_factory):
    """Every reduced cell through ``run_cell`` on a fake (2, 4) mesh: the
    reduced configs and small shapes registered, the production mesh's
    shape patched, all of it undone before the tests."""
    out_dir = tmp_path_factory.mktemp("dryrun")
    patch = pytest.MonkeyPatch()
    out = {}
    try:
        patch.setitem(mesh_mod.PRODUCTION_MESHES, False,
                      ((2, 4), ("data", "model")))
        for name, shape in CELLS:
            cfg = _reduced(ARCHS, name)
            patch.setitem(ARCHS, cfg.name, cfg)
            patch.setitem(SHAPES, shape.name, shape)
            out[name, shape.name] = dryrun.run_cell(cfg.name, shape.name,
                                                    False, out_dir=out_dir)
    finally:
        patch.undo()
    return out


@pytest.mark.parametrize("name,shape", CELLS,
                         ids=[f"{n}-{s.name}" for n, s in CELLS])
def test_argument_bytes_equal_xla(measured, name, shape):
    """Equal, but for one case: an SSM-only decode step never reads its
    position, and XLA prunes that unused 4-byte argument from the
    executable; the port's step takes it all the same."""
    rec = measured[name, shape.name]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["mesh"] == "gpu2x4" and rec["n_gpus"] == 8
    got = rec["memory"]["argument_size_in_bytes"]
    unused_pos = 4 if (shape.kind == "decode"
                       and ARCHS[name].family == "ssm") else 0
    assert got == _reference_arg_bytes(name, shape) + unused_pos


@pytest.mark.parametrize("name,shape", CELLS,
                         ids=[f"{n}-{s.name}" for n, s in CELLS])
def test_global_flops_equal_unsharded_run(measured, name, shape):
    cfg = _reduced(ARCHS, name)
    fn, args = dryrun.build_cell(cfg, shape, None)
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    roof = measured[name, shape.name]["roofline"]
    assert roof["flops_global"] == fc.get_total_flops() > 0
    # each rank does at least its share, at most the whole step
    assert roof["flops_global"] / 8 <= roof["flops_per_device"] \
        <= roof["flops_global"]
    assert measured[name, shape.name]["groups_traced"] == [1, 2]


def test_reduced_cells_record_a_roofline(measured):
    for rec in measured.values():
        roof = rec["roofline"]
        assert roof["n_gpus"] == 8 and roof["bytes_per_device"] > 0
        assert roof["bottleneck"] in ("compute", "memory", "collective")
        assert "modelled, not measured" in roof["hardware"]
        assert rec["memory"]["temp_size_in_bytes"] == "not measured"
    # a sharded train step gathers FSDP shards and reduces gradients
    counts = measured["granite-moe-1b-a400m", "train_s"]["roofline"][
        "coll_counts"]
    assert any(k.startswith("all_gather/") for k in counts)
    # CostMode sees every collective CommDebugMode sees, and no other
    for rec in measured.values():
        roof = rec["roofline"]
        assert sum(roof["coll_counts"].values()) == \
            roof["comm_debug_mode_total"]
    assert any(k.startswith(("reduce_scatter/", "all_reduce/"))
               for k in counts)


def test_run_cell_full_size_decode(tmp_path):
    """granite-moe decode_32k on the 256-GPU mesh: status ok, its JSON
    written, the fake process group gone afterwards."""
    rec = dryrun.run_cell("granite-moe-1b-a400m", "decode_32k", False,
                          out_dir=tmp_path)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["n_gpus"] == 256 and rec["groups"] == 24
    saved = json.loads((tmp_path / "granite-moe-1b-a400m__decode_32k__"
                        "gpu32x8.json").read_text())
    assert saved["memory"] == rec["memory"]
    assert not torch.distributed.is_initialized()
    skipped = dryrun.run_cell("granite-moe-1b-a400m", "long_500k", False,
                              out_dir=tmp_path)
    assert skipped["status"] == "skipped"
