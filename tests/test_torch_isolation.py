"""The port stands alone: it imports neither JAX nor the reference package,
and it never runs on the CPU unless its caller asked for the CPU."""
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import RStore, ShardedDeviceKVS, VersionGraph
from repro_torch.core.index import Projections
from repro_torch.configs import ARCHS
from repro_torch.core.partition import ShinglePartitioner
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.interop import state_from_reference
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_debug_mesh, make_sharded_backend
from repro_torch.models.model import init_params, zero_cache
from repro_torch.train.checkpoint import VersionedCheckpointer
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_step import init_state

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_port_imports_no_jax_and_no_reference():
    mods = _port_modules()
    for m in ("kernels.ops", "interop", "kernels.minhash",
              "core.partition.shingle", "core.partition.traversal",
              "core.partition.baselines", "core.query", "core.datagen",
              "core.secondary", "core.compact", "core.cache", "core.replica",
              "core.flusher", "serve.ingest_gateway", "launch.mesh",
              "tree", "models.config", "models.layers", "models.model",
              "configs", "configs.registry", "configs.shapes",
              "configs.smollm_360m", "data.pipeline", "train.optimizer",
              "train.train_step", "train.checkpoint", "train.grad_compress",
              "launch.train", "serve.engine", "launch.serve",
              "sharding.rules", "train.elastic", "launch.dryrun",
              "launch.cost"):
        assert "repro_torch." + m in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_chip_smoke_imports_no_jax_and_no_reference():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        src = f.read()
    for line in src.splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            assert words[1].split(".")[0] not in ("jax", "repro"), line


def _one_version_graph() -> VersionGraph:
    g = VersionGraph()
    g.add_root(0, g.store.add_batch(np.arange(4), np.full(4, 8)))
    return g


@pytest.mark.parametrize("entry", [
    lambda: ShardedDeviceKVS(),
    lambda: ops.bitmap_vm_batch(np.zeros((2, 2), np.uint32),
                                np.zeros((0, 4), np.int32)),
    lambda: ops.xor_delta_bytes(b"ab", b"cd"),
    lambda: RStore(),
    lambda: ops.minhash_csr(np.array([0, 1]), np.array([3]),
                            *ops.hash_family(2)),
    lambda: ops.and_popcount_batch(np.ones((2, 2), np.uint32),
                                   np.ones(2, np.uint32)),
    lambda: ShinglePartitioner().partition(_one_version_graph(), 1024),
    lambda: Projections({0: np.array([0])}, {1: np.array([0])},
                        1).candidates_batch([(0, [1])]),
    lambda: make_sharded_backend(),
    lambda: VersionedCheckpointer(),
    lambda: init_state(ARCHS["smollm-360m"].reduced(),
                       make_optimizer(ARCHS["smollm-360m"]),
                       torch.Generator()),
    lambda: init_params(ARCHS["smollm-360m"].reduced(), torch.Generator()),
    lambda: synthetic_batch(ARCHS["smollm-360m"].reduced(), 0, 2, 8),
    lambda: state_from_reference({"w": np.zeros(2, np.float32)}),
    lambda: launch_train.run(["--reduced", "--steps", "1"]),
    lambda: launch_serve.run(["--reduced", "--batch", "1", "--gen", "2"]),
    lambda: zero_cache(ARCHS["smollm-360m"].reduced(), 1, 4),
    lambda: make_debug_mesh(),
])
def test_default_device_is_the_card(entry):
    """With no device given, an entry point asks for CUDA and raises here
    instead of quietly running the plain versions on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        entry()
