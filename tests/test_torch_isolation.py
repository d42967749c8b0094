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
from repro_torch.core.partition import ShinglePartitioner
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_sharded_backend

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
              "core.flusher", "serve.ingest_gateway", "launch.mesh"):
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
])
def test_default_device_is_the_card(entry):
    """With no device given, an entry point asks for CUDA and raises here
    instead of quietly running the plain versions on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        entry()
