"""What the benchmark may load and read: no JAX and no JAX package (top-level
names compared whole), a reference that imports nothing of the program, no
file of the JAX package's benchmark folder, and no run without a card or
without the program."""
import ast
import os
import shutil
import subprocess
import sys

import pytest

from portbench import run
from portbench.harness import registry

BENCH = registry.BENCH_DIR
OLD_FOLDER = "bench" + "marks"          # the JAX package's benchmark folder


def sources():
    for dp, dirs, fs in os.walk(BENCH):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in fs:
            if f.endswith(".py") and not f.startswith("test_"):
                yield os.path.join(dp, f)


def imported(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def top(name):
    return name.split(".", 1)[0]


def test_forbidden_modules_compare_whole_top_level_names():
    assert run.forbidden_modules(["repro_torch", "repro_torch.core",
                                  "reprox", "numpy"]) == []
    assert run.forbidden_modules(["repro", "repro.core.api", "jax.numpy",
                                  "jaxlib", "flax.linen", "torch"]) == [
        "flax.linen", "jax.numpy", "jaxlib", "repro", "repro.core.api"]


def test_nothing_imports_jax_or_the_jax_package():
    for path in sources():
        for name in imported(path):
            assert top(name) not in run.FORBIDDEN, (path, name)


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            for name in imported(os.path.join(ref, f)):
                assert top(name) in ("__future__", "typing", "numpy"), \
                    (f, name)


def test_nothing_reads_the_jax_packages_benchmarks():
    for path in sources():
        text = open(path).read()
        assert OLD_FOLDER + "/" not in text and \
            OLD_FOLDER + "." not in text, path
        for name in imported(path):
            assert top(name) != OLD_FOLDER, (path, name)


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, os.path.join(cwd, "portbench", "run.py"),
         "--workload", "a2-k1.lookup", "--seed", "1", "--seconds", "1",
         "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    p = _run(registry.ROOT)
    assert p.returncode != 0 and p.stdout.strip() == "", p.stderr[-2000:]
    assert "card" in p.stderr


def test_no_result_from_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(registry.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(str(tmp_path))
    assert p.returncode != 0 and p.stdout.strip() == "", p.stderr[-2000:]


def test_unknown_workload_is_refused(monkeypatch):
    monkeypatch.setattr(sys, "path", list(sys.path))
    for k in run.CACHES:               # so that teardown undoes main's
        monkeypatch.setenv(k, "")
    with pytest.raises(SystemExit):
        run.main(["--workload", "a2-k1.lookup"])          # no seed
    assert run.main(["--workload", "nope", "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) != 0
    assert all(os.environ[k] == v for k, v in run.CACHES.items())
