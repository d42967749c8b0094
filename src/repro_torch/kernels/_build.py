"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a`` into an object file (``csrc/*.cuh`` holds device code
that several of them include); the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``.  Nothing
includes PyTorch's headers, so a build takes seconds.  The library is built
at first use, from the sources in the checkout, into ``build/repro_torch/``
at the repository root (listed in ``.gitignore``); its file name carries a
hash of the sources, so an edited source is never served a stale build.
Nothing here runs at import: this module is imported on machines without
``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lib: Optional[ctypes.CDLL] = None
# what the last build did: seconds, library path, nvcc's ptxas report
BUILD_INFO: Dict[str, object] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME/bin); "
                       "the CUDA kernels are built on the machine with the card")


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _headers() -> List[Path]:
    return sorted(CSRC.glob("*.cuh"))


def build() -> Path:
    """Compile the sources (in parallel) and link the library; returns its
    path.  Reuses an existing library built from identical sources."""
    srcs = _sources()
    digest = hashlib.sha256()
    for s in srcs + _headers():
        digest.update(s.name.encode())
        digest.update(s.read_bytes())
    tag = digest.hexdigest()[:16]
    lib = BUILD_DIR / f"libreprotorch_{tag}.so"
    if lib.exists():
        BUILD_INFO.update(seconds=0.0, library=str(lib), reused=True)
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for s in srcs:
        obj = BUILD_DIR / f"{s.stem}_{tag}.o"
        procs.append((s, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    reports = []
    for s, _, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {s.name}:\n{out}")
        reports.append(out)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, library=str(lib),
                      reused=False, ptxas="".join(reports))
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bitmap_vm_launch.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, ptr]
        lib.bitmap_vm_launch.restype = i32
        lib.xor_delta_launch.argtypes = [ptr, ptr, ptr, ptr, i64, i64, ptr]
        lib.xor_delta_launch.restype = i32
        lib.xor_delta_ragged_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, i64,
                                                i64, ptr]
        lib.xor_delta_ragged_launch.restype = i32
        lib.and_popcount_launch.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i32,
                                            ptr]
        lib.and_popcount_launch.restype = i32
        lib.minhash_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i32, ptr]
        lib.minhash_launch.restype = i32
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise on a launch the runtime refused (``cudaGetLastError() != 0``)."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")
