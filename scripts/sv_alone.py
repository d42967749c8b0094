#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s sv path (model serving) alone on the card.

    python3 scripts/sv_alone.py [--seed 0] [--sv-layers 0]
        [--sv-registry-layers 2]

Builds the kernels, runs ``chip_smoke.main_path_sv`` with its checks (the
granite-moe waves through ``Engine``, mamba2-130m and whisper-base, the
reduced architectures, the model registry), then holds the ``bitmap_vm``
launches of its restores against the plain version.  About two minutes on
the H100, against the whole smoke's twelve: a quick try of a serving change.
The whole run stays ``chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sv-layers", type=int, default=0)
    ap.add_argument("--sv-registry-layers", type=int, default=2)
    args = ap.parse_args()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("sv_alone: no card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build, bitmap, deltaenc, minhash, ops, ref
    K = SimpleNamespace(ops=ops, ref=ref, bitmap=bitmap, delta=deltaenc,
                        minhash=minhash)
    cs.log(f"[setup] {cs.gpu_line()}; torch {torch.__version__}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.library()
    t0 = time.perf_counter()
    launches, programs = cs.main_path_sv(args, torch, dev, K)
    cs.log(f"[time] sv done in {time.perf_counter() - t0:.1f} s")
    for i, (regs, prog) in enumerate(programs):
        o1, c1 = bitmap.bitmap_vm(regs, prog)
        o2, c2 = ref.bitmap_vm_ref(regs, prog)
        if not (torch.equal(o1, o2) and torch.equal(c1, c2)):
            raise AssertionError(f"bitmap_vm sv restore {i} disagrees")
    cs.log(f"[kernels] bitmap_vm: the {len(programs)} sv restore programs "
           "bit-exact")
    return 0


if __name__ == "__main__":
    sys.exit(main())
