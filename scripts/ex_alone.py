#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ex path (the repo's examples on the port) alone
on the card, then ``examples/versioned_training_torch.py`` at its default
flags.

    python3 scripts/ex_alone.py [-- TRAINING FLAGS]

Builds the kernels, runs ``chip_smoke.main_path_ex`` with its checks (the
quickstart, EHR and serving examples at their default flags, their output
held to the reference's transcripts), holds every ``bitmap_vm`` program and
``xor_delta`` ragged launch they made against the plain versions, then runs
the training example in-process: smollm-360m at its published width, depth
8, f32, 200 steps of batch 8 x 256, with its commits, crash, restore and
fork (``-- FLAGS`` passes other flags to it, for a quick try).  Its
transcript is printed after it; the last line gives its time, its
launches, its peak device memory and the card.  Every printed loss must be
finite.  The training example is too long for ``chip_smoke.py``'s time
limit; path tr is its checked counterpart there.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import sys
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("training_flags", nargs="*",
                    help="flags for versioned_training_torch.py after --")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ex_alone: no card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build, bitmap, deltaenc, minhash, ops, ref
    K = SimpleNamespace(ops=ops, ref=ref, bitmap=bitmap, delta=deltaenc,
                        minhash=minhash)
    card = cs.gpu_line()
    cs.log(f"[setup] {card}; torch {torch.__version__}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.library()

    t0 = time.perf_counter()
    launches, programs, ragged = cs.main_path_ex(torch, K)
    cs.log(f"[time] ex done in {time.perf_counter() - t0:.3f} s; launches "
           f"{json.dumps(launches)}")
    for name, regs, prog in programs:
        o1, c1 = bitmap.bitmap_vm(regs, prog)
        o2, c2 = ref.bitmap_vm_ref(regs, prog)
        if not (torch.equal(o1, o2) and torch.equal(c1, c2)):
            raise AssertionError(f"bitmap_vm {name} disagrees")
    for name, p, c, off in ragged:
        d1, n1 = deltaenc.xor_delta_ragged(p, c, off)
        d2, n2 = ref.xor_delta_ragged_ref(p, c, off)
        if not (torch.equal(d1, d2) and torch.equal(n1, n2)):
            raise AssertionError(f"xor_delta ragged {name} disagrees")
    cs.log(f"[kernels] the ex path's {len(programs)} bitmap_vm programs and "
           f"{len(ragged)} xor_delta ragged launches bit-exact")

    mod = cs.load_example("versioned_training_torch.py")
    cs.zero_launches(K)
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            mod.main(args.training_flags)
        torch.cuda.synchronize()
    finally:
        print(buf.getvalue(), end="", flush=True)
    dt = time.perf_counter() - t0
    losses = [float(x) for x in re.findall(r"loss (\S+)", buf.getvalue())]
    if not losses or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"versioned_training: losses {losses}")
    cs.log(f"[ex_alone] versioned_training_torch.py "
           f"{' '.join(args.training_flags) or '(default flags)'}: "
           f"{dt:.3f} s; launches {json.dumps(cs.read_launches(K))}; peak "
           f"device memory {torch.cuda.max_memory_allocated()} bytes; "
           f"{len(losses)} losses, all finite; {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
