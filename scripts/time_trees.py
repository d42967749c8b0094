#!/usr/bin/env python3
"""Time the port's k=3 build and compaction, and its train step, on the card
for one source tree, so that two trees can be compared within one call.

    python3 scripts/time_trees.py [--src DIR] [--label NAME] [--seed 0]
        [--k3-base-log2 16] [--k3-versions 32] [--tr-layers 2] [--steps 30]

``--src`` is the root of a checkout whose ``src/repro_torch`` is timed (by
default this one); the data come from this checkout's ``chip_smoke.py``
(its ``Chain`` and ``ingest``), so both trees get the same chain.  Steps:

- k3: ``chip_smoke``'s k=3 chain staged through two writer sessions, then
  ``rs.build()``, ``retain(keep_last(16))`` and ``compact()`` (a rebuild at
  k>1), each timed on the host clock with a ``synchronize``, with the
  ``xor_delta`` launches each made and the host seconds and calls spent in
  ``ops.xor_delta_pairs`` (packing, copies, launches, syncs);
- tr: smollm-360m at its published width, ``--tr-layers`` layers, f32,
  AdamW lr 1e-3, batch 8 x 256, deterministic algorithms: ``--steps`` train
  steps, each timed on the host clock with a ``synchronize``; the median
  and the final loss.

Prints one JSON line.  Compare trees in turns within one call (A, B, B, A):
host time moves by about 30% between calls.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=HERE)
    ap.add_argument("--label", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--k3-base-log2", type=int, default=16)
    ap.add_argument("--k3-versions", type=int, default=32)
    ap.add_argument("--tr-layers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    # the tree under test first, so chip_smoke's own path entry comes after
    sys.path.insert(0, os.path.join(os.path.abspath(args.src), "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("time_trees: no card", file=sys.stderr)
        return 2
    import repro_torch.core as T
    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.kernels import deltaenc
    from repro_torch.kernels import ops as kops
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import init_state, make_train_step
    sys.path.append(HERE)
    import chip_smoke as CS
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out = {"label": args.label, "src": os.path.relpath(args.src, HERE),
           "card": CS.gpu_line()}

    # ---- k3: build and compaction
    chain = CS.Chain(args.seed + 1, 1 << args.k3_base_log2, args.k3_versions,
                     p_d=0.1)
    kvs = T.ShardedKVS([T.ShardedDeviceKVS(slot_bytes=CS.SLOT_BYTES,
                                           device=dev) for _ in range(4)])
    rs = T.RStore(T.RStoreConfig(k=3), kvs, device=dev)
    CS.ingest(rs, chain, flush_on_close=False)
    # host seconds inside ops.xor_delta_pairs: packing, copies, launches
    timers = CS.Timers(torch)
    timers.wrap(kops, "xor_delta_pairs", "pairs")
    for name, fn in (("build", rs.build),
                     ("compact", lambda: (rs.retain(T.keep_last(16)),
                                          rs.compact()))):
        d0 = deltaenc.LAUNCHES
        timers.reset()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out[f"{name}_s"] = time.perf_counter() - t0
        out[f"{name}_xor_delta_launches"] = deltaenc.LAUNCHES - d0
        out[f"{name}_xor_delta_pairs_s"] = timers.t.get("pairs", 0.0)
        out[f"{name}_xor_delta_pairs_calls"] = len(timers.calls.get("pairs",
                                                                    []))
    timers.close()
    out["stored_chunk_bytes"] = rs.storage_stats()["stored_chunk_bytes"]
    del rs, kvs, chain

    # ---- tr: train steps
    base = ARCHS[CS.TR_ARCH]
    cfg = base.__class__(**{**base.__dict__, "n_layers": args.tr_layers,
                            "dtype": "float32", "remat": "none"})
    model, opt = build_model(cfg), make_optimizer(cfg, lr=1e-3)
    step_fn = make_train_step(model, opt)
    torch.use_deterministic_algorithms(True)
    state = init_state(cfg, opt, torch.Generator(device=dev)
                       .manual_seed(args.seed), dev)
    ms, loss = [], None
    for i in range(args.steps):
        batch = synthetic_batch(cfg, i, CS.TR_BATCH, CS.TR_SEQ, device=dev)
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        loss = float(m["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    out.update(step_ms_median=statistics.median(ms[3:]),
               step_ms_min=min(ms[3:]), final_loss=loss, steps=args.steps)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
