"""Batched serving demo on the PyTorch port: prefill + greedy decode over a
reduced arch, with a versioned model registry (serve the model at any
RStore version).

Model restores ride the plan/execute session API: a full restore is a
one-query session (Q1) and a partial restore batches one ``Q.records`` query
per tensor — either way the registry pays a single KVS round trip.

Run:  python examples/serve_demo_torch.py [--arch granite-moe-1b-a400m]
      [--device cpu]

It mirrors ``examples/serve_demo.py`` and prints the same lines; its random
weights come from a seeded ``torch.Generator`` on the model's device, so the
generated tokens differ from the reference's.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.serve.engine import Engine
from repro_torch.train.checkpoint import VersionedCheckpointer
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_step import init_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-moe-1b-a400m",
                    choices=sorted(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="where the model and store run (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = ARCHS[args.arch].reduced()
    cfg = cfg.__class__(**{**cfg.__dict__, "remat": "none"})
    model = build_model(cfg)
    opt = make_optimizer(cfg)

    # "train" two quick model versions and register them
    step = make_train_step(model, opt)
    state = init_state(cfg, opt, torch.Generator(device=dev).manual_seed(0),
                       dev)
    ckpt = VersionedCheckpointer(device=dev)
    v0 = ckpt.commit(state, parents=(), tag="init")
    for i in range(5):
        state, _ = step(state, synthetic_batch(cfg, i, 4, 64, device=dev))
    v1 = ckpt.commit(state, parents=(v0,), tag="tuned")

    prompts = {"tokens": synthetic_batch(cfg, 0, args.batch, args.prompt_len,
                                         device=dev)["tokens"]}
    kvs_stats = ckpt.rs.kvs.stats
    for version in (v0, v1):
        q0 = kvs_stats.n_queries
        params = ckpt.restore(version, like=state)["params"]
        print(f"restore@v{version}: {kvs_stats.n_queries - q0} KVS round "
              f"trip(s) (batched session)")
        eng = Engine(cfg, params, max_len=args.prompt_len + args.gen + 8)
        t0 = time.time()
        toks = eng.generate(prompts, steps=args.gen).cpu()
        dt = time.time() - t0
        tps = args.batch * args.gen / dt
        print(f"model@v{version}: generated {tuple(toks.shape)} in {dt:.2f}s "
              f"({tps:.1f} tok/s) — first row: {toks[0].numpy()[:8]}")

    # partial restore (elastic rescale): every embedding tensor in one
    # multi-point session — one KVS round trip regardless of tensor count
    q0 = kvs_stats.n_queries
    partial = ckpt.restore_tensors(v1, prefixes=("params",))
    print(f"partial restore of {len(partial)} tensors: "
          f"{kvs_stats.n_queries - q0} KVS round trip(s)")


if __name__ == "__main__":
    main()
