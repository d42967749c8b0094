"""Serving launcher: batched greedy generation over waves of prompts.

  python -m repro_torch.launch.serve --arch granite-moe-1b-a400m --reduced \\
      --batch 8 --prompt-len 64 --gen 32 [--device cpu]

The model runs on the card unless ``--device`` names another device; its
weights are random, drawn from a seeded generator on that device.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import ARCHS
from ..data.pipeline import synthetic_batch
from ..device import resolve_device
from ..models.model import init_params
from ..serve.engine import Engine


def run(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-moe-1b-a400m",
                    choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--waves", type=int, default=3,
                    help="batches served back-to-back (continuous batching)")
    ap.add_argument("--device", default=None,
                    help="where the model runs (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    cfg = cfg.__class__(**{**cfg.__dict__, "remat": "none"})
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    eng = Engine(cfg, params, max_len=args.prompt_len + args.gen + 8)

    for wave in range(args.waves):
        batch = {"tokens": synthetic_batch(cfg, wave, args.batch,
                                           args.prompt_len,
                                           device=dev)["tokens"]}
        t0 = time.time()
        toks = eng.generate(batch, steps=args.gen).cpu()
        dt = time.time() - t0
        print(f"wave {wave}: {toks.shape[0]}×{toks.shape[1]} tokens "
              f"in {dt:.2f}s ({toks.shape[0]*toks.shape[1]/dt:.1f} tok/s)")
    return 0


if __name__ == "__main__":
    run()
