"""End-to-end training launcher with RStore-versioned checkpoint/restart.

Examples:
  # smoke-scale model, a few steps (the card unless --device cpu)
  python -m repro_torch.launch.train --arch smollm-360m --reduced --steps 50

  # resume after a crash (restores the newest committed RStore version; the
  # deterministic pipeline skips ahead, no data replay)
  python -m repro_torch.launch.train --arch smollm-360m --reduced --steps 100 --resume

Fault-tolerance contract:
  - checkpoint commits are RStore versions (delta from the parent version →
    unchanged blocks dedupe);
  - --crash-at simulates a hard failure mid-run for the restart tests;
  - the checkpointer is pickled to --ckpt-state after every commit (it
    stands in for a shared RStore service): it holds host data only, no
    tensor on the card and no handle of the kernel library.
"""
from __future__ import annotations

import argparse
import os
import pickle
import tempfile
import time
from pathlib import Path

import torch

from ..configs import ARCHS
from ..data.pipeline import synthetic_batch
from ..device import resolve_device
from ..models.model import build_model
from ..train.checkpoint import VersionedCheckpointer
from ..train.optimizer import make_optimizer
from ..train.train_step import init_state, make_train_step


def run(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-every", type=int, default=20)
    ap.add_argument("--retain-last", type=int, default=0,
                    help="cap checkpoint storage: keep only the newest N "
                         "versions and compact after each commit (0 = keep "
                         "all)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--crash-at", type=int, default=-1,
                    help="simulate a hard failure after N steps")
    ap.add_argument("--ckpt-state",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt_state.pkl"),
                    help="host-side pickled checkpointer (stands in for the "
                         "shared RStore service)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where the model, the data and the store's device "
                         "steps run (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    cfg = cfg.__class__(**{**cfg.__dict__, "dtype": "float32",
                           "remat": "none"})
    model = build_model(cfg)
    opt = make_optimizer(cfg, lr=args.lr)
    step_fn = make_train_step(model, opt)

    def fresh_state():
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        return init_state(cfg, opt, gen, dev)

    ckpt_path = Path(args.ckpt_state)
    start_step = 0
    if args.resume and ckpt_path.exists():
        ckpt, meta = pickle.loads(ckpt_path.read_bytes())
        state = ckpt.restore(meta["version"], like=fresh_state())
        start_step = meta["step"]
        print(f"[train] resumed at step {start_step} "
              f"(version {meta['version']})")
    else:
        ckpt = VersionedCheckpointer(device=dev)
        state = fresh_state()
        v0 = ckpt.commit(state, parents=(), tag="init")
        pickle_meta(ckpt_path, ckpt, {"version": v0, "step": 0})

    last_version = ckpt.latest()
    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = synthetic_batch(cfg, step, args.batch, args.seq, device=dev)
        state, metrics = step_fn(state, batch)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"[train] step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({(time.time()-t0):.1f}s)")
        if args.crash_at >= 0 and step + 1 >= args.crash_at:
            print(f"[train] simulated crash at step {step + 1}")
            raise SystemExit(17)
        if (step + 1) % args.checkpoint_every == 0 or step == args.steps - 1:
            v = ckpt.commit(state, parents=(last_version,),
                            tag=f"step{step + 1}")
            last_version = v
            if args.retain_last > 0:
                rep = ckpt.retain_last(args.retain_last)
                if rep.mode != "noop":
                    print(f"[train] compacted: -{rep.reclaimed_frac:.0%} "
                          f"stored bytes ({rep.chunks_deleted} chunks -> "
                          f"{rep.chunks_written})")
            pickle_meta(ckpt_path, ckpt, {"version": v, "step": step + 1})
            st = ckpt.storage_stats()
            print(f"[train] committed version {v} at step {step + 1} "
                  f"(chunks={st['n_chunks']}, "
                  f"stored={st['stored_chunk_bytes']/2**20:.1f} MiB)")
    print(f"[train] done: {args.steps} steps in {time.time()-t0:.1f}s")
    return ckpt, state


def pickle_meta(path: Path, ckpt, meta):
    path.write_bytes(pickle.dumps((ckpt, meta)))


if __name__ == "__main__":
    run()
