"""End-to-end driver on the PyTorch port: train a ~100M-param model for a
few hundred steps with RStore-versioned checkpointing, simulate a crash,
restart bit-identically, and fork a branch (the paper's branched version
graphs, realized as ML experiment lineage).

Run:  python examples/versioned_training_torch.py [--steps 200] [--device cpu]
(~100M params: smollm-360m at its published width, depth trimmed to 8; pass
--full-360m to train the whole 32-layer config.)

It mirrors ``examples/versioned_training.py`` and prints the same lines; its
random weights come from a seeded ``torch.Generator`` on the model's device,
so the losses differ from the reference's.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch

from repro_torch.configs import ARCHS
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.train.checkpoint import VersionedCheckpointer
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_step import init_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--full-360m", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where the model and store run (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def seeded():
        return torch.Generator(device=dev).manual_seed(0)

    cfg = ARCHS["smollm-360m"]
    if not args.full_360m:
        # ~100M params: keep width/vocab, trim depth 32→8
        cfg = cfg.__class__(**{**cfg.__dict__, "n_layers": 8})
    cfg = cfg.__class__(**{**cfg.__dict__, "dtype": "float32", "remat": "none"})
    print(f"arch {cfg.name}: {cfg.param_count()/1e6:.0f}M params")

    model = build_model(cfg)
    opt = make_optimizer(cfg, lr=1e-3)
    step = make_train_step(model, opt)
    state = init_state(cfg, opt, seeded(), dev)
    ckpt = VersionedCheckpointer(device=dev)

    v = ckpt.commit(state, parents=(), tag="init")
    t0 = time.time()
    crash_at = args.steps // 2
    for i in range(crash_at):
        state, m = step(state, synthetic_batch(cfg, i, args.batch, args.seq,
                                               device=dev))
        if i % 20 == 0:
            print(f"step {i:4d} loss {float(m['loss']):.4f} "
                  f"({time.time()-t0:.0f}s)")
        if (i + 1) % 50 == 0:
            v = ckpt.commit(state, parents=(v,), tag=f"step{i+1}")
    v_mid = ckpt.commit(state, parents=(v,), tag=f"step{crash_at}")
    print(f"--- simulated crash at step {crash_at}; restarting from "
          f"version {v_mid} ---")

    # restart: fresh state object restored from the store
    state2 = ckpt.restore(v_mid, like=init_state(cfg, opt, seeded(), dev))
    for i in range(crash_at, args.steps):
        state2, m = step(state2, synthetic_batch(cfg, i, args.batch, args.seq,
                                                 device=dev))
        if i % 20 == 0:
            print(f"step {i:4d} loss {float(m['loss']):.4f}")
    v_main = ckpt.commit(state2, parents=(v_mid,), tag="main")

    # fork a branch from the mid checkpoint (different data order)
    branch = ckpt.restore(v_mid, like=state2)
    for i in range(crash_at, crash_at + 20):
        branch, _ = step(branch, synthetic_batch(cfg, 10_000 + i, args.batch,
                                                 args.seq, device=dev))
    v_branch = ckpt.commit(branch, parents=(v_mid,), tag="fork")

    st = ckpt.storage_stats()
    print(f"versions: {ckpt.rs.graph.num_versions} "
          f"(main={v_main}, branch={v_branch})")
    print(f"stored {st['stored_chunk_bytes']/2**20:.1f} MiB in "
          f"{st['n_chunks']} chunks; raw unique "
          f"{st['raw_unique_bytes']/2**20:.1f} MiB")
    evo = ckpt.evolution("params/final_norm", 0)
    print(f"Q3 over params/final_norm block 0: {len(evo)} distinct versions")


if __name__ == "__main__":
    main()
