#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s sd path (sharding on a (1, 1) NCCL mesh) alone
on the card.

    python3 scripts/sd_alone.py [--seed 0] [--tr-layers 2]

Makes what path tr leaves for sd without training: smollm-360m at its
published width (depth ``--tr-layers``), f32, AdamW, its initial state
committed to a ``VersionedCheckpointer`` on the card.  Then runs
``chip_smoke.main_path_sd`` with its checks: the elastic restore of that
version and a train step of the restored ``DTensor`` state, granite-moe's
prefill through ``moe_shard_map`` and through ``DTensor`` params, and one
dry-run cell.  About a minute on the H100, against the whole smoke's
twelve: a quick try of a sharding change.  The whole run stays
``chip_smoke.py``.
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
    ap.add_argument("--tr-layers", type=int, default=2)
    args = ap.parse_args()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("sd_alone: no card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import bitmap, deltaenc, minhash, ops, ref
    from repro_torch.train.checkpoint import VersionedCheckpointer
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import init_state
    K = SimpleNamespace(ops=ops, ref=ref, bitmap=bitmap, delta=deltaenc,
                        minhash=minhash)
    cs.log(f"[setup] {cs.gpu_line()}; torch {torch.__version__}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    base = ARCHS[cs.TR_ARCH]
    cfg = base.__class__(**{**base.__dict__, "n_layers": args.tr_layers,
                            "dtype": "float32", "remat": "none"})
    opt = make_optimizer(cfg, lr=1e-3)
    state = init_state(cfg, opt, torch.Generator(device=dev)
                       .manual_seed(args.seed), dev)
    ckpt = VersionedCheckpointer(device=dev)
    t0 = time.perf_counter()
    version = ckpt.commit(state, parents=(), tag="init")
    ckpt.rs.flush()
    cs.log(f"[setup] committed the initial state as v{version} in "
           f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cs.main_path_sd(args, torch, dev, K, (ckpt, version, state, cfg, opt))
    cs.log(f"[time] sd done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
