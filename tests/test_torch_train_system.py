"""Training substrate of the port, the reference's own suite
(``tests/test_train_system.py``) run against it on the CPU: optimizers,
RStore-versioned checkpointing (commit/restore/branch/evolution),
crash-restart equivalence, gradient compression, data-pipeline
determinism.  The reference's serving-engine case is in
``test_torch_serve.py``; its elastic-restore case needs a device mesh and
comes with the sharding slice (ROADMAP item 3)."""
import numpy as np
import pytest
import torch

from repro_torch import tree as T
from repro_torch.configs import ARCHS
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.models.model import build_model, init_params
from repro_torch.train import grad_compress
from repro_torch.train.checkpoint import VersionedCheckpointer
from repro_torch.train.optimizer import OptConfig, Optimizer, make_optimizer
from repro_torch.train.train_step import init_state, make_train_step

CPU = "cpu"


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _batch(cfg, step, b, s):
    return synthetic_batch(cfg, step, b, s, device=CPU)


@pytest.fixture(scope="module")
def small_setup():
    cfg = ARCHS["smollm-360m"].reduced()
    cfg = cfg.__class__(**{**cfg.__dict__, "dtype": "float32", "remat": "none"})
    model = build_model(cfg)
    opt = make_optimizer(cfg)
    step = make_train_step(model, opt)
    state = init_state(cfg, opt, _gen(0), CPU)
    return cfg, model, opt, step, state


# ------------------------------------------------------------- optimizers
def test_adamw_reduces_loss(small_setup):
    cfg, model, opt, step, state = small_setup
    losses = []
    for i in range(8):
        batch = _batch(cfg, 0, 4, 64)   # same batch → must overfit
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.05


def test_adafactor_reduces_loss():
    cfg = ARCHS["smollm-360m"].reduced()
    cfg = cfg.__class__(**{**cfg.__dict__, "dtype": "float32", "remat": "none",
                           "optimizer": "adafactor"})
    model = build_model(cfg)
    opt = make_optimizer(cfg, lr=1e-2)
    step = make_train_step(model, opt)
    state = init_state(cfg, opt, _gen(0), CPU)
    losses = []
    for _ in range(8):
        state, metrics = step(state, _batch(cfg, 0, 4, 64))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.05


def test_adafactor_state_is_factored():
    cfg = ARCHS["kimi-k2-1t-a32b"].reduced()
    opt = Optimizer(OptConfig(name="adafactor"))
    params = init_params(cfg, _gen(0), CPU)
    st = opt.init(params)
    p_bytes = sum(x.numel() * 4 for x in T.leaves(params))
    o_bytes = sum(x.numel() * 4 for x in T.leaves(st))
    assert o_bytes < 0.2 * p_bytes     # factored ≪ AdamW's 2× params


# ---------------------------------------------------------- checkpointing
def test_checkpoint_roundtrip(small_setup):
    cfg, model, opt, step, state = small_setup
    ckpt = VersionedCheckpointer(device=CPU)
    v0 = ckpt.commit(state, parents=())
    restored = ckpt.restore(v0, like=state)
    for a, b in zip(T.leaves(state), T.leaves(restored)):
        assert torch.equal(a, b)


def test_checkpoint_dedupes_unchanged_blocks(small_setup):
    cfg, model, opt, step, state = small_setup
    ckpt = VersionedCheckpointer(block_bytes=1 << 14, device=CPU)
    v0 = ckpt.commit(state, parents=())
    n0 = len(ckpt.rs.graph.store)
    v1 = ckpt.commit(state, parents=(v0,))        # identical state
    assert len(ckpt.rs.graph.store) == n0         # nothing new stored
    restored = ckpt.restore(v1, like=state)
    for a, b in zip(T.leaves(state), T.leaves(restored)):
        assert torch.equal(a, b)


def test_checkpoint_branching_and_evolution(small_setup):
    cfg, model, opt, step, state = small_setup
    ckpt = VersionedCheckpointer(device=CPU)
    v0 = ckpt.commit(state, parents=())
    sA, _ = step(state, _batch(cfg, 1, 4, 64))
    sB, _ = step(state, _batch(cfg, 2, 4, 64))
    vA = ckpt.commit(sA, parents=(v0,), tag="branchA")
    vB = ckpt.commit(sB, parents=(v0,), tag="branchB")
    rA = ckpt.restore(vA, like=state)
    rB = ckpt.restore(vB, like=state)
    la = T.leaves(rA)[0]
    lb = T.leaves(rB)[0]
    assert not torch.equal(la, lb)
    # Q3: the embed table evolved across versions
    some_tensor = sorted(ckpt.meta[v0].keys())[0]
    evo = ckpt.evolution(some_tensor, 0)
    assert len(evo) >= 2


def test_crash_restart_is_bit_identical(small_setup):
    """Training k steps straight == training j, crash, restore, resume."""
    cfg, model, opt, step, state0 = small_setup

    def run(n, s):
        for i in range(n):
            s, _ = step(s, _batch(cfg, i, 4, 64))
        return s

    straight = run(6, state0)

    ckpt = VersionedCheckpointer(device=CPU)
    mid = run(3, state0)
    v = ckpt.commit(mid, parents=())
    resumed = ckpt.restore(v, like=state0)           # "new process"
    for i in range(3, 6):
        resumed, _ = step(resumed, _batch(cfg, i, 4, 64))
    for a, b in zip(T.leaves(straight), T.leaves(resumed)):
        assert torch.equal(a, b)


def test_partial_restore_by_prefix(small_setup):
    cfg, model, opt, step, state = small_setup
    ckpt = VersionedCheckpointer(device=CPU)
    v0 = ckpt.commit(state, parents=())
    sub = ckpt.restore_tensors(v0, prefixes=["params/embed"])
    assert len(sub) >= 1
    for k in sub:
        assert k.startswith("params/embed")


# ----------------------------------------------------- gradient compression
def test_compress_update_roundtrip_accuracy():
    rng = np.random.default_rng(0)
    u = torch.from_numpy(rng.normal(0, 0.01, (1000,)).astype(np.float32))
    q, scale = grad_compress.compress_update(u)
    back = grad_compress.decompress_update(q, scale, u.shape, torch.float32)
    err = float((back - u).abs().max())
    assert err <= float(u.abs().max()) / 127 + 1e-8


def test_xor_delta_stats_detects_sparsity():
    rng = np.random.default_rng(1)
    prev = rng.integers(0, 2**32, 65536, dtype=np.uint32)
    new = prev.copy()
    new[:64] ^= 12345                     # change 64 of 65536 words
    st = grad_compress.xor_delta_stats(torch.from_numpy(prev.view(np.int32)),
                                       torch.from_numpy(new.view(np.int32)))
    assert 0 < st["changed_word_fraction"] < 0.01


# ------------------------------------------------------------ data pipeline
def test_pipeline_deterministic_and_skip_ahead():
    cfg = ARCHS["smollm-360m"].reduced()
    b1 = _batch(cfg, 7, 4, 32)
    b2 = _batch(cfg, 7, 4, 32)
    assert torch.equal(b1["tokens"], b2["tokens"])
    b3 = _batch(cfg, 8, 4, 32)
    assert not torch.equal(b1["tokens"], b3["tokens"])
    assert int(b1["tokens"].max()) < cfg.vocab_size
