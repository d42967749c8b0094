"""The port's training stack against the reference package, on the CPU:
optimizer updates and train steps on shared weights, update compression,
the XOR-delta statistics, and the versioned checkpointer blob for blob (the
same JAX-initialized state committed through both packages gives the same
version ids, ``TensorMeta``s and backend blobs).  Tolerances are stated at
each check."""
import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.configs import ARCHS as R_ARCHS
from repro.core import RStoreConfig as R_RStoreConfig
from repro.data.pipeline import synthetic_batch as r_batch
from repro.models.model import build_model as r_build
from repro.train import grad_compress as r_gc
from repro.train.checkpoint import VersionedCheckpointer as R_Checkpointer
from repro.train.optimizer import OptConfig as R_OptConfig
from repro.train.optimizer import Optimizer as R_Optimizer
from repro.train.optimizer import make_optimizer as r_make_opt
from repro.train.train_step import init_state as r_init_state
from repro.train.train_step import make_train_step as r_make_step
from repro_torch import tree as T
from repro_torch.configs import ARCHS
from repro_torch.core import RStoreConfig
from repro_torch.interop import state_from_reference, state_to_numpy
from repro_torch.kernels import deltaenc
from repro_torch.launch import train as launch_train
from repro_torch.models.model import build_model
from repro_torch.train import grad_compress
from repro_torch.train.checkpoint import VersionedCheckpointer
from repro_torch.train.optimizer import OptConfig, Optimizer, make_optimizer
from repro_torch.train.train_step import make_train_step

CPU = "cpu"


def small(**kw):
    out = []
    for archs in (R_ARCHS, ARCHS):
        cfg = archs["smollm-360m"].reduced()
        out.append(cfg.__class__(**{**cfg.__dict__, "dtype": "float32",
                                    "remat": "none", **kw}))
    return out


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def t_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def ref_setup():
    """The reference's ``small_setup`` (smollm-360m reduced, f32, AdamW) and
    the port's twin on the same initial state."""
    cfg_r, cfg_t = small()
    opt_r = r_make_opt(cfg_r)
    state_r = r_init_state(cfg_r, opt_r, jax.random.PRNGKey(0))
    step_r = jax.jit(r_make_step(r_build(cfg_r), opt_r))
    step_t = make_train_step(build_model(cfg_t), make_optimizer(cfg_t))
    return cfg_r, cfg_t, step_r, step_t, state_r


# ----------------------------------------------------------------- optimizer
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_update_matches_reference(name):
    """One update on identical params, grads and a nontrivial state (step
    4, random moments).  AdamW: the new params and state equal the
    reference's bit for bit (its sqrt is taken in f64 and rounded, which is
    the correctly rounded f32 sqrt that XLA's CPU gives).  Adafactor: the
    new state at rtol 1e-6; the new params' update ``lr * u`` at rtol 1e-6,
    plus one ulp of the new param (its rounding to f32).  Adafactor's rsqrt
    is not correctly rounded on either side (XLA's CPU ``lax.rsqrt`` and
    PyTorch's SLEEF differ by up to 2 ulp), so no rounding of the port's
    can match it bit for bit; and an rtol on the params themselves cannot
    hold near 0, since ``p - lr * u`` carries a few ulps of the update into
    a ``p`` that may be far smaller than it."""
    cfg_r, _ = small()
    params = np_tree(r_init_state(cfg_r, r_make_opt(cfg_r),
                                  jax.random.PRNGKey(1))["params"])
    rng = np.random.default_rng(2)
    ro, to = R_Optimizer(R_OptConfig(name=name)), Optimizer(OptConfig(name=name))
    state = jax.tree.map(
        lambda x: np.abs(rng.normal(0, 1e-3, x.shape)).astype(np.float32),
        np_tree(ro.init(jax.tree.map(jnp.asarray, params))))
    state["step"] = np.int32(4)
    grads = jax.tree.map(
        lambda p: rng.normal(0, 0.01, p.shape).astype(np.float32), params)
    pr, sr = ro.update(jax.tree.map(jnp.asarray, grads),
                       jax.tree.map(jnp.asarray, state),
                       jax.tree.map(jnp.asarray, params))
    pt, st = to.update(state_from_reference(grads, CPU),
                       state_from_reference(state, CPU),
                       state_from_reference(params, CPU))
    assert [tuple(x.shape) for x in T.leaves(to.init(pt))] == \
        [np.shape(x) for x in jax.tree.leaves(ro.init(pr))]
    if name == "adamw":
        ref_leaves, port_leaves = jax.tree.leaves((pr, sr)), T.leaves((pt, st))
        assert len(ref_leaves) == len(port_leaves)
        for a, b in zip(ref_leaves, port_leaves):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        return
    for a, b in zip(jax.tree.leaves(sr), T.leaves(st)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=0)
    for p0, a, b in zip(jax.tree.leaves(params), jax.tree.leaves(pr),
                        T.leaves(pt)):
        a, b = np.asarray(a), b.numpy()
        upd = np.abs(a.astype(np.float64) - p0)
        assert (np.abs(b.astype(np.float64) - a)
                <= 1e-6 * upd + np.spacing(np.abs(a))).all()


def test_four_train_steps_match_reference(ref_setup):
    """Per-step loss at rtol 1e-4 (grad norm too) over 4 steps from the
    same initial state."""
    cfg_r, cfg_t, step_r, step_t, state_r = ref_setup
    state_t = state_from_reference(np_tree(state_r), CPU)
    for i in range(4):
        batch = r_batch(cfg_r, i, 4, 64)
        state_r, m_r = step_r(state_r, batch)
        state_t, m_t = step_t(state_t, t_batch(batch))
        np.testing.assert_allclose(float(m_t["loss"]), float(m_r["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(m_t["grad_norm"]),
                                   float(m_r["grad_norm"]), rtol=1e-4)
    assert int(state_t["opt"]["step"]) == 4


def test_train_step_leaves_its_input_state_unchanged(ref_setup):
    _, cfg_t, _, step_t, state_r = ref_setup
    s0 = state_from_reference(np_tree(state_r), CPU)
    before = [x.clone() for x in T.leaves(s0)]
    step_t(s0, t_batch(r_batch(ref_setup[0], 0, 4, 64)))
    assert all(torch.equal(a, b) for a, b in zip(before, T.leaves(s0)))


# --------------------------------------------------------------- compression
def test_compress_update_matches_reference():
    """q equal, scale at rtol 1e-7; exact .5 ties round half to even."""
    rng = np.random.default_rng(3)
    u = rng.normal(0, 0.01, 1000).astype(np.float32)
    u[:8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]   # block 0 ties
    q_r, s_r = r_gc.compress_update(jnp.asarray(u))
    q_t, s_t = grad_compress.compress_update(torch.from_numpy(u))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_r))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_r), rtol=1e-7)
    back_r = r_gc.decompress_update(q_r, s_r, (10, 100), jnp.float32)
    back_t = grad_compress.decompress_update(q_t, s_t, (10, 100),
                                             torch.float32)
    np.testing.assert_array_equal(back_t.numpy(), np.asarray(back_r))


def test_xor_delta_stats_matches_reference():
    rng = np.random.default_rng(4)
    for n, block in ((65536, 1 << 16), (70001, 1 << 12), (3, 1 << 16)):
        prev = rng.integers(0, 2**32, n, dtype=np.uint32)
        new = prev.copy()
        new[rng.integers(0, n, max(1, n // 300))] ^= 0x5A5A
        want = r_gc.xor_delta_stats(prev, new, block_bytes=block)
        got = grad_compress.xor_delta_stats(
            torch.from_numpy(prev.view(np.int32)),
            torch.from_numpy(new.view(np.int32)), block_bytes=block)
        assert got == want
    # float32 buffers are viewed as their words, as the reference does
    a = rng.normal(size=5000).astype(np.float32)
    b = a.copy()
    b[100:200] += 1
    assert grad_compress.xor_delta_stats(torch.from_numpy(a),
                                         torch.from_numpy(b)) == \
        r_gc.xor_delta_stats(a, b)


def test_xor_delta_stats_makes_one_kernel_call(monkeypatch):
    calls = []
    orig = deltaenc.xor_delta

    def counting(p, c):
        calls.append(tuple(p.shape))
        return orig(p, c)
    monkeypatch.setattr(deltaenc, "xor_delta", counting)
    x = torch.zeros(1 << 16, dtype=torch.float32)
    grad_compress.xor_delta_stats(x, x + 1)
    assert calls == [(4, 16384)]


def _allreduce_worker(rank, world, init, u, res, out):
    import torch.distributed as dist
    from repro_torch.train import grad_compress as gc
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        mean, new_res = gc.compressed_allreduce_error_feedback(
            torch.from_numpy(u[rank]), torch.from_numpy(res[rank]))
        np.save(f"{out}_{rank}_mean.npy", mean.numpy())
        np.save(f"{out}_{rank}_res.npy", new_res.numpy())
    finally:
        dist.destroy_process_group()


def test_compressed_allreduce_error_feedback_on_gloo(tmp_path):
    """Two ranks on gloo: each gets the mean of the dequantized targets and
    its own residual, as the reference's psum gives them."""
    rng = np.random.default_rng(5)
    world = 2
    u = rng.normal(0, 0.01, (world, 700)).astype(np.float32)
    res = rng.normal(0, 0.001, (world, 700)).astype(np.float32)
    out = str(tmp_path / "r")
    mp.start_processes(_allreduce_worker,
                       args=(world, f"file://{tmp_path / 'rdzv'}", u, res,
                             out),
                       nprocs=world, join=True, start_method="spawn")
    deqs, resids = [], []
    for r in range(world):
        target = jnp.asarray(u[r] + res[r])
        q, s = r_gc.compress_update(target)
        deq = r_gc.decompress_update(q, s, (700,), jnp.float32)
        deqs.append(np.asarray(deq))
        resids.append(np.asarray(target - deq))
    for r in range(world):
        np.testing.assert_allclose(np.load(f"{out}_{r}_mean.npy"),
                                   sum(deqs) / world, rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(np.load(f"{out}_{r}_res.npy"), resids[r],
                                   rtol=0, atol=0)


# -------------------------------------------------------------- checkpointer
def _ck_config(cls):
    return cls(algorithm="bottom_up", capacity=1 << 16, batch_size=8,
               store_payloads=True)


def _meta_dicts(ck):
    return {v: {p: dataclasses.asdict(m) for p, m in ms.items()}
            for v, ms in ck.meta.items()}


def test_checkpointer_blobs_equal_reference(ref_setup):
    """The same JAX-initialized states through both packages: version ids,
    TensorMetas, tags and every backend blob equal (commit, a branch,
    commit_many, an unchanged commit)."""
    cfg_r, _, step_r, _, state_r = ref_setup
    s1, _ = step_r(state_r, r_batch(cfg_r, 1, 4, 64))
    s2, _ = step_r(s1, r_batch(cfg_r, 2, 4, 64))
    s3, _ = step_r(state_r, r_batch(cfg_r, 3, 4, 64))
    ref = R_Checkpointer(block_bytes=1 << 12,
                         rstore_config=_ck_config(R_RStoreConfig))
    port = VersionedCheckpointer(block_bytes=1 << 12,
                                 rstore_config=_ck_config(RStoreConfig),
                                 device=CPU)
    for ck, conv in ((ref, lambda s: s),
                     (port, lambda s: state_from_reference(np_tree(s), CPU))):
        v0 = ck.commit(conv(state_r), tag="init")
        v1 = ck.commit(conv(s1), parents=(v0,))
        ck.commit(conv(s3), parents=(v0,), tag="fork")
        ck.commit_many([conv(s2), conv(s2)], parents=(v1,), tag="chain")
        ck.rs.flush()
    assert _meta_dicts(port) == _meta_dicts(ref)
    assert port.tags == ref.tags and port.latest() == ref.latest()
    assert sorted(port.rs.kvs.scan()) == sorted(ref.rs.kvs.scan())
    assert len(port.rs.kvs.scan()) > 8
    st_r, st_t = ref.storage_stats(), port.storage_stats()
    for k in ("n_chunks", "stored_chunk_bytes", "raw_unique_bytes"):
        assert st_t[k] == st_r[k]
    want = ref.restore(4)
    got = port.restore(4)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    assert port.evolution("params/final_norm") == \
        ref.evolution("params/final_norm")


def test_checkpointer_restore_puts_tensors_where_like_is(ref_setup):
    _, _, _, _, state_r = ref_setup
    state = state_from_reference(np_tree(state_r), CPU)
    ck = VersionedCheckpointer(device=CPU)
    v = ck.commit(state)
    like = T.tree_map(lambda t: torch.zeros_like(t, dtype=torch.float64)
                      if t.is_floating_point() else torch.zeros_like(t),
                      state)
    got = ck.restore(v, like=like)
    for a, b in zip(T.leaves(got), T.leaves(state)):
        assert a.dtype == (torch.float64 if b.is_floating_point()
                           else b.dtype)
        assert torch.equal(a.to(b.dtype), b)


def test_checkpointer_bfloat16_round_trip():
    state = {"w": torch.randn(300, 7, generator=torch.Generator()
                              .manual_seed(0)).to(torch.bfloat16),
             "step": torch.tensor(3, dtype=torch.int32)}
    ck = VersionedCheckpointer(block_bytes=512, device=CPU)
    v = ck.commit(state)
    assert ck.meta[v]["w"].dtype == "bfloat16"
    got = ck.restore(v, like=state)
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"],
                                                            state["w"])
    assert torch.equal(ck.restore(v)["w"], state["w"])
    sub = ck.restore_tensors(v, ["w"])
    assert torch.equal(sub["w"], state["w"])


# ----------------------------------------------------- launcher and pickling
def _launcher_argv(tmp_path, name):
    return ["--reduced", "--steps", "6", "--checkpoint-every", "3",
            "--batch", "2", "--seq", "32", "--device", CPU,
            "--ckpt-state", str(tmp_path / name)]


def test_launcher_crash_and_resume_equals_straight_run(tmp_path, capsys):
    argv = _launcher_argv(tmp_path, "crash.pkl")
    with pytest.raises(SystemExit) as e:
        launch_train.run(argv + ["--crash-at", "4"])
    assert e.value.code == 17
    ck, resumed = launch_train.run(argv + ["--resume"])
    assert "resumed at step 3" in capsys.readouterr().out
    _, straight = launch_train.run(_launcher_argv(tmp_path, "straight.pkl"))
    for a, b in zip(T.leaves(resumed), T.leaves(straight)):
        assert torch.equal(a, b)
    assert ck.tags == {"init": 0, "step3": 1, "step6": 2}


def test_launcher_retain_last_caps_versions(tmp_path):
    argv = _launcher_argv(tmp_path, "ret.pkl")
    argv[argv.index("--checkpoint-every") + 1] = "1"
    ck, state = launch_train.run(argv + ["--retain-last", "2"])
    assert sorted(ck.meta) == [5, 6]
    got = ck.restore(6, like=state)
    assert all(torch.equal(a, b)
               for a, b in zip(T.leaves(got), T.leaves(state)))


class _NoTensorPickler(pickle.Pickler):
    def persistent_id(self, obj):
        if isinstance(obj, torch.Tensor):
            raise AssertionError("a tensor lives in the checkpointer")
        return None


def test_pickled_checkpointer_restores_the_same_state(ref_setup, tmp_path):
    _, _, _, _, state_r = ref_setup
    state = state_from_reference(np_tree(state_r), CPU)
    ck = VersionedCheckpointer(block_bytes=1 << 12, device=CPU)
    v0 = ck.commit(state)
    v1 = ck.commit(T.tree_map(lambda t: t + 1, state), parents=(v0,))
    with open(tmp_path / "ck.pkl", "wb") as f:
        _NoTensorPickler(f).dump(ck)
    ck2 = pickle.loads((tmp_path / "ck.pkl").read_bytes())
    for v in (v0, v1):
        a, b = ck.restore(v, like=state), ck2.restore(v, like=state)
        assert all(torch.equal(x, y) for x, y in zip(T.leaves(a),
                                                     T.leaves(b)))
    assert sorted(ck2.rs.kvs.scan()) == sorted(ck.rs.kvs.scan())


def test_state_to_numpy_feeds_the_reference_checkpointer(ref_setup):
    """A port state goes back to numpy and commits through the reference
    into the same blobs as the port's own commit."""
    cfg_r, cfg_t, _, step_t, state_r = ref_setup
    st = state_from_reference(np_tree(state_r), CPU)
    st, _ = step_t(st, t_batch(r_batch(cfg_r, 0, 4, 64)))
    ref = R_Checkpointer(block_bytes=1 << 12,
                         rstore_config=_ck_config(R_RStoreConfig))
    port = VersionedCheckpointer(block_bytes=1 << 12,
                                 rstore_config=_ck_config(RStoreConfig),
                                 device=CPU)
    ref.commit(state_to_numpy(st))
    port.commit(st)
    ref.rs.flush()
    port.rs.flush()
    assert sorted(port.rs.kvs.scan()) == sorted(ref.rs.kvs.scan())

