"""Training beyond device memory in the port, held against the JAX
package on the CPU: remat ``dots`` and ``nvme`` (parallel/act_offload.py,
the cases of tests/test_act_offload.py), ``OffloadedAdam``
(parallel/opt_offload.py, the cases of tests/test_opt_offload.py, a
moment directory written by the JAX optimizer resumed here), and the
learning-rate schedule and global-norm clip against optax.

Tolerances: an offloaded step against the port's plain step 1e-6 on the
loss and 1e-5 / 1e-6 (rtol / atol) on the gradients (the store only
moves bytes); the port against the JAX step 1e-4 / 2e-5 (float32 sums
in another order, as tests/test_torch_train.py); ``OffloadedAdam``
against the JAX one 1e-5 / 1e-6; schedules to float32 rounding (1e-6).
The JAX test's sharded-input refusal has no counterpart: the port's
``OffloadedAdam`` takes each process's slices (``shardings=``, held in
tests/test_torch_multigpu_io.py)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nvme_strom_tpu.models import transformer as jtr
from nvme_strom_tpu.parallel.opt_offload import OffloadedAdam as JaxAdam
from nvme_strom_tpu_torch.models import transformer as ttr
from nvme_strom_tpu_torch.parallel.act_offload import ActivationStore
from nvme_strom_tpu_torch.parallel.opt_offload import OffloadedAdam

CPU = torch.device("cpu")
SAME = dict(rtol=1e-5, atol=1e-6)
JAX_GRAD = dict(rtol=1e-4, atol=2e-5)


def _model(moe: bool = False, seed: int = 0, **kw):
    base = (jtr.tiny_moe_config() if moe else jtr.tiny_config()).__dict__
    cfg_j = jtr.TransformerConfig(**{**base, "dtype": jnp.float32, **kw})
    cfg_t = dataclasses.replace(
        ttr.tiny_moe_config() if moe else ttr.tiny_config(),
        dtype=torch.float32, **{k: v or "none" for k, v in kw.items()})
    pj = jtr.init_params(jax.random.key(seed), cfg_j)
    pt = ttr.trainable_params({k: np.asarray(v) for k, v in pj.items()}, CPU)
    return cfg_j, cfg_t, pj, pt


def _tokens(cfg, b=2, s=None, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (b, s or cfg.max_seq)).astype(np.int32)


def _grads_close(got, want, tol):
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), **tol, err_msg=k)


@pytest.fixture()
def store_path(tmp_path):
    return str(tmp_path / "acts" / "store.bin")


# -- remat nvme and dots ------------------------------------------------------

@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_nvme_loss_and_grads_match(store_path, moe):
    """The offloaded step equals the port's plain step and the JAX one,
    dense and with MoE layers (aux loss through the store's layers)."""
    cfg_j, cfg_t, pj, pt = _model(moe, seed=2 if moe else 0)
    toks = _tokens(cfg_t)
    lj, gj = jax.jit(jax.value_and_grad(
        lambda p, t: jtr.loss_fn(p, t, cfg_j)))(pj, jnp.asarray(toks))
    l0, g0 = ttr.value_and_grad(pt, torch.from_numpy(toks), cfg_t)
    off = dataclasses.replace(cfg_t, remat_policy="nvme")
    with ActivationStore(store_path, cfg_t.n_layers) as st:
        l1, g1 = ttr.value_and_grad(pt, torch.from_numpy(toks), off,
                                    act_store=st)
        assert st.writes == st.reads == cfg_t.n_layers
        assert st.prefetch_hits == cfg_t.n_layers - 1
    np.testing.assert_allclose(l1.item(), l0.item(), rtol=1e-6)
    _grads_close(g1, {k: v.numpy() for k, v in g0.items()}, SAME)
    np.testing.assert_allclose(l1.item(), float(lj), rtol=1e-5)
    _grads_close(g1, gj, JAX_GRAD)


def test_dots_matches_jax_dots_and_none():
    cfg_j, cfg_t, pj, pt = _model(remat_policy="dots")
    toks = _tokens(cfg_t)
    lj, gj = jax.jit(jax.value_and_grad(
        lambda p, t: jtr.loss_fn(p, t, cfg_j)))(pj, jnp.asarray(toks))
    l1, g1 = ttr.value_and_grad(pt, torch.from_numpy(toks), cfg_t)
    l0, g0 = ttr.value_and_grad(
        pt, torch.from_numpy(toks),
        dataclasses.replace(cfg_t, remat_policy="none"))
    np.testing.assert_allclose(l1.item(), l0.item(), rtol=1e-6)
    _grads_close(g1, {k: v.numpy() for k, v in g0.items()}, SAME)
    np.testing.assert_allclose(l1.item(), float(lj), rtol=1e-5)
    _grads_close(g1, gj, JAX_GRAD)


def test_full_train_step_with_offload(store_path):
    """Ten AdamW steps through the store: slots reused step after step,
    and the loss trains down as the plain step's does."""
    _, cfg, _, pt = _model(seed=4, remat_policy="nvme")
    toks = torch.from_numpy(_tokens(cfg, b=4, s=32, seed=5))
    with ActivationStore(store_path, cfg.n_layers) as st:
        step = ttr.make_train_step(cfg, ttr.adamw(pt, 3e-3), act_store=st)
        losses = [step(pt, toks).item() for _ in range(10)]
        assert st.writes == st.reads == 10 * cfg.n_layers
    assert losses[-1] < losses[0] - 0.3, losses


def test_store_mechanics(tmp_path):
    path = str(tmp_path / "m.bin")
    with ActivationStore(path, n_slots=3) as st:
        a = np.arange(4096 * 3, dtype=np.float32).reshape(3, 4096)
        st.write(0, a)
        st.write(2, a * 2)
        np.testing.assert_array_equal(st.read(0).numpy(), a)
        np.testing.assert_array_equal(st.read(2).numpy(), a * 2)
        st.write(0, a * 3)            # an unread write of the slot drains
        np.testing.assert_array_equal(st.read(0).numpy(), a * 3)
        with pytest.raises(ValueError, match="layout"):
            st.write(1, np.zeros((7,), np.float32))
        with pytest.raises(ValueError, match="slot"):
            st.write(5, a)
    with ActivationStore(path, n_slots=1) as st2:
        with pytest.raises(ValueError, match="before any write"):
            st2.read(0)


def test_backward_order_prefetch(tmp_path):
    """Reading high → low prefetches slot - 1; a rewrite of a prefetched
    slot drops the stale bytes."""
    with ActivationStore(str(tmp_path / "p.bin"), n_slots=4) as st:
        arrs = [np.full((2048,), i, np.float32) for i in range(4)]
        for i, a in enumerate(arrs):
            st.write(i, a)
        for i in (3, 2, 1, 0):
            np.testing.assert_array_equal(st.read(i).numpy(), arrs[i])
        assert st.prefetch_hits == 3
        for i, a in enumerate(arrs):
            st.write(i, a)
        np.testing.assert_array_equal(st.read(3).numpy(), arrs[3])
        st.write(2, arrs[2] * 10)
        np.testing.assert_array_equal(st.read(2).numpy(), arrs[2] * 10)


def test_remat_policy_needs_store_and_a_known_name():
    _, cfg, _, pt = _model(remat_policy="nvme")
    toks = torch.zeros(2, 32, dtype=torch.int64)
    with pytest.raises(ValueError, match="act_store"):
        ttr.loss_fn(pt, toks, cfg)
    with pytest.raises(ValueError, match="none\\|full\\|dots\\|nvme"):
        ttr.loss_fn(pt, toks, dataclasses.replace(cfg, remat_policy="x"))


def test_bf16_activations_roundtrip(store_path):
    """bfloat16 layer inputs survive the round trip: the loss equals the
    plain bf16 loss, the gradients are finite."""
    cfg = dataclasses.replace(ttr.tiny_config(), remat_policy="nvme")
    assert cfg.dtype == torch.bfloat16
    pt = ttr.trainable_params(ttr.init_params(7, cfg), CPU)
    toks = torch.from_numpy(_tokens(cfg, seed=8))
    l0, _ = ttr.value_and_grad(
        pt, toks, dataclasses.replace(cfg, remat_policy="none"))
    with ActivationStore(store_path, cfg.n_layers) as st:
        l1, g1 = ttr.value_and_grad(pt, toks, cfg, act_store=st)
        assert st.writes == st.reads == cfg.n_layers
    assert l1.item() == pytest.approx(l0.item(), rel=1e-6)
    assert all(bool(torch.isfinite(g).all()) for g in g1.values())


def test_accum_steps_reuse_slots_within_one_step(store_path):
    """Each microbatch rewrites and rereads every slot; the accumulated
    update equals the plain accumulated step's."""
    _, cfg, _, pt = _model(seed=9, remat_policy="nvme")
    toks = torch.from_numpy(_tokens(cfg, b=4, s=32, seed=10))

    def run(c, store):
        p = {k: v.detach().clone().requires_grad_() for k, v in pt.items()}
        step = ttr.make_train_step(c, ttr.adamw(p, 1e-3), accum_steps=2,
                                   act_store=store)
        losses = [step(p, toks).item() for _ in range(2)]
        return p, losses[-1]

    p_ref, l_ref = run(dataclasses.replace(cfg, remat_policy="none"), None)
    with ActivationStore(store_path, cfg.n_layers) as st:
        p_off, l_off = run(cfg, st)
        assert st.writes == st.reads == 2 * 2 * cfg.n_layers
    np.testing.assert_allclose(l_off, l_ref, rtol=1e-6)
    _grads_close(p_off, {k: v.detach().numpy() for k, v in p_ref.items()},
                 dict(rtol=1e-5, atol=1e-7))


# -- OffloadedAdam ------------------------------------------------------------

def _jparams(seed=0):
    ks = jax.random.split(jax.random.key(seed), 4)
    return {"emb": jax.random.normal(ks[0], (64, 32)),
            "layers": {"w1": jax.random.normal(ks[1], (32, 48)),
                       "norm": jnp.ones((32,))},
            "head": jax.random.normal(ks[2], (32, 7))}


def _jgrads(params, seed):
    leaves, treedef = jax.tree_util.tree_flatten(params)
    ks = jax.random.split(jax.random.key(seed), len(leaves))
    return jax.tree_util.tree_unflatten(
        treedef, [jax.random.normal(k, p.shape, jnp.float32)
                  for k, p in zip(ks, leaves)])


def _t(tree):
    """A JAX tree → the same tree of (writable) torch tensors."""
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def _j(tree):
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tree)


def _run_jax(path, params, steps, first=0, **kw):
    with JaxAdam(path, params, **kw) as opt:
        for i in range(first, first + steps):
            params = opt.update(params, _jgrads(params, 100 + i))
    return params


def _run_port(path, params, steps, first=0, **kw):
    with OffloadedAdam(path, params, **kw) as opt:
        for i in range(first, first + steps):
            opt.update(params, _t(_jgrads(_j(params), 100 + i)))
        return opt.step


def _same_tree(got, want, **tol):
    for (kp, a), b in zip(jax.tree_util.tree_leaves_with_path(want),
                          jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                   **(tol or SAME),
                                   err_msg=jax.tree_util.keystr(kp))


@pytest.mark.parametrize("group_bytes", [1 << 30, 4096])
def test_offloaded_adam_matches_jax(tmp_path, group_bytes):
    """One group and one group a leaf: the grouping is invisible."""
    want = _run_jax(tmp_path / "j", _jparams(), 3, lr=1e-2,
                    weight_decay=0.01, group_bytes=group_bytes)
    got = _t(_jparams())
    assert _run_port(tmp_path / "t", got, 3, lr=1e-2, weight_decay=0.01,
                     group_bytes=group_bytes) == 3
    _same_tree(got, want)
    # the same layout and manifest fields as the JAX optimizer's
    mj = json.load(open(tmp_path / "j" / "moments.json"))
    mt = json.load(open(tmp_path / "t" / "moments.json"))
    assert mt == mj


def test_resume_matches_straight_run(tmp_path):
    want = _run_jax(tmp_path / "j", _jparams(1), 5, lr=1e-2)
    got = _t(_jparams(1))
    _run_port(tmp_path / "t", got, 3, lr=1e-2)
    assert _run_port(tmp_path / "t", got, 2, first=3, lr=1e-2) == 5
    _same_tree(got, want)


def test_jax_moment_dir_resumes_in_the_port(tmp_path):
    """Three JAX updates, then the fourth by the port from the JAX
    directory against the fourth by the JAX optimizer."""
    p3 = _run_jax(tmp_path / "j", _jparams(2), 3, lr=1e-2,
                  weight_decay=0.01, group_bytes=4096)
    import shutil
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    want = _run_jax(tmp_path / "j", p3, 1, first=3, lr=1e-2,
                    weight_decay=0.01, group_bytes=4096)
    got = _t(p3)
    assert _run_port(tmp_path / "t", got, 1, first=3, lr=1e-2,
                     weight_decay=0.01, group_bytes=4096) == 4
    _same_tree(got, want)


def test_dirty_manifest_refused(tmp_path):
    params = _t(_jparams())
    with OffloadedAdam(tmp_path / "opt", params, lr=1e-2) as opt:
        opt.update(params, _t(_jgrads(_jparams(), 0)))
        mpath = opt.manifest_path
    m = json.load(open(mpath))
    assert m["dirty"] is False
    m["dirty"] = True
    json.dump(m, open(mpath, "w"))
    with pytest.raises(ValueError, match="dirty"):
        OffloadedAdam(tmp_path / "opt", params, lr=1e-2)


def test_layout_mismatch_refused(tmp_path):
    with OffloadedAdam(tmp_path / "opt", _t(_jparams()), lr=1e-2):
        pass
    with pytest.raises(ValueError, match="refusing to overwrite"):
        OffloadedAdam(tmp_path / "opt", {"different": torch.zeros(3, 3)},
                      lr=1e-2)


def test_wrong_tree_in_update_refused(tmp_path):
    with OffloadedAdam(tmp_path / "opt", _t(_jparams()), lr=1e-2) as opt:
        with pytest.raises(ValueError, match="does not match"):
            opt.update({"nope": torch.zeros(2)}, {"nope": torch.zeros(2)})


def test_bf16_moments_run_and_track(tmp_path):
    """Half-traffic moments track the float32 trajectory closely."""
    want = _run_jax(tmp_path / "j", _jparams(2), 2, lr=1e-3)
    got = _t(_jparams(2))
    with OffloadedAdam(tmp_path / "t", got, lr=1e-3,
                       moment_dtype=torch.bfloat16) as opt:
        for i in range(2):
            opt.update(got, _t(_jgrads(_j(got), 100 + i)))
        for d in opt._layout.values():
            assert d["nbytes"] == 2 * int(np.prod(d["shape"]))
    for a, b in zip(jax.tree_util.tree_leaves(want),
                    jax.tree_util.tree_leaves(got)):
        assert np.all(np.isfinite(b.numpy()))
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=2e-2)


def test_peak_is_two_groups_and_io_flows_through_engine(tmp_path):
    """Small groups hold less than the whole model, and each step moves
    the moment bytes through the engine both ways, every write
    O_DIRECT-sized (slots padded to 4096 bytes)."""
    params = _t(_jparams(3))
    total = 2 * sum(t.numel() * 4 for t in jax.tree_util.tree_leaves(params))
    with OffloadedAdam(tmp_path / "opt", params, lr=1e-2,
                       group_bytes=4096) as opt:
        assert opt.num_groups() > 1
        assert opt.peak_group_bytes() < total
        assert opt.moment_bytes() >= total
        eng = opt.engine
        eng.sync_stats()
        before = eng.stats.snapshot()
        opt.update(params, _t(_jgrads(_jparams(3), 7)))
        eng.sync_stats()
        after = eng.stats.snapshot()
        read = sum(after[k] - before[k] for k in (
            "bytes_direct", "bytes_fallback"))
        written = (after["bytes_written_direct"]
                   - before["bytes_written_direct"]
                   + after["bounce_bytes"] - before["bounce_bytes"])
        assert read >= total
        assert written >= opt.moment_bytes()


def test_lr_schedule_callable_matches_jax_across_resume(tmp_path):
    """The port's schedule in ``OffloadedAdam`` follows the JAX
    optimizer under the optax schedule, across a resume."""
    sched_j = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=1e-2, warmup_steps=2, decay_steps=6,
        end_value=1e-3)
    sched_t = ttr.lr_schedule(1e-2, "cosine", warmup_steps=2,
                              total_steps=6)
    want = _run_jax(tmp_path / "j", _jparams(), 4, lr=sched_j)
    got = _t(_jparams())
    _run_port(tmp_path / "t", got, 2, lr=sched_t)
    assert _run_port(tmp_path / "t", got, 2, first=2, lr=sched_t) == 4
    _same_tree(got, want)


# -- schedules and clipping ---------------------------------------------------

@pytest.mark.parametrize("kind,warmup,total", [
    ("constant", 3, 10), ("cosine", 0, 8), ("cosine", 2, 6),
    ("cosine", 5, 3)])
def test_lr_schedule_equals_optax(kind, warmup, total):
    """examples/train_lm.py's optax schedule, at every step and past
    the end."""
    lr = 3e-4
    decay = max(total, warmup + 1)
    if kind == "cosine":
        want = optax.warmup_cosine_decay_schedule(
            0.0, lr, warmup, decay, end_value=lr * 0.1)
    else:
        want = optax.join_schedules(
            [optax.linear_schedule(0.0, lr, warmup),
             optax.constant_schedule(lr)], boundaries=[warmup])
    got = ttr.lr_schedule(lr, kind, warmup, total)
    for c in range(decay + 4):
        np.testing.assert_allclose(got(c), float(want(c)), rtol=1e-6,
                                   atol=1e-12, err_msg=str(c))
    assert ttr.lr_schedule(lr, "constant", 0, total) == lr


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_equals_optax(max_norm):
    rng = np.random.default_rng(3)
    grads = {"a": rng.standard_normal((4, 5)).astype(np.float32),
             "b": rng.standard_normal((7,)).astype(np.float32)}
    want, _ = optax.clip_by_global_norm(max_norm).update(
        {k: jnp.asarray(v) for k, v in grads.items()}, optax.EmptyState())
    got = ttr.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in grads.items()}, max_norm)
    for k in grads:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=0)
