"""The port's training path (models/transformer.py training half,
``adamw``, train.py ``Trainer``) against the JAX package's.

The train-step parity runs tiny_config at float32 from the JAX
parameters, on the same numpy token batches, through both packages'
``make_train_step`` with dense and flash attention, chunked
cross-entropy, gradient accumulation and full remat.  Step-1 gradients
agree to atol 2e-5 / rtol 1e-4 and the losses of three AdamW steps to
1e-4: every product is float32 on both sides, summed in another order,
and AdamW's first steps move each weight by about ±lr whatever the
gradient's size, so a step's loss moves less than the gradients would
suggest.  The ``Trainer`` cases are tests/test_trainer.py's, on the
CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nvme_strom_tpu.models import transformer as jtr
from nvme_strom_tpu.ops.flash_attention import make_flash_attn as j_flash
from nvme_strom_tpu_torch.models import transformer as ttr
from nvme_strom_tpu_torch.ops.flash_attention import make_flash_attn
from nvme_strom_tpu_torch.train import FitResult, Trainer

GRAD = dict(atol=2e-5, rtol=1e-4)
LOSS = dict(atol=1e-4, rtol=1e-4)


def _configs(**kw):
    base = {**jtr.tiny_config().__dict__, "dtype": jnp.float32, **kw}
    cfg_j = jtr.TransformerConfig(**base)
    fields = {f.name for f in dataclasses.fields(ttr.TransformerConfig)}
    kept = {k: v for k, v in base.items() if k in fields and k != "dtype"}
    # the JAX config's "" (fall back to its ``remat`` flag, off) is the
    # port's "none"
    kept["remat_policy"] = kept["remat_policy"] or "none"
    cfg_t = ttr.TransformerConfig(**kept, dtype=torch.float32)
    return cfg_j, cfg_t


def _tokens(cfg, n, b=4, s=32, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
            for _ in range(n)]


@pytest.mark.parametrize("attn,xent,accum,remat", [
    ("dense", 0, 1, ""), ("flash", 0, 1, ""), ("dense", 2, 1, ""),
    ("flash", 2, 2, ""), ("dense", 0, 2, "full"), ("flash", 0, 1, "full"),
])
def test_train_step_matches_jax(attn, xent, accum, remat):
    cfg_j, cfg_t = _configs(xent_chunks=xent, remat_policy=remat)
    pj = jtr.init_params(jax.random.key(0), cfg_j)
    pt = ttr.trainable_params({k: np.array(v) for k, v in pj.items()},
                              torch.device("cpu"))
    af_j = j_flash() if attn == "flash" else None
    af_t = make_flash_attn() if attn == "flash" else None
    batches = _tokens(cfg_t, 3)
    lr = 1e-3

    # step-1 gradients
    gj_loss, gj = jax.jit(lambda p, t: jtr.accumulate_grads(
        lambda mb: jax.value_and_grad(
            lambda q: jtr.loss_fn(q, mb, cfg_j, af_j))(p),
        p, t, accum))(pj, batches[0])
    gt_loss, gt = ttr.accumulate_grads(
        lambda mb: ttr.value_and_grad(pt, mb, cfg_t, af_t), pt,
        torch.from_numpy(batches[0]), accum)
    np.testing.assert_allclose(gt_loss.item(), float(gj_loss), **LOSS)
    for name in pj:
        np.testing.assert_allclose(gt[name].numpy(), np.asarray(gj[name]),
                                   **GRAD, err_msg=name)

    # three AdamW steps
    opt_j = optax.adamw(lr)
    step_j = jax.jit(jtr.make_train_step(cfg_j, opt_j, attn_fn=af_j,
                                         accum_steps=accum))
    state_j = opt_j.init(pj)
    step_t = ttr.make_train_step(cfg_t, ttr.adamw(pt, lr), attn_fn=af_t,
                                 accum_steps=accum)
    for tokens in batches:
        pj, state_j, lj = step_j(pj, state_j, tokens)
        lt = step_t(pt, torch.from_numpy(tokens))
        np.testing.assert_allclose(lt.item(), float(lj), **LOSS)


def test_adamw_matches_optax():
    """The same three gradients through optax.adamw and the port's
    ``adamw``.  optax forms the bias correction 1 − b2**t in float32,
    where 0.999 is not exact (1 − b2 is off by 1.3e-5 relative, so each
    update of size ~lr is off by ~6.4e-6 relative); torch forms it in
    float64.  Three steps at lr 3e-2 therefore agree to atol 2e-6."""
    rng = np.random.default_rng(0)
    shapes = {"w": (5, 7), "b": (7,), "s": ()}
    p_np = {n: rng.standard_normal(s).astype(np.float32)
            for n, s in shapes.items()}
    grads = [{n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()} for _ in range(3)]
    lr = 3e-2
    opt = optax.adamw(lr)
    pj = {n: jnp.asarray(v) for n, v in p_np.items()}
    state = opt.init(pj)
    pt = {n: torch.from_numpy(v.copy()).requires_grad_()
          for n, v in p_np.items()}
    opt_t = ttr.adamw(pt, lr)
    assert opt_t.defaults["weight_decay"] == 1e-4
    for g in grads:
        upd, state = opt.update({n: jnp.asarray(v) for n, v in g.items()},
                                state, pj)
        pj = optax.apply_updates(pj, upd)
        for n, p in pt.items():
            p.grad = torch.from_numpy(g[n])
        opt_t.step()
        for n in shapes:
            np.testing.assert_allclose(pt[n].detach().numpy(),
                                       np.asarray(pj[n]), rtol=0,
                                       atol=2e-6, err_msg=n)


def test_remat_dots_and_moe_are_refused():
    """Remat ``dots`` and ``nvme`` are ported now (the parity cases are
    tests/test_torch_train_offload.py): ``dots`` gives ``none``'s loss,
    ``nvme`` refuses to run without an activation store, and an unknown
    policy is refused by name."""
    cfg = dataclasses.replace(ttr.tiny_config(), remat_policy="dots")
    params = ttr.trainable_params(ttr.init_params(0, cfg),
                                  torch.device("cpu"))
    toks = torch.zeros(1, 8, dtype=torch.int64)
    assert ttr.loss_fn(params, toks, cfg).item() == ttr.loss_fn(
        params, toks, dataclasses.replace(cfg, remat_policy="none")).item()
    cfg = dataclasses.replace(cfg, remat_policy="nvme")
    with pytest.raises(ValueError, match="act_store"):
        ttr.loss_fn(params, toks, cfg)
    with pytest.raises(ValueError, match="expected none"):
        ttr.loss_fn(params, toks,
                    dataclasses.replace(cfg, remat_policy="dot"))
    # mixture-of-experts layers are ported now (models/moe.py; the
    # parity cases are tests/test_torch_quant_moe.py): the config builds
    moe = ttr.TransformerConfig(n_experts=4)
    assert [moe.is_moe_layer(i) for i in range(4)] == [False, True] * 2


# -- Trainer (tests/test_trainer.py's cases) --------------------------------

def _batches(cfg, b=8, seed=0):
    rng = np.random.default_rng(seed)
    while True:
        yield rng.integers(0, cfg.vocab, size=(b, 32)).astype(np.int32)


def _trainer(cfg, **kw):
    return Trainer(cfg, device="cpu", **kw)


def test_fit_trains_and_checkpoints(tmp_path):
    cfg = ttr.tiny_config()
    seen = []
    with _trainer(cfg, lr=3e-3, ckpt_dir=tmp_path / "ck", save_every=2,
                  hooks=[lambda s, l, dt: seen.append((s, l))]) as tr:
        res = tr.fit(_batches(cfg), steps=4)
    assert isinstance(res, FitResult)
    assert res.steps == 4 and res.resumed_from is None
    assert np.isfinite(res.last_loss)
    assert [s for s, _ in seen] == [1, 2, 3, 4]
    assert res.steps_per_s > 0
    with _trainer(cfg, lr=3e-3) as tr2:
        r2 = tr2.fit(_batches(cfg), steps=20)
    assert r2.last_loss < seen[0][1]


def test_resume_continues_schedule(tmp_path):
    cfg = ttr.tiny_config()
    with _trainer(cfg, ckpt_dir=tmp_path / "ck", save_every=2) as tr:
        tr.fit(_batches(cfg), steps=4)
        saved = {n: p.detach().clone() for n, p in tr.params.items()}
        moments = {n: tr.optimizer.state[p]["exp_avg_sq"].clone()
                   for n, p in tr.params.items()}
    with _trainer(cfg, ckpt_dir=tmp_path / "ck") as tr2:
        assert tr2.resumed_from == 4 and tr2.step == 4
        for n, p in tr2.params.items():
            assert torch.equal(p.detach(), saved[n]), n
            assert torch.equal(tr2.optimizer.state[p]["exp_avg_sq"],
                               moments[n]), n
        res = tr2.fit(_batches(cfg, seed=1), steps=6)
    assert res.steps == 6 and res.resumed_from == 4
    with _trainer(cfg, ckpt_dir=tmp_path / "ck") as tr3:
        assert tr3.step == 6
        assert tr3.fit(_batches(cfg), steps=6).steps == 6


def test_hook_stop_iteration_stops_early(tmp_path):
    cfg = ttr.tiny_config()

    def stop_at_3(step, loss, dt):
        if step >= 3:
            raise StopIteration

    with _trainer(cfg, ckpt_dir=tmp_path / "ck", hooks=[stop_at_3]) as tr:
        res = tr.fit(_batches(cfg), steps=100)
    assert res.steps == 3
    with _trainer(cfg, ckpt_dir=tmp_path / "ck") as tr2:
        assert tr2.step == 3          # the early stop still saved


def test_async_save_and_manual_save(tmp_path):
    cfg = ttr.tiny_config()
    with _trainer(cfg, ckpt_dir=tmp_path / "ck", save_every=2,
                  async_save=True) as tr:
        tr.fit(_batches(cfg), steps=4)
        tr.save()
    with _trainer(cfg, ckpt_dir=tmp_path / "ck") as tr2:
        assert tr2.step == 4


def test_save_without_manager_refused():
    cfg = ttr.tiny_config()
    with _trainer(cfg) as tr:
        with pytest.raises(ValueError, match="ckpt_dir"):
            tr.save()


def test_data_exhaustion_at_save_boundary(tmp_path):
    """Data ends exactly on a cadence save: the final save must not
    collide with the step already on disk."""
    cfg = ttr.tiny_config()

    def two_batches():
        g = _batches(cfg)
        for _ in range(2):
            yield next(g)

    with _trainer(cfg, ckpt_dir=tmp_path / "ck", save_every=2) as tr:
        res = tr.fit(two_batches(), steps=10)
    assert res.steps == 2
    with _trainer(cfg, ckpt_dir=tmp_path / "ck") as tr2:
        assert tr2.step == 2


def test_warm_start_loses_to_resume(tmp_path):
    """init_weights seeds a fresh run (cast to float32 master weights);
    once a checkpoint exists, resume wins."""
    from nvme_strom_tpu_torch.parallel.weights import save_checkpoint
    cfg = ttr.tiny_config()
    init = {n: torch.from_numpy(a).to(torch.bfloat16 if a.ndim == 2
                                      else torch.float32)
            for n, a in ttr.init_params(7, cfg).items()}
    save_checkpoint(tmp_path / "w.safetensors", init)
    with _trainer(cfg, init_weights=tmp_path / "w.safetensors",
                  ckpt_dir=tmp_path / "ck") as tr:
        for n, p in tr.params.items():
            assert p.dtype == torch.float32
            assert torch.equal(p.detach(), init[n].float()), n
        tr.fit(_batches(cfg), steps=1)
        after = {n: p.detach().clone() for n, p in tr.params.items()}
    with _trainer(cfg, init_weights=tmp_path / "w.safetensors",
                  ckpt_dir=tmp_path / "ck") as tr2:
        assert tr2.resumed_from == 1
        for n, p in tr2.params.items():
            assert torch.equal(p.detach(), after[n]), n


def test_train_lm_cli_runs_and_resumes(tmp_path, capsys):
    from nvme_strom_tpu_torch import train_lm
    args = ["--tiny", "--steps", "3", "--seq-len", "32", "--global-batch",
            "4", "--save-every", "2", "--device", "cpu", "--flash",
            "--ckpt-dir", str(tmp_path / "ck")]
    assert train_lm.main(args) == 0
    out = capsys.readouterr().out
    assert "engine stats: direct=" in out and "3 steps" in out
    assert train_lm.main(args[:2] + ["5"] + args[3:]) == 0
    assert "resumed from step 3" in capsys.readouterr().out
