"""The port's ViT (nvme_strom_tpu_torch/models/vit.py) held against the
JAX package's: the cases of tests/test_vit.py but the sharded and mesh
ones, with the JAX parameters carried across
(``convert.vit_params_from_jax``): patchify bitwise, logits and every
gradient in float32, the explicit attention backward, remat, three
AdamW steps against ``optax.adamw``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nvme_strom_tpu.models import vit as jvit
from nvme_strom_tpu_torch.convert import vit_params_from_jax
from nvme_strom_tpu_torch.models import vit
from nvme_strom_tpu_torch.models.transformer import adamw, trainable_params

LOGITS_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jvit.tiny_vit_config(), dtype=jnp.float32)
    cfg = dataclasses.replace(vit.tiny_vit_config(), dtype=torch.float32)
    jparams = jvit.init_vit_params(jax.random.key(0), jcfg)
    rng = np.random.default_rng(1)
    images = rng.random((4, cfg.image_size, cfg.image_size, 3),
                        dtype=np.float32)
    labels = rng.integers(0, cfg.n_classes, 4).astype(np.int32)
    params = vit_params_from_jax({k: np.asarray(v)
                                  for k, v in jparams.items()}, cfg, "cpu")
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params,
                images=images, labels=labels)


def test_config_matches_jax_defaults():
    ours, theirs = vit.ViTConfig(), jvit.ViTConfig()
    for f in dataclasses.fields(theirs):
        if f.name != "dtype":
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert ours.n_patches == theirs.n_patches
    assert ours.patch_dim == theirs.patch_dim


def test_init_shapes_match_jax(setup):
    ours = vit.init_vit_params(0, setup["cfg"])
    assert {k: v.shape for k, v in ours.items()} == {
        k: tuple(v.shape) for k, v in setup["jparams"].items()}
    assert all(v.dtype == np.float32 for v in ours.values())


def test_patchify_bitwise(setup):
    cfg = setup["cfg"]
    img = np.arange(2 * 16 * 16 * 3, dtype=np.float32).reshape(2, 16, 16, 3)
    got = vit.patchify(torch.from_numpy(img), cfg).numpy()
    want = np.asarray(jvit.patchify(jnp.asarray(img), setup["jcfg"]))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, cfg.n_patches, cfg.patch_dim)
    np.testing.assert_array_equal(got[0, 0], img[0, :4, :4, :].reshape(-1))


def test_layer_norm_population_variance(setup):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    got = vit.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b), 1e-6).numpy()
    want = np.asarray(jvit.layer_norm(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b), 1e-6))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_forward_matches_jax(setup):
    s = setup
    got = vit.vit_forward(s["params"], torch.from_numpy(s["images"]),
                          s["cfg"])
    assert got.shape == (4, s["cfg"].n_classes)
    assert got.dtype == torch.float32
    want = np.asarray(jvit.vit_forward(s["jparams"],
                                       jnp.asarray(s["images"]), s["jcfg"]))
    np.testing.assert_allclose(got.numpy(), want, **LOGITS_TOL)


def test_bf16_forward_runs(setup):
    s = setup
    cfg = dataclasses.replace(s["cfg"], dtype=torch.bfloat16)
    got = vit.vit_forward(s["params"], torch.from_numpy(s["images"]), cfg)
    assert got.dtype == torch.float32
    assert torch.isfinite(got).all()


def test_every_gradient_matches_jax(setup):
    s = setup
    jg = jax.grad(lambda p: jvit.vit_loss(
        p, jnp.asarray(s["images"]), jnp.asarray(s["labels"]),
        s["jcfg"]))(s["jparams"])
    params = trainable_params(s["params"], torch.device("cpu"))
    loss = vit.vit_loss(params, torch.from_numpy(s["images"]),
                        torch.from_numpy(s["labels"]), s["cfg"])
    jloss = jvit.vit_loss(s["jparams"], jnp.asarray(s["images"]),
                          jnp.asarray(s["labels"]), s["jcfg"])
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    loss.backward()
    assert set(jg) == set(params)
    for name, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg[name]),
                                   err_msg=name, **GRAD_TOL)


def test_sdpa_backward_matches_autograd_of_the_plain_formula():
    """``_SDPA``'s explicit backward equals autograd of the plain
    softmax(QKᵀ/√d)V at float32 (where its dS cast is a no-op), and its
    forward is the formula's bitwise; the JAX custom VJP gives the same
    gradients."""
    rng = np.random.default_rng(3)
    q, k, v, ct = (rng.standard_normal((2, 4, 16, 8)).astype(np.float32)
                   for _ in range(4))

    def plain(q, k, v):
        scores = q.float() @ k.float().transpose(-1, -2)
        probs = torch.softmax(scores / np.sqrt(q.shape[-1]), -1).to(q.dtype)
        return probs @ v

    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = vit._SDPA.apply(*ts)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  plain(*ts).detach().numpy())
    g1 = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), ts)
    g2 = torch.autograd.grad((plain(*ts) * torch.from_numpy(ct)).sum(), ts)
    jg = jax.grad(lambda q, k, v: jnp.sum(jvit._sdpa(q, k, v) * ct),
                  (0, 1, 2))(q, k, v)
    for a, b, c, n in zip(g1, g2, jg, "qkv"):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                   atol=2e-6, err_msg=n)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=2e-5,
                                   atol=2e-6, err_msg=n)


def test_sdpa_backward_rounds_ds_to_the_activation_dtype():
    """In bf16 the backward rounds dS to bf16 before the dQ / dK
    products: dQ equals the product of the rounded dS with K exactly."""
    rng = np.random.default_rng(4)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((1, 2, 8, 8))
                                   .astype(np.float32)).to(torch.bfloat16)
                  for _ in range(4))
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    out = vit._SDPA.apply(*ts)
    dq, dk, dv = torch.autograd.grad(out, ts, g)
    probs32 = torch.softmax((q.float() @ k.float().transpose(-1, -2))
                            / np.sqrt(8), -1)
    dp = g.float() @ v.float().transpose(-1, -2)
    ds = ((probs32 * (dp - (dp * probs32).sum(-1, keepdim=True)))
          / np.sqrt(8)).to(torch.bfloat16).float()
    assert torch.equal(dq, (ds @ k.float()).to(torch.bfloat16))
    assert torch.equal(dk, (ds.transpose(-1, -2) @ q.float())
                       .to(torch.bfloat16))
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16


def test_remat_bitwise(setup):
    s = setup
    rcfg = dataclasses.replace(s["cfg"], remat=True)
    out = {}
    for c in (s["cfg"], rcfg):
        params = trainable_params(s["params"], torch.device("cpu"))
        loss = vit.vit_loss(params, torch.from_numpy(s["images"]),
                            torch.from_numpy(s["labels"]), c)
        loss.backward()
        out[c.remat] = (loss.detach(), {n: p.grad for n, p in
                                        params.items()})
    assert torch.equal(out[False][0], out[True][0])
    for n in out[False][1]:
        assert torch.equal(out[False][1][n], out[True][1][n]), n


def test_three_adamw_steps_match_optax(setup):
    s = setup
    opt = optax.adamw(1e-2)
    jstep = jax.jit(jvit.make_vit_train_step(s["jcfg"], opt))
    jp, jstate = s["jparams"], opt.init(s["jparams"])
    params = trainable_params(s["params"], torch.device("cpu"))
    step = vit.make_vit_train_step(s["cfg"], adamw(params, 1e-2))
    images = torch.from_numpy(s["images"])
    labels = torch.from_numpy(s["labels"])
    for _ in range(3):
        jp, jstate, jloss = jstep(jp, jstate, jnp.asarray(s["images"]),
                                  jnp.asarray(s["labels"]))
        loss = step(params, images, labels)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-4)
    for name, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[name]),
                                   err_msg=name, rtol=1e-4, atol=1e-5)


def test_train_step_learns(setup):
    s = setup
    params = trainable_params(s["params"], torch.device("cpu"))
    step = vit.make_vit_train_step(s["cfg"], adamw(params, 1e-2))
    images = torch.from_numpy(s["images"])
    labels = torch.from_numpy(s["labels"])
    l0 = float(vit.vit_loss(params, images, labels, s["cfg"]).detach())
    for _ in range(10):
        loss = step(params, images, labels)
    assert np.isfinite(float(loss))
    assert float(loss) < l0


def test_vit_params_from_jax_checks_names_and_shapes(setup):
    s = setup
    np_params = {k: np.asarray(v) for k, v in s["jparams"].items()}
    with pytest.raises(KeyError, match="missing"):
        vit_params_from_jax({k: v for k, v in np_params.items()
                             if k != "head"}, s["cfg"], "cpu")
    with pytest.raises(KeyError, match="does not know"):
        vit_params_from_jax({**np_params, "bogus": np.zeros(1)}, s["cfg"],
                            "cpu")
    with pytest.raises(ValueError, match="shape"):
        vit_params_from_jax({**np_params, "head": np.zeros((3, 3))},
                            s["cfg"], "cpu")
