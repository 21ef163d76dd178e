"""LoRA and QLoRA in the port (models/lora.py), held against the JAX
package on the CPU: the cases of tests/test_lora.py, the int8-base case
and QLoRA over an int4 base (tests/test_quant.py), in float32 on the
JAX fixtures' tiny config.  The JAX adapters are carried across with
``convert.adapters_from_jax`` (the packages' random streams differ).

Tolerances: losses 1e-5 relative to the JAX ones; a LoRA step's adapter
gradients within 1e-5 of the JAX step's; the adapted model at t=0
exactly the base's in float32, and within the JAX test's (3e-2, 3e-2)
over a quantized base, whose merged targets are bfloat16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvme_strom_tpu.models import lora as jlora
from nvme_strom_tpu.models import quant as jq
from nvme_strom_tpu.models import transformer as jtr
from nvme_strom_tpu_torch.convert import adapters_from_jax, params_from_jax
from nvme_strom_tpu_torch.models import lora
from nvme_strom_tpu_torch.models import quant as tq
from nvme_strom_tpu_torch.models import transformer as ttr
from nvme_strom_tpu_torch.models.decode import generate

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def setup():
    cfg_j = jtr.TransformerConfig(**{**jtr.tiny_config().__dict__,
                                     "dtype": jnp.float32})
    cfg_t = ttr.TransformerConfig(**{**ttr.tiny_config().__dict__,
                                     "dtype": torch.float32})
    pj = jtr.init_params(jax.random.key(0), cfg_j)
    base = {k: t.requires_grad_(False) for k, t in params_from_jax(
        {k: np.asarray(v) for k, v in pj.items()}, cfg_t, CPU).items()}
    toks = np.asarray(jax.random.randint(jax.random.key(1), (4, 16), 0,
                                         cfg_j.vocab), np.int32)
    return cfg_j, cfg_t, pj, base, toks


def _jforward(params, toks, cfg_j):
    return jax.jit(lambda p, t: jtr.forward(p, t, cfg_j))(
        params, jnp.asarray(toks))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_zero_init_is_identity(setup):
    cfg_j, cfg, pj, base, toks = setup
    ad = lora.lora_init(_gen(2), base, rank=4)
    tok = torch.from_numpy(toks.copy())
    want = ttr.loss_fn(base, tok, cfg)
    got = lora.lora_loss_fn(ad, base, tok, cfg)
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-6)
    np.testing.assert_allclose(
        got.item(), float(jax.jit(lambda p, t: jtr.loss_fn(p, t, cfg_j))(
            pj, jnp.asarray(toks))), rtol=1e-5)
    merged = lora.merge_lora(base, ad)
    for n in base:
        assert torch.equal(merged[n], base[n]), n
    # A ~ N(0, 1/rank), B = 0, on the sorted target names
    assert list(ad) == sorted(n for n in base
                              if n.rsplit(".", 1)[-1] in lora.DEFAULT_TARGETS)
    a, b = ad["layers.0.wq"]
    assert a.shape == (64, 4) and b.shape == (4, 64)
    assert not b.any() and 0.3 < a.std().item() < 0.7


def test_adapter_training_reduces_loss_base_frozen(setup):
    _, cfg, _, base, toks = setup
    ad = lora.lora_init(_gen(3), base, rank=8)
    leaves = lora.adapter_leaves(ad)
    opt = torch.optim.Adam(list(leaves.values()), lr=1e-2)
    step = lora.make_lora_train_step(cfg, opt)
    snap = {n: t.clone() for n, t in base.items()}
    losses = [step(ad, base, torch.from_numpy(toks.copy())).item()
              for _ in range(8)]
    assert losses[-1] < losses[0], losses
    for n in base:
        assert torch.equal(base[n], snap[n]) and base[n].grad is None, n
    assert lora.count_params(ad) < 0.2 * lora.count_params(base)


def test_merged_params_decode(setup):
    """Merged parameters drive generate unchanged; a nonzero adapter
    changes the tokens."""
    _, cfg, _, base, toks = setup
    ad = lora.lora_init(_gen(4), base, rank=4)
    g = _gen(5)
    ad = {n: tuple((t + 0.05 * torch.randn(t.shape, generator=g)).detach()
                   for t in ab) for n, ab in ad.items()}
    merged = lora.merge_lora(base, ad, alpha=8.0)
    prompt = torch.from_numpy(np.array(toks[:2, :8]))
    with torch.no_grad():
        out_base = generate(base, prompt, cfg, 8)
        out_ad = generate(merged, prompt, cfg, 8)
    assert out_ad.shape == out_base.shape
    assert (out_ad != out_base).any()


def test_targets_validation(setup):
    base = setup[3]
    with pytest.raises(ValueError, match="no base matmuls"):
        lora.lora_init(_gen(6), base, rank=4, targets=("nonexistent",))
    with pytest.raises(ValueError, match="rank"):
        lora.lora_init(_gen(7), base, rank=0)


def test_mlp_targets_opt_in(setup):
    base = setup[3]
    names = set(lora.lora_init(_gen(8), base, rank=2,
                               targets=("wq", "w_gate", "w_down")))
    assert any(n.endswith("w_gate") for n in names)
    assert any(n.endswith("w_down") for n in names)
    assert not any(n.endswith("wk") for n in names)


def test_lora_gradient_accumulation_matches(setup):
    """Two microbatches give the full batch's adapters after three Adam
    steps.  Adam divides each update by the gradient's own scale, so a
    near-zero gradient summed in another order can move its weight by
    ~1e-5 (the JAX test allows 5e-6 for its own summation order; the
    port's is another)."""
    _, cfg, _, base, toks = setup

    def run(accum):
        ad = lora.lora_init(_gen(9), base, rank=4)
        opt = torch.optim.Adam(list(lora.adapter_leaves(ad).values()),
                               lr=1e-2)
        step = lora.make_lora_train_step(cfg, opt, accum_steps=accum)
        for _ in range(3):
            loss = step(ad, base, torch.from_numpy(toks.copy()))
        return ad, loss.item()

    a1, l1 = run(1)
    a2, l2 = run(2)
    np.testing.assert_allclose(l1, l2, rtol=1e-5)
    for k in a1:
        for x, y in zip(a1[k], a2[k]):
            np.testing.assert_allclose(x.detach().numpy(),
                                       y.detach().numpy(), atol=2e-5,
                                       rtol=1e-5)


def test_lora_step_grads_match_jax(setup):
    """Adapters drawn by the JAX package, pushed off zero, carried
    across: one LoRA step's loss and adapter gradients (with alpha 8)
    against the JAX step's."""
    cfg_j, cfg, pj, base, toks = setup
    adj = jlora.lora_init(jax.random.key(10), pj, rank=4)
    adj = jax.tree_util.tree_map(
        lambda x: x + 0.05 * jax.random.normal(jax.random.key(11), x.shape),
        adj)
    lj, gj = jax.jit(jax.value_and_grad(
        lambda a, t: jlora.lora_loss_fn(a, pj, t, cfg_j, alpha=8.0)))(
        adj, jnp.asarray(toks))
    ad = adapters_from_jax(jax.tree_util.tree_map(np.asarray, adj), CPU)
    leaves = lora.adapter_leaves(ad)
    loss = lora.lora_loss_fn(ad, base, torch.from_numpy(toks.copy()), cfg,
                             alpha=8.0)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(loss.item(), float(lj), rtol=1e-5)
    for (name, _), g in zip(leaves.items(), grads):
        n, i = name.split("|")
        np.testing.assert_allclose(g.numpy(), np.asarray(gj[n][int(i)]),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_lora_over_int8_base_trains(setup):
    """Adapters over an int8 base: t=0 close to the quantized base (the
    merge is bfloat16), the loss falls, and the base stays int8."""
    cfg_j, cfg, pj, base, toks = setup
    qj = jq.quantize_weights_int8(pj)
    qt = tq.quantize_weights_int8(base)
    assert np.array_equal(qt["layers.0.wq"]["q8"].numpy(),
                          np.asarray(qj["layers.0.wq"]["q8"]))
    ad = lora.lora_init(_gen(1), qt, rank=4)
    assert "layers.0.wq" in ad
    tok = torch.from_numpy(np.array(toks[:2]))
    with torch.no_grad():
        l0 = ttr.forward(lora.merge_lora(qt, ad), tok, cfg)
        lb = ttr.forward(qt, tok, cfg)
    np.testing.assert_allclose(l0.numpy(), lb.numpy(), atol=0.05, rtol=0.05)
    np.testing.assert_allclose(lb.numpy(), np.asarray(_jforward(
        qj, toks[:2], cfg_j)), atol=2e-5)
    opt = torch.optim.Adam(list(lora.adapter_leaves(ad).values()), lr=3e-3)
    step = lora.make_lora_train_step(cfg, opt)
    losses = [step(ad, qt, tok).item() for _ in range(6)]
    assert losses[-1] < losses[0], losses
    assert isinstance(qt["layers.0.wq"], dict)


def test_qlora_int4_logical_shapes_and_t0(setup):
    """QLoRA over int4: adapters at the logical weight shape (q4 packs
    two input rows a byte), t=0 within the JAX test's rails of the
    base, the JAX adapted logits too."""
    cfg_j, cfg, pj, base, toks = setup
    qt = tq.quantize_weights_int4(base, group=32)
    qj = jq.quantize_weights_int4(pj, group=32)
    ad = lora.lora_init(_gen(2), qt, rank=4)
    a, b = ad["layers.0.wq"]
    assert a.shape == (base["layers.0.wq"].shape[0], 4)
    assert b.shape == (4, base["layers.0.wq"].shape[1])
    tok = torch.from_numpy(np.array(toks[:2, :8]))
    with torch.no_grad():
        want = ttr.forward(qt, tok, cfg)
        got = ttr.forward(lora.merge_lora(qt, ad), tok, cfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=3e-2,
                               rtol=3e-2)
    adj = jlora.lora_init(jax.random.key(2), qj, rank=4)
    got_j = _jforward(jlora.merge_lora(qj, adj), toks[:2, :8], cfg_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(got_j), atol=3e-2,
                               rtol=3e-2)
    for n in ad:
        assert isinstance(qt[n], dict) and "q4" in qt[n]
