"""The port's flash attention (nvme_strom_tpu_torch/ops/flash_attention.py)
against the JAX package's, which runs its Pallas kernels in interpret
mode on the CPU.  The same numpy inputs go through both; on the CPU the
port runs its kernels' plain versions, so these tests hold the formulas
the CUDA kernels implement against the TPU kernels.  Tolerances are the
JAX suite's own (tests/test_flash_attention.py): 2e-5 on float32
outputs, 1e-4 on float32 gradients (both sides sum in float32 in
another order), and one bfloat16 ulp (rtol 2**-7) on bfloat16 outputs,
which both sides round once from float32."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from nvme_strom_tpu.ops import flash_attention as jfa
from nvme_strom_tpu_torch.ops import flash_attention as tfa

F32 = dict(atol=2e-5, rtol=2e-5)
GRAD = dict(atol=1e-4, rtol=1e-4)


def _qkv(b=2, h=3, s=128, d=32, skv=None, seed=0):
    rng = np.random.default_rng(seed)
    skv = s if skv is None else skv
    return (rng.standard_normal((b, h, s, d), dtype=np.float32),
            rng.standard_normal((b, h, skv, d), dtype=np.float32),
            rng.standard_normal((b, h, skv, d), dtype=np.float32))


def _t(*arrays, grad=False):
    out = tuple(torch.from_numpy(a.copy()) for a in arrays)
    if grad:
        out = tuple(t.requires_grad_() for t in out)
    return out


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,block", [(128, 64), (96, 32), (64, 64)])
def test_forward_matches_jax(causal, s, block):
    q, k, v = _qkv(s=s)
    want = jfa.flash_attention(q, k, v, causal=causal, block_q=block,
                               block_k=block)
    got = tfa.flash_attention(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_forward_uneven_jax_blocks():
    """JAX block_q != block_k (its causal block-boundary rounding)
    against the port's own tiles."""
    q, k, v = _qkv(s=128)
    want = jfa.flash_attention(q, k, v, causal=True, block_q=64,
                               block_k=32)
    got = tfa.flash_attention(*_t(q, k, v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_forward_bf16():
    q, k, v = (a.astype(ml_dtypes.bfloat16) for a in _qkv(s=128))
    want = np.asarray(jfa.flash_attention(q, k, v)).astype(np.float32)
    got = tfa.flash_attention(*(torch.from_numpy(a.view(np.int16).copy())
                                .view(torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-4)


@pytest.mark.parametrize("s,skv,block_k", [(64, 96, 32), (96, 32, 32)])
def test_forward_kv_length_differs(s, skv, block_k):
    q, k, v = _qkv(s=s, skv=skv, seed=4)
    want, want_lse = jfa.flash_attention_lse(q, k, v, causal=False,
                                             block_q=32, block_k=block_k)
    got, lse = tfa.flash_attention_lse(*_t(q, k, v), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **F32)


@pytest.mark.parametrize("causal", [True, False])
def test_lse_matches_jax(causal):
    q, k, v = _qkv(s=96, d=16, seed=5)
    want, want_lse = jfa.flash_attention_lse(q, k, v, causal=causal,
                                             block_q=32, block_k=32)
    got, lse = tfa.flash_attention_lse(*_t(q, k, v), causal=causal)
    assert lse.dtype == torch.float32 and lse.shape == (2, 3, 96)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **F32)


@pytest.mark.parametrize("causal", [True, False])
def test_grads_match_jax(causal):
    q, k, v = _qkv(s=64, d=16, seed=3)
    w = np.random.default_rng(9).standard_normal(q.shape, dtype=np.float32)

    def jloss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, causal=causal,
                                           block_q=32, block_k=32) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = _t(q, k, v, grad=True)
    (tfa.flash_attention(tq, tk, tv, causal=causal)
     * torch.from_numpy(w)).sum().backward()
    for got, ref, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GRAD,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
def test_lse_pair_grads_match_jax(causal):
    """Cotangents on both outputs: delta = Σ dO·out − dlse."""
    q, k, v = _qkv(s=64, d=16, seed=7)
    rng = np.random.default_rng(11)
    w = rng.standard_normal(q.shape, dtype=np.float32)
    u = rng.standard_normal(q.shape[:3], dtype=np.float32)

    def jloss(q, k, v):
        out, lse = jfa.flash_attention_lse(q, k, v, causal=causal,
                                           block_q=32, block_k=32)
        return jnp.sum(out * w) + jnp.sum(lse * u)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = _t(q, k, v, grad=True)
    out, lse = tfa.flash_attention_lse(tq, tk, tv, causal=causal)
    ((out * torch.from_numpy(w)).sum()
     + (lse * torch.from_numpy(u)).sum()).backward()
    for got, ref, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GRAD,
                                   err_msg=f"d{name}")


def test_blockwise_combine_matches_jax():
    """Two K/V halves merged by LSE weight (the ring combine in
    miniature): loss and every gradient match the JAX package's."""
    q, k, v = _qkv(s=64, d=16, seed=8)
    k1, k2 = np.split(k, 2, axis=2)
    v1, v2 = np.split(v, 2, axis=2)
    w = np.random.default_rng(13).standard_normal(q.shape,
                                                  dtype=np.float32)

    def combine(lse_fn, mod, wt, q, k1, k2, v1, v2, **kw):
        o1, l1 = lse_fn(q, k1, v1, causal=False, **kw)
        o2, l2 = lse_fn(q, k2, v2, causal=False, **kw)
        m = mod.maximum(l1, l2)
        w1 = mod.exp(l1 - m)[..., None]
        w2 = mod.exp(l2 - m)[..., None]
        return ((o1 * w1 + o2 * w2) / (w1 + w2) * wt).sum()

    jl, jg = jax.value_and_grad(
        lambda *a: combine(jfa.flash_attention_lse, jnp, w, *a,
                           block_q=32),
        argnums=(0, 1, 2, 3, 4))(q, k1, k2, v1, v2)
    ts = _t(q, k1, k2, v1, v2, grad=True)
    tl = combine(tfa.flash_attention_lse, torch, torch.from_numpy(w), *ts)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), **GRAD)
    for t, ref, name in zip(ts, jg, ["q", "k1", "k2", "v1", "v2"]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), **GRAD,
                                   err_msg=f"d{name}")


def test_plain_backward_formulas_match_autograd():
    """flash_bwd_dq_plain / flash_bwd_dkv_plain (the kernels' explicit
    formulas) equal autograd through the plain forward, with an LSE
    cotangent folded into delta."""
    q, k, v = _qkv(b=1, h=2, s=40, d=16, seed=12)
    rng = np.random.default_rng(14)
    do = torch.from_numpy(rng.standard_normal(q.shape, dtype=np.float32))
    dlse = torch.from_numpy(rng.standard_normal(q.shape[:3],
                                                dtype=np.float32))
    tq, tk, tv = _t(q, k, v, grad=True)
    out, lse = tfa.flash_fwd_plain(tq, tk, tv, True, 0.25)
    ((out * do).sum() + (lse * dlse).sum()).backward()
    delta = (do * out.detach()).sum(-1) - dlse
    args = (*_t(q, k, v), do, lse.detach(), delta, True, 0.25)
    np.testing.assert_allclose(tfa.flash_bwd_dq_plain(*args).numpy(),
                               tq.grad.numpy(), **GRAD)
    dk, dv = tfa.flash_bwd_dkv_plain(*args)
    np.testing.assert_allclose(dk.numpy(), tk.grad.numpy(), **GRAD)
    np.testing.assert_allclose(dv.numpy(), tv.grad.numpy(), **GRAD)


def test_rejects_bad_rank_and_causal_unequal_lengths():
    x = torch.zeros(2, 4, 8)
    with pytest.raises(ValueError, match="expected"):
        tfa.flash_attention(x, x, x)
    q = torch.zeros(1, 2, 16, 16)
    kv = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="equal q/kv lengths"):
        tfa.flash_attention(q, kv, kv, causal=True)
    with pytest.raises(ValueError, match="equal q/kv lengths"):
        tfa.flash_fwd(q, kv, kv, causal=True)
    assert tfa.flash_attention(q, kv, kv, causal=False).shape == q.shape
