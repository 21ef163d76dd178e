"""decode_attention_plain (nvme_strom_tpu_torch/ops/decode_attention.py)
against the JAX package's Pallas decode kernel, run in interpret mode on
the CPU, on the same numpy inputs.  Tolerance: float32 throughout,
atol=rtol=1e-5 (the two differ only in summation order: online softmax
over k-blocks vs one softmax over the row)."""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvme_strom_tpu.ops.decode_attention import decode_attention as jax_da
from nvme_strom_tpu_torch.ops.decode_attention import (
    decode_attention, decode_attention_plain)

TOL = 1e-5


def _inputs(b, nh, nkv, S, d, seed, nan_after=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, nh, 1, d)).astype(np.float32)
    k = rng.standard_normal((b, nkv, S, d)).astype(np.float32)
    v = rng.standard_normal((b, nkv, S, d)).astype(np.float32)
    if nan_after is not None:
        for i, p in enumerate(nan_after):
            k[i, :, p + 1:] = np.nan
            v[i, :, p + 1:] = np.nan
    return q, k, v


CASES = [
    # (label, b, nh, nkv, S, d, pos, block_k, nan tail)
    ("dense pos 0", 2, 4, 4, 64, 16, 0, 512, False),
    ("dense pos 7", 2, 4, 4, 64, 16, 7, 512, False),
    ("dense last", 2, 4, 4, 64, 16, 63, 512, False),
    ("gqa odd S pos 0", 2, 8, 2, 107, 16, 0, 32, False),
    ("gqa odd S pos 63", 2, 8, 2, 107, 16, 63, 32, False),
    ("gqa odd S last", 2, 8, 2, 107, 16, 106, 32, False),
    ("vector pos", 3, 4, 2, 50, 16, [0, 17, 49], 512, False),
    ("vector pos NaN tail", 3, 4, 2, 50, 16, [3, 17, 40], 16, True),
    ("scalar pos NaN tail", 2, 8, 2, 107, 16, 40, 32, True),
]


@pytest.mark.parametrize("label,b,nh,nkv,S,d,pos,block_k,nan", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_matches_jax_kernel(label, b, nh, nkv, S, d, pos, block_k,
                                  nan):
    per_row = pos if isinstance(pos, list) else [pos] * b
    q, k, v = _inputs(b, nh, nkv, S, d, seed=len(label),
                      nan_after=per_row if nan else None)
    want = np.asarray(jax_da(jnp.asarray(q), jnp.asarray(k),
                             jnp.asarray(v),
                             jnp.asarray(pos, jnp.int32)
                             if isinstance(pos, list) else pos,
                             block_k=block_k, interpret=True))
    tpos = torch.tensor(pos, dtype=torch.int32) if isinstance(
        pos, list) else pos
    got = decode_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), tpos)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_wrapper_on_cpu_runs_plain_and_launches_nothing():
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 4, 2, 30, 16, 0))
    before = decode_attention.launches
    out = decode_attention(q, k, v, torch.tensor([3, 29],
                                                 dtype=torch.int32))
    assert decode_attention.launches == before
    ref = decode_attention_plain(q, k, v, torch.tensor([3, 29]))
    assert torch.equal(out, ref)
    # bf16 in, bf16 out; the math runs in float32
    out16 = decode_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), 5)
    assert out16.dtype == torch.bfloat16
    ref32 = decode_attention_plain(q.bfloat16().float(),
                                   k.bfloat16().float(),
                                   v.bfloat16().float(), 5)
    torch.testing.assert_close(out16.float(), ref32, atol=1e-2, rtol=1e-2)


def test_validation_and_no_fallback_off_cpu():
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 4, 2, 30, 16, 1))
    with pytest.raises(ValueError, match="expected q"):
        decode_attention(q[:, :, :0], k, v, 0)
    with pytest.raises(ValueError, match="not divisible"):
        decode_attention(q[:, :3], k, v, 0)
    with pytest.raises(ValueError, match="pos must be"):
        decode_attention(q, k, v, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="does not match"):
        decode_attention(q, k[:1], v[:1], 0)
    # a tensor on a device other than the CPU never takes the plain path
    with pytest.raises(ValueError, match="unsupported device"):
        decode_attention(q.to("meta"), k.to("meta"), v.to("meta"), 0)


def test_kernel_build_raises_without_nvcc():
    """Without a CUDA toolkit the kernel library does not build, and says
    so: nothing falls back to another implementation."""
    from nvme_strom_tpu_torch import _build
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is present")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.kernel_library()
