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
    combine_splits_plain, decode_attention, decode_attention_plain,
    kernel_launch, kernel_shape, split_partials_plain, workspace)

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
    # GQA groups and head dims past the powers of two
    ("gqa 7 d 40 NaN tail", 3, 14, 2, 70, 40, [0, 33, 69], 16, True),
    ("gqa 16 d 24", 2, 32, 2, 50, 24, [17, 49], 512, False),
    # head dims of the any-width path: ragged (rows not 16-byte
    # aligned) and wide
    ("d 12 NaN tail", 2, 4, 2, 40, 12, [5, 39], 16, True),
    ("gqa 7 d 100", 2, 14, 2, 33, 100, [0, 32], 512, False),
    ("d 320 NaN tail", 2, 4, 4, 24, 320, [9, 23], 8, True),
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


#: float16: both sides compute in float32 and round once to float16, so
#: they may differ by one float16 ulp (rtol 2**-10) plus the float32
#: summation order near zero
F16 = dict(atol=2e-5, rtol=2 ** -10)


@pytest.mark.parametrize("label,b,nh,nkv,S,d,pos,block_k,nan", [
    c for c in CASES if c[0] in ("gqa odd S last", "vector pos NaN tail",
                                 "gqa 7 d 40 NaN tail", "d 12 NaN tail",
                                 "d 320 NaN tail")], ids=str)
def test_plain_matches_jax_kernel_fp16(label, b, nh, nkv, S, d, pos,
                                       block_k, nan):
    """float16 in, float16 out, as the Pallas kernel takes it."""
    per_row = pos if isinstance(pos, list) else [pos] * b
    q, k, v = (a.astype(np.float16) for a in _inputs(
        b, nh, nkv, S, d, seed=len(label),
        nan_after=per_row if nan else None))
    jpos = (jnp.asarray(pos, jnp.int32) if isinstance(pos, list) else pos)
    want = np.asarray(jax_da(jnp.asarray(q), jnp.asarray(k),
                             jnp.asarray(v), jpos, block_k=block_k,
                             interpret=True))
    assert want.dtype == np.float16
    tpos = torch.tensor(pos, dtype=torch.int32) if isinstance(
        pos, list) else pos
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), tpos)
    assert got.dtype == torch.float16
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               **F16)


SPLIT_CASES = [
    # (label, b, nh, nkv, S, d, pos, split_len)
    ("pos at split edges", 4, 4, 2, 64, 16, [15, 16, 17, 31], 16),
    ("empty splits past pos", 3, 8, 2, 100, 16, [0, 3, 40], 16),
    ("one split holds the row", 2, 4, 4, 30, 8, [29, 7], 32),
    ("pos < 0 and a split of one key", 3, 14, 2, 33, 40, [-1, 32, 8], 8),
    ("gqa 16, split of one key", 2, 16, 1, 9, 24, [8, 4], 1),
    ("d 12 at split edges", 3, 4, 2, 48, 12, [15, 16, 47], 16),
    ("gqa 7 d 100, empty splits", 2, 14, 2, 40, 100, [3, 20], 8),
    ("d 320, pos < 0", 3, 4, 1, 20, 320, [-1, 19, 4], 8),
]


@pytest.mark.parametrize("label,b,nh,nkv,S,d,pos,split_len", SPLIT_CASES,
                         ids=[c[0] for c in SPLIT_CASES])
def test_split_and_combine_match_plain(label, b, nh, nkv, S, d, pos,
                                       split_len):
    """The kernel's split-and-combine, written in torch, against the
    one-softmax plain version: splits past pos are empty, a row whose pos
    sits on a split edge fills its last split exactly or starts a new one
    with one key, and pos < 0 gives 0.  NaN past pos must not reach the
    output."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(
        b, nh, nkv, S, d, seed=len(label), nan_after=pos))
    tpos = torch.tensor(pos, dtype=torch.int32)
    m, l, acc = split_partials_plain(q, k, v, tpos, split_len)
    n = -(-S // split_len)
    assert m.shape == (b, nkv, nh // nkv, n) and acc.shape[-2:] == (n, d)
    for row, p in enumerate(pos):
        empty = slice(p // split_len + 1 if p >= 0 else 0, None)
        assert (m[row, ..., empty] == -1e30).all()
        assert (l[row, ..., empty] == 0).all()
        assert (acc[row, :, :, empty] == 0).all()
    got = combine_splits_plain(m, l, acc, q.dtype)
    want = decode_attention_plain(q, k, v, tpos)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL,
                               rtol=TOL)
    assert (got[[i for i, p in enumerate(pos) if p < 0]] == 0).all()


@pytest.mark.parametrize("d,g,want", [
    (64, 1, (64, 1)), (40, 7, (64, 4)), (96, 3, (128, 4)),
    (128, 16, (128, 4)), (256, 2, (256, 2)), (8, 12, (64, 4)),
    # the any-width path: its width is d
    (1, 1, (1, 1)), (12, 7, (12, 4)), (100, 2, (100, 2)),
    (264, 16, (264, 4)), (320, 1, (320, 1)), (576, 3, (576, 4))])
def test_kernel_shape(d, g, want):
    """The built head width (64, 128 or 256) at or above a d that is a
    multiple of 8 up to 256, else d itself (the any-width path), and the
    query rows a block holds (a power of 2 up to 4)."""
    assert kernel_shape(d, g) == want


@pytest.mark.parametrize("b,nh,nkv,S,d,block_k,sms,want", [
    # the flagship's 2k cache: 256 (the grid at 512 would not fill an
    # H100's 132 SMs twice); 8k of a group of 7 and 16k of a group of 4:
    # 512; the flagship on a card of 16 SMs: 512
    (8, 8, 8, 2048, 64, 1, 132, 256),
    (4, 28, 4, 8192, 128, 1, 132, 512),
    (4, 32, 8, 16384, 128, 1, 132, 512),
    (8, 8, 8, 2048, 64, 1, 16, 512),
    # cut to whole pool blocks; a split inside a longer block is not
    (8, 8, 8, 2048, 64, 96, 132, 192),
    (8, 8, 8, 2048, 64, 384, 132, 256),
    # one split a row: no workspace
    (2, 4, 2, 200, 16, 1, 132, 256),
    # the any-width path: workspace rows of d floats
    (4, 28, 4, 8192, 100, 1, 132, 512),
    (8, 8, 8, 2048, 576, 128, 132, 256),
    (2, 4, 2, 200, 320, 1, 132, 256),
])
def test_kernel_launch_plan(b, nh, nkv, S, d, block_k, sms, want):
    """Keys a split holds and the workspace: every split's acc (rows,
    width), m and l in float32, none where a row has one split."""
    width, rows, got, ws = kernel_launch(b, nh, nkv, d, S, block_k, sms)
    assert got == want
    assert (width, rows) == kernel_shape(d, nh // nkv)
    n_splits = -(-S // got)
    cells = b * nkv * -(-(nh // nkv) // rows)
    assert ws == (cells * n_splits * rows * (width + 2)
                  if n_splits > 1 else 0)


def test_workspace_is_kept_per_stream_and_grows():
    """One float32 workspace for each stream a thread launches on, reused
    while it is large enough; none where the launch needs none."""
    dev = torch.device("cpu")
    assert workspace(dev, 11, 0) is None
    ws = workspace(dev, 11, 100)
    assert ws.dtype == torch.float32 and ws.numel() == 100
    assert workspace(dev, 11, 60) is ws
    other = workspace(dev, 12, 60)
    assert other is not ws
    grown = workspace(dev, 11, 101)
    assert grown.numel() == 101 and workspace(dev, 11, 100) is grown
    assert workspace(dev, 12, 60) is other


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
