"""paged_attention_plain (nvme_strom_tpu_torch/ops/paged_attention.py)
against the JAX package's Pallas paged kernel, run in interpret mode on
the CPU, on the same numpy inputs: ragged lengths, GQA, and padding
table entries pointing at a NaN block.  Tolerance: float32,
atol=rtol=1e-5 (summation order only)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvme_strom_tpu.ops.paged_attention import paged_attention as jax_pa
from nvme_strom_tpu_torch.ops.decode_attention import (
    combine_splits_plain, decode_attention_plain)
from nvme_strom_tpu_torch.ops.paged_attention import (
    paged_attention, paged_attention_plain, paged_split_partials_plain)

TOL = 1e-5


def _case(b, nh, nkv, d, block_k, n_pool, table, pos, nan_block, seed):
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((n_pool, nkv, block_k, d)).astype(np.float32)
    vp = rng.standard_normal((n_pool, nkv, block_k, d)).astype(np.float32)
    if nan_block is not None:
        kp[nan_block] = np.nan
        vp[nan_block] = np.nan
    q = rng.standard_normal((b, nh, 1, d)).astype(np.float32)
    return q, kp, vp, np.asarray(table, np.int32), np.asarray(pos, np.int32)


CASES = {
    # ragged lengths 21, 10, 32 (tests/test_paged_attention.py)
    "ragged": dict(b=3, nh=4, nkv=2, d=16, block_k=8, n_pool=12,
                   table=[[3, 7, 1, 0], [5, 2, 0, 0], [9, 4, 8, 11]],
                   pos=[20, 9, 31], nan_block=None),
    # the second block of the only row is a NaN pad
    "nan padding block": dict(b=1, nh=2, nkv=2, d=8, block_k=4, n_pool=3,
                              table=[[1, 2]], pos=[3], nan_block=2),
    # GQA group 4, padding entries of every row point at the NaN block
    "gqa nan padding": dict(b=3, nh=8, nkv=2, d=16, block_k=8, n_pool=9,
                            table=[[0, 1, 8, 8], [2, 8, 8, 8],
                                   [3, 4, 5, 6]],
                            pos=[12, 0, 30], nan_block=8),
    # head dims of the any-width path: ragged and wide
    "d 12 ragged": dict(b=2, nh=4, nkv=2, d=12, block_k=8, n_pool=6,
                        table=[[3, 1, 0], [5, 2, 4]], pos=[20, 9],
                        nan_block=None),
    "gqa 7 d 100 nan padding": dict(b=2, nh=14, nkv=2, d=100, block_k=4,
                                    n_pool=5, table=[[0, 1, 4], [2, 3, 4]],
                                    pos=[6, 7], nan_block=4),
    "d 320": dict(b=1, nh=2, nkv=1, d=320, block_k=8, n_pool=3,
                  table=[[2, 0, 1]], pos=[17], nan_block=None),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_kernel(name):
    c = CASES[name]
    q, kp, vp, table, pos = _case(**c, seed=len(name))
    want = np.asarray(jax_pa(jnp.asarray(q), jnp.asarray(kp),
                             jnp.asarray(vp), jnp.asarray(table),
                             jnp.asarray(pos), interpret=True))
    got = paged_attention_plain(*(torch.from_numpy(a) for a in
                                  (q, kp, vp, table, pos)))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("split_len", [8, 16])
def test_split_and_combine_match_plain(name, split_len):
    """The paged kernel's split-and-combine, written in torch, against
    the plain paged version: splits of whole blocks (8 and 16 keys over
    blocks of 8 and 4), NaN padding blocks past pos never reached."""
    c = CASES[name]
    args = [torch.from_numpy(a) for a in _case(**c, seed=len(name))]
    got = combine_splits_plain(
        *paged_split_partials_plain(*args, split_len), torch.float32)
    np.testing.assert_allclose(got.numpy(),
                               paged_attention_plain(*args).numpy(),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("split_len", [4, 8, 12])
def test_split_whose_every_key_is_skipped(split_len):
    """Table entries outside the pool (-1, n_pool) are skipped, keys and
    all: a split made only of them adds nothing, and the output equals
    the dense decode over the keys that remain."""
    rng = np.random.default_rng(split_len)
    b, nh, nkv, d, bk, n_pool = 2, 14, 2, 16, 4, 6
    kp = torch.from_numpy(rng.standard_normal((n_pool, nkv, bk, d),
                                              np.float32))
    vp = torch.from_numpy(rng.standard_normal((n_pool, nkv, bk, d),
                                              np.float32))
    q = torch.from_numpy(rng.standard_normal((b, nh, 1, d), np.float32))
    # row 0: blocks 2 and 3 (keys 8..15) outside the pool; row 1: all
    # of its keys outside
    table = torch.tensor([[0, 1, -1, n_pool, 2, 3], [-1, 9, 0, 0, 0, 0]],
                         dtype=torch.int32)
    pos = torch.tensor([21, 7], dtype=torch.int32)
    m, l, acc = paged_split_partials_plain(q, kp, vp, table, pos,
                                           split_len)
    if split_len <= 8:   # one split lies wholly on row 0's skipped blocks
        assert (m[0, ..., 8 // split_len] == -1e30).all()
        assert (l[0, ..., 8 // split_len] == 0).all()
    got = combine_splits_plain(m, l, acc, torch.float32)
    keep = [0, 1, 2, 3]          # row 0's blocks in the pool, in order
    k = kp[keep].permute(1, 0, 2, 3).reshape(1, nkv, 4 * bk, d)
    v = vp[keep].permute(1, 0, 2, 3).reshape(1, nkv, 4 * bk, d)
    want = decode_attention_plain(q[:1], k, v, 21 - 2 * bk)
    np.testing.assert_allclose(got[:1].numpy(), want.numpy(), atol=TOL,
                               rtol=TOL)
    assert (got[1] == 0).all()


def test_paged_equals_dense_on_the_gathered_cache():
    """The same cache cut into blocks: the paged and dense plain paths
    agree exactly, and the CPU wrapper launches nothing."""
    from nvme_strom_tpu_torch.ops.decode_attention import \
        decode_attention_plain
    rng = np.random.default_rng(5)
    b, nh, nkv, S, d, bk = 2, 4, 2, 32, 16, 8
    q = torch.from_numpy(rng.standard_normal((b, nh, 1, d), np.float32))
    k = torch.from_numpy(rng.standard_normal((b, nkv, S, d), np.float32))
    v = torch.from_numpy(rng.standard_normal((b, nkv, S, d), np.float32))
    pool = lambda t: (t.reshape(b, nkv, S // bk, bk, d)        # noqa: E731
                      .permute(0, 2, 1, 3, 4).reshape(-1, nkv, bk, d))
    table = torch.arange(b * S // bk, dtype=torch.int32).view(b, -1)
    pos = torch.tensor([5, 31], dtype=torch.int32)
    before = paged_attention.launches
    got = paged_attention(q, pool(k), pool(v), table, pos)
    assert paged_attention.launches == before
    torch.testing.assert_close(got, decode_attention_plain(q, k, v, pos),
                               atol=0, rtol=0)


def test_validation_and_no_fallback_off_cpu():
    q, kp, vp, table, pos = (torch.from_numpy(a) for a in
                             _case(**CASES["ragged"], seed=0))
    with pytest.raises(ValueError, match="table"):
        paged_attention(q, kp, vp, table[:2], pos)
    with pytest.raises(ValueError, match="q"):
        paged_attention(q.expand(-1, -1, 2, -1), kp, vp, table, pos)
    with pytest.raises(ValueError, match="pools"):
        paged_attention(q, kp, vp[:, :, :4], table, pos)
    with pytest.raises(ValueError, match="unsupported device"):
        paged_attention(q.to("meta"), kp.to("meta"), vp.to("meta"),
                        table.to("meta"), pos.to("meta"))
