"""Ring attention: the sequence split over an ``sp`` mesh axis
(counterpart of nvme_strom_tpu/parallel/ring_attention.py).

Each rank holds one span of the sequence: its block of Q, K and V.  The
K/V blocks go round the ring (``collectives.ppermute``, one exchange of
K and V stacked a step) while each rank merges the attention of its Q
block over every K/V block it sees.  At step t rank i holds K/V block
j = (i − t) mod n.  Under causality j < i counts whole, j == i with the
in-block causal mask, and j > i not at all: that block's product is
skipped, but the block still travels on, so every rank makes the same
exchanges in the same order, forward and backward.  K/V are rotated
n − 1 times: the n-th would only bring each block home.

Two inners compute a step:

- ``dense``: plain torch block maths with the online softmax (running
  max m, sum l and output o in float32), the (s_local, s_local) scores
  of one block at a time;
- ``flash``: the port's flash kernels through ``flash_attention_lse``
  (kernel 4 forward, kernels 5 and 6 backward on a CUDA tensor; their
  plain versions on the CPU), the blocks merged by their log-sum-exps:
  m' = max(m, lse_j), num' = num·e^{m−m'} + o_j·e^{lse_j−m'}, den'
  likewise.  The merge sends a nonzero lse cotangent into every block's
  backward.

Under a causal mask rank i launches the forward kernel i + 1 times a
call, so n ranks launch it n(n + 1)/2 times, and each backward kernel
as often.  q / k / v are this rank's (b_local, h_local, s / sp, d)
blocks with K/V already expanded to Q's head count; the batch and head
splits (dp, tp) need no collective here.
"""

from __future__ import annotations

import math

import torch

from nvme_strom_tpu_torch.parallel import collectives as _coll

_NEG = -1e30  # finite, so exp() underflows to 0 instead of giving NaN

class _Tie(torch.autograd.Function):
    """``out`` unchanged, with the last K/V block one of its inputs: its
    backward hands that block a zero gradient.  Under a causal mask a
    rank uses none of the blocks after its own, and autograd would skip
    the backward of the rotations that brought them, on some ranks and
    not others; tied, every rotation's backward exchange runs on every
    rank, in the same order."""

    @staticmethod
    def forward(ctx, out, kv):
        ctx.kv = (kv.shape, kv.dtype, kv.device)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.kv
        return g, torch.zeros(shape, dtype=dtype, device=device)


def _tie(out, kv, causal: bool):
    return _Tie.apply(out, kv) if causal and kv.requires_grad else out


def _ring_dense(q, k, v, group, causal: bool):
    b, h, s, d = q.shape
    n, i = _coll.group_size(group), _coll.group_rank(group)
    scale = 1.0 / math.sqrt(d)
    q_pos = i * s + torch.arange(s, device=q.device)
    m = torch.full((b, h, s), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    kv = torch.stack((k, v))
    for t in range(n):
        j = (i - t) % n
        if not (causal and j > i):
            kt, vt = kv[0], kv[1]
            # products on the activation dtype's values, f32 sums (the
            # JAX qk_scores / pv_apply)
            sc = (q.float() @ kt.float().transpose(-1, -2)) * scale
            if causal:
                kv_pos = j * s + torch.arange(s, device=q.device)
                mask = kv_pos[None, :] <= q_pos[:, None]
                sc = sc.masked_fill(~mask, _NEG)
            m_new = torch.maximum(m, sc.amax(-1))
            p = torch.exp(sc - m_new[..., None])
            if causal:
                p = p.masked_fill(~mask, 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            o = o * corr[..., None] + p.to(v.dtype).float() @ vt.float()
            m = m_new
        if t < n - 1:
            kv = _coll.ppermute(kv, group)
    return _tie((o / l[..., None]).to(q.dtype), kv, causal)


def _ring_flash(q, k, v, group, causal: bool):
    from nvme_strom_tpu_torch.ops.flash_attention import flash_attention_lse
    b, h, s, d = q.shape
    n, i = _coll.group_size(group), _coll.group_rank(group)
    m = torch.full((b, h, s), _NEG, dtype=torch.float32, device=q.device)
    den = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    num = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    kv = torch.stack((k, v))
    for t in range(n):
        j = (i - t) % n
        if not (causal and j > i):
            o_j, lse_j = flash_attention_lse(q, kv[0], kv[1],
                                             causal=causal and j == i)
            m_new = torch.maximum(m, lse_j)
            c = torch.exp(m - m_new)
            w = torch.exp(lse_j - m_new)
            den = den * c + w
            num = num * c[..., None] + w[..., None] * o_j.float()
            m = m_new
        if t < n - 1:
            kv = _coll.ppermute(kv, group)
    return _tie((num / den[..., None]).to(q.dtype), kv, causal)


_INNERS = {"dense": _ring_dense, "flash": _ring_flash}


def _inner(inner: str):
    if inner not in _INNERS:
        raise ValueError(f"inner must be 'dense' or 'flash', got {inner!r}")
    return _INNERS[inner]


def ring_block(q, k, v, group, causal: bool = True, inner: str = "dense"):
    """Attention of this rank's Q block over the sequence spread over
    ``group`` (None: one rank, plain attention of the block)."""
    return _inner(inner)(q, k, v, group, causal)


def ring_attention(q, k, v, mesh, sp_axis: str = "sp", causal: bool = True,
                   inner: str = "dense"):
    """Attention with the sequence split over ``mesh``'s ``sp_axis``:
    q / k / v (b_local, h_local, s / sp, d) are this rank's blocks, K/V
    expanded to Q's heads; returns this rank's block of the output.
    ``inner``: ``"dense"`` or ``"flash"`` (see the module docstring);
    anything else raises ``ValueError``."""
    return ring_block(q, k, v, mesh.group(sp_axis), causal, inner)


def make_ring_attn(mesh, sp_axis: str = "sp", inner: str = "dense"):
    """``attn_fn(q, k, v)`` for models/transformer (``Trainer(attn_fn=)``,
    ``make_train_step(attn_fn=)``): the sequence-parallel drop-in for
    causal attention."""
    _inner(inner)

    def attn_fn(q, k, v):
        return ring_attention(q, k, v, mesh, sp_axis=sp_axis, inner=inner)

    return attn_fn
