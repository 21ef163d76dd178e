"""Paged attention: decode against a block-table KV pool (counterpart
of nvme_strom_tpu/ops/paged_attention.py).

``paged_attention`` launches the hand-written CUDA kernel
(csrc/paged_attention.cu, replacing the TPU kernel ``_paged_kernel``)
for CUDA tensors and runs ``paged_attention_plain`` for CPU tensors.
The kernel splits each row's keys into pieces of whole pool blocks,
loads each split's block-table entries itself, and skips the splits past
the row's live length, so padding entries are never read; bound, layout
and the shapes it takes as in ops/decode_attention.py.
``paged_split_partials_plain`` is its split written in torch, for the
tests.
"""

from __future__ import annotations

import math

import torch

from nvme_strom_tpu_torch import _build
from nvme_strom_tpu_torch.device import current_stream, sm_count
from nvme_strom_tpu_torch.ops.decode_attention import (
    _check_q, _positions, check_kernel_inputs, decode_attention_plain,
    kernel_launch, split_partials_plain, workspace)


def _check(q, k_pool, v_pool, table) -> None:
    if q.dim() != 4 or q.shape[2] != 1:
        raise ValueError(f"expected q (b, h, 1, d), got {tuple(q.shape)}")
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape \
            or k_pool.shape[3] != q.shape[3]:
        raise ValueError(f"pools must be (n_blocks, nkv, block_k, "
                         f"{q.shape[3]}), got {tuple(k_pool.shape)} and "
                         f"{tuple(v_pool.shape)}")
    if table.dim() != 2 or table.shape[0] != q.shape[0]:
        raise ValueError(f"table must be ({q.shape[0]}, max_blocks), got "
                         f"{tuple(table.shape)}")
    _check_q(q, k_pool.shape[1])


def paged_attention_plain(q, k_pool, v_pool, table, pos, *, scale=None
                          ) -> torch.Tensor:
    """Plain PyTorch version: gather each row's blocks into a dense
    (b, nkv, max_blocks·block_k, d) cache, then the masked dense decode
    of :func:`decode_attention_plain`."""
    _check(q, k_pool, v_pool, table)
    b, nb = table.shape
    _, nkv, bk, d = k_pool.shape
    idx = table.long()

    def gather(pool):
        return pool[idx].permute(0, 2, 1, 3, 4).reshape(b, nkv, nb * bk, d)

    return decode_attention_plain(q, gather(k_pool), gather(v_pool), pos,
                                  scale=scale)


def paged_split_partials_plain(q, k_pool, v_pool, table, pos,
                               split_len: int, *, scale=None):
    """:func:`split_partials_plain` over each row's gathered blocks, the
    keys of a table entry outside the pool skipped as the kernel skips
    them."""
    _check(q, k_pool, v_pool, table)
    b, nb = table.shape
    n_pool, nkv, bk, d = k_pool.shape
    idx = table.long()
    inside = (idx >= 0) & (idx < n_pool)

    def gather(pool):
        return (pool[idx.clamp(0, n_pool - 1)].permute(0, 2, 1, 3, 4)
                .reshape(b, nkv, nb * bk, d))

    return split_partials_plain(
        q, gather(k_pool), gather(v_pool), pos, split_len, scale=scale,
        present=inside.repeat_interleave(bk, dim=1))


def paged_attention(q, k_pool, v_pool, table, pos, *, scale=None
                    ) -> torch.Tensor:
    """q (b, n_heads, 1, d) attends to its block-table history.
    k_pool/v_pool (n_blocks, n_kv_heads, block_k, d); table
    (b, max_blocks) int32, block j covering positions
    [j·block_k, (j+1)·block_k); pos (b,) the newest position per row.
    Padding entries may be anything (never read by the kernel)."""
    _check(q, k_pool, v_pool, table)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, table, pos,
                                     scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    code = check_kernel_inputs(q, k_pool, v_pool)
    if table.device != q.device or table.dtype != torch.int32 \
            or not table.is_contiguous():
        raise ValueError("table must be a contiguous int32 tensor on "
                         f"{q.device}")
    b, nh, _, d = q.shape
    n_pool, nkv, block_k, _ = k_pool.shape
    max_blocks = table.shape[1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    p = _positions(pos, b, q.device)
    out = torch.empty_like(q)
    dev = q.device.index
    width, rows, split_len, n_ws = kernel_launch(
        b, nh, nkv, d, max_blocks * block_k, block_k, sm_count(dev))
    stream = current_stream(dev)
    ws = workspace(q.device, stream, n_ws)
    _build.check(_build.kernel_library().strom_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        table.data_ptr(), p.data_ptr(), out.data_ptr(),
        0 if ws is None else ws.data_ptr(), b, nkv, nh // nkv, n_pool,
        block_k, max_blocks, d, width, rows, split_len, code, float(scale),
        stream, dev), "paged_attention")
    paged_attention.launches += 1
    return out


#: launches of the paged-attention kernel (one a call, as for
#: decode_attention)
paged_attention.launches = 0
