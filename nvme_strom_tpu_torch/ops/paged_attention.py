"""Paged attention: decode against a block-table KV pool (counterpart
of nvme_strom_tpu/ops/paged_attention.py).

``paged_attention`` launches the hand-written CUDA kernel
(csrc/paged_attention.cu, replacing the TPU kernel ``_paged_kernel``)
for CUDA tensors and runs ``paged_attention_plain`` for CPU tensors.
The kernel reads each row's block-table entries itself and stops at the
row's live length, so padding entries are never read; bound and layout
as in ops/decode_attention.py.
"""

from __future__ import annotations

import math

import torch

from nvme_strom_tpu_torch import _build
from nvme_strom_tpu_torch.ops.decode_attention import (
    KERNEL_GROUPS, _check_q, _positions, check_kernel_inputs,
    decode_attention_plain)


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
    g = nh // nkv
    if g not in KERNEL_GROUPS:
        raise ValueError(f"the kernel takes query groups {KERNEL_GROUPS}, "
                         f"got {g}")
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    p = _positions(pos, b, q.device)
    out = torch.empty_like(q)
    _build.check(_build.kernel_library().strom_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        table.data_ptr(), p.data_ptr(), out.data_ptr(), b, nkv, g, n_pool,
        block_k, table.shape[1], d, code, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream, q.device.index),
        "paged_attention")
    paged_attention.launches += 1
    return out


#: launches of the paged-attention kernel
paged_attention.launches = 0
