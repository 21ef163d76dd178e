"""Decode attention: one query token per row against the KV cache
(counterpart of nvme_strom_tpu/ops/decode_attention.py).

``decode_attention`` launches the hand-written CUDA kernel
(csrc/decode_attention.cu, replacing the TPU kernel ``_decode_kernel``)
for CUDA tensors and runs ``decode_attention_plain`` for CPU tensors.
The kernel reads the cache at kv-head width (the GQA group is handled
inside), masks each row by its own position, stops at that position, and
keeps the online-softmax state in float32.  It is bound by the K/V bytes
of the live positions over HBM bandwidth; at the flagship width it runs
only b·n_kv_heads blocks, fewer than the card's 132 SMs (see
csrc/attn_common.cuh).
"""

from __future__ import annotations

import math

import torch

from nvme_strom_tpu_torch import _build

#: element types the kernels take, by their code in csrc/attn_common.cuh
KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_GROUPS = (1, 2, 4, 8)


def _positions(pos, b: int, device) -> torch.Tensor:
    """``pos`` (int, 0-d or (b,)) as an int32 (b,) tensor on ``device``."""
    if isinstance(pos, torch.Tensor):
        p = pos.to(device=device, dtype=torch.int32)
        if p.dim() == 0:
            return p.expand(b).contiguous()
        if p.shape != (b,):
            raise ValueError(f"pos must be scalar or ({b},), got "
                             f"{tuple(p.shape)}")
        return p.contiguous()
    return torch.full((b,), int(pos), dtype=torch.int32, device=device)


def _check_q(q: torch.Tensor, nkv: int) -> None:
    if q.dim() != 4 or q.shape[2] != 1:
        raise ValueError(f"expected q (b, h, 1, d), got {tuple(q.shape)}")
    if q.shape[1] % nkv:
        raise ValueError(f"{q.shape[1]} query heads not divisible by {nkv} "
                         "kv heads")


def check_kernel_inputs(q: torch.Tensor, *tensors: torch.Tensor) -> int:
    """Raise on anything the attention kernels do not take; returns the
    dtype code."""
    for t in (q,) + tensors:
        if t.device != q.device:
            raise ValueError(f"tensors on {q.device} and {t.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"mixed dtypes {q.dtype} and {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError("the kernel needs 16-byte aligned tensors")
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"the kernel takes {list(KERNEL_DTYPES)}, got "
                         f"{q.dtype}")
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {q.shape[-1]}")
    return KERNEL_DTYPES[q.dtype]


def decode_attention_plain(q, k, v, pos, *, scale=None) -> torch.Tensor:
    """Plain PyTorch version: float32 scores over the whole cache, keys
    past ``pos`` masked with -1e30 and their V rows zeroed (so garbage
    there cannot make 0·NaN), output in q's dtype."""
    b, nh, _, d = q.shape
    _, nkv, S, _ = k.shape
    _check_q(q, nkv)
    g = nh // nkv
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    p = _positions(pos, b, q.device)
    ok = torch.arange(S, device=q.device)[None, :] <= p[:, None].long()
    qg = q.reshape(b, nkv, g, d).float() * scale
    vf = torch.where(ok[:, None, :, None], v.float(), 0.0)
    s = torch.einsum("bngd,bnsd->bngs", qg, k.float())
    s = torch.where(ok[:, None, None, :], s, -1e30)
    o = torch.einsum("bngs,bnsd->bngd", torch.softmax(s, dim=-1), vf)
    return o.reshape(b, nh, 1, d).to(q.dtype)


def decode_attention(q, k, v, pos, *, scale=None) -> torch.Tensor:
    """q (b, n_heads, 1, d) attends to the kv-width cache k/v
    (b, n_kv_heads, S, d) at positions [0, pos]; ``pos`` is the index of
    the newest entry, an int or a (b,) tensor.  Returns
    (b, n_heads, 1, d) in q's dtype."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (b, h, 1, d) and k/v (b, nkv, S, d),"
                         f" got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, nh, _, d = q.shape
    _, nkv, S, _ = k.shape
    _check_q(q, nkv)
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"cache {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, pos, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    code = check_kernel_inputs(q, k, v)
    g = nh // nkv
    if g not in KERNEL_GROUPS:
        raise ValueError(f"the kernel takes query groups {KERNEL_GROUPS}, "
                         f"got {g}")
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    p = _positions(pos, b, q.device)
    out = torch.empty_like(q)
    _build.check(_build.kernel_library().strom_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(),
        out.data_ptr(), b, nkv, g, S, d, code, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream, q.device.index),
        "decode_attention")
    decode_attention.launches += 1
    return out


#: launches of the decode-attention kernel
decode_attention.launches = 0
