"""Flash attention over (b, h, s, d) tensors (counterpart of
nvme_strom_tpu/ops/flash_attention.py): the training path's attention.

Three hand-written CUDA kernels, each beside its plain PyTorch version:

* ``flash_fwd`` (csrc/flash_attention_fwd.cu, replacing the TPU kernel
  ``_fwd_kernel``): out and the per-row log-sum-exp, online softmax in
  fp32, causal runs stopping at the q tile's last k tile;
* ``flash_bwd_dq`` (csrc/flash_attention_bwd.cu, ``_dq_kernel``): dQ,
  one block per q tile looping over k tiles;
* ``flash_bwd_dkv`` (csrc/flash_attention_bwd.cu, ``_dkv_kernel``): dK
  and dV, one block per k tile looping over q tiles from the causal
  start.

On bf16 inputs the forward and dK/dV run on the tensor cores (wgmma fed
by TMA, the probability and dS operands split into two bf16 parts);
fp32 inputs and dQ run fp32 FMA kernels.  :func:`flash_route` says which.

Each wrapper launches its kernel for CUDA tensors (and raises on what
the kernel does not take) and runs its plain version for CPU tensors.
The plain versions are the explicit formulas the kernels implement, not
autograd, so the CPU tests check the backward formula itself.  Each
kernel is bound by its fp32/bf16 products (operations); the bounds and
the design are in the CUDA sources.

``flash_attention`` / ``flash_attention_lse`` wrap the three in a
``torch.autograd.Function`` with a differentiable ``(out, lse)`` pair:
the LSE cotangent folds into the backward as
``delta = Σ_d dO·out − dlse``.  Tiles are the kernels' own (64 rows), so
the JAX package's ``block_q`` / ``block_k`` / ``interpret`` arguments
have no counterpart here.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from nvme_strom_tpu_torch import _build
from nvme_strom_tpu_torch.ops.decode_attention import KERNEL_DTYPES

#: head dims the kernels are compiled for (the flagship's 64, Llama's 128)
KERNEL_HEAD_DIMS = (64, 128)
_NEG_INF = -1e30


def _masked_scores(q, k, causal: bool, scale: float, prescale: bool):
    """fp32 scores q·kᵀ, masked with −1e30 above the diagonal when
    causal.  ``prescale`` multiplies q by ``scale`` before the product
    (the forward's order); otherwise the product is scaled (the
    backward's), as in the TPU kernels."""
    qf = q.float()
    if prescale:
        s = (qf * scale) @ k.float().transpose(-1, -2)
    else:
        s = (qf @ k.float().transpose(-1, -2)) * scale
    if causal:
        n, m = s.shape[-2], s.shape[-1]
        keep = torch.ones(n, m, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, _NEG_INF)
    return s


def flash_fwd_plain(q, k, v, causal: bool, scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`flash_fwd`: (out in q's dtype, lse fp32
    (b, h, s))."""
    s = _masked_scores(q, k, causal, scale, prescale=True)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    out = (p @ v.float()) / l
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def _probs_and_ds(q, k, v, dout, lse, delta, causal, scale):
    s = _masked_scores(q, k, causal, scale, prescale=False)
    p = torch.exp(s - lse[..., None])
    dp = dout.float() @ v.float().transpose(-1, -2)
    return p, p * (dp - delta[..., None]) * scale


def flash_bwd_dq_plain(q, k, v, dout, lse, delta, causal: bool,
                       scale: float) -> torch.Tensor:
    """Plain version of :func:`flash_bwd_dq`: dQ = Σ_k ds·K."""
    _, ds = _probs_and_ds(q, k, v, dout, lse, delta, causal, scale)
    return (ds @ k.float()).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, dout, lse, delta, causal: bool,
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`flash_bwd_dkv`: dK = Σ_q dsᵀ·Q and
    dV = Σ_q pᵀ·dO."""
    p, ds = _probs_and_ds(q, k, v, dout, lse, delta, causal, scale)
    dk = ds.transpose(-1, -2) @ q.float()
    dv = p.transpose(-1, -2) @ dout.float()
    return dk.to(k.dtype), dv.to(v.dtype)


# -- the kernels -------------------------------------------------------------

def _check_shapes(q, k, v, causal: bool) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (b, h, s, d) and k/v (b, h, skv, d), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (equal batch, head count and "
                         "head dim)")
    if causal and k.shape[2] != q.shape[2]:
        raise ValueError(f"causal attention requires equal q/kv lengths, "
                         f"got {q.shape[2]} vs {k.shape[2]}")


def _kernel_dtype(*tensors: torch.Tensor) -> int:
    """Raise on anything the flash kernels do not take; returns the
    dtype code.  Every tensor is a CUDA (b, h, seq, d) view on one
    device with unit stride along d and its other strides and base on
    16-byte boundaries (the kernels load 16 bytes at a time)."""
    t0 = tensors[0]
    if t0.device.type != "cuda":
        raise ValueError(f"unsupported device {t0.device}")
    if t0.dtype not in KERNEL_DTYPES:
        raise ValueError(f"the kernel takes {list(KERNEL_DTYPES)}, got "
                         f"{t0.dtype}")
    if t0.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {KERNEL_HEAD_DIMS}, "
                         f"got {t0.shape[-1]}")
    per16 = 16 // t0.element_size()
    for t in tensors:
        if t.device != t0.device:
            raise ValueError(f"tensors on {t0.device} and {t.device}")
        if t.dtype != t0.dtype:
            raise ValueError(f"mixed dtypes {t0.dtype} and {t.dtype}")
        if t.stride(-1) != 1 or any(st % per16 for st in t.stride()[:3]):
            raise ValueError(f"the kernel takes unit stride along d and "
                             f"16-byte strides, got {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError("the kernel needs 16-byte aligned tensors")
    return KERNEL_DTYPES[t0.dtype]


def _check_rows(t: torch.Tensor, like: torch.Tensor, what: str) -> None:
    """lse / delta: contiguous fp32 (b, h, s) on ``like``'s device."""
    if (t.dtype != torch.float32 or tuple(t.shape) != tuple(like.shape[:3])
            or not t.is_contiguous() or t.device != like.device):
        raise ValueError(f"{what} must be contiguous float32 "
                         f"{tuple(like.shape[:3])} on {like.device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _strides(*tensors: torch.Tensor):
    vals = [st for t in tensors for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _bhsd_like(t: torch.Tensor) -> torch.Tensor:
    """An empty (b, h, s, d) tensor laid out as (b, s, h, d): the model
    reshapes it to (b, s, h·d) without a copy."""
    b, h, s, d = t.shape
    return torch.empty(b, s, h, d, dtype=t.dtype,
                       device=t.device).transpose(1, 2)


def _launch_args(q, k):
    b, h, s, d = q.shape
    return (b, h, s, k.shape[2], d)


def flash_fwd(q, k, v, causal: bool = True, scale: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kernel: (out (b, h, s, d) in q's dtype, lse (b, h, s)
    fp32).  Non-causal K/V may be longer or shorter than Q."""
    _check_shapes(q, k, v, causal)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal, scale)
    code = _kernel_dtype(q, k, v)
    if not scale > 0:  # the kernel's running max is over unscaled scores
        raise ValueError(f"the kernel takes a positive scale, got {scale}")
    out = _bhsd_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _build.check(_build.kernel_library().strom_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), _strides(q, k, v, out), *_launch_args(q, k), code,
        int(causal), scale, torch.cuda.current_stream(q.device).cuda_stream,
        q.device.index), "flash_fwd")
    flash_fwd.launches += 1
    return out, lse


def flash_bwd_dq(q, k, v, dout, lse, delta, causal: bool = True,
                 scale: Optional[float] = None) -> torch.Tensor:
    """dQ kernel (``delta = Σ_d dO·out − dlse``, fp32 (b, h, s))."""
    _check_shapes(q, k, v, causal)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, dout, lse, delta, causal, scale)
    if dout.shape != q.shape:
        raise ValueError(f"dout {tuple(dout.shape)} != q {tuple(q.shape)}")
    code = _kernel_dtype(q, k, v, dout)
    _check_rows(lse, q, "lse")
    _check_rows(delta, q, "delta")
    dq = _bhsd_like(q)
    _build.check(_build.kernel_library().strom_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        _strides(q, k, v, dout, dq), *_launch_args(q, k), code, int(causal),
        scale, torch.cuda.current_stream(q.device).cuda_stream,
        q.device.index), "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal: bool = True,
                  scale: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK/dV kernel: (dk, dv) in k's and v's dtype."""
    _check_shapes(q, k, v, causal)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, dout, lse, delta, causal, scale)
    if dout.shape != q.shape:
        raise ValueError(f"dout {tuple(dout.shape)} != q {tuple(q.shape)}")
    code = _kernel_dtype(q, k, v, dout)
    _check_rows(lse, q, "lse")
    _check_rows(delta, q, "delta")
    dk, dv = _bhsd_like(k), _bhsd_like(v)
    _build.check(_build.kernel_library().strom_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _strides(q, k, v, dout, dk, dv), *_launch_args(q, k), code,
        int(causal), scale, torch.cuda.current_stream(q.device).cuda_stream,
        q.device.index), "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


def flash_route(kernel: str, dtype: torch.dtype) -> str:
    """``"wgmma"`` or ``"fma"``: the CUDA kernel that ``kernel``
    (``"fwd"``, ``"dq"`` or ``"dkv"``) runs for inputs of ``dtype``, as
    the library's own dispatch decides it."""
    code = KERNEL_DTYPES[dtype]
    index = ("fwd", "dq", "dkv").index(kernel)
    return ("wgmma" if _build.kernel_library().strom_flash_route(index, code)
            else "fma")


#: launches of each kernel (CUDA only)
flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


# -- autograd ----------------------------------------------------------------

def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernels can read it in place (unit stride
    along d, 16-byte strides and base), else a contiguous copy: the
    gradient autograd hands the backward may be expanded (stride 0)."""
    if t.device.type == "cpu":
        return t
    per16 = 16 // t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and not any(st % per16 for st in t.stride()[:3])
            and all(st > 0 for st in t.stride())):
        return t
    return t.contiguous()


class _FlashLSE(torch.autograd.Function):
    """(out, lse) = flash attention, both differentiable: the backward
    takes delta = Σ_d dO·out − dlse in fp32 (a missing dO or dlse counts
    as zero) and runs the dQ kernel and the dK/dV kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        q, k, v = (_kernel_layout(t) for t in (q, k, v))
        out, lse = flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dout = (torch.zeros_like(out) if dout is None
                else _kernel_layout(dout.to(out.dtype)))
        delta = (dout.float() * out.float()).sum(-1)
        if dlse is not None:
            delta = delta - dlse.float()
        delta = delta.contiguous()
        dq = flash_bwd_dq(q, k, v, dout, lse, delta, ctx.causal, ctx.scale)
        dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, ctx.causal,
                               ctx.scale)
        return dq, dk, dv, None, None


def _prep(q, k, causal: bool, scale) -> Tuple[bool, float]:
    """The JAX package's argument checks: rank 4, and causal needs equal
    q/kv lengths (position alignment is ambiguous otherwise)."""
    if q.dim() != 4:
        raise ValueError(f"expected (b, h, s, d), got {tuple(q.shape)}")
    if causal and k.shape[2] != q.shape[2]:
        raise ValueError(
            f"causal attention requires equal q/kv lengths, got "
            f"{q.shape[2]} vs {k.shape[2]} (position alignment is "
            "ambiguous otherwise)")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return bool(causal), float(scale)


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Fused attention over (batch, heads, seq, head_dim) tensors with
    equal head counts; differentiable.  Non-causal K/V may have another
    sequence length than Q."""
    return _FlashLSE.apply(q, k, v, *_prep(q, k, causal, scale))[0]


def flash_attention_lse(q, k, v, *, causal: bool = True,
                        scale: Optional[float] = None):
    """Like :func:`flash_attention` but also returns the per-row
    log-sum-exp (b, h, s) fp32; cotangents on both outputs flow through
    the backward kernels (the blockwise / ring combine's inner)."""
    return _FlashLSE.apply(q, k, v, *_prep(q, k, causal, scale))


def make_flash_attn(causal: bool = True, **kw):
    """``attn_fn`` for models.transformer: a drop-in replacement for
    dense causal attention with O(s) memory."""
    return functools.partial(flash_attention, causal=causal, **kw)
