"""LoRA fine-tuning over a frozen base (counterpart of
nvme_strom_tpu/models/lora.py).

Adapters apply as a merged delta, ``W_eff = W + (alpha/rank)·A@B``,
inside the loss: one (d_in, r) × (r, d_out) product per target and step,
and the forward, decode and checkpoint paths run unchanged on the merged
parameters.  Gradients reach only the adapters (the base tensors do not
require grad), so the optimizer state is adapter-sized.  A weight-only
quantized base (models/quant.py, int8 or int4: QLoRA) stays quantized at
rest; its merged targets are dequantized and carried in bfloat16, as the
JAX package does by design.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from nvme_strom_tpu_torch.models.quant import logical_shape
from nvme_strom_tpu_torch.models.transformer import (
    TransformerConfig, accumulate_grads, apply_gradients, loss_fn, wmat)

#: attention projections are the canonical LoRA targets; MLP matmuls
#: opt in through ``targets=``
DEFAULT_TARGETS = ("wq", "wk", "wv", "wo")


def lora_init(gen: torch.Generator, base_params: Dict, rank: int,
              targets: Sequence[str] = DEFAULT_TARGETS,
              dtype: torch.dtype = torch.float32, device=None
              ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Adapters {name: (A, B)} for every 2-D base matmul whose last name
    component is in ``targets``, in sorted name order: A ~ N(0, 1/rank)
    drawn from ``gen``, B = 0, so the adapted model starts equal to the
    base.  A quantized leaf adapts at its logical shape.  The adapters
    are leaves that require grad, on ``device`` (default: the base
    leaf's)."""
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    names = [n for n in sorted(base_params)
             if n.rsplit(".", 1)[-1] in targets
             and len(logical_shape(base_params[n])) == 2]
    if not names:
        raise ValueError(f"no base matmuls match targets {targets}")
    out = {}
    for n in names:
        w = base_params[n]
        dev = device if device is not None else (
            next(iter(w.values())) if isinstance(w, dict) else w).device
        d_in, d_out = logical_shape(w)
        a = torch.randn(d_in, rank, generator=gen, dtype=dtype,
                        device=gen.device) / torch.tensor(rank, dtype=dtype
                                                          ).sqrt()
        b = torch.zeros(rank, d_out, dtype=dtype)
        out[n] = (a.to(dev).requires_grad_(), b.to(dev).requires_grad_())
    return out


def merge_lora(base_params: Dict, adapters: Dict,
               alpha: float = 1.0) -> Dict:
    """Base + scaled adapter deltas → full parameters, same names and
    dtypes as the base (scale alpha / rank, the sum in float32).  A
    quantized target dequantizes, takes the delta and continues in
    bfloat16; the base itself is not changed."""
    out = dict(base_params)
    for n, (a, b) in adapters.items():
        delta = (a @ b) * (alpha / a.shape[1])
        w = base_params[n]
        if isinstance(w, dict):
            out[n] = (wmat(base_params, n, torch.float32)
                      + delta.float()).to(torch.bfloat16)
        else:
            out[n] = (w.float() + delta.float()).to(w.dtype)
    return out


def lora_loss_fn(adapters: Dict, base_params: Dict, tokens: torch.Tensor,
                 cfg: TransformerConfig, alpha: float = 1.0, attn_fn=None
                 ) -> torch.Tensor:
    """The adapted model's loss, differentiable in ``adapters`` only."""
    return loss_fn(merge_lora(base_params, adapters, alpha=alpha), tokens,
                   cfg, attn_fn=attn_fn)


def adapter_leaves(adapters: Dict) -> Dict[str, torch.Tensor]:
    """{``name|0``: A, ``name|1``: B}: the adapters as one flat dict of
    tensors (the checkpoint's names for them)."""
    return {f"{n}|{i}": t for n, ab in adapters.items()
            for i, t in enumerate(ab)}


def make_lora_train_step(cfg: TransformerConfig, optimizer,
                         alpha: float = 1.0, attn_fn=None,
                         accum_steps: int = 1, lr=None,
                         grad_clip: float = 0.0):
    """``step(adapters, base_params, tokens) -> loss``: the adapter
    gradients of the mean loss over ``accum_steps`` microbatches, then
    one update of ``optimizer`` (a torch optimizer over the adapter
    tensors, which it updates in place) through
    ``transformer.apply_gradients`` (``lr``, ``grad_clip``)."""

    def grads_of(adapters, base_params, mb):
        leaves = adapter_leaves(adapters)
        loss = lora_loss_fn(adapters, base_params, mb, cfg, alpha=alpha,
                            attn_fn=attn_fn)
        g = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, g))

    def step(adapters: Dict, base_params: Dict,
             tokens: torch.Tensor) -> torch.Tensor:
        leaves = adapter_leaves(adapters)
        loss, grads = accumulate_grads(
            lambda mb: grads_of(adapters, base_params, mb), leaves, tokens,
            accum_steps)
        apply_gradients(optimizer, leaves, grads, lr=lr,
                        grad_clip=grad_clip)
        return loss

    return step


def count_params(tree) -> int:
    """Elements over every tensor of a dict / tuple / list tree (a
    quantized leaf counts its stored tensors)."""
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(count_params(v) for v in tree)
    return tree.numel()
