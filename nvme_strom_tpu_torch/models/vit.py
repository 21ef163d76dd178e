"""Vision transformer, the image-side consumer of the data path
(counterpart of nvme_strom_tpu/models/vit.py).

Images stream from fixed-record shards through the engine onto the card
(``train_vit``); this classifier trains on them.  The choices follow the
JAX model: patchify is a reshape and one matmul (no convolution),
pre-LN encoder blocks, optional per-layer remat
(``torch.utils.checkpoint``).  Parameters are a flat ``{name: tensor}``
dict of float32 master weights, cast to ``cfg.dtype`` at each product,
so the safetensors loader and the checkpoint manager take them
unchanged.

Attention is :class:`_SDPA`, the JAX model's custom VJP carried over
formula for formula: scores and the softmax in float32, the
probabilities cast to q's dtype before the PV product; the backward
computes dS in float32, divides it by √d and casts it to the activation
dtype before the dQ and dK products (a no-op at float32).  It stays
plain torch ops, as the reference's einsums do: the flash kernels keep
dS in float32 and would not match it.

Numerics that follow JAX: ``jax.nn.gelu`` is the tanh approximation
(``F.gelu(..., approximate="tanh")``), and ``jnp.var`` is the population
variance.  The tensor-parallel specs of the reference
(``vit_param_specs``) wait for multi-GPU support.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from nvme_strom_tpu_torch.models.transformer import apply_gradients


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    channels: int = 3
    d_model: int = 384
    n_layers: int = 6
    n_heads: int = 6
    d_ff: int = 1536
    n_classes: int = 1000
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * self.channels


def tiny_vit_config() -> ViTConfig:
    return ViTConfig(image_size=16, patch_size=4, channels=3, d_model=32,
                     n_layers=2, n_heads=4, d_ff=64, n_classes=10)


def vit_param_shapes(cfg: ViTConfig) -> Dict[str, tuple]:
    """Every parameter's name and shape, in init order."""
    dm, ff = cfg.d_model, cfg.d_ff
    shapes = {"patch_embed": (cfg.patch_dim, dm),
              "pos_embed": (cfg.n_patches + 1, dm), "cls_token": (dm,),
              "final_norm": (dm,), "final_bias": (dm,),
              "head": (dm, cfg.n_classes)}
    for i in range(cfg.n_layers):
        L = f"layers.{i}."
        shapes.update({
            L + "attn_norm": (dm,), L + "attn_bias": (dm,),
            L + "wq": (dm, dm), L + "wk": (dm, dm), L + "wv": (dm, dm),
            L + "wo": (dm, dm), L + "mlp_norm": (dm,), L + "mlp_bias": (dm,),
            L + "w_up": (dm, ff), L + "w_down": (ff, dm)})
    return shapes


def init_vit_params(seed: int, cfg: ViTConfig) -> Dict[str, np.ndarray]:
    """Float32 numpy parameters made from ``seed``: matrices normal /
    √fan_in (fan_in the input dim), ``pos_embed`` 0.02 × normal, norm
    weights ones, biases and the class token zeros (the JAX init
    scheme)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in vit_param_shapes(cfg).items():
        if name == "pos_embed":
            out[name] = (np.float32(0.02)
                         * rng.standard_normal(shape, dtype=np.float32))
        elif len(shape) == 2:
            out[name] = (rng.standard_normal(shape, dtype=np.float32)
                         / np.float32(np.sqrt(shape[0])))
        elif name.endswith(("_norm", "norm")):
            out[name] = np.ones(shape, np.float32)
        else:
            out[name] = np.zeros(shape, np.float32)
    return out


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm in float32 with the population variance, one cast back
    to ``x``'s dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * weight + bias).to(x.dtype)


def patchify(images: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """(b, H, W, C) → (b, n_patches, p²·C), a reshape and a transpose,
    so the patch embedding is one matmul."""
    b = images.shape[0]
    s, p = cfg.image_size, cfg.patch_size
    n = s // p
    x = images.reshape(b, n, p, n, p, cfg.channels)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, n * n, cfg.patch_dim)


class _SDPA(torch.autograd.Function):
    """softmax(QKᵀ/√d)V over (b, h, s, d), non-causal, with the JAX
    model's explicit backward (see the module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v):
        hd = q.shape[-1]
        scores = q.float() @ k.float().transpose(-1, -2)
        probs32 = torch.softmax(scores / math.sqrt(hd), dim=-1)
        ctx.save_for_backward(q, k, v, probs32)
        return probs32.to(q.dtype) @ v

    @staticmethod
    def backward(ctx, g):
        q, k, v, probs32 = ctx.saved_tensors
        hd = q.shape[-1]
        g32 = g.to(q.dtype).float()
        probs = probs32.to(q.dtype).float()
        dv = (probs.transpose(-1, -2) @ g32).to(v.dtype)
        dp = g32 @ v.float().transpose(-1, -2)
        ds32 = probs32 * (dp - (dp * probs32).sum(-1, keepdim=True))
        ds = (ds32 / math.sqrt(hd)).to(q.dtype).float()
        dq = (ds @ k.float()).to(q.dtype)
        dk = (ds.transpose(-1, -2) @ q.float()).to(k.dtype)
        return dq, dk, dv


def _attention(x: torch.Tensor, p: Dict, L: str, cfg: ViTConfig):
    b, s, _ = x.shape
    hd, nh = cfg.head_dim, cfg.n_heads
    q, k, v = ((x @ p[L + w].to(x.dtype)).reshape(b, s, nh, hd)
               .transpose(1, 2) for w in ("wq", "wk", "wv"))
    o = _SDPA.apply(q, k, v)
    o = o.transpose(1, 2).reshape(b, s, nh * hd)
    return o @ p[L + "wo"].to(x.dtype)


def _layer(params: Dict, x: torch.Tensor, i: int, cfg: ViTConfig):
    L = f"layers.{i}."
    h = layer_norm(x, params[L + "attn_norm"], params[L + "attn_bias"],
                   cfg.norm_eps)
    x = x + _attention(h, params, L, cfg)
    h = layer_norm(x, params[L + "mlp_norm"], params[L + "mlp_bias"],
                   cfg.norm_eps)
    h = F.gelu(h @ params[L + "w_up"].to(h.dtype), approximate="tanh")
    return (x + h @ params[L + "w_down"].to(h.dtype)).to(cfg.dtype)


def vit_forward(params: Dict, images: torch.Tensor,
                cfg: ViTConfig) -> torch.Tensor:
    """images (b, H, W, C) of any real dtype → logits (b, n_classes)
    float32."""
    x = patchify(images.to(cfg.dtype), cfg)
    x = x @ params["patch_embed"].to(cfg.dtype)
    cls = params["cls_token"].to(cfg.dtype).expand(x.shape[0], 1,
                                                   cfg.d_model)
    x = torch.cat([cls, x], dim=1)
    x = x + params["pos_embed"].to(cfg.dtype)[None]
    for i in range(cfg.n_layers):
        if cfg.remat:
            x = checkpoint(_layer, params, x, i, cfg, use_reentrant=False)
        else:
            x = _layer(params, x, i, cfg)
    x = layer_norm(x[:, 0], params["final_norm"], params["final_bias"],
                   cfg.norm_eps)
    return (x @ params["head"].to(x.dtype)).float()


def vit_loss(params: Dict, images: torch.Tensor, labels: torch.Tensor,
             cfg: ViTConfig) -> torch.Tensor:
    """Mean cross-entropy of the logits against ``labels`` (b,)."""
    logp = torch.log_softmax(vit_forward(params, images, cfg), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


def make_vit_train_step(cfg: ViTConfig, optimizer):
    """``step(params, images, labels) -> loss``: the gradient of
    :func:`vit_loss`, then one ``optimizer.step()``.  ``optimizer`` is
    a torch optimizer over ``params``' tensors (``transformer.adamw``
    for optax's AdamW), which it updates in place."""

    def step(params: Dict, images: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
        names = list(params)
        loss = vit_loss(params, images, labels, cfg)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        apply_gradients(optimizer, params, dict(zip(names, grads)))
        return loss.detach()

    return step
