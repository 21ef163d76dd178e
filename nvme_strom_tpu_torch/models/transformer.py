"""Llama-style decoder, inference half (counterpart of
nvme_strom_tpu/models/transformer.py).

Parameters are a flat ``{name: tensor}`` dict in the JAX package's
namespace and layout: matmul weights are ``(d_in, d_out)`` and apply as
``x @ w``.  Matrices are held in the compute dtype, norm weights in
float32.  Attention scores and softmax run in float32; the output of
every matmul is in the compute dtype, as in the JAX model.  Mixture-of-
experts layers and quantized weights are not part of this port yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 8         # grouped-query attention when < n_heads
    d_ff: int = 1408
    max_seq: int = 2048
    rope_theta: float = 10000.0
    # Llama-3.1 rope scaling: None or a dict with rope_type "llama3" and
    # factor / low_freq_factor / high_freq_factor /
    # original_max_position_embeddings; kept as a sorted tuple so the
    # config stays hashable
    rope_scaling: object = None
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    n_experts: int = 0

    def __post_init__(self):
        if isinstance(self.rope_scaling, dict):
            object.__setattr__(self, "rope_scaling",
                               tuple(sorted(self.rope_scaling.items())))
        if self.n_experts:
            raise NotImplementedError(
                "mixture-of-experts layers are not ported yet")
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.n_heads} heads not divisible by "
                             f"{self.n_kv_heads} kv heads")

    @property
    def rope_scaling_dict(self):
        return dict(self.rope_scaling) if self.rope_scaling else None

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def flagship_config() -> TransformerConfig:
    return TransformerConfig()


def tiny_config() -> TransformerConfig:
    return TransformerConfig(vocab=128, d_model=64, n_layers=2, n_heads=4,
                             n_kv_heads=2, d_ff=128, max_seq=64)


def param_shapes(cfg: TransformerConfig) -> Dict[str, tuple]:
    """Every parameter's name and shape, in init order."""
    hd, nh, nkv, d = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    shapes = {"tok_embed": (cfg.vocab, d), "final_norm": (d,),
              "lm_head": (d, cfg.vocab)}
    for i in range(cfg.n_layers):
        L = f"layers.{i}."
        shapes.update({
            L + "attn_norm": (d,), L + "wq": (d, nh * hd),
            L + "wk": (d, nkv * hd), L + "wv": (d, nkv * hd),
            L + "wo": (nh * hd, d), L + "mlp_norm": (d,),
            L + "w_gate": (d, cfg.d_ff), L + "w_up": (d, cfg.d_ff),
            L + "w_down": (cfg.d_ff, d)})
    return shapes


def init_params(seed: int, cfg: TransformerConfig) -> Dict[str, np.ndarray]:
    """Float32 numpy parameters made from ``seed``: norms are ones,
    every matrix is normal / sqrt(fan_in) (the JAX init scheme; the
    token embedding uses fan_in 1)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in param_shapes(cfg).items():
        if len(shape) == 1:
            out[name] = np.ones(shape, np.float32)
        else:
            fan_in = 1.0 if name == "tok_embed" else shape[0]
            out[name] = (rng.standard_normal(shape, dtype=np.float32)
                         / np.float32(np.sqrt(fan_in)))
    return out


# ----------------------------- layers -----------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """Norm math in float32, one cast back to ``x``'s dtype."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight).to(x.dtype)


def _llama3_scale_freqs(freqs: torch.Tensor, scaling: dict) -> torch.Tensor:
    """Llama-3.1 frequency remap: long wavelengths divided by
    ``factor``, short ones kept, a smooth ramp between."""
    factor = float(scaling["factor"])
    low = float(scaling.get("low_freq_factor", 1.0))
    high = float(scaling.get("high_freq_factor", 4.0))
    orig = float(scaling["original_max_position_embeddings"])
    wavelen = 2.0 * math.pi / freqs
    smooth = ((orig / wavelen - low) / (high - low)).clamp(0.0, 1.0)
    return torch.where(wavelen > orig / low, freqs / factor,
                       torch.where(wavelen < orig / high, freqs,
                                   (1 - smooth) * freqs / factor
                                   + smooth * freqs))


def _rope_cos_sin(half: int, theta: float, positions: torch.Tensor,
                  scaling):
    """cos/sin tables (..., seq, half) in float32 for float32
    ``positions`` of shape (seq,) or (b, seq)."""
    dev = positions.device
    freqs = torch.tensor(theta, dtype=torch.float32, device=dev) ** (
        -torch.arange(0, half, dtype=torch.float32, device=dev) / half)
    if scaling is not None:
        rt = scaling.get("rope_type", scaling.get("type"))
        if rt != "llama3":
            raise NotImplementedError(f"rope_scaling type {rt!r}")
        freqs = _llama3_scale_freqs(freqs, scaling)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def _apply_rope(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                ) -> torch.Tensor:
    """Half-split rotation (HF Llama's rotate_half convention)."""
    t1, t2 = t.float().chunk(2, dim=-1)
    return torch.cat([t1 * cos - t2 * sin, t2 * cos + t1 * sin],
                     dim=-1).to(t.dtype)


def wmat(p: Dict[str, torch.Tensor], name: str, dtype: torch.dtype
         ) -> torch.Tensor:
    """Matmul weight by name in ``dtype`` (dense weights only)."""
    w = p[name]
    if not isinstance(w, torch.Tensor):
        raise NotImplementedError(
            f"{name}: quantized weights are not ported yet")
    return w if w.dtype == dtype else w.to(dtype)


def qkv_project(x: torch.Tensor, p, prefix: str, cfg: TransformerConfig,
                positions: torch.Tensor):
    """q (b, nh, s, hd) and post-RoPE k / v at kv-head width
    (b, nkv, s, hd).  ``positions``: float32 (s,) or per-row (b, s)."""
    b, s, _ = x.shape
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = (x @ wmat(p, prefix + "wq", x.dtype)).view(b, s, nh, hd)
    k = (x @ wmat(p, prefix + "wk", x.dtype)).view(b, s, nkv, hd)
    v = (x @ wmat(p, prefix + "wv", x.dtype)).view(b, s, nkv, hd)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    cos, sin = _rope_cos_sin(hd // 2, cfg.rope_theta, positions,
                             cfg.rope_scaling_dict)
    if cos.dim() == 3:              # per-row positions: over heads
        cos, sin = cos[:, None], sin[:, None]
    return _apply_rope(q, cos, sin), _apply_rope(k, cos, sin), v


def expand_gqa(t: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """kv-head width → full head width (no-op when nkv == nh)."""
    if cfg.n_kv_heads != cfg.n_heads:
        t = t.repeat_interleave(cfg.n_heads // cfg.n_kv_heads, dim=1)
    return t


def dense_causal_attention(q, k, v) -> torch.Tensor:
    """softmax(QKᵀ/√d)V under a causal mask; (b, h, s, d) each, equal
    head counts.  Scores and softmax in float32."""
    s, hd = q.shape[-2], q.shape[-1]
    scores = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(hd)
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return (probs @ v).to(q.dtype)


def attention(x, p, prefix, cfg: TransformerConfig, positions=None,
              return_kv: bool = False):
    """Causal self-attention of a (b, s, d) block; ``return_kv`` also
    returns the post-RoPE kv-width k / v for the cache."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.float32, device=x.device)
    q, k, v = qkv_project(x, p, prefix, cfg, positions)
    out = dense_causal_attention(q, expand_gqa(k, cfg), expand_gqa(v, cfg))
    out = out.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim)
    out = out @ wmat(p, prefix + "wo", x.dtype)
    return (out, k, v) if return_kv else out


def mlp(x, p, prefix) -> torch.Tensor:
    gate = F.silu(x @ wmat(p, prefix + "w_gate", x.dtype))
    up = x @ wmat(p, prefix + "w_up", x.dtype)
    return (gate * up) @ wmat(p, prefix + "w_down", x.dtype)


def embed(p, tokens: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    return F.embedding(tokens.long(), p["tok_embed"]).to(cfg.dtype)
