"""Llama-style decoder (counterpart of
nvme_strom_tpu/models/transformer.py): the inference half and the
training half (loss, chunked cross-entropy, remat, the train step).

Parameters are a flat ``{name: tensor}`` dict in the JAX package's
namespace and layout: matmul weights are ``(d_in, d_out)`` and apply as
``x @ w``.  For serving, matrices are held in the compute dtype and norm
weights in float32; for training, every parameter is a float32 master
weight and ``wmat`` casts matrices to the compute dtype at use, as the
JAX model does.  Attention scores and softmax run in float32; the output
of every matmul is in the compute dtype.

Mixture-of-experts layers (models/moe.py) replace the dense MLP of every
layer ``i`` with ``i % moe_every == moe_every - 1`` when ``n_experts`` >
0; their router weights stay float32.  Weight-only quantized leaves
(models/quant.py) dequantize in ``wmat``; training takes full-precision
weights only.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from nvme_strom_tpu_torch.models import moe as _moe


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
    # mixture-of-experts (models/moe.py): 0 experts is a dense model
    n_experts: int = 0
    expert_top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_every: int = 2            # layer i is MoE iff i % moe_every ==
    #                               moe_every - 1
    # tokens per routing group; 0 = one batch row
    moe_group_size: int = 0
    # "full" recomputes each layer in the backward
    # (torch.utils.checkpoint); "none" keeps every activation
    remat_policy: str = "none"
    # cross-entropy over this many sequence slices (chunked_xent);
    # 0/1 = the full-logits path
    xent_chunks: int = 0

    def __post_init__(self):
        if isinstance(self.rope_scaling, dict):
            object.__setattr__(self, "rope_scaling",
                               tuple(sorted(self.rope_scaling.items())))
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.n_heads} heads not divisible by "
                             f"{self.n_kv_heads} kv heads")

    @property
    def rope_scaling_dict(self):
        return dict(self.rope_scaling) if self.rope_scaling else None

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def is_moe_layer(self, i: int) -> bool:
        return (self.n_experts > 0
                and i % self.moe_every == self.moe_every - 1)


def flagship_config() -> TransformerConfig:
    return TransformerConfig()


def tiny_config() -> TransformerConfig:
    return TransformerConfig(vocab=128, d_model=64, n_layers=2, n_heads=4,
                             n_kv_heads=2, d_ff=128, max_seq=64)


def tiny_moe_config() -> TransformerConfig:
    return TransformerConfig(vocab=128, d_model=64, n_layers=2, n_heads=4,
                             n_kv_heads=2, d_ff=128, max_seq=64,
                             n_experts=4, expert_top_k=2)


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
            L + "wo": (nh * hd, d), L + "mlp_norm": (d,)})
        if cfg.is_moe_layer(i):
            shapes.update(_moe.moe_param_shapes(cfg, L))
        else:
            shapes.update({L + "w_gate": (d, cfg.d_ff),
                           L + "w_up": (d, cfg.d_ff),
                           L + "w_down": (cfg.d_ff, d)})
    return shapes


def init_params(seed: int, cfg: TransformerConfig) -> Dict[str, np.ndarray]:
    """Float32 numpy parameters made from ``seed``: norms are ones,
    every matrix is normal / sqrt(fan_in), fan_in its input dim (the JAX
    init scheme; the token embedding uses fan_in 1); an MoE layer's
    weights come from ``moe.init_moe_params``."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in param_shapes(cfg).items():
        if name in out:
            continue
        if name.endswith(".router"):
            out.update(_moe.init_moe_params(rng, cfg,
                                            name[:-len("router")]))
        elif len(shape) == 1:
            out[name] = np.ones(shape, np.float32)
        else:
            fan_in = 1.0 if name == "tok_embed" else shape[-2]
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
    """Matmul weight by name in ``dtype``, dequantizing a weight-only
    quantized leaf (models/quant.py) in ``dtype`` as the JAX ``wmat``
    does: int8 ``{"q8" (..., d_in, d_out), "scale" (..., 1, d_out)}`` is
    ``q8 * scale``; packed int4 ``{"q4" (..., d_in / 2, d_out), "scale4"
    (..., n_groups, 1, d_out)}`` unpacks byte i's low nibble to row 2i
    and its high nibble to row 2i + 1 (each stored as q + 8), then
    scales each group of rows.  The dequantized weight is a new tensor
    of the full weight's size in ``dtype``."""
    w = p[name]
    if isinstance(w, dict):
        if "q8" in w:
            return w["q8"].to(dtype) * w["scale"].to(dtype)
        pk, sc = w["q4"], w["scale4"]
        lead = tuple(pk.shape[:-2])
        dhalf, dout = pk.shape[-2], pk.shape[-1]
        lo = (pk & 0xF).to(torch.int8) - 8
        hi = (pk >> 4).to(torch.int8) - 8
        q = torch.stack([lo, hi], dim=-2).reshape(*lead, 2 * dhalf, dout)
        ngroup = sc.shape[-3]
        g = (2 * dhalf) // ngroup
        wf = q.to(dtype).reshape(*lead, ngroup, g, dout) * sc.to(dtype)
        return wf.reshape(*lead, 2 * dhalf, dout)
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


class _DenseGrouped(torch.autograd.Function):
    """Causal attention in projection layout with k / v at kv-head
    width (the JAX package's ``dense_causal_attention_grouped``): the
    einsums carry (b, nkv) as batch dims, so K/V are never expanded.
    The backward runs the softmax VJP in fp32 and rounds dS to the
    activation dtype before the dQ / dK products, as the JAX custom VJP
    does (a no-op at float32)."""

    @staticmethod
    def forward(ctx, q, k, v):
        b, s, nh, hd = q.shape
        nkv = k.shape[2]
        qg = q.reshape(b, s, nkv, nh // nkv, hd)
        scores = torch.einsum("bsngd,btnd->bngst", qg.float(), k.float())
        scores = scores / math.sqrt(hd)
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        probs32 = torch.softmax(scores.masked_fill(~keep, -1e30), dim=-1)
        out = torch.einsum("bngst,btnd->bsngd", probs32.to(q.dtype), v)
        ctx.save_for_backward(q, k, v, probs32)
        return out.reshape(b, s, nh * hd)

    @staticmethod
    def backward(ctx, g_out):
        q, k, v, probs32 = ctx.saved_tensors
        b, s, nh, hd = q.shape
        nkv = k.shape[2]
        gr = nh // nkv
        go = g_out.to(q.dtype).reshape(b, s, nkv, gr, hd).float()
        probs = probs32.to(q.dtype).float()
        dv = torch.einsum("bngst,bsngd->btnd", probs, go).to(v.dtype)
        dprobs = torch.einsum("bsngd,btnd->bngst", go, v.float())
        # masked entries have probs32 == 0 exactly: no gradient leaks
        ds32 = probs32 * (dprobs - (dprobs * probs32).sum(-1, keepdim=True))
        ds = (ds32 / math.sqrt(hd)).to(q.dtype).float()
        qg = q.reshape(b, s, nkv, gr, hd).float()
        dqg = torch.einsum("bngst,btnd->bsngd", ds, k.float()).to(q.dtype)
        dk = torch.einsum("bngst,bsngd->btnd", ds, qg).to(k.dtype)
        return dqg.reshape(b, s, nh, hd), dk, dv


def dense_causal_attention_grouped(q, k, v) -> torch.Tensor:
    """q (b, s, nh, hd), k / v (b, s, nkv, hd) → (b, s, nh·hd); the
    default single-device training attention."""
    return _DenseGrouped.apply(q, k, v)


def attention(x, p, prefix, cfg: TransformerConfig, attn_fn=None,
              positions=None, return_kv: bool = False):
    """Causal self-attention of a (b, s, d) block.  Without ``attn_fn``
    it is the grouped dense attention in projection layout; an
    ``attn_fn`` (the flash kernels: ops.flash_attention
    ``make_flash_attn``) takes q and GQA-expanded k / v in (b, h, s, d).
    ``return_kv`` (cache prefill) also returns the post-RoPE kv-width
    k / v (b, nkv, s, hd)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.float32, device=x.device)
    q, k, v = qkv_project(x, p, prefix, cfg, positions)
    if attn_fn is None:
        # back to projection layout: free views of the projections
        out = dense_causal_attention_grouped(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    else:
        out = attn_fn(q, expand_gqa(k, cfg), expand_gqa(v, cfg))
        out = out.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim)
    out = out @ wmat(p, prefix + "wo", x.dtype)
    return (out, k, v) if return_kv else out


def mlp(x, p, prefix) -> torch.Tensor:
    gate = F.silu(x @ wmat(p, prefix + "w_gate", x.dtype))
    up = x @ wmat(p, prefix + "w_up", x.dtype)
    return (gate * up) @ wmat(p, prefix + "w_down", x.dtype)


def mlp_block(h, p, prefix: str, cfg: TransformerConfig) -> torch.Tensor:
    """The layer's MLP, dense or MoE by its index in ``prefix``
    (``layers.<i>.``); the one dispatch every inference path shares.
    The MoE aux loss is dropped: inference has no use for it."""
    if cfg.is_moe_layer(int(prefix.split(".")[1])):
        return _moe.moe_mlp(h, p, prefix, cfg)[0]
    return mlp(h, p, prefix)


def embed(p, tokens: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    return F.embedding(tokens.long(), p["tok_embed"]).to(cfg.dtype)


# ----------------------------- training -----------------------------

def _remat_policy(cfg: TransformerConfig) -> str:
    policy = cfg.remat_policy
    if policy in ("dots", "nvme"):
        raise NotImplementedError(
            f"remat_policy {policy!r} is not ported yet (none|full)")
    if policy not in ("none", "full"):
        raise ValueError(f"remat_policy {policy!r}: expected none|full")
    return policy


def forward_hidden(params: Dict, tokens: torch.Tensor,
                   cfg: TransformerConfig, attn_fn=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (b, s) → (final-norm hidden (b, s, d) in cfg.dtype,
    aux_loss scalar), everything short of the lm_head.  aux_loss is the
    summed MoE load-balancing loss, 0 for a dense model.
    ``remat_policy="full"`` recomputes each layer in the backward
    (``torch.utils.checkpoint``)."""
    policy = _remat_policy(cfg)
    x = wmat(params, "tok_embed", cfg.dtype)[tokens.long()]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def layer(x, i):
        L = f"layers.{i}."
        x = x + attention(rms_norm(x, params[L + "attn_norm"], cfg.norm_eps),
                          params, L, cfg, attn_fn)
        h = rms_norm(x, params[L + "mlp_norm"], cfg.norm_eps)
        if cfg.is_moe_layer(i):
            h, a = _moe.moe_mlp(h, params, L, cfg)
        else:
            h, a = mlp(h, params, L), torch.zeros_like(aux)
        return x + h, a

    for i in range(cfg.n_layers):
        x, a = (checkpoint(layer, x, i, use_reentrant=False)
                if policy == "full" else layer(x, i))
        aux = aux + a
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def forward_with_aux(params: Dict, tokens: torch.Tensor,
                     cfg: TransformerConfig, attn_fn=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (b, s) → (logits (b, s, vocab) float32, aux_loss)."""
    x, aux = forward_hidden(params, tokens, cfg, attn_fn)
    return (x @ wmat(params, "lm_head", x.dtype)).float(), aux


def forward(params: Dict, tokens: torch.Tensor, cfg: TransformerConfig,
            attn_fn=None) -> torch.Tensor:
    """tokens (b, s) → logits (b, s, vocab) float32."""
    return forward_with_aux(params, tokens, cfg, attn_fn)[0]


def _chunk_nll(h, w, t, wt):
    logits = (h @ w).float()                        # (b, c, vocab)
    lse = torch.logsumexp(logits, dim=-1)
    tl = logits.gather(-1, t[..., None])[..., 0]
    return ((lse - tl) * wt).sum()


def chunked_xent(params: Dict, hidden: torch.Tensor, tokens: torch.Tensor,
                 cfg: TransformerConfig) -> torch.Tensor:
    """Mean next-token NLL without materialising (b, s, vocab): the
    sequence is cut into ``cfg.xent_chunks`` slices, each projected
    through the lm_head and reduced under one ``torch.utils.checkpoint``
    (its logits are recomputed in the backward).  The last position has
    no next token and carries weight 0."""
    b, s, _ = hidden.shape
    n = cfg.xent_chunks
    if s % n:
        raise ValueError(f"xent_chunks={n} must divide the sequence "
                         f"length {s}")
    c = s // n
    tokens = tokens.long()
    targets = torch.cat([tokens[:, 1:], tokens.new_zeros(b, 1)], dim=1)
    weights = torch.ones(b, s, dtype=torch.float32, device=hidden.device)
    weights[:, -1] = 0.0
    w = wmat(params, "lm_head", hidden.dtype)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n):
        sl = slice(i * c, (i + 1) * c)
        total = total + checkpoint(_chunk_nll, hidden[:, sl], w,
                                   targets[:, sl], weights[:, sl],
                                   use_reentrant=False)
    return total / (b * (s - 1))


def loss_fn(params: Dict, tokens: torch.Tensor, cfg: TransformerConfig,
            attn_fn=None) -> torch.Tensor:
    """Next-token cross-entropy; tokens are input and target.  The full
    sequence is forwarded and the last logit dropped.  ``xent_chunks``
    > 1 takes :func:`chunked_xent`.  The MoE aux loss is added times
    ``router_aux_coef``."""
    if cfg.xent_chunks > 1:
        hidden, aux = forward_hidden(params, tokens, cfg, attn_fn)
        return (chunked_xent(params, hidden, tokens, cfg)
                + cfg.router_aux_coef * aux)
    logits, aux = forward_with_aux(params, tokens, cfg, attn_fn)
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    ll = logp.gather(-1, tokens[:, 1:].long()[..., None])
    return -ll.mean() + cfg.router_aux_coef * aux


def value_and_grad(params: Dict, tokens: torch.Tensor,
                   cfg: TransformerConfig, attn_fn=None):
    """(loss, {name: gradient}) of :func:`loss_fn` at ``params``."""
    names = list(params)
    loss = loss_fn(params, tokens, cfg, attn_fn)
    grads = torch.autograd.grad(loss, [params[n] for n in names])
    return loss.detach(), dict(zip(names, grads))


def accumulate_grads(grad_fn: Callable, like: Dict, tokens: torch.Tensor,
                     accum_steps: int):
    """Microbatched gradients: ``grad_fn(microbatch) -> (loss, grads)``
    over ``accum_steps`` equal row groups of tokens (b, s), summed in
    float32 and averaged, so the mean matches the full-batch value."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if accum_steps == 1:
        return grad_fn(tokens)
    b = tokens.shape[0]
    if b % accum_steps:
        raise ValueError(f"batch {b} not divisible by accum_steps "
                         f"{accum_steps}")
    loss_sum = torch.zeros((), dtype=torch.float32)
    grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in like.items()}
    for mb in tokens.reshape(accum_steps, b // accum_steps, -1):
        loss, g = grad_fn(mb)
        loss_sum = loss_sum.to(loss.device) + loss
        for n in grads:
            grads[n] += g[n]
    inv = 1.0 / accum_steps
    return loss_sum * inv, {n: g * inv for n, g in grads.items()}


def make_train_step(cfg: TransformerConfig, optimizer, attn_fn=None,
                    accum_steps: int = 1):
    """``step(params, tokens) -> loss``: gradients of the mean loss over
    ``accum_steps`` microbatches, then one ``optimizer.step()``.
    ``optimizer`` is a torch optimizer over ``params``' tensors, which
    it updates in place (where the JAX step returns new params)."""

    def step(params: Dict, tokens: torch.Tensor) -> torch.Tensor:
        loss, grads = accumulate_grads(
            lambda mb: value_and_grad(params, mb, cfg, attn_fn), params,
            tokens, accum_steps)
        for n, p in params.items():
            p.grad = grads[n].to(p.dtype)
        optimizer.step()
        return loss

    return step


def adamw(params, lr: float) -> torch.optim.AdamW:
    """``optax.adamw(lr)`` as torch: betas (0.9, 0.999), eps 1e-8 and
    decoupled weight decay 1e-4 (optax's defaults; torch's own default
    decay is 1e-2).  ``params``: a {name: tensor} dict or tensors."""
    if isinstance(params, dict):
        params = list(params.values())
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def trainable_params(np_params: Dict[str, np.ndarray],
                     device: torch.device) -> Dict[str, torch.Tensor]:
    """float32 leaf tensors on ``device`` that require grad, from
    :func:`init_params`' numpy arrays or any tensors.  A quantized leaf
    raises: the optimizer would update its integers and scales as
    independent tensors."""
    out = {}
    for name, arr in np_params.items():
        if isinstance(arr, dict):
            raise ValueError(
                f"{name} is a quantized leaf: training takes "
                "full-precision weights (quantize after training)")
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(arr))
        out[name] = t.detach().to(device=device, dtype=torch.float32
                                  ).clone().requires_grad_()
    return out
