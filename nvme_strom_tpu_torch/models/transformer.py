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
(models/quant.py) dequantize in ``wmat`` and multiply in :func:`project`
(on the card through ops/quant_matmul.py's kernels); training takes
full-precision weights only.

Tensor parallelism (parallel/shardings.py ``param_specs``): inside
``collectives.use_mesh(mesh)`` the parameters are this rank's slices and
each layer runs Megatron's scheme with explicit collectives.  q / k / v,
gate and up are column-parallel on the local heads and features, their
input entering through ``copy_to``; ``wo`` and ``w_down`` are
row-parallel, summed over ``tp`` by ``reduce_from``; the token
embedding's feature slice is gathered; the lm_head's vocabulary slice
feeds a vocabulary-parallel cross-entropy, or is gathered into whole
logits.  Head counts come from the local weights' widths, so the same
code runs every tp size.  Without a mesh none of this runs.

Sequence parallelism (``sp``, parallel/ring_attention.py and
parallel/ulysses.py): each rank forwards its span of every sequence,
RoPE at the span's absolute positions; attention is the ``attn_fn``
(``make_ring_attn`` or ``make_ulysses_attn``), or the dense ring without
one; the next-token loss takes each span's last target from the next
rank and counts the whole sequence (:func:`next_token_targets`).  The
parameters are replicated over ``sp``, so their gradients are summed
over it.  MoE layers under ``sp`` run in the pipeline only
(parallel/pipeline.py).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from nvme_strom_tpu_torch.models import moe as _moe
from nvme_strom_tpu_torch.ops import quant_matmul as _qmm
from nvme_strom_tpu_torch.parallel import collectives as _coll


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
    of the full weight's size in ``dtype``: on the card written by the
    ``dequant`` kernel (ops/quant_matmul.py), on the CPU by its plain
    torch ops.  A product ``x @ W`` takes :func:`project`, which never
    writes W on the card at decode widths."""
    w = p[name]
    if isinstance(w, dict):
        return _qmm.dequant(w, dtype)
    return w if w.dtype == dtype else w.to(dtype)


def project(x: torch.Tensor, p, name: str) -> torch.Tensor:
    """``x @ W`` of the named matmul weight in x's dtype.  A plain tensor
    is ``x @ w``; a quantized leaf goes through ops/quant_matmul.py
    ``quant_matmul``: on the card the fused GEMV for up to
    ``QUANT_GEMV_MAX_ROWS`` rows of x, the ``dequant`` kernel and a
    matmul past them; on the CPU ``x @ wmat(...)``'s torch ops."""
    w = p[name]
    if isinstance(w, dict):
        return _qmm.quant_matmul(x, w)
    return x @ (w if w.dtype == x.dtype else w.to(x.dtype))


def qkv_project(x: torch.Tensor, p, prefix: str, cfg: TransformerConfig,
                positions: torch.Tensor):
    """q (b, nh, s, hd) and post-RoPE k / v at kv-head width
    (b, nkv, s, hd).  ``positions``: float32 (s,) or per-row (b, s)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    x = _coll.copy_to(x, _coll.tp_group())
    q = project(x, p, prefix + "wq").view(b, s, -1, hd)
    k = project(x, p, prefix + "wk").view(b, s, -1, hd)
    v = project(x, p, prefix + "wv").view(b, s, -1, hd)
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
    sp = _coll.sp_group()
    if positions is None:
        # under sp this rank holds positions [r·s, (r + 1)·s)
        positions = (torch.arange(s, dtype=torch.float32, device=x.device)
                     + _coll.group_rank(sp) * s)
    q, k, v = qkv_project(x, p, prefix, cfg, positions)
    if attn_fn is None and sp is not None:
        from nvme_strom_tpu_torch.parallel.ring_attention import ring_block
        attn_fn = functools.partial(ring_block, group=sp)
    if attn_fn is None:
        # back to projection layout: free views of the projections
        out = dense_causal_attention_grouped(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    else:
        out = attn_fn(q, expand_gqa(k, cfg), expand_gqa(v, cfg))
        out = out.transpose(1, 2).reshape(b, s, -1)
    out = row_parallel(out, p, prefix + "wo")
    return (out, k, v) if return_kv else out


def row_parallel(x, p, name: str) -> torch.Tensor:
    """``x @ w`` of a row-parallel weight, summed over ``tp``."""
    return _coll.reduce_from(project(x, p, name), _coll.tp_group())


def mlp(x, p, prefix) -> torch.Tensor:
    x = _coll.copy_to(x, _coll.tp_group())
    gate = F.silu(project(x, p, prefix + "w_gate"))
    up = project(x, p, prefix + "w_up")
    return row_parallel(gate * up, p, prefix + "w_down")


def mlp_block(h, p, prefix: str, cfg: TransformerConfig) -> torch.Tensor:
    """The layer's MLP, dense or MoE by its index in ``prefix``
    (``layers.<i>.``); the one dispatch every inference path shares.
    The MoE aux loss is dropped: inference has no use for it."""
    if cfg.is_moe_layer(int(prefix.split(".")[1])):
        return _moe.moe_mlp(h, p, prefix, cfg)[0]
    return mlp(h, p, prefix)


def embed(p, tokens: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    return _coll.gather_from(F.embedding(tokens.long(), p["tok_embed"]),
                             _coll.tp_group()).to(cfg.dtype)


def lm_logits(x: torch.Tensor, p, gather: bool = True) -> torch.Tensor:
    """float32 logits of ``x`` through the lm_head: whole, or with
    ``gather=False`` this rank's vocabulary slice under tp."""
    g = _coll.tp_group()
    logits = project(_coll.copy_to(x, g), p, "lm_head").float()
    return _coll.gather_from(logits, g) if gather else logits


def _vocab_start(p) -> int:
    """The first vocabulary column of this rank's lm_head slice."""
    return _coll.group_rank(_coll.tp_group()) * p["lm_head"].shape[-1] \
        if not isinstance(p["lm_head"], dict) else 0


# ----------------------------- training -----------------------------

REMAT_POLICIES = ("none", "full", "dots", "nvme")

#: the products ``dots`` keeps: the weight matmuls, which reach aten as
#: a 2-D ``mm`` / ``addmm`` after ``x @ w`` folds (b, s, d) to (b·s, d)
#: (JAX's ``dots_with_no_batch_dims_saveable``); attention's batched
#: products, the norms and the activations are recomputed
_DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS_SAVED
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return create_selective_checkpoint_contexts(_dots_policy)


def _remat_policy(cfg: TransformerConfig) -> str:
    policy = cfg.remat_policy
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {policy!r}: expected "
                         f"{'|'.join(REMAT_POLICIES)}")
    return policy


def layer_body(p: Dict, x: torch.Tensor, i: int, cfg: TransformerConfig,
               attn_fn=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decoder layer ``i`` on x (b, s, d) with the parameters in ``p``
    (every name the layer reads): (output, MoE aux loss, 0 when
    dense)."""
    L = f"layers.{i}."
    x = x + attention(rms_norm(x, p[L + "attn_norm"], cfg.norm_eps),
                      p, L, cfg, attn_fn)
    h = rms_norm(x, p[L + "mlp_norm"], cfg.norm_eps)
    if cfg.is_moe_layer(i):
        h, a = _moe.moe_mlp(h, p, L, cfg)
    else:
        h = mlp(h, p, L)
        a = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + h, a


def forward_hidden(params: Dict, tokens: torch.Tensor,
                   cfg: TransformerConfig, attn_fn=None, act_store=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (b, s) → (final-norm hidden (b, s, d) in cfg.dtype,
    aux_loss scalar), everything short of the lm_head.  aux_loss is the
    summed MoE load-balancing loss, 0 for a dense model.

    ``remat_policy``: ``full`` recomputes each layer in the backward
    (``torch.utils.checkpoint``); ``dots`` keeps the weight products'
    outputs and recomputes the rest (selective checkpointing);
    ``nvme`` needs ``act_store`` (parallel/act_offload.py
    ``ActivationStore``): each layer's input lives on NVMe between
    forward and backward, and the backward recomputes the layer from the
    bytes read back, so activations take one layer's worth of device
    memory whatever the depth."""
    policy = _remat_policy(cfg)
    if _coll.sp_group() is not None and cfg.n_experts > 0:
        # the JAX model routes whole rows here; a span's routing groups
        # would be other ones (the pipeline routes spans, as its JAX
        # counterpart does)
        raise ValueError("MoE layers under sp run in the pipeline only "
                         "(parallel/pipeline.py)")
    x = _coll.gather_from(wmat(params, "tok_embed", cfg.dtype)[tokens.long()],
                          _coll.tp_group())
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if policy == "nvme":
        if act_store is None:
            raise ValueError("remat_policy='nvme' needs an act_store= "
                             "(parallel/act_offload.ActivationStore)")
        from nvme_strom_tpu_torch.parallel.act_offload import offload_layer
        for i in range(cfg.n_layers):
            L = f"layers.{i}."
            lp = {k: v for k, v in params.items() if k.startswith(L)}
            x, a = offload_layer(
                lambda p, h, i=i: layer_body(p, h, i, cfg, attn_fn),
                act_store, i, lp, x)
            aux = aux + a
        return rms_norm(x, params["final_norm"], cfg.norm_eps), aux

    def layer(x, i):
        return layer_body(params, x, i, cfg, attn_fn)

    for i in range(cfg.n_layers):
        if policy == "full":
            x, a = checkpoint(layer, x, i, use_reentrant=False)
        elif policy == "dots":
            x, a = checkpoint(layer, x, i, use_reentrant=False,
                              context_fn=_dots_context)
        else:
            x, a = layer(x, i)
        aux = aux + a
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def forward_with_aux(params: Dict, tokens: torch.Tensor,
                     cfg: TransformerConfig, attn_fn=None, act_store=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (b, s) → (logits (b, s, vocab) float32, aux_loss)."""
    x, aux = forward_hidden(params, tokens, cfg, attn_fn,
                            act_store=act_store)
    return lm_logits(x, params), aux


def forward(params: Dict, tokens: torch.Tensor, cfg: TransformerConfig,
            attn_fn=None) -> torch.Tensor:
    """tokens (b, s) → logits (b, s, vocab) float32."""
    return forward_with_aux(params, tokens, cfg, attn_fn)[0]


def _chunk_nll(h, w, t, wt, group=None, start=0):
    if group is not None:
        nll = _coll.vocab_parallel_xent(
            (_coll.copy_to(h, group) @ w).float(), t, group, start)
        return (nll * wt).sum()
    logits = (h @ w).float()                        # (b, c, vocab)
    lse = torch.logsumexp(logits, dim=-1)
    tl = logits.gather(-1, t[..., None])[..., 0]
    return ((lse - tl) * wt).sum()


def next_token_targets(tokens: torch.Tensor):
    """(targets, weights, count) of the next-token loss over tokens
    (b, s): each position's next token with weight 1 float32, the
    sequence's last position target 0 with weight 0; ``count`` the
    predicted positions, b·(S − 1).  Under sp (the current
    ``use_mesh``) tokens are this rank's span of the sequence S: a
    span's last position predicts the next span's first token, received
    from the next rank, and only the last span's last position has
    weight 0."""
    tokens = tokens.long()
    b, s = tokens.shape
    sp = _coll.sp_group()
    n, r = _coll.group_size(sp), _coll.group_rank(sp)
    last = (_coll.ppermute(tokens[:, :1].contiguous(), sp, shift=-1)
            if sp is not None else tokens.new_zeros(b, 1))
    targets = torch.cat([tokens[:, 1:], last], dim=1)
    weights = torch.ones(b, s, dtype=torch.float32, device=tokens.device)
    if r == n - 1:
        weights[:, -1] = 0.0
    return targets, weights, b * (s * n - 1)


def nll_sum(hidden: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
            weights: torch.Tensor, chunks: int = 1, group=None,
            start: int = 0) -> torch.Tensor:
    """Σ weight · NLL of ``hidden`` (b, s, d) through the lm_head ``w``
    (this rank's vocabulary columns from ``start`` under a tp
    ``group``).  ``chunks`` > 1 cuts the sequence into that many slices,
    each projected and reduced under one ``torch.utils.checkpoint`` (its
    logits are recomputed in the backward), so (b, s, vocab) logits
    never exist at once."""
    if chunks <= 1:
        return _chunk_nll(hidden, w, targets, weights, group, start)
    s = hidden.shape[1]
    if s % chunks:
        raise ValueError(f"xent_chunks={chunks} must divide the sequence "
                         f"length {s}")
    c = s // chunks
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(chunks):
        sl = slice(i * c, (i + 1) * c)
        total = total + checkpoint(_chunk_nll, hidden[:, sl], w,
                                   targets[:, sl], weights[:, sl], group,
                                   start, use_reentrant=False)
    return total


def chunked_xent(params: Dict, hidden: torch.Tensor, tokens: torch.Tensor,
                 cfg: TransformerConfig) -> torch.Tensor:
    """Mean next-token NLL without materialising (b, s, vocab): the
    sequence cut into ``cfg.xent_chunks`` slices (:func:`nll_sum`).
    Targets and weights are :func:`next_token_targets`' (under sp, this
    span's share of the mean)."""
    targets, weights, count = next_token_targets(tokens)
    return nll_sum(hidden, wmat(params, "lm_head", hidden.dtype), targets,
                   weights, cfg.xent_chunks, _coll.tp_group(),
                   _vocab_start(params)) / count


def loss_fn(params: Dict, tokens: torch.Tensor, cfg: TransformerConfig,
            attn_fn=None, act_store=None) -> torch.Tensor:
    """Next-token cross-entropy; tokens are input and target.  The full
    sequence is forwarded and the last logit dropped.  ``xent_chunks``
    > 1, and sp, take :func:`chunked_xent`.  The MoE aux loss is added
    times ``router_aux_coef``.  ``act_store`` serves
    ``remat_policy="nvme"`` (see :func:`forward_hidden`).  Under sp (the
    current ``use_mesh``) tokens are this rank's span and the loss is the
    span's share of the mean over the whole sequence
    (:func:`next_token_targets`): the shares add over ``sp``."""
    if cfg.xent_chunks > 1 or _coll.sp_group() is not None:
        hidden, aux = forward_hidden(params, tokens, cfg, attn_fn,
                                     act_store=act_store)
        return (chunked_xent(params, hidden, tokens, cfg)
                + cfg.router_aux_coef * aux)
    group = _coll.tp_group()
    if group is not None:
        hidden, aux = forward_hidden(params, tokens, cfg, attn_fn,
                                     act_store=act_store)
        nll = _coll.vocab_parallel_xent(
            lm_logits(hidden[:, :-1], params, gather=False),
            tokens[:, 1:], group, _vocab_start(params))
        return nll.mean() + cfg.router_aux_coef * aux
    logits, aux = forward_with_aux(params, tokens, cfg, attn_fn,
                                   act_store=act_store)
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    ll = logp.gather(-1, tokens[:, 1:].long()[..., None])
    return -ll.mean() + cfg.router_aux_coef * aux


def value_and_grad(params: Dict, tokens: torch.Tensor,
                   cfg: TransformerConfig, attn_fn=None, act_store=None):
    """(loss, {name: gradient}) of :func:`loss_fn` at ``params``."""
    names = list(params)
    loss = loss_fn(params, tokens, cfg, attn_fn, act_store=act_store)
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


def _sq_norm(grads: Dict[str, torch.Tensor], shardings=None
             ) -> torch.Tensor:
    """Σ g² over every gradient of the global model.  With
    ``shardings`` (parallel/shardings.py, gradients this rank's slices,
    already averaged over ``dp``) each distinct slice counts once: a
    rank adds a slice only where it is the first of its replicas among
    the ranks of its ``dp`` block, and the sum is all-reduced over the
    mesh's other axes."""
    if not shardings:
        return sum(g.float().square().sum() for g in grads.values())
    mesh = next(iter(shardings.values())).mesh
    mp = tuple(a for a in mesh.axis_names if a != "dp")
    total = None
    for n, g in grads.items():
        used = {a for e in shardings[n].spec if e is not None
                for a in ((e,) if isinstance(e, str) else e)}
        if any(mesh.coords[a] for a in mp if a not in used):
            continue                # a replica another rank counts
        sq = g.float().square().sum()
        total = sq if total is None else total + sq
    if total is None:
        total = torch.zeros((), dtype=torch.float32,
                            device=next(iter(grads.values())).device)
    return _coll.all_reduce(total.reshape(1), mesh.group(mp))[0]


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float,
                        shardings=None) -> Dict[str, torch.Tensor]:
    """``optax.clip_by_global_norm``: with ‖g‖ the L2 norm over every
    gradient, each becomes ``g / ‖g‖ * max_norm`` unless ‖g‖ <
    ``max_norm``.  (``torch.nn.utils.clip_grad_norm_`` divides by ‖g‖ +
    1e-6, which is another function.)  Under a mesh, ``shardings``
    names each gradient's slice, so ‖g‖ is the whole model's norm on
    every rank (:func:`_sq_norm`)."""
    norm = torch.sqrt(_sq_norm(grads, shardings))
    if bool(norm < max_norm):
        return grads
    return {n: g / norm.to(g.dtype) * max_norm for n, g in grads.items()}


def lr_schedule(lr: float, kind: str = "constant", warmup_steps: int = 0,
                total_steps: int = 0):
    """The learning rate at each optimizer step, as the JAX
    ``train_lm`` builds it with optax: a linear warmup from 0 over
    ``warmup_steps``, then ``constant``, or ``cosine`` decay to 10% of
    ``lr`` at step max(total_steps, warmup_steps + 1).  A plain float
    when there is neither warmup nor decay, else ``fn(count) -> float``
    computed in float32 as optax does; ``count`` is the number of
    updates already taken (an optimizer's step count, so a resumed run
    continues the schedule)."""
    if kind not in ("constant", "cosine"):
        raise ValueError(f"lr schedule {kind!r}: expected constant|cosine")
    if kind == "constant" and warmup_steps <= 0:
        return float(lr)
    f32 = np.float32
    peak = f32(lr)
    decay = max(total_steps, warmup_steps + 1) - warmup_steps

    def warm(c):
        if warmup_steps <= 0:
            return f32(0.0)
        frac = f32(1) - f32(min(max(c, 0), warmup_steps)) / f32(warmup_steps)
        return (f32(0.0) - peak) * frac + peak

    def after(c):
        if kind == "constant":
            return peak
        alpha = 0.1                     # end_value / peak_value
        t = f32(min(float(c), float(decay)))
        cos = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * t / f32(decay)))
        return peak * (f32(1 - alpha) * cos + f32(alpha))

    def schedule(count: int) -> float:
        count = int(count)
        return float(warm(count) if count < warmup_steps
                     else after(count - warmup_steps))

    return schedule


def optimizer_count(optimizer: torch.optim.Optimizer) -> int:
    """Updates a torch optimizer has taken (its per-parameter ``step``,
    which a checkpoint restores); 0 before the first."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            step = optimizer.state.get(p, {}).get("step")
            if step is not None:
                return int(step)
    return 0


def apply_gradients(optimizer: torch.optim.Optimizer, params: Dict,
                    grads: Dict, lr=None, grad_clip: float = 0.0,
                    shardings=None) -> None:
    """One optimizer update of the tensors in ``params`` ({name: tensor})
    from ``grads`` (same names): clipped to ``grad_clip`` global norm
    first when it is > 0 (:func:`clip_by_global_norm`, over the slices
    ``shardings`` names under a mesh), and with ``lr`` (a float, or
    ``fn(count)`` from :func:`lr_schedule`) set on every parameter
    group when given."""
    if grad_clip > 0:
        grads = clip_by_global_norm(grads, grad_clip, shardings)
    if lr is not None:
        value = lr(optimizer_count(optimizer)) if callable(lr) else lr
        for group in optimizer.param_groups:
            group["lr"] = value
    for n, p in params.items():
        p.grad = grads[n].to(p.dtype)
    optimizer.step()


def make_train_step(cfg: TransformerConfig, optimizer, attn_fn=None,
                    accum_steps: int = 1, act_store=None, lr=None,
                    grad_clip: float = 0.0, mesh=None, shardings=None):
    """``step(params, tokens) -> loss``: gradients of the mean loss over
    ``accum_steps`` microbatches, then one ``optimizer.step()`` through
    :func:`apply_gradients` (``lr`` and ``grad_clip`` as there).
    ``optimizer`` is a torch optimizer over ``params``' tensors, which
    it updates in place (where the JAX step returns new params).
    ``act_store``: the NVMe activation store of ``remat_policy="nvme"``.

    Under a ``mesh`` (parallel/mesh.py) ``params`` are this rank's
    slices (``shardings``, parallel/shardings.py ``param_shardings``)
    and ``tokens`` its ``dp`` block of the batch (with ``sp``, its span
    of that block's sequences): the model runs inside ``use_mesh(mesh)``,
    the gradients and the loss are summed over ``sp`` and averaged over
    ``dp`` (``collectives.mesh_mean_``), and the returned loss is the
    whole batch's."""

    def step(params: Dict, tokens: torch.Tensor) -> torch.Tensor:
        with _coll.use_mesh(mesh):
            loss, grads = accumulate_grads(
                lambda mb: value_and_grad(params, mb, cfg, attn_fn,
                                          act_store=act_store), params,
                tokens, accum_steps)
        if mesh is not None and mesh.group(("dp", "sp")) is not None:
            loss = loss.reshape(1).clone()
            _coll.mesh_mean_(list(grads.values()) + [loss], mesh)
            loss = loss[0]
        with _coll.use_mesh(mesh):
            apply_gradients(optimizer, params, grads, lr=lr,
                            grad_clip=grad_clip, shardings=shardings)
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
