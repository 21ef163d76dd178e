"""Autoregressive decoding with a KV cache (counterpart of
nvme_strom_tpu/models/decode.py).

The cache is ``{"k", "v": (n_layers, b, n_kv_heads, max_len, head_dim),
"pos": int}``, updated IN PLACE (the JAX version returns new arrays);
``pos`` counts the valid positions and lives on the host.  GQA keeps the
cache at kv-head width.  Sampling draws from an explicit
``torch.Generator``; greedy decoding takes the exact argmax.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from nvme_strom_tpu_torch.models.transformer import (
    TransformerConfig, attention, embed, expand_gqa, mlp_block, qkv_project,
    rms_norm, wmat)


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device=None) -> Dict:
    """Empty KV cache; callers push at most ``max_len`` positions."""
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "pos": 0}


def _lm_head(params, x: torch.Tensor, cfg: TransformerConfig):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x @ wmat(params, "lm_head", x.dtype)).float()


def prefill(params: Dict, tokens: torch.Tensor, cfg: TransformerConfig,
            cache: Dict, last: Optional[int] = None):
    """The prompt tokens (b, s) through the model, filling
    ``cache[..., :s]``.  Returns logits (b, vocab) float32 at position
    ``last`` (default s-1) and the cache."""
    b, s = tokens.shape
    x = embed(params, tokens, cfg)
    positions = torch.arange(s, dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        L = f"layers.{i}."
        h = rms_norm(x, params[L + "attn_norm"], cfg.norm_eps)
        a, k, v = attention(h, params, L, cfg, positions=positions,
                            return_kv=True)
        cache["k"][i, :, :, :s] = k.to(cfg.dtype)
        cache["v"][i, :, :, :s] = v.to(cfg.dtype)
        x = x + a
        h = rms_norm(x, params[L + "mlp_norm"], cfg.norm_eps)
        x = (x + mlp_block(h, params, L, cfg)).to(cfg.dtype)
    cache["pos"] = s
    return _lm_head(params, x[:, s - 1 if last is None else last], cfg), \
        cache


def cache_attention(q, ck, cv, limit: torch.Tensor, cfg: TransformerConfig):
    """Masked attention of an m-row query block over a live cache.
    q (b, nh, m, hd); ck/cv kv-width (b, nkv, S, hd); limit (b, m): row
    t of batch b attends cache positions <= limit[b, t]."""
    S = ck.shape[2]
    scores = (q.float() @ expand_gqa(ck, cfg).float().transpose(-1, -2)) \
        / math.sqrt(cfg.head_dim)
    valid = (torch.arange(S, device=q.device)[None, None, None, :]
             <= limit[:, None, :, None])
    scores = scores.masked_fill(~valid, -1e30)
    cve = expand_gqa(cv, cfg)
    probs = torch.softmax(scores, dim=-1).to(cve.dtype)
    return probs @ cve


def decode_step(params: Dict, token: torch.Tensor, cfg: TransformerConfig,
                cache: Dict, cache_attn=None):
    """One incremental step: token (b,) at position ``cache['pos']``.
    Returns next-token logits (b, vocab) float32 and the cache.
    ``cache_attn(q, k_cache, v_cache, pos) -> (b, nh, 1, hd)`` swaps
    the attention inner (e.g. ``ops.decode_attention.decode_attention``);
    it receives the cache at kv-head width.  The default is the masked
    dense path of :func:`block_step`."""
    if cache_attn is None:
        logits, cache = block_step(params, token[:, None], cfg, cache)
        return logits[:, 0], cache
    b = token.shape[0]
    pos = cache["pos"]
    x = embed(params, token[:, None], cfg)
    positions = torch.full((1,), pos, dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        L = f"layers.{i}."
        h = rms_norm(x, params[L + "attn_norm"], cfg.norm_eps)
        q, k, v = qkv_project(h, params, L, cfg, positions)
        cache["k"][i, :, :, pos:pos + 1] = k.to(cfg.dtype)
        cache["v"][i, :, :, pos:pos + 1] = v.to(cfg.dtype)
        a = cache_attn(q.contiguous(), cache["k"][i], cache["v"][i], pos)
        a = a.transpose(1, 2).reshape(b, 1, -1)
        x = x + a @ wmat(params, L + "wo", a.dtype)
        h = rms_norm(x, params[L + "mlp_norm"], cfg.norm_eps)
        x = (x + mlp_block(h, params, L, cfg)).to(cfg.dtype)
    cache["pos"] = pos + 1
    return _lm_head(params, x[:, 0], cfg), cache


def block_step(params: Dict, tokens: torch.Tensor, cfg: TransformerConfig,
               cache: Dict, last: Optional[int] = None):
    """Tokens (b, m) enter the cache at positions pos..pos+m-1; row t
    attends the cache up to pos+t.  Returns logits (b, m, vocab) — or
    (b, vocab) at row ``last`` — and the cache with pos += m."""
    b, m = tokens.shape
    pos = cache["pos"]
    x = embed(params, tokens, cfg)
    dev = x.device
    positions = pos + torch.arange(m, dtype=torch.float32, device=dev)
    limit = (pos + torch.arange(m, device=dev)).expand(b, m)
    for i in range(cfg.n_layers):
        L = f"layers.{i}."
        h = rms_norm(x, params[L + "attn_norm"], cfg.norm_eps)
        q, k, v = qkv_project(h, params, L, cfg, positions)
        cache["k"][i, :, :, pos:pos + m] = k.to(cfg.dtype)
        cache["v"][i, :, :, pos:pos + m] = v.to(cfg.dtype)
        a = cache_attention(q, cache["k"][i], cache["v"][i], limit, cfg)
        a = a.transpose(1, 2).reshape(b, m, -1)
        x = x + a @ wmat(params, L + "wo", a.dtype)
        h = rms_norm(x, params[L + "mlp_norm"], cfg.norm_eps)
        x = (x + mlp_block(h, params, L, cfg)).to(cfg.dtype)
    cache["pos"] = pos + m
    if last is not None:
        x = x[:, last]
    return _lm_head(params, x, cfg), cache


def nucleus_truncate(logits: torch.Tensor, top_p) -> torch.Tensor:
    """Logits outside the smallest sorted prefix whose probability
    reaches ``top_p`` (float or per-row tensor) become -inf; the first
    token is always kept."""
    top_p = torch.as_tensor(top_p, dtype=torch.float32,
                            device=logits.device)
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    keep = torch.cumsum(probs, dim=-1) - probs < top_p[..., None]
    cutoff = torch.where(keep, sorted_logits,
                         torch.full_like(sorted_logits, math.inf)
                         ).min(dim=-1, keepdim=True).values
    return logits.masked_fill(logits < cutoff, -math.inf)


def _sample(logits: torch.Tensor, temperature: float,
            generator: Optional[torch.Generator], top_k: int = 0,
            top_p: float = 1.0) -> torch.Tensor:
    """Greedy (temperature 0) or categorical sampling with optional
    top-k / nucleus truncation."""
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    logits = logits / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, -math.inf)
    if top_p < 1.0:
        logits = nucleus_truncate(logits, top_p)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[..., 0]


def generate(params: Dict, prompt: torch.Tensor, cfg: TransformerConfig,
             max_new_tokens: int, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             eos_id: Optional[int] = None, pad_id: int = 0,
             cache_attn=None, top_k: int = 0, top_p: float = 1.0
             ) -> torch.Tensor:
    """prompt (b, s) → (b, max_new_tokens) token ids.  After ``eos_id``
    a row emits ``pad_id`` (the eos itself is emitted)."""
    b, s = prompt.shape
    if top_k < 0 or not 0.0 < top_p <= 1.0:
        raise ValueError(f"bad top_k={top_k} / top_p={top_p}")
    cache = init_cache(cfg, b, s + max_new_tokens, device=prompt.device)
    logits, cache = prefill(params, prompt, cfg, cache)
    tok = _sample(logits, temperature, generator, top_k, top_p)
    done = (torch.zeros(b, dtype=torch.bool, device=prompt.device)
            if eos_id is None else tok == eos_id)
    out = [tok]
    for _ in range(max_new_tokens - 1):
        logits, cache = decode_step(params, tok, cfg, cache, cache_attn)
        tok = _sample(logits, temperature, generator, top_k, top_p)
        if eos_id is not None:
            tok = torch.where(done, torch.full_like(tok, pad_id), tok)
            done = done | (tok == eos_id)
        out.append(tok)
    return torch.stack(out, dim=1)
