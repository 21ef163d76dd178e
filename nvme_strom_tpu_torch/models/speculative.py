"""Speculative decoding: a small draft model proposes, the target
verifies k tokens per forward (counterpart of
nvme_strom_tpu/models/speculative.py).

Two acceptance schemes: :func:`speculative_generate` (greedy: the
emitted tokens are the target's own greedy decode, whatever the draft)
and :func:`speculative_sample` (rejection sampling: the emitted tokens
are distributed as sampling from the target at the requested
temperature and top_p).  The draft changes only how many target
forwards the output takes: a verify forward over k+1 positions costs
about what one decode step does, so an acceptance rate a saves about
a·k target steps a round.

The control loop runs on the host (acceptance counts are data
dependent).  The draft's k proposals are k ``decode_step`` calls, whose
attention inner is ``cache_attn`` (``ops.decode_attention
.decode_attention`` on the card: kernel 2); the target's verify is one
``block_step`` over the k+1 rows, the dense masked product, which the
decode kernel's single query row does not cover.  The caches are updated
in place and ``pos`` is a host int, so a rewind after a partial
acceptance only sets ``cache["pos"]``: positions past it are dead (every
mask tests ``<= pos``, and later writes overwrite them).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from nvme_strom_tpu_torch.models import decode as _dec
from nvme_strom_tpu_torch.models.transformer import TransformerConfig


@dataclass
class SpecStats:
    """Acceptance accounting for one generate call."""
    target_forwards: int = 0
    drafted: int = 0
    accepted: int = 0

    @property
    def accept_rate(self) -> float:
        return self.accepted / self.drafted if self.drafted else 0.0


def _draft_k(params: Dict, cache: Dict, cfg: TransformerConfig, k: int,
             tok: torch.Tensor, cache_attn=None):
    """k greedy draft steps → ((b, k) int32 tokens, cache)."""
    toks = []
    for _ in range(k):
        logits, cache = _dec.decode_step(params, tok, cfg, cache, cache_attn)
        tok = logits.argmax(-1).to(torch.int32)
        toks.append(tok)
    return torch.stack(toks, dim=1), cache


def _verify(params: Dict, cache: Dict, cfg: TransformerConfig,
            blk: torch.Tensor):
    """The model over the block → (greedy picks (b, m) int32, cache)."""
    logits, cache = _dec.block_step(params, blk, cfg, cache)
    return logits.argmax(-1).to(torch.int32), cache


def _warp(logits: torch.Tensor, temperature: float, top_p: float):
    warped = logits / temperature
    if top_p < 1.0:       # the no-op case pays no vocabulary sort
        warped = _dec.nucleus_truncate(warped, top_p)
    return warped


def _draft_k_probs(params: Dict, cache: Dict, cfg: TransformerConfig,
                   k: int, temperature: float, top_p: float,
                   tok: torch.Tensor, generator: torch.Generator,
                   cache_attn=None):
    """k sampled draft steps → (tokens (b, k), warped draft
    distributions (b, k, V) float32, cache).  Every step's whole
    distribution is kept: the residual draw reads the whole row."""
    toks, probs = [], []
    for _ in range(k):
        logits, cache = _dec.decode_step(params, tok, cfg, cache, cache_attn)
        p = torch.softmax(_warp(logits, temperature, top_p), dim=-1)
        tok = torch.multinomial(p, 1, generator=generator)[:, 0].to(
            torch.int32)
        toks.append(tok)
        probs.append(p)
    return torch.stack(toks, dim=1), torch.stack(probs, dim=1), cache


def _verify_probs(params: Dict, cache: Dict, cfg: TransformerConfig,
                  temperature: float, top_p: float, blk: torch.Tensor):
    """The target over the block → warped target distributions
    (b, m, V), with the draft's temperature and top_p (warp both, then
    accept-test)."""
    logits, cache = _dec.block_step(params, blk, cfg, cache)
    return torch.softmax(_warp(logits, temperature, top_p), dim=-1), cache


def _validate_spec(max_new_tokens: int, k: int, b: int) -> None:
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, "
                         f"got {max_new_tokens}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if b != 1:
        raise ValueError(f"speculative decode is batch-1 (got b={b})")


def _setup_caches(draft_params, target_params, prompt, cfg, dcfg,
                  max_new_tokens: int, k: int, st: SpecStats):
    """Prefill both models → (target logits, target cache, draft
    cache)."""
    b, s = prompt.shape
    cap = s + max_new_tokens + k + 1
    t_cache = _dec.init_cache(cfg, b, cap, device=prompt.device)
    d_cache = _dec.init_cache(dcfg, b, cap, device=prompt.device)
    t_logits, t_cache = _dec.prefill(target_params, prompt, cfg, t_cache)
    _, d_cache = _dec.prefill(draft_params, prompt, dcfg, d_cache)
    st.target_forwards += 1
    return t_logits, t_cache, d_cache


def _catch_up_and_rewind(draft_params, dcfg, drafts, n_acc, kk,
                         t_cache, d_cache, t_pos, d_pos, n_emitted):
    """The caches after a round hold every emitted token but the newest
    (it enters with the next round's block).  The target took the whole
    kk+1 block; the draft took up to draft kk-1, so a full acceptance
    leaves it one token short: it takes draft kk (picks discarded)."""
    if n_acc == kk:
        _, d_cache = _verify(draft_params, d_cache, dcfg, drafts[:, -1:])
    t_cache["pos"] = t_pos + n_emitted
    d_cache["pos"] = d_pos + n_emitted
    return t_cache, d_cache


def _finalize(out, max_new_tokens: int, eos_id, pad_id: int,
              device) -> torch.Tensor:
    """eos trim and right-pad to (1, max_new_tokens) int32."""
    out = out[:max_new_tokens]
    if eos_id is not None and eos_id in out:
        cut = out.index(eos_id) + 1
        out = out[:cut] + [pad_id] * (max_new_tokens - cut)
    out += [pad_id] * (max_new_tokens - len(out))
    return torch.tensor([out], dtype=torch.int32, device=device)


def speculative_generate(draft_params: Dict, target_params: Dict,
                         prompt: torch.Tensor, cfg: TransformerConfig,
                         max_new_tokens: int, k: int = 4,
                         draft_cfg: Optional[TransformerConfig] = None,
                         eos_id: Optional[int] = None, pad_id: int = 0,
                         stats: Optional[SpecStats] = None,
                         cache_attn=None) -> torch.Tensor:
    """Greedy generation by draft-k / verify: the tokens of
    ``decode.generate(target_params, ...)`` at temperature 0.

    prompt (1, s) → (1, max_new_tokens) int32, on the prompt's device.
    Batch 1 only: acceptance lengths are per sequence and the caches
    share one position.  ``draft_cfg`` defaults to ``cfg``; the draft
    must share the target's vocabulary.  ``stats`` collects the
    acceptance accounting; ``cache_attn`` is the draft steps' attention
    inner (``decode_step``'s), the dense path by default."""
    _validate_spec(max_new_tokens, k, prompt.shape[0])
    dcfg = draft_cfg or cfg
    st = stats if stats is not None else SpecStats()
    t_logits, t_cache, d_cache = _setup_caches(
        draft_params, target_params, prompt, cfg, dcfg, max_new_tokens, k,
        st)
    dev = prompt.device
    out = [int(t_logits.argmax(-1)[0])]
    while len(out) < max_new_tokens:
        if eos_id is not None and out[-1] == eos_id:
            break
        tok = torch.tensor([out[-1]], dtype=torch.int32, device=dev)
        t_pos, d_pos = t_cache["pos"], d_cache["pos"]
        kk = min(k, max_new_tokens - len(out))
        drafts, d_cache = _draft_k(draft_params, d_cache, dcfg, kk, tok,
                                   cache_attn)
        # the verify block [current token, d_1 .. d_kk]: pick t is the
        # target's choice after row t, so pick kk is the bonus token
        # when every draft is accepted
        blk = torch.cat([tok[:, None], drafts], dim=1)
        picks, t_cache = _verify(target_params, t_cache, cfg, blk)
        st.target_forwards += 1
        st.drafted += kk
        # one device→host fetch for both, not 2·kk scalar reads
        both = torch.cat([drafts[0], picks[0]]).cpu().tolist()
        drafts_h, picks_h = both[:kk], both[kk:]
        n_acc = 0
        while n_acc < kk and picks_h[n_acc] == drafts_h[n_acc]:
            n_acc += 1
        st.accepted += n_acc
        # the accepted drafts and the target's pick at row n_acc: the
        # correction on a mismatch, the bonus on a full acceptance
        emitted = drafts_h[:n_acc] + [picks_h[n_acc]]
        out.extend(emitted)
        t_cache, d_cache = _catch_up_and_rewind(
            draft_params, dcfg, drafts, n_acc, kk, t_cache, d_cache, t_pos,
            d_pos, len(emitted))
    return _finalize(out, max_new_tokens, eos_id, pad_id, dev)


def speculative_sample(draft_params: Dict, target_params: Dict,
                       prompt: torch.Tensor, cfg: TransformerConfig,
                       max_new_tokens: int, temperature: float,
                       k: int = 4, top_p: float = 1.0, seed: int = 0,
                       draft_cfg: Optional[TransformerConfig] = None,
                       eos_id: Optional[int] = None, pad_id: int = 0,
                       stats: Optional[SpecStats] = None,
                       cache_attn=None) -> torch.Tensor:
    """Speculative sampling (the rejection scheme): the emitted tokens
    are distributed as sampling from the target at ``temperature`` and
    ``top_p``.

    A round: the draft samples k tokens from its warped distribution q;
    one target forward gives p at every position; token x_i is accepted
    with probability min(1, p_i(x_i) / q_i(x_i)), and the first
    rejection emits a draw from the residual norm(max(p_i − q_i, 0));
    a full acceptance draws a bonus token from p_{k+1}.  The accept
    tests and the residual and bonus draws run on host rows from
    ``np.random.default_rng(seed & 0xFFFFFFFF)``; the draft draws from
    a ``torch.Generator`` seeded ``(seed ^ 0x5EED) & 0xFFFFFFFF`` on the
    prompt's device.  ``temperature`` must be > 0 (0 is
    :func:`speculative_generate`).  Reproducible per ``seed`` on one
    device."""
    if temperature <= 0:
        raise ValueError(
            "speculative_sample needs temperature > 0; temperature 0 "
            "is speculative_generate's greedy acceptance")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    _validate_spec(max_new_tokens, k, prompt.shape[0])
    dcfg = draft_cfg or cfg
    st = stats if stats is not None else SpecStats()
    dev = prompt.device
    rng = np.random.default_rng(seed & 0xFFFFFFFF)
    gen = torch.Generator(device=dev).manual_seed(
        (seed ^ 0x5EED) & 0xFFFFFFFF)

    def host_draw(p_row) -> int:
        p_row = np.clip(np.asarray(p_row, np.float64), 0, None)
        tot = p_row.sum()
        if tot <= 0:                    # a fully truncated row: greedy
            return int(p_row.argmax())
        return int(rng.choice(p_row.shape[0], p=p_row / tot))

    t_logits, t_cache, d_cache = _setup_caches(
        draft_params, target_params, prompt, cfg, dcfg, max_new_tokens, k,
        st)
    first_p = torch.softmax(_warp(t_logits, float(temperature),
                                  float(top_p)), dim=-1)
    out = [host_draw(first_p[0].cpu().numpy())]
    while len(out) < max_new_tokens:
        if eos_id is not None and out[-1] == eos_id:
            break
        tok = torch.tensor([out[-1]], dtype=torch.int32, device=dev)
        t_pos, d_pos = t_cache["pos"], d_cache["pos"]
        kk = min(k, max_new_tokens - len(out))
        drafts, q, d_cache = _draft_k_probs(
            draft_params, d_cache, dcfg, kk, float(temperature),
            float(top_p), tok, gen, cache_attn)
        blk = torch.cat([tok[:, None], drafts], dim=1)
        p, t_cache = _verify_probs(target_params, t_cache, cfg,
                                   float(temperature), float(top_p), blk)
        st.target_forwards += 1
        st.drafted += kk
        # one device→host fetch of the round's tokens and distributions
        V = p.shape[-1]
        flat = torch.cat([drafts[0].to(torch.float32), q[0].reshape(-1),
                          p[0].reshape(-1)]).cpu().numpy()
        drafts_h = flat[:kk].astype(np.int64).tolist()
        q_h = flat[kk:kk + kk * V].reshape(kk, V)
        p_h = flat[kk + kk * V:].reshape(kk + 1, V)
        emitted = []
        n_acc = 0
        for i in range(kk):
            x = drafts_h[i]
            qx = float(q_h[i, x])
            px = float(p_h[i, x])
            if qx <= 0 or rng.random() < min(1.0, px / qx):
                emitted.append(x)
                n_acc += 1
                continue
            # the residual draw makes the output law exactly p
            emitted.append(host_draw(np.maximum(p_h[i] - q_h[i], 0.0)))
            break
        else:
            emitted.append(host_draw(p_h[kk]))   # the bonus from p_{k+1}
        st.accepted += n_acc
        out.extend(emitted)
        t_cache, d_cache = _catch_up_and_rewind(
            draft_params, dcfg, drafts, n_acc, kk, t_cache, d_cache, t_pos,
            d_pos, len(emitted))
    return _finalize(out, max_new_tokens, eos_id, pad_id, dev)
