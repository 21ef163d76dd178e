"""Mixture-of-experts SwiGLU MLP (counterpart of
nvme_strom_tpu/models/moe.py), GShard/Switch-style dense dispatch.

Routing is one-hot dispatch and combine tensors contracted with
``torch.einsum``, as the JAX module contracts them with ``jnp.einsum``:
a token's expert outputs are weighted by its renormalised top-k gates,
and each expert holds a fixed ``capacity`` of slots per routing group.
A token routed past an expert's capacity is dropped for that expert
(its slot contributes zero).  Slot priority is k-major (every token's
first choice before any second choice) and token-major within an
expert.  Tokens route in groups of ``moe_group_size`` (0: one batch
row), so the dispatch tensors are (G, S, E, C): linear in the token
count.  The router runs in float32.

Expert parallelism (:func:`moe_param_specs`, the JAX module's specs):
experts split over ``ep`` and each expert's FFN over ``tp``.  Under a
mesh (parallel/collectives.py ``use_mesh``) every rank routes the tokens
it holds to all experts, runs only its own experts' slice, and the
combine is summed over ``ep`` × ``tp``; the expert inputs and the
combine weights enter through ``copy_to``, so their gradients are summed
over the same ranks and the router's gradient is whole on each.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from nvme_strom_tpu_torch.parallel import collectives as _coll


def _dispatch_groups(probs: torch.Tensor, top_k: int, capacity: int):
    """:func:`moe_dispatch_combine` over a leading group axis: probs
    (G, T, E) → dispatch, combine (G, T, E, C) and aux (G,)."""
    G, T, E = probs.shape
    # the JAX top_k: descending, the lower index first on a tie
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals = order.values[..., :top_k]
    gate_idx = order.indices[..., :top_k]                      # (G, T, k)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)

    mask = F.one_hot(gate_idx, E).float()                      # (G, T, k, E)
    # Switch load balancing: the share of tokens whose first choice is e
    # times e's mean router probability, summed
    f = mask[:, :, 0, :].mean(dim=1)                           # (G, E)
    p = probs.mean(dim=1)
    aux = E * (f * p).sum(-1)

    mask_kt = mask.transpose(1, 2).reshape(G, top_k * T, E)    # k-major
    pos = torch.cumsum(mask_kt, dim=1) - mask_kt               # 0-based
    keep = mask_kt * (pos < capacity)
    slots = torch.arange(capacity, device=probs.device, dtype=pos.dtype)
    pos_oh = (pos[..., None] == slots).float() * keep[..., None]
    pos_oh = pos_oh.reshape(G, top_k, T, E, capacity).transpose(1, 2)
    dispatch = pos_oh.sum(dim=2)                               # (G, T, E, C)
    combine = (pos_oh * gate_vals[..., None, None]).sum(dim=2)
    return dispatch, combine, aux


def moe_dispatch_combine(router_probs: torch.Tensor, top_k: int,
                         capacity: int):
    """Dispatch and combine tensors from router probabilities.

    router_probs (T, E) float32 → (dispatch (T, E, C) in {0, 1}: token t
    holds slot c of expert e; combine (T, E, C) float32: dispatch times
    the token's renormalised top-k gate; aux: the Switch load-balancing
    loss, a float32 scalar)."""
    d, c, aux = _dispatch_groups(router_probs[None], top_k, capacity)
    return d[0], c[0], aux[0]


def expert_capacity(n_tokens: int, n_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Slots per expert and group: ceil(k·T/E · factor), at least 1."""
    return max(1, math.ceil(n_tokens * top_k / n_experts * capacity_factor))


def prefill_len(cfg, s: int, padded: int) -> int:
    """The tokens a server prefills for ``s`` prompt tokens: ``s``, or
    ``padded`` (the length the JAX server pads that prefill to, right
    with 0) where an expert's capacity can bind.  Below
    ``capacity_factor`` = E / k a group's tokens can overflow an expert,
    so they are coupled and pad tokens change the routing of real ones;
    at E / k or above every token keeps all its k experts, whatever the
    group (a dropless configuration such as Mixtral's), and the exact
    prompt routes alike."""
    if cfg.n_experts > 0 and \
            cfg.capacity_factor * cfg.expert_top_k < cfg.n_experts:
        return padded
    return s


def moe_group_size(cfg, n_tokens: int, seq: int) -> int:
    """Tokens per routing group.  ``cfg.moe_group_size`` 0: one batch
    row.  Else it must divide the token count, unless it covers the whole
    batch (one global group); a size that does not divide raises."""
    gs = getattr(cfg, "moe_group_size", 0)
    if not gs:
        return seq
    if gs >= n_tokens:
        return n_tokens
    if n_tokens % gs:
        raise ValueError(
            f"moe_group_size={gs} does not divide token count "
            f"{n_tokens}; pick a divisor or 0 (per-batch-row groups)")
    return gs


def moe_mlp(x: torch.Tensor, p: Dict, prefix: str, cfg) -> tuple:
    """x (b, s, d) → (out (b, s, d), aux loss).  Weights:
    ``{prefix}router`` (d, E), ``moe_w_gate`` / ``moe_w_up`` (E, d, ff),
    ``moe_w_down`` (E, ff, d); the experts' may be quantized leaves.
    Capacity binds within each group; aux is the mean over groups."""
    from nvme_strom_tpu_torch.models.transformer import wmat
    b, s, d = x.shape
    T = b * s
    E, k = cfg.n_experts, cfg.expert_top_k
    S = moe_group_size(cfg, T, s)
    G = T // S
    C = expert_capacity(S, E, k, cfg.capacity_factor)
    xg = x.reshape(G, S, d)

    logits = torch.einsum("gsd,de->gse", xg.float(),
                          p[prefix + "router"].float())
    probs = torch.softmax(logits, dim=-1)
    dispatch, combine, aux = _dispatch_groups(probs, k, C)
    aux = aux.mean()

    w_gate = wmat(p, prefix + "moe_w_gate", x.dtype)
    group = _coll.moe_group()
    if group is not None:
        # this rank's experts, on the tokens it holds
        el = w_gate.shape[0]
        e0 = _coll.ep_index() * el
        xg = _coll.copy_to(xg, group)
        combine = _coll.copy_to(combine, group)
        dispatch = dispatch[:, :, e0:e0 + el]
        combine = combine[:, :, e0:e0 + el]
        E = el
    # each expert sees G·C slots, wherever the group boundaries fell
    xd = torch.einsum("gsec,gsd->egcd", dispatch.to(x.dtype), xg)
    xd = xd.reshape(E, G * C, d)
    gate = F.silu(torch.einsum("ecd,edf->ecf", xd, w_gate))
    up = torch.einsum("ecd,edf->ecf", xd,
                      wmat(p, prefix + "moe_w_up", x.dtype))
    h = torch.einsum("ecf,efd->ecd", gate * up,
                     wmat(p, prefix + "moe_w_down", x.dtype))
    h = h.reshape(E, G, C, d)
    out = torch.einsum("gsec,egcd->gsd", combine.to(x.dtype), h)
    out = _coll.reduce_from(out, group)
    return out.reshape(b, s, d), aux


def moe_param_specs(cfg, layer_prefix: str) -> Dict[str, tuple]:
    """Partition specs of one MoE layer (parallel/shardings.py): experts
    over ``ep``, each expert's FFN Megatron-split over ``tp``
    (column-parallel gate / up, row-parallel down)."""
    L = layer_prefix
    return {L + "router": (),
            L + "moe_w_gate": ("ep", None, "tp"),
            L + "moe_w_up": ("ep", None, "tp"),
            L + "moe_w_down": ("ep", "tp", None)}


def moe_param_shapes(cfg, prefix: str) -> Dict[str, tuple]:
    """One MoE layer's weight names and shapes, in init order."""
    E, dm, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    return {prefix + "router": (dm, E),
            prefix + "moe_w_gate": (E, dm, ff),
            prefix + "moe_w_up": (E, dm, ff),
            prefix + "moe_w_down": (E, ff, dm)}


def init_moe_params(rng, cfg, prefix: str) -> Dict:
    """One MoE layer's float32 numpy weights from the numpy generator
    ``rng``: normal / sqrt(fan_in), fan_in the input dim (d for the
    router and the gate / up experts, ff for the down experts)."""
    import numpy as np
    out = {}
    for name, shape in moe_param_shapes(cfg, prefix).items():
        out[name] = (rng.standard_normal(shape, dtype=np.float32)
                     / np.float32(np.sqrt(shape[-2])))
    return out
