"""Pipeline parallelism: GPipe microbatching over a ``pp`` mesh axis
(counterpart of nvme_strom_tpu/parallel/pipeline.py).

The layer stack is split into ``pp`` stages of contiguous layers; each
rank holds its stage's weights as a stacked ``(layers_per_stage, ...)``
slice (:func:`split_layer_stack`, :func:`shard_stack`).  The schedule is
written out rather than left to autograd across ranks: every stage runs
all its microbatches forward (stage 0 embeds each one, the others
receive it from the stage before, ``collectives.recv``), sends each
output on (``collectives.send``), and the last stage takes the loss;
then each stage runs the backward of its microbatches in reverse order,
the activation gradient received from the stage after and the input's
gradient sent to the one before.  A stage with no work for a tick
simply waits in its receive: the (pp − 1)-tick bubble at either end.

Inside a stage each layer is the model's own ``layer_body`` under
``collectives.use_mesh(mesh)``: Megatron tensor parallelism over ``tp``
(the reduce after each row-parallel product), the dense ring over
``sp`` (RoPE at the span's positions; the JAX pipeline takes no
``attn_fn``, so its stages run no flash kernel), and MoE super-layers
(``moe_every`` − 1 dense layers and one MoE layer) with experts over
``ep`` and each expert's FFN over ``tp``, routed over each rank's rows
and span.  ``cfg.remat_policy`` full or dots recomputes each stage layer
in the backward.

The token embedding, the final norm and the lm_head (``rest``) are whole
on every rank.  The embedding runs on stage 0 and the head on the last
stage only; their gradients are summed over ``pp`` (the stages that do
not run them add zeros), so every rank holds the same ones.  The loss
takes each span's last target from the next sp rank and counts the
whole sequence (``transformer.next_token_targets``).  The router aux
loss is summed over stages, divided by the microbatch count and
averaged over ``dp`` and ``sp``, as the JAX schedule does.  Forward-only
callers get the last stage's outputs on every pp rank (the JAX masked
sum over ``pp``).

Every function takes this rank's block of the batch: its ``dp`` rows
and, with ``sp``, its span of each sequence.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from nvme_strom_tpu_torch.models import transformer as _tr
from nvme_strom_tpu_torch.parallel import collectives as _coll
from nvme_strom_tpu_torch.parallel.shardings import (P, Sharding, prune_spec,
                                                     shard_params)

_STACKED = ("attn_norm", "wq", "wk", "wv", "wo",
            "mlp_norm", "w_gate", "w_up", "w_down")
_ATTN = ("attn_norm", "wq", "wk", "wv", "wo")
_MOE_MLP = ("mlp_norm", "router", "moe_w_gate", "moe_w_up", "moe_w_down")


def _moe_period(cfg) -> int:
    """Super-layer period of an MoE stack: 0 for a dense config, else
    ``cfg.moe_every`` (layer g·p + p − 1 of each group of p is the MoE
    layer, ``cfg.is_moe_layer``'s pattern)."""
    if not any(cfg.is_moe_layer(i) for i in range(cfg.n_layers)):
        return 0
    p = cfg.moe_every
    if cfg.n_layers % p:
        raise ValueError(
            f"MoE pipeline needs n_layers ({cfg.n_layers}) divisible by "
            f"moe_every ({p}) to form super-layers")
    return p


def _stack(arrays):
    if isinstance(arrays[0], torch.Tensor):
        return torch.stack(arrays)
    return np.stack(arrays)


def split_layer_stack(params: Dict, cfg) -> tuple:
    """Flat ``{name: array}`` params (tensors or numpy arrays) → (stack,
    rest).  Dense: ``stack[name]`` (n_layers, *per_layer), the leading
    dim the one ``pp`` splits.  MoE: ``stack["dense"][name]`` (n_super,
    p − 1, *per_layer) holds each super-layer's dense layers and
    ``stack["moe"][name]`` (n_super, *per_layer) its MoE layer.
    ``rest``: the embedding, final norm and lm_head."""
    p = _moe_period(cfg)
    if p == 0:
        stack = {n: _stack([params[f"layers.{i}.{n}"]
                            for i in range(cfg.n_layers)])
                 for n in _STACKED}
    else:
        n_super = cfg.n_layers // p
        stack = {"moe": {n: _stack([params[f"layers.{g * p + p - 1}.{n}"]
                                    for g in range(n_super)])
                         for n in _ATTN + _MOE_MLP}}
        if p > 1:
            stack["dense"] = {
                n: _stack([_stack([params[f"layers.{g * p + j}.{n}"]
                                   for j in range(p - 1)])
                           for g in range(n_super)])
                for n in _STACKED}
    rest = {k: v for k, v in params.items() if not k.startswith("layers.")}
    return stack, rest


def merge_layer_stack(stack: Dict, rest: Dict) -> Dict:
    """Inverse of :func:`split_layer_stack` (names back to
    ``layers.<i>.<name>``)."""
    out = dict(rest)
    if "moe" in stack:
        n_super = stack["moe"]["attn_norm"].shape[0]
        p = (stack["dense"]["attn_norm"].shape[1] + 1
             if "dense" in stack else 1)
        for g in range(n_super):
            for j in range(p - 1):
                for n in _STACKED:
                    out[f"layers.{g * p + j}.{n}"] = stack["dense"][n][g, j]
            for n in _ATTN + _MOE_MLP:
                out[f"layers.{g * p + p - 1}.{n}"] = stack["moe"][n][g]
        return out
    for i in range(stack["attn_norm"].shape[0]):
        for n in _STACKED:
            out[f"layers.{i}.{n}"] = stack[n][i]
    return out


def stacked_specs(cfg=None) -> Dict:
    """Partition specs of :func:`split_layer_stack`'s stack (pass the
    config for an MoE stack; the default is the dense one)."""
    col = P("pp", None, "tp")     # (L, d, out / tp) column-parallel
    row = P("pp", "tp", None)     # (L, in / tp, d) row-parallel
    norm = P("pp", None)
    dense = {"attn_norm": norm, "wq": col, "wk": col, "wv": col, "wo": row,
             "mlp_norm": norm, "w_gate": col, "w_up": col, "w_down": row}
    p = _moe_period(cfg) if cfg is not None else 0
    if p == 0:
        return dense
    specs = {"moe": {
        "attn_norm": norm, "wq": col, "wk": col, "wv": col, "wo": row,
        "mlp_norm": norm, "router": P("pp", None, None),
        # experts over ep, each expert's FFN over tp
        "moe_w_gate": P("pp", "ep", None, "tp"),
        "moe_w_up": P("pp", "ep", None, "tp"),
        "moe_w_down": P("pp", "ep", "tp", None)}}
    if p > 1:   # the dense layers gain the (n_super, p - 1) leading dims
        specs["dense"] = {k: P(*(s[:1] + (None,) + s[1:]))
                          for k, s in dense.items()}
    return specs


def stacked_shardings(mesh, cfg=None) -> Dict:
    """:func:`stacked_specs` laid over ``mesh`` (pruned to its axes)."""
    def walk(specs):
        return {k: walk(v) if isinstance(v, dict) else
                Sharding(mesh, prune_spec(v, mesh))
                for k, v in specs.items()}
    return walk(stacked_specs(cfg))


def shard_stack(stack: Dict, mesh, cfg, device=None) -> Dict:
    """This rank's slices of a whole stack (tensors or numpy arrays), on
    ``device``."""
    def walk(part, shs):
        if isinstance(next(iter(part.values())), dict):   # MoE: nested
            return {k: walk(part[k], shs[k]) for k in part}
        return shard_params(part, cfg, mesh, device=device, shardings=shs)
    return walk(stack, stacked_shardings(mesh, cfg))


def named_leaves(tree: Dict, prefix: str = "") -> list:
    """(name, tensor) of every leaf, in the tree's order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += named_leaves(v, f"{prefix}{k}/")
        else:
            out.append((prefix + k, v))
    return out


def from_leaves(tree: Dict, values: dict, prefix: str = "") -> Dict:
    """``tree``'s structure with each leaf replaced by ``values[its
    name]`` (the names of :func:`named_leaves`)."""
    return {k: (from_leaves(v, values, f"{prefix}{k}/")
                if isinstance(v, dict) else values[prefix + k])
            for k, v in tree.items()}


def pp_parameters(stack: Dict, rest: Dict) -> list:
    """The tensors an optimizer of :func:`make_pp_train_step` updates,
    in its order."""
    return [t for _, t in named_leaves(stack) + named_leaves(rest)]


def _axis_size(mesh, name: str) -> int:
    return mesh.shape.get(name, 1)


class _Schedule:
    """The GPipe schedule of one config on one mesh (see the module
    docstring)."""

    def __init__(self, cfg, mesh, n_microbatches: int):
        self.cfg, self.mesh, self.n_mb = cfg, mesh, int(n_microbatches)
        if mesh is None:
            raise ValueError("the pipeline needs a mesh")
        self.n_pp = _axis_size(mesh, "pp")
        tp, sp, ep = (_axis_size(mesh, a) for a in ("tp", "sp", "ep"))
        self.sp = sp
        self.period = p = _moe_period(cfg)
        if sp > 1 and cfg.max_seq % sp:
            raise ValueError(f"seq {cfg.max_seq} not divisible by sp={sp}")
        n_units = cfg.n_layers if p == 0 else cfg.n_layers // p
        if n_units % self.n_pp:
            raise ValueError(
                f"{n_units} {'layers' if p == 0 else 'super-layers'} not "
                f"divisible into {self.n_pp} pipeline stages")
        if cfg.n_heads % tp or cfg.n_kv_heads % tp:
            raise ValueError(f"heads ({cfg.n_heads}/{cfg.n_kv_heads}) not "
                             f"divisible by tp={tp}")
        if p and cfg.n_experts % ep:
            raise ValueError(f"{cfg.n_experts} experts not divisible by "
                             f"ep={ep}")
        if cfg.remat_policy == "nvme":
            raise ValueError("the pipeline recomputes stage layers "
                             "(remat_policy full or dots), not nvme")
        self.stage = mesh.coords.get("pp", 0)

    def _check_batch(self, tokens: torch.Tensor) -> int:
        b = tokens.shape[0]
        dp = _axis_size(self.mesh, "dp")
        B = b * dp
        if B % self.n_mb:
            raise ValueError(f"batch {B} not divisible into {self.n_mb} "
                             "microbatches")
        if (B // self.n_mb) % dp:
            raise ValueError(f"microbatch size {B // self.n_mb} not "
                             f"divisible by dp={dp}")
        return b // self.n_mb

    def _layers(self, stack: Dict) -> list:
        """(global layer index, {``layers.<i>.<name>``: weight}) of every
        layer of this stage, in order."""
        out = []
        if self.period == 0:
            n_loc = stack["wq"].shape[0]
            for j in range(n_loc):
                i = self.stage * n_loc + j
                out.append((i, {f"layers.{i}.{n}": stack[n][j]
                                for n in _STACKED}))
            return out
        p = self.period
        n_loc = stack["moe"]["wq"].shape[0]
        for g in range(n_loc):
            base = (self.stage * n_loc + g) * p
            for j in range(p - 1):
                out.append((base + j, {f"layers.{base + j}.{n}":
                                       stack["dense"][n][g, j]
                                       for n in _STACKED}))
            i = base + p - 1
            out.append((i, {f"layers.{i}.{n}": stack["moe"][n][g]
                            for n in _ATTN + _MOE_MLP}))
        return out

    def _stage_apply(self, stack: Dict, x: torch.Tensor) -> tuple:
        """This stage's layers on x: (output, summed router aux loss)."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, lp in self._layers(stack):
            if cfg.remat_policy in ("full", "dots"):
                x, a = checkpoint(_tr.layer_body, lp, x, i, cfg,
                                  use_reentrant=False)
            else:
                x, a = _tr.layer_body(lp, x, i, cfg)
            aux = aux + a
        return x.to(cfg.dtype), aux

    def _head_nll(self, rest: Dict, y, targets, weights) -> torch.Tensor:
        """Σ weight · NLL of the last stage's outputs through the final
        norm and the whole lm_head (``xent_chunks`` > 1 chunked)."""
        cfg = self.cfg
        h = _tr.rms_norm(y, rest["final_norm"], cfg.norm_eps)
        return _tr.nll_sum(h, _tr.wmat(rest, "lm_head", h.dtype), targets,
                           weights, cfg.xent_chunks)

    def run(self, stack: Dict, rest: Dict, tokens: torch.Tensor, *,
            loss: bool, grad: bool):
        """One pass over the microbatches: (this rank's share of the
        loss or None, this stage's aux summed over microbatches, the
        last stage's outputs a microbatch or None, gradients by leaf
        name or None)."""
        cfg, n_mb = self.cfg, self.n_mb
        mb = self._check_batch(tokens)
        s = tokens.shape[1]
        first, last = self.stage == 0, self.stage == self.n_pp - 1
        dev = tokens.device
        saved = []
        with _coll.use_mesh(self.mesh), torch.set_grad_enabled(grad):
            if loss:
                targets, weights, count = _tr.next_token_targets(tokens)
            for m in range(n_mb):
                rows = slice(m * mb, (m + 1) * mb)
                if first:
                    x = _tr.wmat(rest, "tok_embed", cfg.dtype)[
                        tokens[rows].long()]
                else:
                    x = _coll.recv((mb, s, cfg.d_model), cfg.dtype, dev,
                                   self.stage - 1, _coll.pp_group())
                    x.requires_grad_(grad)
                y, aux = self._stage_apply(stack, x)
                if not last:
                    _coll.send(y, self.stage + 1, _coll.pp_group())
                nll = None
                if last and loss:
                    nll = self._head_nll(rest, y, targets[rows],
                                         weights[rows]) / count
                saved.append((x, y, aux, nll))
            grads = self._backward(stack, rest, saved) if grad else None
        share = None
        if loss:
            share = torch.zeros((), dtype=torch.float32, device=dev)
            for _, _, aux, nll in saved:
                if nll is not None:
                    share = share + nll.detach()
                share = share + (cfg.router_aux_coef * aux.detach()
                                 / (n_mb * self.sp))
        aux_sum = sum(a.detach() for _, _, a, _ in saved)
        outs = [y.detach() for _, y, _, _ in saved] if last else None
        return share, aux_sum, outs, grads

    def _backward(self, stack: Dict, rest: Dict, saved: list) -> dict:
        cfg = self.cfg
        first, last = self.stage == 0, self.stage == self.n_pp - 1
        named = named_leaves(stack, "stack/") + named_leaves(rest, "rest/")
        params = [t for _, t in named]
        acc = [None] * len(params)
        scale = cfg.router_aux_coef / (self.n_mb * self.sp)
        for x, y, aux, nll in reversed(saved):
            outputs, grad_out = [], []
            if last:
                outputs.append(nll)
                grad_out.append(None)
            else:
                outputs.append(y)
                grad_out.append(_coll.recv(tuple(y.shape), y.dtype,
                                           y.device, self.stage + 1,
                                           _coll.pp_group()))
            if aux.requires_grad:
                outputs.append(aux * scale)
                grad_out.append(None)
            inputs = params + ([] if first else [x])
            got = torch.autograd.grad(outputs, inputs, grad_out,
                                      allow_unused=True)
            for k, g in enumerate(got[:len(params)]):
                if g is not None:
                    acc[k] = g if acc[k] is None else acc[k] + g
            if not first:
                _coll.send(got[-1], self.stage - 1, _coll.pp_group())
        return {name: (torch.zeros_like(p) if g is None else g)
                for (name, p), g in zip(named, acc)}


def make_pp_forward_with_aux(cfg, mesh, n_microbatches: int):
    """``fwd(stack, rest, tokens) -> (logits, aux)``: float32 logits
    (b, s, vocab) of this rank's block on every pp rank, and the router
    aux loss (0 for a dense config).  ``fwd.hidden`` returns the
    final-norm hidden in place of the logits.  No gradients: see
    :func:`make_pp_value_and_grad`."""
    sched = _Schedule(cfg, mesh, n_microbatches)

    def hidden(stack, rest, tokens):
        _, aux, outs, _ = sched.run(stack, rest, tokens, loss=False,
                                    grad=False)
        b, s = tokens.shape
        if outs is None:
            x = torch.zeros((b, s, cfg.d_model), dtype=cfg.dtype,
                            device=tokens.device)
        else:
            x = torch.cat(outs)
        # the last stage's outputs to every pp rank (a masked sum)
        _coll.all_reduce(x, mesh.group("pp"))
        aux = (aux / sched.n_mb).reshape(1).clone()
        _coll.dp_mean_([aux], mesh.group(("dp", "sp", "pp")),
                       _axis_size(mesh, "dp") * sched.sp)
        return _tr.rms_norm(x, rest["final_norm"], cfg.norm_eps), aux[0]

    def fwd(stack, rest, tokens):
        with torch.no_grad():
            x, aux = hidden(stack, rest, tokens)
            return (x @ rest["lm_head"].to(x.dtype)).float(), aux

    fwd.hidden = hidden
    return fwd


def make_pp_forward(cfg, mesh, n_microbatches: int):
    """``fwd(stack, rest, tokens) -> logits`` (b, s, vocab) float32."""
    fwd_aux = make_pp_forward_with_aux(cfg, mesh, n_microbatches)

    def fwd(stack, rest, tokens):
        return fwd_aux(stack, rest, tokens)[0]

    return fwd


def _reduce(mesh, loss, g_stack=None, g_rest=None) -> None:
    """The stack's gradients summed over sp, averaged over dp; the
    rest's and the loss also summed over the stages."""
    if g_stack is not None:
        _coll.mesh_mean_(list(g_stack.values()), mesh)
    _coll.mesh_mean_((list(g_rest.values()) if g_rest else []) + [loss],
                     mesh, ("dp", "sp", "pp"))


def make_pp_loss(cfg, mesh, n_microbatches: int):
    """``loss_fn(stack, rest, tokens) -> loss``: next-token cross-entropy
    plus ``router_aux_coef`` × the aux loss, the whole batch's on every
    rank (``transformer.loss_fn``'s value; ``xent_chunks`` > 1 chunks
    the head as there).  No gradients: see
    :func:`make_pp_value_and_grad`."""
    sched = _Schedule(cfg, mesh, n_microbatches)

    def loss_fn(stack, rest, tokens):
        share, _, _, _ = sched.run(stack, rest, tokens, loss=True,
                                   grad=False)
        share = share.reshape(1).clone()
        _reduce(mesh, share)
        return share[0]

    return loss_fn


def make_pp_value_and_grad(cfg, mesh, n_microbatches: int):
    """``fn(stack, rest, tokens) -> (loss, stack grads, rest grads)``
    through the explicit GPipe schedule; the gradients have the
    structure of ``stack`` and ``rest`` and are reduced over the mesh
    (every replica of a weight holds the same one)."""
    sched = _Schedule(cfg, mesh, n_microbatches)

    def value_and_grad(stack, rest, tokens):
        share, _, _, grads = sched.run(stack, rest, tokens, loss=True,
                                       grad=True)
        g_stack = {n[len("stack/"):]: g for n, g in grads.items()
                   if n.startswith("stack/")}
        g_rest = {n[len("rest/"):]: g for n, g in grads.items()
                  if n.startswith("rest/")}
        loss = share.reshape(1).clone()
        _reduce(mesh, loss, g_stack, g_rest)
        return (loss[0], from_leaves(stack, g_stack),
                from_leaves(rest, g_rest))

    return value_and_grad


def make_pp_train_step(cfg, optimizer, mesh, n_microbatches: int):
    """``step(stack, rest, tokens) -> loss``: the pipelined counterpart
    of ``transformer.make_train_step``.  ``optimizer`` is a torch
    optimizer over :func:`pp_parameters` (``transformer.adamw`` for
    ``optax.adamw``), which it updates in place."""
    vg = make_pp_value_and_grad(cfg, mesh, n_microbatches)

    def step(stack, rest, tokens):
        loss, g_stack, g_rest = vg(stack, rest, tokens)
        params = dict(named_leaves(stack, "stack/") + named_leaves(rest, "rest/"))
        grads = dict(named_leaves(g_stack, "stack/") + named_leaves(g_rest, "rest/"))
        _tr.apply_gradients(optimizer, params, grads)
        return loss

    return step
