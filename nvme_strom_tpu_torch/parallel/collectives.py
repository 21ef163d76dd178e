"""The collectives a Megatron sharding needs, called by the model code
itself (the JAX package's partitioner inserts them from the shardings,
nvme_strom_tpu/parallel/shardings.py).

Each has an autograd rule, so a sharded model differentiates as its
one-device version does:

- :func:`copy_to`: identity forward, all-reduce of the gradient backward
  (the input of a column-parallel product: each rank's gradient covers
  only its columns);
- :func:`reduce_from`: all-reduce forward, identity backward (the output
  of a row-parallel product);
- :func:`gather_from`: all-gather along a dimension forward, this rank's
  slice of the gradient backward (an embedding split on its features);
- :func:`vocab_parallel_xent`: cross-entropy over logits split on the
  vocabulary, with the max and the sum of exponentials all-reduced.

Every function is the identity where its group is None (one rank), so
the one-device model runs no extra op.  :func:`use_mesh` sets the groups
the model code reads (:func:`tp_group`, :func:`moe_group`) for the
calls inside it.  A gloo group carries CUDA tensors' all-reduces
itself; its all-gathers go through host memory, as gloo has no CUDA
all-gather.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch
import torch.distributed as dist

#: (tp group, moe group, this rank's ep index) of the calls under
#: :func:`use_mesh`
_GROUPS: contextvars.ContextVar = contextvars.ContextVar(
    "strom_parallel_groups", default=(None, None, 0))


@contextlib.contextmanager
def use_mesh(mesh):
    """Run the model code inside with ``mesh``'s groups: ``tp`` for the
    Megatron products, ``ep`` × ``tp`` for the experts (None: one
    device)."""
    groups = ((mesh.group("tp"), mesh.group(("ep", "tp")),
               mesh.coords.get("ep", 0))
              if mesh is not None else (None, None, 0))
    token = _GROUPS.set(groups)
    try:
        yield
    finally:
        _GROUPS.reset(token)


def tp_group():
    """The tensor-parallel group of the current :func:`use_mesh`."""
    return _GROUPS.get()[0]


def moe_group():
    """The group an MoE layer's expert outputs are summed over (``ep``
    and ``tp``)."""
    return _GROUPS.get()[1]


def ep_index() -> int:
    """This rank's index along ``ep`` (its block of experts)."""
    return _GROUPS.get()[2]


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _gloo(group) -> bool:
    return dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``group`` (none: ``t``)."""
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> list:
    """Every rank's ``t`` (equal shapes), in group rank order."""
    if group is None:
        return [t]
    n = dist.get_world_size(group)
    if t.is_cuda and _gloo(group):
        host = t.detach().cpu().contiguous()
        parts = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(parts, host, group=group)
        return [p.to(t.device) for p in parts]
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return parts


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        ctx.width = x.shape[dim]
        return torch.cat(all_gather(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        i = group_rank(ctx.group)
        return g.narrow(ctx.dim, i * ctx.width, ctx.width), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, gradient all-reduced over ``group`` backward."""
    if group is None:
        return x
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` forward, identity backward."""
    if group is None:
        return x
    return _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Concatenation of every rank's ``x`` along ``dim`` forward, this
    rank's slice of the gradient backward."""
    if group is None:
        return x
    return _GatherFrom.apply(x, group, dim % x.dim())


class _VocabXent(torch.autograd.Function):
    """Per-token NLL from logits split on the vocabulary: this rank holds
    columns [start, start + V_local) of each row."""

    @staticmethod
    def forward(ctx, logits, targets, group, start):
        lf = logits.float()
        m = lf.max(dim=-1, keepdim=True).values
        all_reduce(m, group, dist.ReduceOp.MAX)
        e = torch.exp(lf - m)
        sums = e.sum(-1, keepdim=True)
        width = lf.shape[-1]
        local = targets - start
        mine = (local >= 0) & (local < width)
        idx = local.clamp(0, width - 1)
        tl = lf.gather(-1, idx[..., None])[..., 0] * mine
        both = torch.cat([sums[..., 0][None], tl[None]])
        all_reduce(both, group)
        sums, tl = both[0], both[1]
        ctx.save_for_backward(e, sums, idx, mine)
        ctx.dtype = logits.dtype
        return torch.log(sums) + m[..., 0] - tl

    @staticmethod
    def backward(ctx, g):
        e, sums, idx, mine = ctx.saved_tensors
        grad = e / sums[..., None]
        grad.scatter_add_(-1, idx[..., None],
                          -mine.to(grad.dtype)[..., None])
        return (grad * g[..., None]).to(ctx.dtype), None, None, None


def vocab_parallel_xent(logits: torch.Tensor, targets: torch.Tensor,
                        group, start: int = 0) -> torch.Tensor:
    """Per-token NLL ``logsumexp(row) - row[target]`` (float32) of
    logits (..., V_local) that hold vocabulary columns [start, start +
    V_local) of this rank; with no group, of whole logits."""
    if group is None:
        lf = logits.float()
        lse = torch.logsumexp(lf, dim=-1)
        return lse - lf.gather(-1, targets[..., None].long())[..., 0]
    return _VocabXent.apply(logits, targets.long(), group, int(start))


def dp_mean_(tensors, group) -> None:
    """Average each tensor over ``group`` in place (the data-parallel
    gradient mean); one all-reduce of a flat buffer a dtype and
    device."""
    if group is None:
        return
    n = dist.get_world_size(group)
    buckets: dict = {}
    for t in tensors:
        buckets.setdefault((t.dtype, t.device), []).append(t)
    for ts in buckets.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        all_reduce(flat, group)
        flat /= n
        pos = 0
        for t in ts:
            t.copy_(flat[pos:pos + t.numel()].view_as(t))
            pos += t.numel()


def world_group() -> Optional[object]:
    """The default group when ``torch.distributed`` is up, else None."""
    if dist.is_available() and dist.is_initialized() and \
            dist.get_world_size() > 1:
        return dist.group.WORLD
    return None
