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

Sequence and pipeline parallelism add:

- :func:`ppermute`: every rank sends to the rank ``shift`` after it
  along the group and receives from the one ``shift`` before it
  (``lax.ppermute`` over a ring), the gradient sent back the other way;
- :func:`all_to_all`: each rank splits one dimension into a piece for
  every rank and concatenates what it receives along another
  (``lax.all_to_all(tiled=True)``), the gradient through the inverse
  exchange;
- :func:`send` / :func:`recv`: one tensor from one rank to another (a
  pipeline stage's activations and their gradients).

Every function is the identity where its group is None (one rank), so
the one-device model runs no extra op.  :func:`use_mesh` sets the groups
the model code reads (:func:`tp_group`, :func:`moe_group`,
:func:`sp_group`, :func:`pp_group`) for the calls inside it.  A gloo
group carries CUDA tensors' all-reduces itself; its all-gathers,
point-to-point sends and all-to-alls go through host memory, as gloo
has none of them for CUDA tensors.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

class _Groups(NamedTuple):
    tp: object = None
    moe: object = None
    ep_index: int = 0
    sp: object = None
    pp: object = None


#: the groups of the calls under :func:`use_mesh`
_GROUPS: contextvars.ContextVar = contextvars.ContextVar(
    "strom_parallel_groups", default=_Groups())


@contextlib.contextmanager
def use_mesh(mesh):
    """Run the model code inside with ``mesh``'s groups: ``tp`` for the
    Megatron products, ``ep`` × ``tp`` for the experts, ``sp`` for the
    sequence and ``pp`` for the pipeline (None: one device)."""
    groups = (_Groups(mesh.group("tp"), mesh.group(("ep", "tp")),
                      mesh.coords.get("ep", 0), mesh.group("sp"),
                      mesh.group("pp"))
              if mesh is not None else _Groups())
    token = _GROUPS.set(groups)
    try:
        yield
    finally:
        _GROUPS.reset(token)


def tp_group():
    """The tensor-parallel group of the current :func:`use_mesh`."""
    return _GROUPS.get().tp


def moe_group():
    """The group an MoE layer's expert outputs are summed over (``ep``
    and ``tp``)."""
    return _GROUPS.get().moe


def ep_index() -> int:
    """This rank's index along ``ep`` (its block of experts)."""
    return _GROUPS.get().ep_index


def sp_group():
    """The sequence-parallel group of the current :func:`use_mesh`:
    each rank holds one span of every sequence."""
    return _GROUPS.get().sp


def pp_group():
    """The pipeline group of the current :func:`use_mesh`."""
    return _GROUPS.get().pp


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


def _staged(t: torch.Tensor, group) -> bool:
    """Whether ``t`` crosses ``group`` through host memory (a CUDA
    tensor on gloo)."""
    return t.is_cuda and _gloo(group)


def _peer(group, offset: int) -> int:
    """The global rank ``offset`` places after this one along
    ``group`` (modulo its size)."""
    n = dist.get_world_size(group)
    return dist.get_global_rank(group, (dist.get_rank(group) + offset) % n)


def _shift(t: torch.Tensor, group, shift: int) -> torch.Tensor:
    """``t`` sent ``shift`` ranks on along ``group``; returns the one
    received from ``shift`` ranks back."""
    stage = _staged(t, group)
    out = t.detach().cpu().contiguous() if stage else t.detach().contiguous()
    got = torch.empty_like(out)
    ops = [dist.P2POp(dist.isend, out, _peer(group, shift), group),
           dist.P2POp(dist.irecv, got, _peer(group, -shift), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return got.to(t.device) if stage else got


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _shift(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -ctx.shift), None, None


def ppermute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Every rank of ``group`` sends ``x`` to the rank ``shift`` after it
    (in group order, round the ring) and gets the one ``shift`` before
    it; the gradient goes back the other way.  Every rank of the group
    must call it, in the same order as its other collectives."""
    if group is None:
        return x
    return _Ppermute.apply(x, group, shift)


def _exchange(x: torch.Tensor, group, split_dim: int, concat_dim: int
              ) -> torch.Tensor:
    n = dist.get_world_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dimension {split_dim} of "
                         f"{tuple(x.shape)} does not split into {n}")
    pieces = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    stage = _staged(x, group)
    if stage:
        pieces = pieces.cpu()
    got = torch.empty_like(pieces)
    dist.all_to_all_single(got, pieces, group=group)
    if stage:
        got = got.to(x.device)
    return torch.cat(got.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return _exchange(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _exchange(g.contiguous(), ctx.group, concat_dim,
                         split_dim), None, None, None


def all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int
               ) -> torch.Tensor:
    """``x`` cut into one piece a rank along ``split_dim``; piece j goes
    to rank j, and the pieces received are concatenated along
    ``concat_dim`` in rank order (``lax.all_to_all`` with
    ``tiled=True``).  The gradient takes the inverse exchange."""
    if group is None:
        return x
    return _AllToAll.apply(x, group, split_dim % x.dim(),
                           concat_dim % x.dim())


def send(t: torch.Tensor, dst: int, group) -> None:
    """``t`` to group rank ``dst`` (blocking on gloo; queued on the
    stream on NCCL)."""
    peer = dist.get_global_rank(group, dst)
    dist.send(t.detach().cpu().contiguous() if _staged(t, group)
              else t.detach().contiguous(), peer, group=group)


def recv(shape, dtype, device, src: int, group) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` from group rank ``src``, on
    ``device``."""
    peer = dist.get_global_rank(group, src)
    stage = torch.device(device).type == "cuda" and _gloo(group)
    buf = torch.empty(shape, dtype=dtype,
                      device="cpu" if stage else device)
    dist.recv(buf, peer, group=group)
    return buf.to(device) if stage else buf


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


def dp_mean_(tensors, group, divisor: Optional[int] = None) -> None:
    """Average each tensor over ``group`` in place (the data-parallel
    gradient mean); one all-reduce of a flat buffer a dtype and
    device.  ``divisor`` (default the group's size) divides the sum:
    over a (dp, sp) group the sequence spans' partial sums add and the
    batch blocks average."""
    if group is None:
        return
    n = dist.get_world_size(group) if divisor is None else divisor
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


def mesh_mean_(tensors, mesh, axes=("dp", "sp")) -> None:
    """A mesh step's gradients (and loss) in place: summed over the
    group of ``axes`` and divided by the ``dp`` size, so the partial
    sums of sequence spans (and pipeline stages) add and the batch
    blocks average.  With dp alone it is :func:`dp_mean_`."""
    if mesh is not None:
        dp_mean_(tensors, mesh.group(axes), mesh.shape.get("dp", 1))


def world_group() -> Optional[object]:
    """The default group when ``torch.distributed`` is up, else None."""
    if dist.is_available() and dist.is_initialized() and \
            dist.get_world_size() > 1:
        return dist.group.WORLD
    return None
