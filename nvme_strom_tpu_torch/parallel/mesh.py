"""Device meshes and the exchange's device groups (counterpart of
nvme_strom_tpu/parallel/mesh.py).

One process a rank: :func:`init_distributed` brings ``torch.distributed``
up (NCCL on the cards, gloo on the CPU, or gloo over CUDA tensors for
several ranks on one card), and :class:`Mesh` names axes (``dp``,
``tp``, ``sp``, ``pp``, ``ep``) over its ranks with a process group
along every set of axes.  The JAX package lets XLA insert the collectives a sharding
implies; the port calls them itself (parallel/collectives.py).

An :class:`ExchangeGroup` is an ordered list of devices; rank r stands
for virtual host r of the exchange (ops/ici.py).  By default the group
has one rank per visible card.  One process drives every rank, as the
JAX package's single-process exchange does with its local devices: a
device may appear several times, so one card can host several virtual
hosts, each with its own buffers on that card, and ``["cpu"] * 8``
runs the exchange's plain version on the CPU.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


class ExchangeGroup:
    """Ranks of the shard exchange: ``devices[r]`` holds virtual host
    r's buffers.  Every device is a CUDA device, or every one the CPU."""

    def __init__(self, devices: Sequence):
        devs = []
        for d in devices:
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", 0)
            devs.append(d)
        if not devs:
            raise ValueError("an exchange group needs at least one device")
        kinds = {d.type for d in devs}
        if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
            raise ValueError(f"an exchange group is all CUDA devices or all "
                             f"the CPU, got {[str(d) for d in devs]}")
        self.devices = tuple(devs)
        #: the exchange kernel's state for this group (ops/ici.py): its
        #: flag buffers and its count of calls
        self.ring = None

    @property
    def n(self) -> int:
        return len(self.devices)

    @property
    def is_cuda(self) -> bool:
        return self.devices[0].type == "cuda"

    def __repr__(self) -> str:
        return f"ExchangeGroup({[str(d) for d in self.devices]})"


def exchange_group(n_hosts: Optional[int] = None,
                   devices: Optional[Sequence] = None) -> ExchangeGroup:
    """The exchange's ranks: ``devices`` in order (a device may repeat),
    by default one per visible CUDA device.  ``n_hosts`` keeps the
    first ``n_hosts`` of them."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("no CUDA device for the exchange group "
                               "(pass devices, for example ['cpu'] * 8)")
        devs = [torch.device("cuda", i) for i in range(count)]
    else:
        devs = list(devices)
    if n_hosts is not None:
        if n_hosts < 1 or n_hosts > len(devs):
            raise ValueError(f"exchange_group: {n_hosts} hosts requested, "
                             f"{len(devs)} available")
        devs = devs[:n_hosts]
    return ExchangeGroup(devs)


def local_batch_slice(global_batch: int,
                      process_index: Optional[int] = None,
                      process_count: Optional[int] = None) -> slice:
    """The rows of the global batch this process provides.  The index
    and count default to ``torch.distributed``'s rank and world size
    once it is initialised, else to one process."""
    dist = torch.distributed
    up = dist.is_available() and dist.is_initialized()
    pi = process_index if process_index is not None else (
        dist.get_rank() if up else 0)
    pc = process_count if process_count is not None else (
        dist.get_world_size() if up else 1)
    if global_batch % pc:
        raise ValueError(
            f"global batch {global_batch} not divisible by {pc} processes")
    per = global_batch // pc
    return slice(pi * per, (pi + 1) * per)


def batch_sharding(mesh, axis: str = "dp", seq_axis: Optional[str] = None):
    """The :class:`~nvme_strom_tpu_torch.parallel.shardings.Sharding` of a
    (batch, seq, ...) array: dim 0 over ``axis`` and, with ``seq_axis``,
    dim 1 over it (the input of ring or Ulysses sequence parallelism).
    A ``seq_axis`` the mesh lacks raises."""
    from nvme_strom_tpu_torch.parallel.shardings import P, Sharding
    if seq_axis is not None and seq_axis not in mesh.shape:
        raise ValueError(
            f"mesh has no {seq_axis!r} axis for sequence sharding")
    return Sharding(mesh, P(axis) if seq_axis is None else P(axis, seq_axis))


# -- one process a rank: torch.distributed ------------------------------------

#: the gloo group over every rank that carries host-side control traffic
#: (barriers, object exchanges, the exchange's IPC handles) whatever the
#: backend of the tensors' collectives
_CONTROL = None
#: the device this process computes on, set by :func:`init_distributed`
_LOCAL_DEVICE: Optional[torch.device] = None

#: every mesh group made since :func:`init_distributed`, by its ranks:
#: meshes whose axes cut the same sets of ranks share one group (a new
#: NCCL group costs every rank about half a second on the cards)
_GROUPS: dict = {}

#: seconds a collective may wait for a peer before the process group
#: raises: a dead rank must fail its peers, not hang them
DEFAULT_TIMEOUT_S = 300.0


def _distributed() -> bool:
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None, device=None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Bring up ``torch.distributed``, one process a rank (counterpart
    of the JAX ``init_distributed``).

    The rank, world size and local rank come from ``RANK``,
    ``WORLD_SIZE`` and ``LOCAL_RANK`` as ``torchrun`` sets them (with
    its ``MASTER_ADDR`` / ``MASTER_PORT`` rendezvous), or from the
    arguments with an ``init_method`` such as ``file:///path`` or
    ``tcp://localhost:port``.  The device defaults to
    ``cuda:LOCAL_RANK`` when CUDA is there, else the CPU; the backend to
    NCCL on a card and gloo on the CPU.  ``backend="gloo"`` with CUDA
    devices runs several ranks on one card (NCCL refuses that).  A
    ``timeout_s`` bounds every collective's wait for a peer.  Returns
    False, doing nothing, when neither the environment nor the
    arguments name a group (one process), True once the group is up."""
    global _CONTROL, _LOCAL_DEVICE
    import datetime
    import os

    dist = torch.distributed
    env = os.environ
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if init_method is None:
        if "MASTER_ADDR" not in env or rank is None or world_size is None:
            return False
        init_method = "env://"
    if rank is None or world_size is None:
        raise ValueError(f"init_distributed({init_method!r}) needs a rank "
                         "and a world size (arguments or RANK / WORLD_SIZE)")
    local_rank = int(env.get("LOCAL_RANK", rank))
    if device is None:
        device = (torch.device("cuda", local_rank)
                  if torch.cuda.is_available() else torch.device("cpu"))
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    timeout = datetime.timedelta(seconds=timeout_s)
    kw = {}
    if backend == "nccl":
        kw["device_id"] = device
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timeout, **kw)
    _CONTROL = (dist.new_group(backend="gloo", timeout=timeout)
                if backend != "gloo" else dist.group.WORLD)
    _LOCAL_DEVICE = device
    _GROUPS.clear()
    return True


def shutdown_distributed() -> None:
    """Tear the process group down (a no-op without one)."""
    global _CONTROL, _LOCAL_DEVICE
    if _distributed():
        torch.distributed.destroy_process_group()
    _CONTROL = None
    _LOCAL_DEVICE = None
    _GROUPS.clear()


def control_group():
    """The gloo group of host-side control traffic (None with one
    process)."""
    return _CONTROL if _distributed() else None


def local_device() -> torch.device:
    """This process's device: the one :func:`init_distributed` chose, else
    ``cuda:0`` when there is a card, else the CPU."""
    if _LOCAL_DEVICE is not None:
        return _LOCAL_DEVICE
    return torch.device("cuda", 0) if torch.cuda.is_available() else \
        torch.device("cpu")


def process_info() -> tuple:
    """(this process's rank, the number of processes)."""
    if _distributed():
        return torch.distributed.get_rank(), torch.distributed.get_world_size()
    return 0, 1


def barrier() -> None:
    """Every rank reaches this point (a no-op with one process)."""
    if _distributed():
        torch.distributed.barrier(group=control_group())


def all_gather_object(obj) -> list:
    """Every rank's ``obj``, in rank order (``[obj]`` alone)."""
    if not _distributed():
        return [obj]
    out = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(out, obj, group=control_group())
    return out


class Mesh:
    """Named axes over the ranks of ``torch.distributed`` (counterpart
    of ``jax.sharding.Mesh`` as the JAX ``make_mesh`` builds it): rank r
    sits at the row-major position r of an array of the axes' sizes.
    ``shape`` maps each axis to its size; ``coords`` maps it to this
    rank's index along it.  :meth:`group` gives the process group of
    the ranks that differ from this one only along the named axes (None
    where that group is this rank alone).  Every group is made when the
    mesh is, by every rank in the same order, as ``new_group`` needs; a
    set of ranks an earlier mesh made a group for reuses that group."""

    def __init__(self, sizes: Sequence[int], names: Sequence[str],
                 rank: int = 0):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, (int(s) for s in sizes)))
        self.size = int(np.prod(list(self.shape.values()), dtype=np.int64))
        self.rank = int(rank)
        self.ranks = np.arange(self.size).reshape(
            [self.shape[a] for a in self.axis_names])
        pos = np.unravel_index(self.rank, self.ranks.shape)
        self.coords = {a: int(i) for a, i in zip(self.axis_names, pos)}
        self._groups: dict = {}
        if not (_distributed() and self.size > 1):
            return
        import itertools
        for k in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, k):
                for ranks in self._all_groups(axes):
                    if len(ranks) < 2:
                        continue
                    g = _GROUPS.get(tuple(ranks))
                    if g is None:
                        g = _GROUPS[tuple(ranks)] = \
                            torch.distributed.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[axes] = g

    def _all_groups(self, axes) -> list:
        """Every group of ranks that differ only along ``axes``, in a
        fixed order."""
        idx = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in idx]
        arr = np.transpose(self.ranks, rest + idx)
        return [sorted(int(r) for r in row.ravel())
                for row in arr.reshape(-1, int(np.prod(
                    [self.ranks.shape[i] for i in idx], dtype=np.int64)))]

    def _key(self, axes) -> tuple:
        if isinstance(axes, str):
            axes = (axes,)
        axes = tuple(a for a in self.axis_names if a in axes)
        return axes

    def group(self, axes):
        """The process group along ``axes`` (a name or names; those not
        in the mesh are dropped), or None where it holds one rank."""
        return self._groups.get(self._key(axes))

    def devices_coords(self) -> list:
        """Every rank's coordinates, in rank order."""
        return [dict(zip(self.axis_names, (int(i) for i in
                         np.unravel_index(r, self.ranks.shape))))
                for r in range(self.size)]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def make_mesh(axes, world_size: Optional[int] = None) -> Mesh:
    """A :class:`Mesh` from ``{axis: size}`` over the ranks of
    ``torch.distributed`` (one rank without it).  One axis may be -1 to
    take what the others leave.  The sizes must multiply to the world
    size: every rank is one device of the mesh."""
    rank, world = process_info()
    if world_size is not None:
        world = int(world_size)
    names = list(axes.keys())
    sizes = [int(s) for s in axes.values()]
    wild = [i for i, s in enumerate(sizes) if s == -1]
    if len(wild) > 1:
        raise ValueError("at most one axis may be -1")
    known = int(np.prod([s for s in sizes if s != -1], dtype=np.int64))
    if wild:
        if world % known:
            raise ValueError(f"{world} ranks not divisible by {known}")
        sizes[wild[0]] = world // known
    total = int(np.prod(sizes, dtype=np.int64))
    if total != world:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} "
                         f"ranks, the world has {world}")
    return Mesh(sizes, names, rank)
