"""Device groups for the read-once shard exchange (counterpart of
nvme_strom_tpu/parallel/mesh.py ``exchange_mesh`` and
``local_batch_slice``).

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
