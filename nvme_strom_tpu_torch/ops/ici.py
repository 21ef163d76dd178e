"""Read-once shard exchange (counterpart of nvme_strom_tpu/ops/ici.py).

Without it, every host of a group reads a checkpoint's or a model's
whole payload from its own NVMe.  With ``STROM_ICI_SCATTER=1`` each
host reads only its 1/N byte share through the ordinary planner path,
the group all-gathers the shares, and every later read of those files
is served from the gathered bytes (io/scatter.py).

:class:`IciExchange`
    All-gather of per-host byte rows over an :class:`ExchangeGroup`.
    Each rank's share row goes onto its device through kernel 1
    (``h2d_copy``), straight into that rank's own slot of its output;
    kernel 7 (``ici_ring_gather``, csrc/ici_ring.cu) then does the n-1
    ring pushes; rank 0's gathered rows are copied to page-locked host
    memory.  On a CPU group the same schedule runs as plain copies.

:func:`scatter_engine`
    Partition a file set into per-host shares, read them, exchange, and
    return a :class:`~nvme_strom_tpu_torch.io.scatter.ScatterServeEngine`.
    Any failure returns None, counted in ``ici_fallbacks`` and logged, so
    the caller reads everything itself: the restore browns out to the
    read-all path and never fails for the exchange's sake.

One process drives every rank (the JAX package's single-process
emulation): several ranks may share one card, each with its own
buffers.  Knobs: ``STROM_ICI_SCATTER`` (default off), ``STROM_ICI_HOSTS``,
``STROM_ICI_UNIT_BYTES``.  Counters: ``ici_bytes_read``,
``ici_bytes_received`` (0 here: no peers), ``ici_fallbacks``.
"""

from __future__ import annotations

import ctypes
import logging
import os
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from nvme_strom_tpu_torch import _build
from nvme_strom_tpu_torch.io.engine import wait_exact
from nvme_strom_tpu_torch.io.plan import plan_and_submit
from nvme_strom_tpu_torch.io.scatter import (ScatterServeEngine,
                                             ScatterStore, partition_files)
from nvme_strom_tpu_torch.device import current_stream
from nvme_strom_tpu_torch.ops.bridge import h2d_copy, pinned_mapping
from nvme_strom_tpu_torch.parallel.mesh import ExchangeGroup, exchange_group

_log = logging.getLogger(__name__)

#: share rows pad to this many bytes, so every chunk of a slot is
#: 16-byte aligned for the ring kernel
_ROW_ALIGN = 4096

#: default partition unit: share boundaries on 1 MiB lines, so each
#: host's span submits as large aligned reads
DEFAULT_UNIT_BYTES = 1 << 20

#: wall-clock budget of each spin-wait of the ring kernel: a protocol
#: fault raises after this instead of hanging the card
RING_BUDGET_NS = 2_000_000_000

#: most ranks of a CUDA group: the kernel takes every rank's pointers by
#: value in its parameters (csrc/ici_ring.cu kMaxRanks)
RING_MAX_RANKS = 64


def ici_scatter_enabled() -> bool:
    """``STROM_ICI_SCATTER=1`` turns the read-once scatter restore on;
    unset or ``0`` (the default) is the read-all path."""
    return os.environ.get("STROM_ICI_SCATTER", "0") not in ("", "0")


def ici_unit_bytes() -> int:
    """Partition unit of the per-host shares (``STROM_ICI_UNIT_BYTES``,
    default 1 MiB, at least 4 KiB so shares stay O_DIRECT-aligned)."""
    try:
        v = int(os.environ.get("STROM_ICI_UNIT_BYTES", DEFAULT_UNIT_BYTES))
    except ValueError:
        return DEFAULT_UNIT_BYTES
    return max(4096, v)


def ici_hosts() -> Optional[int]:
    """Pinned exchange width (``STROM_ICI_HOSTS``); None = one rank per
    visible card."""
    v = os.environ.get("STROM_ICI_HOSTS")
    if not v:
        return None
    try:
        return max(1, int(v))
    except ValueError:
        return None


def _padded(nbytes: int) -> int:
    return nbytes + (-nbytes) % _ROW_ALIGN


# -- kernel 7: the ring all-gather ---------------------------------------------

def ici_ring_gather_plain(slots: Sequence[torch.Tensor]
                          ) -> Sequence[torch.Tensor]:
    """Plain version of :func:`ici_ring_gather`: the ring schedule slot
    by slot.  At step k rank r copies slot ``(r - k) mod n`` of its
    output into the same slot of rank r+1's; within a step no rank reads
    a slot another rank writes, so this order gives the lockstep
    result."""
    n = len(slots)
    for step in range(n - 1):
        for r in range(n):
            src = (r - step) % n
            slots[(r + 1) % n][src].copy_(slots[r][src])
    return slots


def ring_chunks(width: int, blocks: int, chunk: int) -> int:
    """C, the chunks each block of a rank owns in a slot of ``width``
    bytes cut into ``chunk``-byte chunks over ``blocks`` blocks (the last
    of a block's chunks may lie past the slot's end).  Each call of the
    ring kernel adds (n-1)·C to every flag (csrc/ici_ring.cu)."""
    chunks = -(-width // chunk)
    return -(-chunks // blocks)


class _Ring:
    """A group's ring on its cards: ``blocks`` blocks per rank, the bytes
    of a ``chunk`` (the unit the kernel moves and signals), one flag
    per (rank, block) on the rank's card, an error word per card in
    device memory with its mirror in mapped page-locked host memory,
    ``base`` (the flags' value before the next call: each call adds
    (n-1)·C) and the count of completed calls.  The pointer arrays the
    kernel takes by value are built once here."""

    def __init__(self, group: ExchangeGroup):
        lib = _build.kernel_library()
        self.ranks_on = {}
        for r, d in enumerate(group.devices):
            self.ranks_on.setdefault(d.index, []).append(r)
        caps = []
        cap, chunk = ctypes.c_int(), ctypes.c_uint()
        for card, ranks in self.ranks_on.items():
            with torch.cuda.device(card):   # the call sets the device
                _build.check(lib.strom_ici_ring_capacity(
                    card, ctypes.byref(cap), ctypes.byref(chunk)),
                    "ici_ring_gather capacity")
            caps.append(cap.value // len(ranks))
        self.blocks = min(caps)
        self.chunk = chunk.value
        if self.blocks < 1:
            raise RuntimeError("ici_ring_gather: too many ranks on one card "
                               "for a block per rank")
        n = group.n
        self.remote_right = 0
        for r, d in enumerate(group.devices):
            right = group.devices[(r + 1) % n]
            if right.index != d.index:
                self.remote_right |= 1 << r
                with torch.cuda.device(d):
                    _build.check(lib.strom_enable_peer_access(d.index,
                                                              right.index),
                                 f"peer access {d} -> {right}")
        self.flags, self.err, self.err_host, self.err_ptr = {}, {}, {}, {}
        self.rank_ids = {}
        ptrs = [0] * n
        for card, ranks in self.ranks_on.items():
            dev = torch.device("cuda", card)
            f = torch.zeros(len(ranks) * self.blocks, dtype=torch.int32,
                            device=dev)
            self.flags[card] = f
            self.err[card] = torch.zeros(1, dtype=torch.int32, device=dev)
            host = torch.zeros(1, dtype=torch.int32, pin_memory=True)
            self.err_host[card] = host.numpy()   # read with no CUDA call
            with torch.cuda.device(dev):    # the call sets the device
                self.err_ptr[card] = pinned_mapping(host, dev).dev_base
            self.rank_ids[card] = (ctypes.c_int * len(ranks))(*ranks)
            for j, r in enumerate(ranks):
                ptrs[r] = f.data_ptr() + 4 * j * self.blocks
        self.flag_ptrs = (ctypes.c_uint64 * n)(*ptrs)
        self.base = 0
        self.calls = 0

    def reset(self) -> None:
        """After a failed call (every kernel has ended): zeroed flags and
        error words, a fresh base and count."""
        for card in self.ranks_on:
            self.flags[card].zero_()
            self.err[card].zero_()
            self.err_host[card][0] = 0
            torch.cuda.synchronize(card)
        self.base = 0
        self.calls = 0


def _check_slots(slots: Sequence[torch.Tensor], group: ExchangeGroup):
    n = group.n
    if len(slots) != n:
        raise ValueError(f"{len(slots)} slot arrays for a group of {n}")
    width = slots[0].shape[-1] if slots[0].dim() == 2 else -1
    for r, (s, d) in enumerate(zip(slots, group.devices)):
        if s.dtype != torch.uint8 or tuple(s.shape) != (n, width) or \
                not s.is_contiguous():
            raise ValueError(f"rank {r}: slots must be a contiguous "
                             f"({n}, width) uint8 tensor, got "
                             f"{tuple(s.shape)} {s.dtype}")
        if s.device != d:
            raise ValueError(f"rank {r}: slots on {s.device}, the group "
                             f"puts rank {r} on {d}")
    if width % 16:
        raise ValueError(f"slot width {width} is not a multiple of 16")
    if group.is_cuda and n > RING_MAX_RANKS:
        raise ValueError(f"the ring kernel takes at most {RING_MAX_RANKS} "
                         f"ranks, got {n}")


def ici_ring_gather(slots: Sequence[torch.Tensor],
                    group: ExchangeGroup) -> Sequence[torch.Tensor]:
    """Complete every rank's ``(n, width)`` uint8 output in place: on
    entry slot r of ``slots[r]`` holds rank r's row; on return every
    rank's output holds every row.  ``slots[r]`` lies on
    ``group.devices[r]``.

    On CUDA devices this launches kernel 7 once per card on its current
    stream and waits for it (its error word, in page-locked host memory,
    is read after the wait): a fault raises.  On one card nothing waits
    before the launch.  On the CPU it runs
    :func:`ici_ring_gather_plain`."""
    _check_slots(slots, group)
    if not group.is_cuda:
        return ici_ring_gather_plain(slots)
    if group.ring is None:
        group.ring = _Ring(group)
    ring = group.ring
    lib = _build.kernel_library()
    n = group.n
    width = slots[0].shape[1]
    C = ring_chunks(width, ring.blocks, ring.chunk)
    cards = list(ring.ranks_on)
    ptrs = (ctypes.c_uint64 * n)(*(s.data_ptr() for s in slots))
    try:
        if len(cards) > 1:
            # every rank's output is written by its left neighbour's
            # kernel on another card: nothing queued may still use it
            for card in cards:
                torch.cuda.synchronize(card)
        for card in cards:
            with torch.cuda.device(card):   # the launch sets the device
                _build.check(lib.strom_ici_ring(
                    ptrs, ring.flag_ptrs, ring.rank_ids[card],
                    len(ring.ranks_on[card]), n, ring.remote_right, width,
                    ring.blocks, ring.base, RING_BUDGET_NS,
                    ring.err[card].data_ptr(), ring.err_ptr[card],
                    current_stream(card), card), "ici_ring_gather")
            ici_ring_gather.launches += 1
        for card in cards:
            with torch.cuda.device(card):
                _build.check(lib.strom_stream_synchronize(
                    current_stream(card), card), "ici_ring_gather wait")
        failed = [card for card in cards if ring.err_host[card][0]]
        if failed:
            raise RuntimeError(
                f"ici_ring_gather: a ring wait on cuda:{failed} ran out of "
                f"its {RING_BUDGET_NS / 1e9:.0f} s budget")
    except BaseException:
        for card in cards:
            torch.cuda.synchronize(card)
        ring.reset()
        raise
    ring.base = (ring.base + (n - 1) * C) & 0xFFFFFFFF
    ring.calls += 1
    return slots


#: launches of the ici_ring_gather kernel (CUDA only)
ici_ring_gather.launches = 0


# -- the exchange ------------------------------------------------------------

class IciExchange:
    """All-gather of per-host byte rows over ``group`` (default:
    ``exchange_group(STROM_ICI_HOSTS)``).

    ``all_gather(rows)`` takes an ``(n, row_bytes)`` uint8 host array
    whose row h is host h's share and returns the gathered rows, byte
    for byte, as a host tensor (page-locked when the group is on CUDA).
    Rows pad to 4096 bytes on the devices; callers see exact bytes
    back."""

    def __init__(self, group: Optional[ExchangeGroup] = None, stats=None,
                 tracer=None):
        self.group = group if group is not None else exchange_group(
            ici_hosts())
        self.n = self.group.n
        self.stats = stats
        self.tracer = tracer

    def host_rows(self, row_bytes: int) -> torch.Tensor:
        """A zeroed ``(n, row_bytes)`` host tensor to pack the share rows
        into: on a CUDA group, rows of a page-locked buffer that
        :meth:`all_gather` copies to the devices in place."""
        buf = torch.zeros((self.n, _padded(row_bytes)), dtype=torch.uint8,
                          pin_memory=self.group.is_cuda)
        return buf[:, :row_bytes]

    def all_gather(self, rows) -> torch.Tensor:
        host = rows if torch.is_tensor(rows) else torch.from_numpy(
            np.ascontiguousarray(rows))
        if host.dim() != 2 or host.shape[0] != self.n or \
                host.dtype != torch.uint8 or host.device.type != "cpu":
            raise ValueError(f"rows {tuple(host.shape)} {host.dtype} on "
                             f"{host.device} != ({self.n}, row_bytes) uint8 "
                             "host array")
        nbytes = host.shape[1]
        width = _padded(nbytes)
        t0 = time.monotonic_ns()
        cuda = self.group.is_cuda
        if cuda and not host.is_pinned():
            staged = self.host_rows(nbytes)
            staged.copy_(host)
            host = staged
            if self.stats is not None:
                self.stats.add(bounce_bytes=host.numel())
        slots = [torch.empty((self.n, width), dtype=torch.uint8, device=d)
                 for d in self.group.devices]
        maps = {}
        for r, (slot, d) in enumerate(zip(slots, self.group.devices)):
            if nbytes and cuda:
                with torch.cuda.device(d):  # these calls set the device
                    if d not in maps:
                        maps[d] = pinned_mapping(host, d)
                    h2d_copy(host[r], slot[r, :nbytes], src_ptr=maps[d]
                             .device_ptr(host[r].data_ptr(), nbytes))
            elif nbytes:
                h2d_copy(host[r], slot[r, :nbytes])
            slot[r, nbytes:].zero_()
        t1 = time.monotonic_ns()
        ici_ring_gather(slots, self.group)
        t2 = time.monotonic_ns()
        out = torch.empty((self.n, width), dtype=torch.uint8, pin_memory=cuda)
        out.copy_(slots[0])
        got = out[:, :nbytes]
        if got.shape != host.shape:
            raise RuntimeError(f"ici: gather returned {tuple(got.shape)}, "
                               f"expected {tuple(host.shape)}")
        if self.tracer is not None and getattr(self.tracer, "enabled",
                                               False):
            t3 = time.monotonic_ns()
            # ring_s: the priming copies and the ring (it waits for
            # both); out_s: the host buffer and the copy out of rank 0
            self.tracer.add_span(
                "strom.ici.exchange", t0, t3, category="strom.ici",
                hosts=self.n, bytes=int(self.n * nbytes),
                backend="cuda" if cuda else "plain",
                ring_s=(t2 - t1) / 1e9, out_s=(t3 - t2) / 1e9)
        return got


def _read_share(engine, fhs: Sequence[int], units, row: torch.Tensor) -> int:
    """Pack one host's ``(file_idx, offset, length)`` units, in order,
    into ``row`` through the planner; returns the bytes packed.  The
    packing is a host copy and is counted in ``bounce_bytes``."""
    dst = row.numpy()
    per_extent = plan_and_submit(engine, [(fhs[fi], off, ln)
                                          for fi, off, ln in units])
    pend: List = [p for pieces in per_extent for p in pieces]
    pos = 0
    try:
        while pend:
            v = wait_exact(pend[0])         # a short read must fail HERE
            dst[pos:pos + v.nbytes] = v
            pos += v.nbytes
            pend.pop(0).release()
    finally:
        for p in pend:
            p.release()
    engine.stats.add(bounce_bytes=pos)
    return pos


def scatter_engine(engine, paths: Sequence[str],
                   group: Optional[ExchangeGroup] = None,
                   unit_bytes: Optional[int] = None, manifest=None
                   ) -> Optional[ScatterServeEngine]:
    """Read-once scatter front-end over ``engine`` for ``paths``.

    Partitions the files into per-host contiguous byte shares (or takes
    ``manifest``), reads every rank's share through ``plan_and_submit``,
    exchanges the shares over ``group``, and returns a
    :class:`ScatterServeEngine` serving every later read of those files
    from the gathered bytes.  One process reads all ranks' shares, so
    ``ici_bytes_read`` is the payload total and ``ici_bytes_received``
    stays 0.  When ``engine`` carries a ``tracer``, the set-up and the
    exchange are recorded as ``strom.ici.scatter`` and
    ``strom.ici.exchange`` spans.  Returns None, counted in
    ``ici_fallbacks`` and logged, for a group of one rank or on any
    failure."""
    stats = engine.stats
    tracer = getattr(engine, "tracer", None)

    def fall_back(why: str) -> None:
        _log.warning("ici scatter disabled for this restore: %s (falling "
                     "back to local full reads)", why)
        stats.add(ici_fallbacks=1)

    t0 = time.monotonic_ns()
    try:
        exchange = IciExchange(group, stats=stats, tracer=tracer)
        if exchange.n < 2:
            fall_back(f"exchange group has {exchange.n} rank(s)")
            return None
        if manifest is None:
            manifest = partition_files(
                [os.path.getsize(p) for p in paths], exchange.n,
                unit_bytes if unit_bytes is not None else ici_unit_bytes())
        elif manifest.n_hosts != exchange.n:
            fall_back(f"manifest built for {manifest.n_hosts} hosts, "
                      f"exchange group has {exchange.n}")
            return None
        row_bytes = max(manifest.host_bytes, default=0)
        if row_bytes == 0:
            fall_back("empty file set")
            return None
        rows = exchange.host_rows(row_bytes)
        t_read = time.monotonic_ns()
        fhs: List[int] = []
        try:
            for p in paths:
                fhs.append(engine.open(p))
            for h in range(exchange.n):
                _read_share(engine, fhs, manifest.units_for(h), rows[h])
        finally:
            for fh in fhs:
                engine.close(fh)
        t_read = time.monotonic_ns() - t_read
        gathered = exchange.all_gather(rows)
        for h in range(exchange.n):
            # every row was read here: each must come back bit-identical,
            # or the exchange is not trusted with the restore
            if not torch.equal(gathered[h], rows[h]):
                raise RuntimeError(
                    f"ici: exchange corrupted host {h}'s share row")
        store = ScatterStore(paths, manifest, gathered,
                             host_bytes_read=dict(enumerate(
                                 manifest.host_bytes)))
        stats.add(ici_bytes_read=int(manifest.total_bytes))
        if tracer is not None and getattr(tracer, "enabled", False):
            tracer.add_span(
                "strom.ici.scatter", t0, time.monotonic_ns(),
                category="strom.ici", hosts=exchange.n, files=len(paths),
                total_bytes=int(manifest.total_bytes), read_s=t_read / 1e9)
        return ScatterServeEngine(engine, store)
    except Exception as e:          # brown-out: the caller reads it all
        fall_back(f"{type(e).__name__}: {e}")
        return None
