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
    A failure returns None, counted in ``ici_fallbacks`` and logged, so
    the caller reads everything itself: the restore browns out to the
    read-all path.  Across processes only a failed share read browns
    out; a fault of the exchange itself raises :class:`ExchangeError`.

Two layouts.  With one process (an :class:`ExchangeGroup`), the process
drives every rank (the JAX package's single-process emulation): several
ranks may share one card, each with its own buffers, and the process
reads every share.  With ``torch.distributed`` up and more than one
process (:class:`ProcessExchange`, one rank a process), each process
reads only its own share (the JAX ``my_hosts``), the peers' slots and
flags are mapped through CUDA IPC handles swapped over the process
group, and each process launches kernel 7 for its own rank; on the CPU
the rows are all-gathered over gloo.  Two ranks on one card are refused:
the ring's spinning kernels would be time-sliced against each other.
That refusal, a failed IPC allocation or open, a failed launch and a ring
wait past its budget raise :class:`ExchangeError` and fail the restore.
Knobs: ``STROM_ICI_SCATTER`` (default off), ``STROM_ICI_HOSTS``,
``STROM_ICI_UNIT_BYTES``.  Counters: ``ici_bytes_read``,
``ici_bytes_received`` (the peers' bytes, 0 with one process),
``ici_fallbacks``.
"""

from __future__ import annotations

import contextlib
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
from nvme_strom_tpu_torch.parallel.mesh import (
    ExchangeGroup, all_gather_object, barrier, control_group, exchange_group,
    local_device, process_info)
from nvme_strom_tpu_torch.utils.trace import global_tracer

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
        #: utils/trace.py Tracer of the ``strom.ici.exchange`` span
        self.tracer = tracer if tracer is not None else global_tracer

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
        if self.tracer.enabled:
            t3 = time.monotonic_ns()
            # ring_s: the priming copies and the ring (it waits for
            # both); out_s: the host buffer and the copy out of rank 0
            self.tracer.add_span(
                "strom.ici.exchange", t0, t3, category="strom.ici",
                hosts=self.n, bytes=int(self.n * nbytes),
                backend="cuda" if cuda else "plain",
                ring_s=(t2 - t1) / 1e9, out_s=(t3 - t2) / 1e9)
        return got


class _CudaArray:
    """A raw device allocation seen by torch (``__cuda_array_interface__``),
    kept alive by the tensor made from it."""

    def __init__(self, ptr: int, shape: tuple):
        self.__cuda_array_interface__ = {
            "shape": tuple(shape), "typestr": "|u1", "data": (ptr, False),
            "strides": None, "version": 2}


class ExchangeError(RuntimeError):
    """A fault of the exchange across processes itself: two ranks on one
    card, CUDA IPC, kernel 7's launch or a ring wait past its budget.
    Never browned out: the restore fails with it."""


@contextlib.contextmanager
def _exchange_faults(what: str):
    """Raise what fails inside as an :class:`ExchangeError`."""
    try:
        yield
    except ExchangeError:
        raise
    except Exception as e:
        raise ExchangeError(f"ici: {what}: {type(e).__name__}: {e}") from e


class _IpcBuffer:
    """A zeroed device allocation of this rank, its IPC handle, and the
    peers' allocations opened from theirs (``ptrs[r]``, this rank's
    own at ``ptrs[rank]``)."""

    def __init__(self, device: torch.device, nbytes: int, rank: int):
        lib = _build.kernel_library()
        self.device, self.lib, self.nbytes = device, lib, nbytes
        ptr = ctypes.c_void_p()
        handle = ctypes.create_string_buffer(64)
        _build.check(lib.strom_ipc_alloc(device.index, nbytes,
                                         ctypes.byref(ptr), handle),
                     "ici ipc alloc")
        self.ptr = ptr.value
        self.opened: List[int] = []
        try:
            handles = all_gather_object(handle.raw)
            self.ptrs = []
            for r, h in enumerate(handles):
                if r == rank:
                    self.ptrs.append(self.ptr)
                    continue
                peer = ctypes.c_void_p()
                _build.check(lib.strom_ipc_open(
                    device.index, ctypes.create_string_buffer(h, 64),
                    ctypes.byref(peer)), f"ici ipc open of rank {r}")
                self.opened.append(peer.value)
                self.ptrs.append(peer.value)
        except BaseException:
            self.close()
            raise

    def tensor(self, shape: tuple) -> torch.Tensor:
        return torch.as_tensor(_CudaArray(self.ptr, shape),
                               device=self.device)

    def close(self) -> None:
        for p in self.opened:
            self.lib.strom_ipc_close(self.device.index, p)
        self.opened = []
        if self.ptr:
            self.lib.strom_ipc_free(self.device.index, self.ptr)
            self.ptr = 0


class ProcessExchange:
    """All-gather of byte rows, one rank a process (``torch.distributed``
    up with ``n`` > 1 processes): rank r contributes row r.

    On a card each rank's slots ``(n, width)`` and its ring flags are IPC
    allocations of its own, made once (the slots again only when a call
    is wider than any before) and freed by :meth:`close`; the handles
    are swapped over the gloo control group, each process primes its
    own row through kernel 1, the ranks meet at a barrier, and each
    launches kernel 7 for its own rank with system-scope flags (every
    neighbour is another card).  On the CPU the rows are all-gathered
    over gloo.  Every fault raises :class:`ExchangeError`, two ranks on
    one card at construction."""

    def __init__(self, stats=None, tracer=None):
        self.rank, self.n = process_info()
        self.device = local_device()
        self.stats = stats
        self.tracer = tracer if tracer is not None else global_tracer
        self.is_cuda = self.device.type == "cuda"
        self._flags = None
        self._slots = None
        self.base = 0
        self.calls = 0
        self.last_kernel_ms = None
        if self.is_cuda:
            with _exchange_faults("set-up across processes"):
                self._open_cuda()

    def _open_cuda(self) -> None:
        uuid = str(torch.cuda.get_device_properties(self.device).uuid)
        cards = all_gather_object(uuid)
        if len(set(cards)) != len(cards):
            raise ExchangeError(
                f"ici: ranks {cards} share a card; the ring across "
                "processes needs one rank a card (two spinning ranks "
                "on one card are time-sliced against each other)")
        lib = _build.kernel_library()
        cap, chunk = ctypes.c_int(), ctypes.c_uint()
        _build.check(lib.strom_ici_ring_capacity(
            self.device.index, ctypes.byref(cap), ctypes.byref(chunk)),
            "ici_ring_gather capacity")
        self.blocks = min(all_gather_object(cap.value))
        self.chunk = chunk.value
        self._flags = _IpcBuffer(self.device, 4 * self.blocks, self.rank)
        self._err = torch.zeros(1, dtype=torch.int32, device=self.device)
        host = torch.zeros(1, dtype=torch.int32, pin_memory=True)
        self._err_host = host
        with torch.cuda.device(self.device):
            self._err_ptr = pinned_mapping(host, self.device).dev_base

    def host_rows(self, row_bytes: int) -> torch.Tensor:
        """A zeroed ``(n, row_bytes)`` host tensor; this rank fills its
        own row (page-locked on a card)."""
        buf = torch.zeros((self.n, _padded(row_bytes)), dtype=torch.uint8,
                          pin_memory=self.is_cuda)
        return buf[:, :row_bytes]

    def all_gather(self, rows) -> torch.Tensor:
        """Every rank's row ``rows[r]`` of its own ``(n, row_bytes)``
        host tensor, gathered: the same host tensor on every rank."""
        nbytes = rows.shape[1]
        width = _padded(nbytes)
        t0 = time.monotonic_ns()
        with _exchange_faults("exchange across processes"):
            if not self.is_cuda:
                mine = torch.zeros(width, dtype=torch.uint8)
                mine[:nbytes] = rows[self.rank]
                parts = [torch.empty_like(mine) for _ in range(self.n)]
                torch.distributed.all_gather(parts, mine,
                                             group=control_group())
                got = torch.stack(parts)[:, :nbytes]
                backend = "plain"
            else:
                got = self._ring(rows, nbytes, width)
                backend = "cuda"
        if self.tracer.enabled:
            self.tracer.add_span(
                "strom.ici.exchange", t0, time.monotonic_ns(),
                category="strom.ici", hosts=self.n,
                bytes=int(self.n * nbytes), backend=backend,
                rank=self.rank)
        return got

    def _ring(self, rows, nbytes: int, width: int) -> torch.Tensor:
        lib = _build.kernel_library()
        dev = self.device
        host = rows
        if not host.is_pinned():
            staged = self.host_rows(nbytes)
            staged.copy_(host)
            host = staged
            if self.stats is not None:
                self.stats.add(bounce_bytes=int(nbytes))
        n = self.n
        if self._slots is None or self._slots.nbytes < n * width:
            # every rank grows at the same call: the widths agree, and
            # the last call's closing barrier has passed on every rank
            if self._slots is not None:
                self._slots.close()
                self._slots = None
            self._slots = _IpcBuffer(dev, n * width, self.rank)
        slots = self._slots
        mine = slots.tensor((n, width))
        with torch.cuda.device(dev):
            if nbytes:
                h2d_copy(host[self.rank], mine[self.rank, :nbytes],
                         src_ptr=pinned_mapping(host, dev).device_ptr(
                             host[self.rank].data_ptr(), nbytes))
            torch.cuda.current_stream(dev).synchronize()
        barrier()                       # every rank's own row is primed
        C = ring_chunks(width, self.blocks, self.chunk)
        with torch.cuda.device(dev):
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            _build.check(lib.strom_ici_ring(
                (ctypes.c_uint64 * n)(*slots.ptrs),
                (ctypes.c_uint64 * n)(*self._flags.ptrs),
                (ctypes.c_int * 1)(self.rank), 1, n, (1 << n) - 1,
                width, self.blocks, self.base, RING_BUDGET_NS,
                self._err.data_ptr(), self._err_ptr,
                current_stream(dev.index), dev.index), "ici_ring_gather")
            ici_ring_gather.launches += 1
            ev1.record()
            _build.check(lib.strom_stream_synchronize(
                current_stream(dev.index), dev.index),
                "ici_ring_gather wait")
        #: milliseconds of the last call's kernel on this rank's card
        self.last_kernel_ms = ev0.elapsed_time(ev1)
        if int(self._err_host[0]):
            raise ExchangeError(
                f"ici_ring_gather: a ring wait on {dev} ran out of its "
                f"{RING_BUDGET_NS / 1e9:.0f} s budget")
        self.base = (self.base + (n - 1) * C) & 0xFFFFFFFF
        self.calls += 1
        out = torch.empty((n, width), dtype=torch.uint8, pin_memory=True)
        out.copy_(mine)
        barrier()       # no rank writes the next call's rows before this
        return out[:, :nbytes]

    def close(self) -> None:
        for buf in (self._slots, self._flags):
            if buf is not None:
                buf.close()
        self._slots = self._flags = None


def _multi_process() -> bool:
    return process_info()[1] > 1


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
    from the gathered bytes.  With one process it reads all ranks'
    shares, so ``ici_bytes_read`` is the payload total and
    ``ici_bytes_received`` stays 0.  With several processes and no
    ``group`` (or a :class:`ProcessExchange`) each process reads only
    its own share and receives the rest; the processes agree before the
    exchange, so a share that fails on one browns every one out.  The
    set-up and the exchange are recorded as
    ``strom.ici.scatter`` and ``strom.ici.exchange`` spans on the
    engine's tracer (utils/trace.py) when it is enabled.  Returns None,
    counted in ``ici_fallbacks`` and logged, for a group of one rank or
    on any failure but one: a fault of the exchange across processes
    (:class:`ExchangeError`, two ranks on one card among them) raises."""
    stats = engine.stats
    tracer = getattr(engine, "tracer", None)
    if tracer is None:
        tracer = global_tracer

    def fall_back(why: str) -> None:
        _log.warning("ici scatter disabled for this restore: %s (falling "
                     "back to local full reads)", why)
        stats.add(ici_fallbacks=1)

    t0 = time.monotonic_ns()
    own = None
    if group is None and _multi_process():
        group = own = ProcessExchange(stats=stats, tracer=tracer)
    per_process = isinstance(group, ProcessExchange)
    try:
        exchange = (group if per_process
                    else IciExchange(group, stats=stats, tracer=tracer))
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
        mine = [exchange.rank] if per_process else range(exchange.n)
        failed = None
        try:
            for p in paths:
                fhs.append(engine.open(p))
            for h in mine:
                _read_share(engine, fhs, manifest.units_for(h), rows[h])
        except Exception as e:
            if not per_process:
                raise
            failed = f"{type(e).__name__}: {e}"
        finally:
            for fh in fhs:
                engine.close(fh)
        if per_process:
            # every rank takes the same road: a peer left waiting in the
            # exchange would hang until the group's timeout
            verdicts = all_gather_object(failed)
            if any(verdicts):
                fall_back(f"a share read failed: {verdicts}")
                return None
        t_read = time.monotonic_ns() - t_read
        gathered = exchange.all_gather(rows)
        for h in mine:
            # every row was read here: each must come back bit-identical,
            # or the exchange is not trusted with the restore
            if not torch.equal(gathered[h], rows[h]):
                raise (ExchangeError if per_process else RuntimeError)(
                    f"ici: exchange corrupted host {h}'s share row")
        store = ScatterStore(paths, manifest, gathered,
                             host_bytes_read={h: manifest.host_bytes[h]
                                              for h in mine})
        read = sum(manifest.host_bytes[h] for h in mine)
        stats.add(ici_bytes_read=int(read),
                  ici_bytes_received=int(manifest.total_bytes - read))
        if tracer.enabled:
            tracer.add_span(
                "strom.ici.scatter", t0, time.monotonic_ns(),
                category="strom.ici", hosts=exchange.n, files=len(paths),
                total_bytes=int(manifest.total_bytes), read_s=t_read / 1e9)
        return ScatterServeEngine(engine, store)
    except ExchangeError:
        raise
    except Exception as e:          # brown-out: the caller reads it all
        fall_back(f"{type(e).__name__}: {e}")
        return None
    finally:
        if own is not None:         # the gathered rows are host copies
            own.close()
