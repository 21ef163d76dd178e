"""The bridge: engine staging buffers → device tensors (counterpart of
nvme_strom_tpu/ops/bridge.py).

On a CUDA device every host→device copy runs the hand-written
``h2d_copy`` kernel (csrc/h2d_copy.cu, replacing the TPU's
``_pallas_h2d`` DMA) on a side stream, reading page-locked host memory
through its mapped device pointer: the engine's staging pool (which the
engine registers with CUDA on first use) or a ``pin_memory`` slab.  A
:class:`Transfer` carries the output tensor and a CUDA event recorded
after the copy; a staging buffer or slab is released or overwritten only
once that event has completed.

Byte accounting: a byte counts as direct only when the copy reads it
from page-locked memory CUDA has registered.  Host memory that is not
(a host-side join, an owning array) is first copied into a pinned
buffer and counted in ``bounce_bytes``.  On the CPU ``torch.from_numpy``
would alias the staging buffer, so the CPU path copies and counts the
copy as bounce, as the JAX package does for PJRT's CPU client.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from nvme_strom_tpu_torch import _build
from nvme_strom_tpu_torch.device import resolve_device
from nvme_strom_tpu_torch.io.engine import HostMapping, StromEngine

_SIDE_STREAMS: Dict[int, torch.cuda.Stream] = {}


def side_stream(dev: torch.device) -> "torch.cuda.Stream":
    """The bridge's copy stream on ``dev`` (one per device)."""
    s = _SIDE_STREAMS.get(dev.index)
    if s is None:
        s = _SIDE_STREAMS[dev.index] = torch.cuda.Stream(dev)
    return s


def pinned_mapping(t: torch.Tensor, dev: torch.device) -> HostMapping:
    """A ``pin_memory=True`` tensor (or a strided view of one) with its
    address on ``dev``; the mapping spans every byte the view reaches."""
    ptr = ctypes.c_void_p()
    _build.check(_build.kernel_library().strom_host_device_pointer(
        t.data_ptr(), dev.index, ctypes.byref(ptr)),
        "cudaHostGetDevicePointer")
    extent = (1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
              if t.numel() else 0)
    return HostMapping(t.data_ptr(), extent * t.element_size(), ptr.value)


def _host_bytes(src) -> np.ndarray:
    if isinstance(src, torch.Tensor):
        src = src.numpy()
    return np.asarray(src).reshape(-1).view(np.uint8)


# -- kernel 1: the host→device copy ----------------------------------------

def h2d_copy_plain(src, dst: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`h2d_copy`: ``dst.copy_`` of the host
    bytes."""
    dst.copy_(torch.from_numpy(_host_bytes(src)))
    return dst


def h2d_copy(src, dst: torch.Tensor, src_ptr: Optional[int] = None
             ) -> torch.Tensor:
    """Copy the host bytes ``src`` (numpy array or CPU tensor) into the
    flat uint8 tensor ``dst`` on PyTorch's current stream.

    On a CUDA ``dst`` this launches the ``h2d_copy`` kernel and needs
    ``src_ptr``, the device-visible address of ``src``'s first byte in
    page-locked memory (:class:`HostMapping.device_ptr`); the caller
    keeps ``src`` alive and unmodified until the copy has finished.  On
    a CPU ``dst`` it runs :func:`h2d_copy_plain`."""
    host = _host_bytes(src)
    if dst.dtype != torch.uint8 or dst.dim() != 1 or \
            not dst.is_contiguous():
        raise ValueError("dst must be a contiguous 1-D uint8 tensor")
    if dst.numel() != host.nbytes:
        raise ValueError(f"dst holds {dst.numel()} bytes, src "
                         f"{host.nbytes}")
    if dst.device.type == "cpu":
        return h2d_copy_plain(host, dst)
    if dst.device.type != "cuda":
        raise ValueError(f"unsupported device {dst.device}")
    if src_ptr is None:
        raise ValueError("a CUDA copy reads page-locked memory through "
                         "its device pointer: pass src_ptr")
    if host.nbytes:
        stream = torch.cuda.current_stream(dst.device).cuda_stream
        _build.check(_build.kernel_library().strom_h2d_copy(
            src_ptr, dst.data_ptr(), host.nbytes, stream,
            dst.device.index), "h2d_copy")
        h2d_copy.launches += 1
    return dst


#: launches of the h2d_copy kernel (CUDA only)
h2d_copy.launches = 0


class Transfer:
    """A device tensor whose host→device copy may still be in flight.
    ``keep`` holds host memory the copy reads until it is done."""

    __slots__ = ("tensor", "event", "keep")

    def __init__(self, tensor: torch.Tensor,
                 event: Optional["torch.cuda.Event"] = None, keep=None):
        self.tensor = tensor
        self.event = event
        self.keep = keep

    def is_ready(self) -> bool:
        return self.event is None or self.event.query()

    def synchronize(self) -> None:
        if self.event is not None:
            self.event.synchronize()
        self.keep = None


def host_to_device(engine: Optional[StromEngine], host, dev: torch.device,
                   mappings: Sequence[HostMapping] = ()) -> Transfer:
    """Host bytes → a flat uint8 tensor on ``dev``, with the byte
    accounting of the module docstring.

    CUDA: the copy reads ``host`` in place when it lies in one of
    ``mappings`` or of the engine's (``engine.cuda_mappings``: its
    registered staging pool, and a scatter store's rows); otherwise
    through a pinned bounce buffer.  It runs on the side stream, then an event is
    recorded.  CPU: a copy, counted as bounce."""
    flat = _host_bytes(host)
    n = flat.nbytes
    stats = engine.stats if engine is not None else None
    if dev.type == "cpu":
        if stats is not None:
            stats.add(bounce_bytes=n, bytes_to_device=n)
        return Transfer(torch.from_numpy(flat.copy()))
    ptr = flat.ctypes.data
    maps = list(mappings)
    if engine is not None:
        maps.extend(engine.cuda_mappings(dev.index))
    src_ptr = next((p for p in (m.device_ptr(ptr, n) for m in maps)
                    if p is not None), None)
    keep = None
    if src_ptr is None:
        keep = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        keep.numpy()[:] = flat
        src_ptr = pinned_mapping(keep, dev).dev_base
        if stats is not None:
            stats.add(bounce_bytes=n)
    side = side_stream(dev)
    out = torch.empty(n, dtype=torch.uint8, device=dev)
    # The allocator may hand back a block that work already queued on
    # the current stream still reads (a consumer of an earlier chunk):
    # the copy waits for that work before it writes.
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        h2d_copy(flat, out, src_ptr=src_ptr)
        event = torch.cuda.Event()
        event.record(side)
    out.record_stream(side)
    if stats is not None:
        stats.add(bytes_to_device=n)
    return Transfer(out, event, keep)


def _shaped(t: torch.Tensor, dtype, shape) -> torch.Tensor:
    if dtype is not None:
        t = t.view(dtype)
    if shape is not None:
        t = t.reshape(shape)
    return t


class OverlapStage:
    """Double-buffered host→device stage of ``DeviceStream.stream_ranges``
    for staging pools too small to hold the stream's copies in flight.

    Two slabs of ``chunk_bytes`` (``pin_memory`` on CUDA).  Per chunk:
    the completed staging view is copied into the next slab, the staging
    buffer can be released at once (so the NVMe read of chunk K+1
    overlaps the device copy of chunk K), and the device copy starts
    from the slab.  A slab is never overwritten before the transfer it
    sources has completed — the rotation invariant.

    ``transfer(host_view, dtype, shape) -> Transfer``-like is
    injectable (tests); the default is :func:`host_to_device`."""

    def __init__(self, engine: StromEngine, dev: torch.device,
                 chunk_bytes: int, transfer: Optional[Callable] = None):
        self.engine = engine
        self.dev = dev
        self.chunk_bytes = chunk_bytes
        self._slabs: List[np.ndarray] = []
        self._maps: List[HostMapping] = []
        for _ in range(2):
            if dev.type == "cuda":
                t = torch.empty(chunk_bytes, dtype=torch.uint8,
                                pin_memory=True)
                self._maps.append(pinned_mapping(t, dev))
                self._slabs.append(t.numpy())
            else:
                self._slabs.append(np.empty(chunk_bytes, dtype=np.uint8))
        self._busy: list = [None, None]
        self._k = 0
        self._transfer = transfer or self._default_transfer

    def _default_transfer(self, host: np.ndarray, dtype, shape):
        t = host_to_device(self.engine, host, self.dev, self._maps)
        t.tensor = _shaped(t.tensor, dtype, shape)
        return t

    def put(self, view: np.ndarray, dtype, shape):
        """Stage one completed chunk of at most ``chunk_bytes`` and start
        its device copy.  Blocks only when both slabs still source
        copies in flight."""
        n = view.nbytes
        if n > self.chunk_bytes:
            raise ValueError(f"a {n}-byte chunk does not fit the "
                             f"{self.chunk_bytes}-byte slabs")
        k = self._k
        self._k ^= 1
        prev = self._busy[k]
        if prev is not None:
            prev.synchronize()      # the slab's last copy is done
            self._busy[k] = None
        slab = self._slabs[k][:n]
        slab[:] = view.reshape(-1).view(np.uint8)
        t = self._transfer(slab, dtype, shape)
        self._busy[k] = t
        self.engine.stats.add(overlap_chunks=1, overlap_bytes=n)
        return t

    def close(self) -> None:
        """Wait out the copies in flight, then drop the slabs."""
        for i, t in enumerate(self._busy):
            if t is not None:
                t.synchronize()
                self._busy[i] = None
        self._slabs = []
        self._maps = []


class StagingRetirePool:
    """Deferred staging release for read → host step → device pipelines
    (the weight loader).  ``push(release, transfers)``: completed heads
    retire as soon as their copies report ready; once more than
    ``depth`` entries are outstanding the oldest is waited for.  A
    staging buffer is released only after every copy out of it has
    completed."""

    def __init__(self, depth: int = 3):
        self.depth = max(0, depth)
        self._q: list = []

    def push(self, release, transfers) -> None:
        if release is None:
            return
        self._q.append((release, list(transfers)))
        self.drain_ready()
        while len(self._q) > self.depth:
            self._retire_oldest()

    def drain_ready(self) -> None:
        while self._q and all(t.is_ready() for t in self._q[0][1]):
            self._q.pop(0)[0]()

    def _retire_oldest(self) -> None:
        release, transfers = self._q.pop(0)
        for t in transfers:
            t.synchronize()
        release()

    def flush(self) -> None:
        while self._q:
            self._retire_oldest()


class DeviceStream:
    """Pipelined NVMe → device chunk stream over one engine.

    ``depth`` reads stay in flight while earlier chunks ride to the
    device.  Yields device tensors whose copies have completed.

    At its fullest the stream holds ``3 * depth`` staging buffers: up to
    ``2 * depth`` reads submitted and ``depth`` copies in flight.  When
    the engine's pool has that many (``overlap`` false), each copy reads
    its staging buffer in place and releases it once done.  A smaller
    pool would make reads wait for buffers that copies hold, so chunks
    then go through the :class:`OverlapStage`, which frees each staging
    buffer as soon as its bytes are in a slab.  ``overlap_transfer``
    replaces the stage's transfer (tests)."""

    def __init__(self, engine: StromEngine, device=None, depth: int = 3,
                 overlap_transfer: Optional[Callable] = None):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.engine = engine
        self.device = resolve_device(device)
        self.depth = depth
        self.overlap = engine.n_buffers < 3 * depth
        self.overlap_transfer = overlap_transfer

    def _put(self, view: np.ndarray, dtype, shape) -> Transfer:
        t = host_to_device(self.engine, view, self.device)
        t.tensor = _shaped(t.tensor, dtype, shape)
        return t

    def stream_file(self, path, chunk_bytes: Optional[int] = None,
                    dtype=None) -> Iterator[torch.Tensor]:
        """Device tensors of consecutive file chunks (uint8 unless
        ``dtype``; chunk_bytes must then be a multiple of its size)."""
        chunk = chunk_bytes or self.engine.config.chunk_bytes
        if chunk > self.engine.config.chunk_bytes:
            raise ValueError("chunk_bytes exceeds engine buffer capacity")
        fh = self.engine.open(path)
        try:
            size = self.engine.file_size(fh)
            yield from self.stream_ranges(
                fh, [(o, min(chunk, size - o)) for o in range(0, size,
                                                              chunk)],
                dtype=dtype)
        finally:
            self.engine.close(fh)

    def stream_ranges(self, fh: int, ranges: Sequence[tuple],
                      dtype=None, shapes: Optional[Sequence] = None
                      ) -> Iterator[torch.Tensor]:
        """Device tensors of arbitrary (offset, length) ranges of an
        open file."""
        pending: list = []   # (PendingRead, shape)
        inflight: list = []  # (Transfer, PendingRead or None)
        stage = (OverlapStage(self.engine, self.device,
                              self.engine.config.chunk_bytes,
                              transfer=self.overlap_transfer)
                 if self.overlap else None)

        def drain_one():
            t, pr = inflight.pop(0)
            t.synchronize()          # the device owns the bytes now
            if pr is not None:
                pr.release()
            return t.tensor

        def start_transfer():
            pr, shp = pending.pop(0)
            try:
                view = pr.wait()
                if stage is None:    # the copy reads the staging buffer
                    inflight.append((self._put(view, dtype, shp), pr))
                    return
                t = stage.put(view, dtype, shp)
            except BaseException:
                pr.release()
                raise
            pr.release()             # staging recycles now: the overlap
            inflight.append((t, None))

        ranges = list(ranges)
        shapes_l = list(shapes) if shapes is not None else None
        try:
            i = 0
            while i < len(ranges):
                take = ranges[i:i + self.depth]
                prs = self.engine.submit_readv([(fh, off, ln)
                                                for off, ln in take])
                for j, pr in enumerate(prs):
                    shape = shapes_l[i + j] if shapes_l is not None else None
                    pending.append((pr, shape))
                i += len(take)
                while len(pending) > self.depth:
                    start_transfer()
                    while len(inflight) > self.depth:
                        yield drain_one()
            while pending:
                start_transfer()
            while inflight:
                yield drain_one()
        finally:
            for pr, _ in pending:
                try:
                    pr.wait()
                except OSError:
                    pass
                pr.release()
            for t, pr in inflight:
                t.synchronize()
                if pr is not None:
                    pr.release()
            if stage is not None:
                stage.close()

    def read_to_device(self, path, dtype=None, shape=None) -> torch.Tensor:
        """A whole file as one device tensor, joined on the device."""
        parts = list(self.stream_file(path))
        if not parts:
            out = torch.zeros(0, dtype=torch.uint8, device=self.device)
        elif len(parts) == 1:
            out = parts[0]
        else:
            out = torch.cat(parts)
        return _shaped(out, dtype, shape)


# -- the write side: device → host → NVMe -----------------------------------

def submit_chunked_writes(engine: StromEngine, fh: int, offset: int,
                          host: np.ndarray, pend: list) -> int:
    """Pipelined engine writes of the bytes ``host`` at ``offset`` of an
    open handle, in chunks of at most one staging buffer.  In-flight
    writes live in the caller's ``pend`` list (bounded here at the
    engine's queue depth), so several calls can share one pipeline; the
    caller waits out ``pend`` before closing ``fh``.  Returns the bytes
    confirmed by the waits done here."""
    chunk = engine.config.chunk_bytes
    depth = engine.config.queue_depth
    flat = _host_bytes(host)
    drained = 0
    for pos in range(0, flat.nbytes, chunk):
        pend.append(engine.submit_write(fh, offset + pos,
                                        flat[pos:pos + chunk]))
        while len(pend) >= depth:
            drained += pend.pop(0).wait()
    return drained


def write_from_device(engine: StromEngine, tensor: torch.Tensor, path,
                      offset: int = 0) -> int:
    """A tensor's bytes → ``path`` at ``offset`` through the engine.

    From a CUDA tensor the bytes go device→host into a pinned buffer
    (one copy on the current stream, waited for), whose chunks the
    engine then writes: O_DIRECT straight from the buffer when a chunk
    is alignment-conformant, bounced (and counted) by the engine
    otherwise.  A CPU tensor is written from its own memory.  Returns
    the bytes written."""
    t = tensor.detach().contiguous().reshape(-1).view(torch.uint8)
    if t.device.type == "cuda":
        pinned = torch.empty(t.numel(), dtype=torch.uint8, pin_memory=True)
        pinned.copy_(t)                      # synchronous to the host
        t = pinned
    elif t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device}")
    host = t.numpy()
    fh = engine.open(path, writable=True)
    total = 0
    pend: list = []
    try:
        total += submit_chunked_writes(engine, fh, offset, host, pend)
        while pend:
            total += pend.pop(0).wait()
    finally:
        for p in pend:
            try:
                p.wait()
            except OSError:
                pass
        engine.close(fh)
    return total


def to_device(engine: Optional[StromEngine], host: np.ndarray,
              dev: torch.device) -> torch.Tensor:
    """A numpy array → a tensor of its dtype and shape on ``dev`` through
    :func:`host_to_device` (so a CUDA copy runs ``h2d_copy``); the copy
    has completed when this returns."""
    arr = np.ascontiguousarray(host)
    t = host_to_device(engine, arr, dev)
    t.synchronize()
    dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
    return t.tensor.view(dtype).reshape(arr.shape)
