"""ctypes binding of the strom-io C++ engine (``csrc/strom_io.h``).

Counterpart of nvme_strom_tpu/io/engine.py.  The port loads its own
build of the engine (``_build.engine_library``).  Reads complete into
the engine's locked staging buffers and come back as zero-copy numpy
views; Python never copies payload bytes on the read side.  Writes
(``open(..., writable=True)`` + ``submit_write``) go O_DIRECT straight
from the caller's buffer when it, the offset and the length are
alignment-conformant, and bounce through a staging buffer otherwise
(the engine counts it).

One engine owns N submission rings (``EngineConfig.n_rings``, auto by
default: :func:`auto_ring_count`) over one staging pool, carved from the
process's pinned arena (``io/arena.py``, tag ``staging``) when it has
room.  A multi-ring engine owns the QoS scheduler (``io/sched.py``) that
grants each class's batches a ring; one ring (``STROM_RINGS=1``) is the
engine without a scheduler.  ``open`` keys each file by its identity
(``fstat`` on the engine's own descriptor), which the host-DRAM tier
(``io/hostcache.py``) keys its lines by, and every write drops the
tier's lines it overlaps (``notify_write``), at submit and again at
completion.

New for CUDA: the staging pool is registered with CUDA (mapped) the
first time a device copy reads it (:meth:`StromEngine.cuda_mapping`), so
the host→device kernel reads staging buffers in place; it is
unregistered, after the device has finished every copy out of it,
before the engine is destroyed.

Observability: each completed read and write is a ``strom.read`` /
``strom.write`` span (``strom.read.fallback`` for a buffered read) on
the engine's tracer (``global_tracer`` by default, utils/trace.py),
stamped with the C engine's own submit and completion nanoseconds and
carrying the causal context current at submit; disabled, it costs one
attribute test.  ``latency_histogram`` / ``latency_percentiles`` read
the engine's log2 latency histogram (``strom_get_latency``), which the
resilient engine derives its default hedge threshold from.

Recovery wraps this engine rather than living in it: ``io/faults.py``
``build_engine`` stacks ``FaultyEngine`` and ``ResilientEngine``
(retries, hedges, the write mirror) on it under ``STROM_FAULTS`` /
``STROM_RESILIENT``.  The engine owns its failure-domain supervisor
(``self.supervisor``, io/health.py; ``STROM_BREAKER=0`` builds none)
and its flight recorder (``self.flight``, io/flightrec.py;
``STROM_FLIGHT=0`` builds none).  The scheduler's admission poll
(``_ring_free_slots``) runs the supervision tick and masks the rings
whose breaker is open; scalar reads and writes go to a healthy ring
(``pick_ring``).  Each completed read and write is one flight record,
with its class (``op_klass``) and ring.  ``ring_restart``,
``set_ring_stall`` and ``read_buffered`` bind the C engine's hot
restart, stall injection and degraded pread.

Observability (obs/): under ``STROM_ATTRIB=1`` the engine attaches the
process's attribution collector to its tracer as a span sink, and its
flight dumps carry the collector's summary; ``ring_ledger``
(``RingTimeLedger``) integrates each ring's time busy, idle, stalled
and restarting, sampled at completion reaping (time-gated) and
exported as the ``ring_state_s`` gauge at every ``sync_stats``, which
also samples the ``strom.ring.inflight`` counter track while a trace
file is written; under ``STROM_DEBUG_PORT`` the first engine starts the
process's debug server (obs/debugsrv.py) and each engine attaches as
its live one until ``close_all``.
"""

from __future__ import annotations

import ctypes
import errno
import os
import time
from typing import List, Optional

import numpy as np

from nvme_strom_tpu_torch import _build
from nvme_strom_tpu_torch.io import arena as _arena
from nvme_strom_tpu_torch.io.arena import CudaRegistration, HostMapping
from nvme_strom_tpu_torch.obs.attrib import attach as attach_attrib
from nvme_strom_tpu_torch.obs.debugsrv import maybe_start_debug_server
from nvme_strom_tpu_torch.obs.ledger import RingTimeLedger
from nvme_strom_tpu_torch.utils.config import (BreakerConfig, EngineConfig,
                                               FlightConfig, SchedConfig)
from nvme_strom_tpu_torch.utils.stats import (StromStats,
                                              percentiles_from_log2_hist)
from nvme_strom_tpu_torch.utils.trace import (NO_CONTEXT, attach_context,
                                              global_tracer)

#: the request ids' ring bits bound the ring count (STROM_MAX_RINGS)
_MAX_RINGS = 64
#: buckets of the engine's log2-ns latency histograms (STROM_LAT_BUCKETS)
_LAT_BUCKETS = 64


class _FileInfo(ctypes.Structure):
    _fields_ = [
        ("size", ctypes.c_int64),
        ("supports_direct", ctypes.c_int32),
        ("block_size", ctypes.c_int32),
        ("fs_magic", ctypes.c_uint64),
    ]


class _PoolInfo(ctypes.Structure):
    _fields_ = [
        ("n_buffers", ctypes.c_uint32),
        ("free_buffers", ctypes.c_uint32),
        ("buf_bytes", ctypes.c_uint64),
        ("pool_bytes", ctypes.c_uint64),
        ("locked", ctypes.c_int32),
        ("queue_depth", ctypes.c_int32),
        ("in_flight", ctypes.c_uint32),
        ("deferred", ctypes.c_uint32),
        ("fixed_bufs", ctypes.c_int32),
        ("pad", ctypes.c_uint32),
        ("pool_base", ctypes.c_uint64),
    ]


class _StatsBlk(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint64) for n in (
        "bytes_direct", "bytes_fallback", "bounce_bytes",
        "bytes_written_direct", "requests_submitted", "requests_completed",
        "requests_failed", "retries", "bytes_resident",
        "submit_batches", "submit_syscalls_saved", "submit_enters")]


class _RdExt(ctypes.Structure):
    _fields_ = [
        ("fh", ctypes.c_int32),
        ("pad", ctypes.c_uint32),
        ("offset", ctypes.c_uint64),
        ("length", ctypes.c_uint64),
    ]


class _Completion(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.POINTER(ctypes.c_uint8)),
        ("len", ctypes.c_uint64),
        ("status", ctypes.c_int32),
        ("was_fallback", ctypes.c_int32),
        ("submit_ns", ctypes.c_uint64),
        ("complete_ns", ctypes.c_uint64),
    ]


class _RingInfo(ctypes.Structure):
    _fields_ = [
        ("ring_id", ctypes.c_uint32),
        ("n_buffers", ctypes.c_uint32),
        ("free_buffers", ctypes.c_uint32),
        ("deferred", ctypes.c_uint32),
        ("submitted", ctypes.c_uint64),
        ("completed", ctypes.c_uint64),
        ("inflight_io", ctypes.c_uint32),
        ("backend_uring", ctypes.c_int32),
        ("failed", ctypes.c_uint64),
        ("restarts", ctypes.c_uint64),
        ("parked", ctypes.c_uint32),
        ("stalled", ctypes.c_int32),
        ("oldest_inflight_ns", ctypes.c_uint64),
        ("fixed_bufs", ctypes.c_int32),
        ("reg_files", ctypes.c_int32),
        ("sqpoll", ctypes.c_int32),
    ]


def _nvme_hw_queues() -> int:
    """The most hardware queues of a visible NVMe namespace
    (``/sys/block/nvme*/mq`` holds one directory a queue); 0 unknown."""
    best = 0
    try:
        names = os.listdir("/sys/block")
    except OSError:
        return 0
    for d in names:
        if d.startswith("nvme"):
            try:
                best = max(best, len(os.listdir(f"/sys/block/{d}/mq")))
            except OSError:
                pass
    return best


def auto_ring_count() -> int:
    """Default ring count: a quarter of the CPUs, capped by the NVMe
    hardware queues, rounded down to a power of two, at most 8.  The
    engine caps it further by what its pool and queue depth can feed."""
    n = max(1, min(8, (os.cpu_count() or 1) // 4))
    mq = _nvme_hw_queues()
    if mq:
        n = max(1, min(n, mq))
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


_declared = False


def _lib() -> ctypes.CDLL:
    """The engine library with every bound function's signature."""
    global _declared
    lib = _build.engine_library()
    if _declared:
        return lib
    P, I, U32, U64, I64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                           ctypes.c_uint64, ctypes.c_int64)
    sigs = {
        "strom_engine_create_rings": (P, [U32, U32, U32, U64, U32, I, I]),
        "strom_engine_create_prealloc": (P, [U32, U32, U32, U64, U32, I,
                                             I, P, U64]),
        "strom_engine_pool_bytes": (U64, [U32, U32, U64, U32]),
        "strom_engine_destroy": (None, [P]),
        "strom_get_ring_info": (I, [P, U32, ctypes.POINTER(_RingInfo)]),
        "strom_ring_inflight": (I64, [P, U32]),
        "strom_file_ident": (I, [P, I, ctypes.POINTER(U64)]),
        "strom_check_file": (I, [ctypes.c_char_p,
                                 ctypes.POINTER(_FileInfo)]),
        "strom_get_pool_info": (None, [P, ctypes.POINTER(_PoolInfo)]),
        "strom_open": (I, [P, ctypes.c_char_p, I]),
        "strom_file_is_direct": (I, [P, I]),
        "strom_close": (I, [P, I]),
        "strom_file_size": (I64, [P, I]),
        "strom_submit_read": (I64, [P, I, U64, U64]),
        "strom_submit_read_ring": (I64, [P, U32, I, U64, U64]),
        "strom_submit_readv": (I, [P, ctypes.POINTER(_RdExt), U32,
                                   ctypes.POINTER(I64)]),
        "strom_submit_readv_ring": (I, [P, U32, ctypes.POINTER(_RdExt), U32,
                                        ctypes.POINTER(I64)]),
        "strom_wait": (I, [P, I64, ctypes.POINTER(_Completion)]),
        "strom_wait_timeout": (I, [P, I64, ctypes.POINTER(_Completion),
                                   U64]),
        "strom_release": (I, [P, I64]),
        "strom_submit_write": (I64, [P, I, U64, P, U64]),
        "strom_submit_write_ring": (I64, [P, U32, I, U64, P, U64]),
        "strom_ring_restart": (I64, [P, U32, U64]),
        "strom_set_ring_stall": (I, [P, U32, I]),
        "strom_read_buffered": (I64, [P, I, U64, U64, P]),
        "strom_crc32c": (U32, [P, U64, U32]),
        "strom_drain_stats": (None, [P, ctypes.POINTER(_StatsBlk)]),
        "strom_backend_is_uring": (I, [P]),
        "strom_get_latency": (None, [P, ctypes.POINTER(U64),
                                     ctypes.POINTER(U64)]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    _declared = True
    return lib


def crc32c(data: np.ndarray, crc: int = 0) -> int:
    """CRC32C (the engine's native implementation) of the bytes of a
    numpy array; ``crc`` chains spans."""
    arr = np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    return int(_lib().strom_crc32c(arr.ctypes.data, arr.nbytes, crc))


def check_file(path) -> dict:
    """O_DIRECT eligibility probe: size, supports_direct, block_size."""
    info = _FileInfo()
    rc = _lib().strom_check_file(os.fsencode(path), ctypes.byref(info))
    if rc < 0:
        raise OSError(-rc, os.strerror(-rc), str(path))
    return {"size": info.size, "supports_direct": bool(info.supports_direct),
            "block_size": info.block_size}


class BouncedBytes(np.ndarray):
    """Host bytes the engine already copied and counted in
    ``bounce_bytes`` (a degraded pread, :meth:`StromEngine.read_buffered`):
    pageable memory, which the bridge copies to the card through its
    pinned buffer without counting the bytes again.  Views and slices
    keep the type."""


def _ring_of(req_id: int) -> int:
    """The ring a request rode: its id carries it in the low bits."""
    return int(req_id) & (_MAX_RINGS - 1)


class PendingRead:
    """An in-flight read.  ``wait()`` returns a zero-copy numpy view into
    the staging buffer, valid until ``release()``."""

    def __init__(self, engine: "StromEngine", req_id: int, length: int,
                 fh: int = -1, offset: int = -1):
        self._engine = engine
        self._req_id = req_id
        self._length = length
        self.fh = fh
        self.offset = offset
        self._released = False
        self._view: Optional[np.ndarray] = None
        self._error: Optional[OSError] = None
        #: True once the completion came from the buffered path
        self.was_fallback = False
        #: the span's causal identity, taken at submit (utils/trace.py)
        self.trace_ctx = NO_CONTEXT
        #: the latency class, for the flight recorder
        self.op_klass: Optional[str] = None

    @property
    def length(self) -> int:
        """Bytes requested at submit (the view is shorter only at EOF)."""
        return self._length

    @property
    def ring(self) -> int:
        """The submission ring this request rode (failure-domain
        attribution, io/health.py)."""
        return _ring_of(self._req_id)

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block for the completed staging view.  ``timeout`` (seconds)
        raises TimeoutError with the request still live: wait again, or
        ``release()`` to abort."""
        if self._view is not None:
            return self._view
        if self._error is not None:
            raise self._error
        lib, h = self._engine._lib, self._engine._h
        comp = _Completion()
        if timeout is None:
            rc = lib.strom_wait(h, self._req_id, ctypes.byref(comp))
        else:
            ns = min(int(max(0.0, timeout) * 1e9), (1 << 63) - 1)
            rc = lib.strom_wait_timeout(h, self._req_id, ctypes.byref(comp),
                                        ns)
            if rc == -errno.ETIMEDOUT:
                raise TimeoutError(f"read {self._req_id} still in flight "
                                   f"after {timeout}s")
        flight = self._engine.flight
        if rc < 0:
            self.release()
            e = OSError(-rc, os.strerror(-rc))
            # the C ring counter has this failure: the supervisor must
            # not count it again through note_error
            e.engine_counted = True
            if flight is not None:
                flight.record("read", self.op_klass, self.ring, self.fh,
                              self.offset, 0, 0, "error", err=-rc)
            raise e
        n = int(comp.len)
        self.was_fallback = bool(comp.was_fallback)
        tracer = self._engine.tracer
        if tracer.enabled:
            tracer.add_span(
                "strom.read.fallback" if comp.was_fallback else "strom.read",
                int(comp.submit_ns), int(comp.complete_ns),
                ctx=self.trace_ctx, bytes=n)
        if flight is not None:
            flight.record("read", self.op_klass, self.ring, self.fh,
                          self.offset, n,
                          max(0, int(comp.complete_ns - comp.submit_ns))
                          // 1000,
                          "fallback" if comp.was_fallback else "ok")
        self._engine._sample_ring_states()
        self._view = (np.empty(0, dtype=np.uint8) if n == 0
                      else np.ctypeslib.as_array(comp.data, shape=(n,)))
        return self._view

    def is_ready(self) -> bool:
        """True once ``wait()`` would not block (errors included: the
        OSError is kept and raised by ``wait()``)."""
        if (self._view is not None or self._error is not None
                or self._released):
            return True
        try:
            self.wait(timeout=0.0)
            return True
        except TimeoutError:
            return False
        except OSError as e:
            self._error = e
            return True

    def release(self) -> None:
        """Return the staging buffer; waits first if the read is still
        in flight (the buffer is a live DMA target until then)."""
        if self._released:
            return
        lib, h = self._engine._lib, self._engine._h
        if lib.strom_release(h, self._req_id) == -errno.EBUSY:
            lib.strom_wait(h, self._req_id, None)
            lib.strom_release(h, self._req_id)
        self._released = True
        self._view = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


def wait_exact(pending, timeout: Optional[float] = None) -> np.ndarray:
    """``pending.wait(timeout)`` plus a strict length check: for plans
    that never cross EOF a short view means truncation or a device
    short read, and raises (after releasing the request)."""
    view = pending.wait(timeout)
    if view.nbytes != pending.length:
        pending.release()
        raise OSError(errno.EIO,
                      f"short read: got {view.nbytes} of {pending.length} "
                      f"expected bytes (fh={pending.fh} "
                      f"offset={pending.offset})")
    return view


class PendingWrite:
    """An in-flight write.  ``wait()`` returns the bytes written and
    frees the request; the source buffer is kept alive until then."""

    def __init__(self, engine: "StromEngine", req_id: int,
                 keepalive: np.ndarray, fh: int, offset: int):
        self._engine = engine
        self._req_id = req_id
        self._keepalive = keepalive
        self.fh = fh
        self.offset = offset
        self.length = keepalive.nbytes
        self.trace_ctx = NO_CONTEXT
        self.op_klass: Optional[str] = None
        self._done = False

    @property
    def ring(self) -> int:
        return _ring_of(self._req_id)

    def wait(self, timeout: Optional[float] = None) -> int:
        """Block until the write completes; the bytes written.
        ``timeout`` (seconds) raises TimeoutError with the write still
        live: wait again, or ``release()``."""
        lib, h = self._engine._lib, self._engine._h
        comp = _Completion()
        if timeout is None:
            rc = lib.strom_wait(h, self._req_id, ctypes.byref(comp))
        else:
            ns = min(int(max(0.0, timeout) * 1e9), (1 << 63) - 1)
            rc = lib.strom_wait_timeout(h, self._req_id, ctypes.byref(comp),
                                        ns)
            if rc == -errno.ETIMEDOUT:
                raise TimeoutError(f"write {self._req_id} still in flight "
                                   f"after {timeout}s")
        self._finish()
        flight = self._engine.flight
        if rc < 0:
            e = OSError(-rc, os.strerror(-rc))
            e.engine_counted = True   # as PendingRead.wait's
            if flight is not None:
                flight.record("write", self.op_klass, self.ring, self.fh,
                              self.offset, 0, 0, "error", err=-rc)
            raise e
        n = int(comp.len)
        tracer = self._engine.tracer
        if tracer.enabled:
            tracer.add_span("strom.write", int(comp.submit_ns),
                            int(comp.complete_ns), ctx=self.trace_ctx,
                            bytes=n)
        if flight is not None:
            flight.record("write", self.op_klass, self.ring, self.fh,
                          self.offset, n,
                          max(0, int(comp.complete_ns - comp.submit_ns))
                          // 1000, "ok")
        return n

    def release(self) -> None:
        """Abort: waits for the write to leave flight, frees it."""
        if not self._done:
            self._engine._lib.strom_wait(self._engine._h, self._req_id,
                                         None)
            self._finish()

    def _finish(self) -> None:
        self._engine._lib.strom_release(self._engine._h, self._req_id)
        self._done = True
        self._keepalive = None
        # the tier's staleness guard again at completion: a read
        # admitted after the submit may have filled pre-write bytes
        self._engine._hostcache_write_done(self.fh, self.offset,
                                           self.length)


class StromEngine:
    """The userspace handle to one strom-io engine: ``n_rings``
    submission rings over one locked staging pool of ``n_buffers``
    buffers of ``config.chunk_bytes``, and on more than one ring the
    QoS scheduler that grants them."""

    def __init__(self, config: Optional[EngineConfig] = None,
                 stats: Optional[StromStats] = None, tracer=None):
        self.config = config or EngineConfig()
        self.stats = stats if stats is not None else StromStats()
        #: where the read and write spans go (utils/trace.py); the first
        #: engine on a tracer charges its dropped spans
        self.tracer = tracer if tracer is not None else global_tracer
        if self.tracer.stats is None:
            self.tracer.stats = self.stats
        self._lib = _lib()
        c = self.config
        n_buffers = c.n_buffers
        # each ring needs two staging buffers and one queue slot: a tiny
        # engine stays on one ring
        n_rings = c.n_rings if c.n_rings > 0 else auto_ring_count()
        n_rings = max(1, min(n_rings, _MAX_RINGS, n_buffers // 2,
                             c.queue_depth))
        qd_ring = max(1, c.queue_depth // n_rings)
        bufs_ring = max(2, n_buffers // n_rings)
        uring, lock = (1 if c.use_io_uring else 0), \
            (1 if c.lock_buffers else 0)
        pool_bytes = int(self._lib.strom_engine_pool_bytes(
            n_rings, bufs_ring, c.chunk_bytes, c.alignment))
        slab = (_arena.carve_or_none(pool_bytes, "staging",
                                     stats=self.stats, lock=c.lock_buffers)
                if pool_bytes else None)
        self._h = None
        if slab is not None:
            self._h = self._lib.strom_engine_create_prealloc(
                n_rings, qd_ring, bufs_ring, c.chunk_bytes, c.alignment,
                uring, lock, slab.addr, slab.nbytes)
            if not self._h:
                slab.release()
                slab = None
        if slab is None:
            self._h = self._lib.strom_engine_create_rings(
                n_rings, qd_ring, bufs_ring, c.chunk_bytes, c.alignment,
                uring, lock)
        if not self._h:
            err = ctypes.get_errno()
            raise OSError(err, "strom_engine_create failed: "
                          + os.strerror(err))
        self._pool_slab = slab
        self.n_rings = n_rings
        self.n_buffers = bufs_ring * n_rings
        self._qd_ring = qd_ring
        self._ring_cap = qd_ring
        info = self.pool_info()
        #: the one owner of the staging pool's CUDA registration
        self._pool_reg = (slab.cuda if slab is not None else
                          CudaRegistration(info["pool_base"],
                                           info["pool_bytes"],
                                           "staging pool"))
        #: fh → (dev, ino, mtime_ns, size), the host tier's file key
        self._file_keys: dict = {}
        self._closed = False
        #: failure-domain supervisor (io/health.py); None under
        #: STROM_BREAKER=0, the engine without supervision
        self.supervisor = None
        bcfg = BreakerConfig()
        if bcfg.enabled:
            from nvme_strom_tpu_torch.io.health import EngineSupervisor
            self.supervisor = EngineSupervisor(self, bcfg)
        #: recent-op recorder (io/flightrec.py); None under STROM_FLIGHT=0
        self.flight = None
        fcfg = FlightConfig()
        if fcfg.enabled:
            from nvme_strom_tpu_torch.io.flightrec import FlightRecorder
            self.flight = FlightRecorder(fcfg, self.stats)
        #: the process's attribution collector (obs/attrib.py) on this
        #: engine's tracer as a span sink, under STROM_ATTRIB=1; each
        #: flight dump then opens with its summary
        self._attrib = attach_attrib(self.tracer, self.stats)
        if self._attrib is not None and self.flight is not None:
            self.flight.attrib = self._attrib
        #: per-ring time in state (obs/ledger.py), sampled at completion
        #: reaping (time-gated) and exported at every sync_stats
        self.ring_ledger = RingTimeLedger(n_rings)
        self._ring_sample_next = 0.0
        self._ring_counter_live = False
        self.scheduler = None
        if n_rings > 1:
            scfg = SchedConfig()
            if scfg.enabled:
                from nvme_strom_tpu_torch.io.sched import (QoSScheduler,
                                                           default_policies)
                self._ring_cap = max(1, scfg.max_inflight_per_ring
                                     or qd_ring)
                self.scheduler = QoSScheduler(
                    submit_ring=self._submit_readv_ring,
                    ring_free=self._ring_free_slots,
                    policies=default_policies(scfg.class_weights),
                    aging_rounds=scfg.aging_rounds, stats=self.stats,
                    ring_cap=self._ring_cap, tracer=self.tracer)
        #: the process's debug server (obs/debugsrv.py) under
        #: STROM_DEBUG_PORT, with this engine as its live one
        self._debug_srv = maybe_start_debug_server(self.stats, engine=self)

    # -- files --------------------------------------------------------------

    def open(self, path, writable: bool = False) -> int:
        """A handle for engine reads (and writes when ``writable``); the
        engine tries O_DIRECT first and falls back to buffered I/O.  The
        file's identity comes from ``fstat`` on the engine's own
        descriptor, never the path, so a rename racing the open cannot
        key one file's lines under another's."""
        fh = self._lib.strom_open(self._h, os.fsencode(path),
                                  1 if writable else 0)
        if fh < 0:
            raise OSError(-fh, os.strerror(-fh), str(path))
        ident = (ctypes.c_uint64 * 4)()
        if self._lib.strom_file_ident(self._h, fh, ident) == 0:
            self._file_keys[fh] = tuple(int(x) for x in ident)
        return fh

    def file_key(self, fh: int) -> Optional[tuple]:
        """The identity of the file behind ``fh`` that the host tier
        keys lines by; None when unknown (the tier skips the fh)."""
        return self._file_keys.get(fh)

    def file_is_direct(self, fh: int) -> bool:
        return self._lib.strom_file_is_direct(self._h, fh) == 1

    def close(self, fh: int) -> None:
        self._lib.strom_close(self._h, fh)
        self._file_keys.pop(fh, None)

    def file_size(self, fh: int) -> int:
        n = self._lib.strom_file_size(self._h, fh)
        if n < 0:
            raise OSError(-n, os.strerror(-n))
        return n

    # -- rings --------------------------------------------------------------

    def ring_info(self, ring: int) -> dict:
        """One ring's occupancy and counters (``strom_get_ring_info``)."""
        info = _RingInfo()
        rc = self._lib.strom_get_ring_info(self._h, ring, ctypes.byref(info))
        if rc < 0:
            raise OSError(-rc, os.strerror(-rc))
        return {n: int(getattr(info, n)) for n, _ in _RingInfo._fields_}

    def ring_depths(self) -> List[int]:
        """Each ring's in-flight I/O (submitted minus completed) from
        the lock-free counters: the admission poll's source."""
        return [max(0, int(self._lib.strom_ring_inflight(self._h, r)))
                for r in range(self.n_rings)]

    def _ring_free_slots(self) -> List[int]:
        free = [max(0, self._ring_cap - d) for d in self.ring_depths()]
        if self.supervisor is not None:
            # the admission poll is the supervision heartbeat (gated
            # inside), and an open ring reports no headroom
            self.supervisor.tick()
            free = self.supervisor.mask_free_slots(free)
        return free

    def ring_restart(self, ring: int, drain_timeout_s: float = 0.5) -> int:
        """Hot-restart one ring (``strom_ring_restart``): its parked
        requests complete -ECANCELED (their waiters' retry is the
        requeue), dispatched I/O drains within ``drain_timeout_s``, the
        ring is rebuilt.  Returns the requests cancelled; raises
        TimeoutError when in-flight I/O would not drain (the ring goes
        on untouched), OSError otherwise."""
        t0 = time.monotonic()
        rc = self._lib.strom_ring_restart(self._h, ring,
                                          max(1, int(drain_timeout_s * 1e9)))
        # charged explicitly: the ~10 Hz sampler would mostly miss it
        self.ring_ledger.note_restart(ring, time.monotonic() - t0)
        if rc == -errno.ETIMEDOUT:
            raise TimeoutError(f"ring {ring}: in-flight I/O did not drain "
                               f"within {drain_timeout_s}s; restart "
                               "aborted")
        if rc < 0:
            raise OSError(-rc, os.strerror(-rc))
        return int(rc)

    def _sample_ring_states(self) -> None:
        """Charge the time since the last sample to each ring's state
        (obs/ledger.py): from completion reaping and stats syncs, at
        most ~10 times a second."""
        now = time.monotonic()
        if now < self._ring_sample_next or self._closed:
            return
        self._ring_sample_next = now + 0.1
        states = (self.supervisor.ring_states()
                  if self.supervisor is not None else None)
        self.ring_ledger.sample(self.ring_depths(), states, now=now)

    def set_ring_stall(self, ring: int, on: bool = True) -> None:
        """Arm or disarm the C engine's stall injection on ``ring``:
        armed, the ring parks every dispatch (a wedged ring as its
        waiters see it); disarmed, the parked requests dispatch."""
        rc = self._lib.strom_set_ring_stall(self._h, ring, 1 if on else 0)
        if rc < 0:
            raise OSError(-rc, os.strerror(-rc))

    def read_buffered(self, fh: int, offset: int,
                      length: int) -> BouncedBytes:
        """The degraded mode's read: one synchronous buffered pread into
        a new pageable array, with no ring and no staging buffer (the C
        engine counts the bytes as fallback and bounce).  Short only at
        EOF."""
        arr = np.empty(max(0, length), dtype=np.uint8).view(BouncedBytes)
        if length <= 0:
            return arr
        n = self._lib.strom_read_buffered(self._h, fh, offset, length,
                                          arr.ctypes.data)
        if n < 0:
            raise OSError(-n, os.strerror(-n))
        return arr[:int(n)]

    # -- reads --------------------------------------------------------------

    def _check_lengths(self, reads) -> None:
        chunk = self.config.chunk_bytes
        for _fh, _off, length in reads:
            if length > chunk:
                raise ValueError(f"read length {length} exceeds chunk_bytes "
                                 f"{chunk}; split the range")

    def submit_read(self, fh: int, offset: int, length: int,
                    klass: Optional[str] = None,
                    ring: Optional[int] = None) -> PendingRead:
        """One read, round-robin over the rings whose breaker is not open
        (``ring`` pins one).  Scalar reads are the retry, hedge and probe
        path and bypass the scheduler; ``klass`` routes nothing and is
        kept for the flight recorder."""
        self._check_lengths([(fh, offset, length)])
        if ring is None and self.supervisor is not None:
            ring = self.supervisor.pick_ring()
        if ring is None:
            rid = self._lib.strom_submit_read(self._h, fh, offset, length)
        else:
            rid = self._lib.strom_submit_read_ring(self._h, ring, fh,
                                                   offset, length)
        if rid < 0:
            raise OSError(-rid, os.strerror(-rid))
        pending = PendingRead(self, rid, length, fh=fh, offset=offset)
        pending.op_klass = klass
        if self.tracer.enabled:
            # the span may be waited on another thread: carry the
            # context from here
            pending.trace_ctx = attach_context()
        return pending

    def _submit_readv_ring(self, reads, ring: Optional[int]) -> list:
        """One vectored C call to ``ring`` (or the engine's round-robin
        pick when None): the scheduler's dispatch callback."""
        reads = list(reads)
        n = len(reads)
        exts = (_RdExt * n)()
        for i, (fh, offset, length) in enumerate(reads):
            exts[i].fh, exts[i].offset, exts[i].length = fh, offset, length
        rids = (ctypes.c_int64 * n)()
        if ring is None and self.supervisor is not None:
            # batches without a scheduler avoid open rings too
            ring = self.supervisor.pick_ring()
        if ring is None:
            rc = self._lib.strom_submit_readv(self._h, exts, n, rids)
        else:
            rc = self._lib.strom_submit_readv_ring(self._h, ring, exts, n,
                                                   rids)
        if rc < 0:
            raise OSError(-rc, os.strerror(-rc))
        out = [PendingRead(self, int(rids[i]), reads[i][2], fh=reads[i][0],
                           offset=reads[i][1]) for i in range(n)]
        if self.tracer.enabled:
            for p in out:
                p.trace_ctx = attach_context()
        return out

    def submit_readv(self, reads, klass: Optional[str] = None,
                     ring: Optional[int] = None) -> list:
        """One C call (one io_uring doorbell) for a batch of
        ``(fh, offset, length)`` reads; validation is all-or-nothing.

        ``klass`` is the batch's latency class: on a multi-ring engine
        the scheduler grants it a ring, and the call may block behind
        higher classes.  ``ring`` pins a ring and bypasses the
        scheduler.  A one-ring engine submits at once."""
        reads = list(reads)
        if not reads:
            return []
        self._check_lengths(reads)
        if self.scheduler is not None and ring is None:
            return self.scheduler.submit(reads, klass)
        out = self._submit_readv_ring(reads, ring)
        for p in out:
            p.op_klass = klass
        return out

    # -- writes -------------------------------------------------------------

    def submit_write(self, fh: int, offset: int,
                     data: np.ndarray) -> PendingWrite:
        """Write the bytes of ``data`` at ``offset``; the returned
        request keeps ``data`` alive until ``wait()``.  The host tier's
        lines over the range are dropped now and again at completion."""
        arr = np.ascontiguousarray(data).reshape(-1).view(np.uint8)
        ring = (self.supervisor.pick_ring()
                if self.supervisor is not None else None)
        if ring is None:
            rid = self._lib.strom_submit_write(self._h, fh, offset,
                                               arr.ctypes.data, arr.nbytes)
        else:
            # a write retry never resubmits into an open ring
            rid = self._lib.strom_submit_write_ring(
                self._h, ring, fh, offset, arr.ctypes.data, arr.nbytes)
        if rid < 0:
            raise OSError(-rid, os.strerror(-rid))
        self._hostcache_write_done(fh, offset, arr.nbytes)
        pending = PendingWrite(self, rid, arr, fh, offset)
        if self.tracer.enabled:
            pending.trace_ctx = attach_context()
        return pending

    def _hostcache_write_done(self, fh: int, offset: int,
                              length: int) -> None:
        fkey = self._file_keys.get(fh)
        if fkey is not None and length > 0:
            from nvme_strom_tpu_torch.io.hostcache import notify_write
            notify_write(fkey, offset, length, stats=self.stats)

    # -- CUDA ---------------------------------------------------------------

    def cuda_mapping(self, device_index: int) -> HostMapping:
        """The staging pool page-locked and mapped for CUDA device
        ``device_index`` (registered on first use)."""
        return self._pool_reg.mapping(device_index)

    def cuda_mappings(self, device_index: int) -> list:
        """Every host range a device copy may read in place, each
        registered the first time a copy reads it: the staging pool,
        the host tier's lines, and the arena's bridge slabs."""
        from nvme_strom_tpu_torch.io import hostcache
        out = [self._pool_reg.on(device_index)]
        cache = hostcache.get_cache(self)
        if cache is not None:
            out.append(cache.arena.cuda.on(device_index))
        arena = _arena.get_arena()
        if arena is not None:
            out.extend(s.cuda.on(device_index) for s in arena.live("bridge"))
        return out

    # -- stats / lifecycle --------------------------------------------------

    def latency_histogram(self) -> dict:
        """Submit→complete latency of the engine's successful requests,
        log2-ns buckets: entry i of each list counts requests in
        [2^i, 2^(i+1)) ns (``strom_get_latency``)."""
        rd = (ctypes.c_uint64 * _LAT_BUCKETS)()
        wr = (ctypes.c_uint64 * _LAT_BUCKETS)()
        self._lib.strom_get_latency(self._h, rd, wr)
        return {"read": [int(x) for x in rd], "write": [int(x) for x in wr]}

    def latency_percentiles(self, kind: str = "read",
                            ps=(50, 90, 99)) -> dict:
        """Approximate percentiles (ns) of ``kind`` ("read" or "write")
        from the log2 histogram; 0 while it is empty."""
        return percentiles_from_log2_hist(self.latency_histogram()[kind], ps)

    def pool_info(self) -> dict:
        info = _PoolInfo()
        self._lib.strom_get_pool_info(self._h, ctypes.byref(info))
        return {n: int(getattr(info, n)) for n, _ in _PoolInfo._fields_}

    def sync_stats(self) -> dict:
        """Drain the C counters (read-and-zero) into ``self.stats``; a
        multi-ring engine also sets the ``ring_depths`` gauge."""
        blk = _StatsBlk()
        self._lib.strom_drain_stats(self._h, ctypes.byref(blk))
        snap = {n: int(getattr(blk, n)) for n, _ in _StatsBlk._fields_}
        self.stats.merge_engine(snap)
        if self.n_rings > 1:
            self.stats.set_gauges(ring_depths=self.ring_depths())
        self._sample_ring_states()
        self.ring_ledger.export(self.stats)
        # ``exports`` read defensively: a caller may swap in its own
        # span sink as ``tracer`` (one with ``enabled`` and ``add_span``)
        if self.n_rings > 1 and getattr(self.tracer, "exports", False):
            # per-ring in-flight on the spans' timeline while I/O is in
            # flight, then one zero sample that returns the track to 0
            depths = self.ring_depths()
            live = any(depths)
            if live or self._ring_counter_live:
                self.tracer.add_counter(
                    "strom.ring.inflight",
                    {str(i): d for i, d in enumerate(depths)})
            self._ring_counter_live = live
        return snap

    @property
    def backend(self) -> str:
        return ("io_uring" if self._lib.strom_backend_is_uring(self._h)
                else "threadpool")

    def close_all(self) -> None:
        """Wake every submitter blocked in the scheduler, drain the
        counters, unregister the pool from CUDA (after every queued
        device copy out of it has finished), destroy the engine, and
        return the pool's carve to the arena."""
        if self._closed:
            return
        self._closed = True
        if self._debug_srv is not None:
            # the server outlives engines: it only stops routing here
            self._debug_srv.detach_engine(self)
            self._debug_srv = None
        if self.supervisor is not None:
            self.supervisor.close()
        if self.scheduler is not None:
            self.scheduler.close()
        self.sync_stats()
        self._pool_reg.unregister(final=True)
        self._lib.strom_engine_destroy(self._h)
        if self._pool_slab is not None:
            self._pool_slab.release()
            self._pool_slab = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close_all()
