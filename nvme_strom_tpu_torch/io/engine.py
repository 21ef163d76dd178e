"""ctypes binding of the strom-io C++ engine (``csrc/strom_io.h``).

Counterpart of nvme_strom_tpu/io/engine.py.  The port loads its own
build of the engine (``_build.engine_library``).  Reads complete into
the engine's locked staging buffers and come back as zero-copy numpy
views; Python never copies payload bytes on the read side.  Writes
(``open(..., writable=True)`` + ``submit_write``) go O_DIRECT straight
from the caller's buffer when it, the offset and the length are
alignment-conformant, and bounce through a staging buffer otherwise
(the engine counts it).

New for CUDA: :meth:`StromEngine.cuda_mapping` page-locks the staging
pool for a CUDA device (``cudaHostRegister``, mapped) the first time a
device transfer needs it, so the host→device kernel reads staging
buffers in place; the pool is unregistered before the engine is
destroyed.
"""

from __future__ import annotations

import ctypes
import errno
import os
from typing import Dict, Optional

import numpy as np

from nvme_strom_tpu_torch import _build
from nvme_strom_tpu_torch.utils.config import EngineConfig
from nvme_strom_tpu_torch.utils.stats import StromStats


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
        "strom_engine_create": (P, [U32, U32, U64, U32, I, I]),
        "strom_engine_destroy": (None, [P]),
        "strom_check_file": (I, [ctypes.c_char_p,
                                 ctypes.POINTER(_FileInfo)]),
        "strom_get_pool_info": (None, [P, ctypes.POINTER(_PoolInfo)]),
        "strom_open": (I, [P, ctypes.c_char_p, I]),
        "strom_file_is_direct": (I, [P, I]),
        "strom_close": (I, [P, I]),
        "strom_file_size": (I64, [P, I]),
        "strom_submit_read": (I64, [P, I, U64, U64]),
        "strom_submit_readv": (I, [P, ctypes.POINTER(_RdExt), U32,
                                   ctypes.POINTER(I64)]),
        "strom_wait": (I, [P, I64, ctypes.POINTER(_Completion)]),
        "strom_wait_timeout": (I, [P, I64, ctypes.POINTER(_Completion),
                                   U64]),
        "strom_release": (I, [P, I64]),
        "strom_submit_write": (I64, [P, I, U64, P, U64]),
        "strom_crc32c": (U32, [P, U64, U32]),
        "strom_drain_stats": (None, [P, ctypes.POINTER(_StatsBlk)]),
        "strom_backend_is_uring": (I, [P]),
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


class HostMapping:
    """A page-locked host range with its device-visible address."""

    __slots__ = ("host_base", "nbytes", "dev_base")

    def __init__(self, host_base: int, nbytes: int, dev_base: int):
        self.host_base = host_base
        self.nbytes = nbytes
        self.dev_base = dev_base

    def device_ptr(self, host_ptr: int, nbytes: int) -> Optional[int]:
        """Device address of [host_ptr, host_ptr+nbytes), or None when
        the range is not inside this mapping."""
        off = host_ptr - self.host_base
        if 0 <= off and off + nbytes <= self.nbytes:
            return self.dev_base + off
        return None


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

    @property
    def length(self) -> int:
        """Bytes requested at submit (the view is shorter only at EOF)."""
        return self._length

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
        if rc < 0:
            self.release()
            raise OSError(-rc, os.strerror(-rc))
        n = int(comp.len)
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

    def wait(self) -> int:
        lib, h = self._engine._lib, self._engine._h
        comp = _Completion()
        rc = lib.strom_wait(h, self._req_id, ctypes.byref(comp))
        lib.strom_release(h, self._req_id)
        self._keepalive = None
        if rc < 0:
            raise OSError(-rc, os.strerror(-rc))
        return int(comp.len)


class StromEngine:
    """The userspace handle to one strom-io engine: one submission ring
    over one locked staging pool of ``config.n_buffers`` buffers of
    ``config.chunk_bytes``."""

    def __init__(self, config: Optional[EngineConfig] = None,
                 stats: Optional[StromStats] = None):
        self.config = config or EngineConfig()
        self.stats = stats if stats is not None else StromStats()
        self._lib = _lib()
        c = self.config
        self.n_buffers = c.n_buffers
        self._h = self._lib.strom_engine_create(
            c.queue_depth, self.n_buffers, c.chunk_bytes, c.alignment,
            1 if c.use_io_uring else 0, 1 if c.lock_buffers else 0)
        if not self._h:
            err = ctypes.get_errno()
            raise OSError(err, "strom_engine_create failed: "
                          + os.strerror(err))
        self._mappings: Dict[int, HostMapping] = {}
        self._closed = False

    # -- files --------------------------------------------------------------

    def open(self, path, writable: bool = False) -> int:
        """A handle for engine reads (and writes when ``writable``); the
        engine tries O_DIRECT first and falls back to buffered I/O."""
        fh = self._lib.strom_open(self._h, os.fsencode(path),
                                  1 if writable else 0)
        if fh < 0:
            raise OSError(-fh, os.strerror(-fh), str(path))
        return fh

    def file_is_direct(self, fh: int) -> bool:
        return self._lib.strom_file_is_direct(self._h, fh) == 1

    def close(self, fh: int) -> None:
        self._lib.strom_close(self._h, fh)

    def file_size(self, fh: int) -> int:
        n = self._lib.strom_file_size(self._h, fh)
        if n < 0:
            raise OSError(-n, os.strerror(-n))
        return n

    # -- reads --------------------------------------------------------------

    def submit_read(self, fh: int, offset: int, length: int) -> PendingRead:
        if length > self.config.chunk_bytes:
            raise ValueError(f"read length {length} exceeds chunk_bytes "
                             f"{self.config.chunk_bytes}; split the range")
        rid = self._lib.strom_submit_read(self._h, fh, offset, length)
        if rid < 0:
            raise OSError(-rid, os.strerror(-rid))
        return PendingRead(self, rid, length, fh=fh, offset=offset)

    def submit_readv(self, reads) -> list:
        """One C call (one io_uring doorbell) for a batch of
        ``(fh, offset, length)`` reads; validation is all-or-nothing."""
        reads = list(reads)
        if not reads:
            return []
        for _fh, _off, length in reads:
            if length > self.config.chunk_bytes:
                raise ValueError(
                    f"read length {length} exceeds chunk_bytes "
                    f"{self.config.chunk_bytes}; split the range")
        n = len(reads)
        exts = (_RdExt * n)()
        for i, (fh, offset, length) in enumerate(reads):
            exts[i].fh, exts[i].offset, exts[i].length = fh, offset, length
        rids = (ctypes.c_int64 * n)()
        rc = self._lib.strom_submit_readv(self._h, exts, n, rids)
        if rc < 0:
            raise OSError(-rc, os.strerror(-rc))
        return [PendingRead(self, int(rids[i]), reads[i][2], fh=reads[i][0],
                            offset=reads[i][1]) for i in range(n)]

    # -- writes -------------------------------------------------------------

    def submit_write(self, fh: int, offset: int,
                     data: np.ndarray) -> PendingWrite:
        """Write the bytes of ``data`` at ``offset``; the returned
        request keeps ``data`` alive until ``wait()``."""
        arr = np.ascontiguousarray(data).reshape(-1).view(np.uint8)
        rid = self._lib.strom_submit_write(self._h, fh, offset,
                                           arr.ctypes.data, arr.nbytes)
        if rid < 0:
            raise OSError(-rid, os.strerror(-rid))
        return PendingWrite(self, rid, arr, fh, offset)

    # -- CUDA ---------------------------------------------------------------

    def cuda_mapping(self, device_index: int) -> HostMapping:
        """The staging pool page-locked and mapped for CUDA device
        ``device_index`` (registered on first use)."""
        m = self._mappings.get(device_index)
        if m is None:
            info = self.pool_info()
            klib = _build.kernel_library()
            dev_ptr = ctypes.c_void_p()
            _build.check(klib.strom_host_register(
                info["pool_base"], info["pool_bytes"], device_index,
                ctypes.byref(dev_ptr)), "cudaHostRegister(staging pool)")
            m = HostMapping(info["pool_base"], info["pool_bytes"],
                            dev_ptr.value)
            self._mappings[device_index] = m
        return m

    # -- stats / lifecycle --------------------------------------------------

    def pool_info(self) -> dict:
        info = _PoolInfo()
        self._lib.strom_get_pool_info(self._h, ctypes.byref(info))
        return {n: int(getattr(info, n)) for n, _ in _PoolInfo._fields_}

    def sync_stats(self) -> dict:
        """Drain the C counters (read-and-zero) into ``self.stats``."""
        blk = _StatsBlk()
        self._lib.strom_drain_stats(self._h, ctypes.byref(blk))
        snap = {n: int(getattr(blk, n)) for n, _ in _StatsBlk._fields_}
        self.stats.merge_engine(snap)
        return snap

    @property
    def backend(self) -> str:
        return ("io_uring" if self._lib.strom_backend_is_uring(self._h)
                else "threadpool")

    def close_all(self) -> None:
        """Drain the counters, unregister the pool from CUDA (after every
        queued device copy out of it has finished), destroy the engine."""
        if self._closed:
            return
        self._closed = True
        self.sync_stats()
        if self._mappings:
            import torch
            klib = _build.kernel_library()
            for dev, m in self._mappings.items():
                torch.cuda.synchronize(dev)
                _build.check(klib.strom_host_unregister(m.host_base, dev),
                             "cudaHostUnregister(staging pool)")
            self._mappings.clear()
        self._lib.strom_engine_destroy(self._h)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close_all()
