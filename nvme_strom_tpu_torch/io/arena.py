"""The pinned host arena: one reservation behind every page-locked
consumer (counterpart of nvme_strom_tpu/io/arena.py).

``strom_arena_create`` maps anonymous ``MAP_NORESERVE`` memory, virtual
until touched, and a first-fit allocator carves it into tagged slabs:

  ``staging``    engine staging pools (``strom_engine_create_prealloc``
                 stages into the carve and never unmaps it);
  ``hostcache``  the host-DRAM tier's lines (io/hostcache.py);
  ``bridge``     the overlap stage's two host→device slabs
                 (ops/bridge.py ``OverlapStage``).

Pages commit, and are mlocked (best effort, ``STROM_MLOCK``), per carve.
A carve that does not fit returns None and the consumer takes its
private mapping, counted as ``arena_fallbacks``.  ``STROM_ARENA=0``
removes the arena; ``STROM_ARENA_MB`` sizes the reservation (default
1024, virtual).

New for CUDA: every carve carries a :class:`CudaRegistration`.  A
carve is registered with CUDA (``cudaHostRegister``, mapped) the first
time a device copy reads a byte of it, so the ``h2d_copy`` kernel reads
it in place; registering the whole reservation would pin and commit all
of it.  ``Slab.release`` waits for the device (every copy queued out of
the carve has finished), unregisters, and only then returns the range to
the free list.  Carves are page-aligned and page-sized, so two carves
never share a page and their registrations never overlap.

While a trace file is being written (utils/trace.py), every carve and
release samples the ``strom.arena.occupancy`` counter track.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from nvme_strom_tpu_torch import _build
from nvme_strom_tpu_torch.utils.lockwitness import make_lock

#: carve alignment: every slab starts O_DIRECT- and page-aligned
CARVE_ALIGN = 4096


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


class CudaRegistration:
    """One host range, registered with CUDA for a device the first time
    a copy on that device reads it.  Exactly one object owns a range's
    registration: a second ``cudaHostRegister`` of an overlapping range
    fails in CUDA (``cudaErrorHostMemoryAlreadyRegistered``), and
    :func:`_build.check` raises it."""

    __slots__ = ("host_base", "nbytes", "what", "_maps", "_lock", "_closed")

    def __init__(self, host_base: int, nbytes: int, what: str):
        self.host_base = host_base
        self.nbytes = nbytes
        self.what = what
        self._maps: Dict[int, HostMapping] = {}
        self._lock = make_lock("arena.CudaRegistration._lock")
        self._closed = False

    @property
    def devices(self) -> List[int]:
        """The devices the range is registered for now."""
        with self._lock:
            return list(self._maps)

    def mapping(self, device_index: int) -> HostMapping:
        """The range's mapping for ``device_index``, registering it on
        first use; a failed registration raises."""
        with self._lock:
            if self._closed:
                raise RuntimeError(f"{self.what}: released, cannot map")
            m = self._maps.get(device_index)
            if m is None:
                dev_ptr = ctypes.c_void_p()
                _build.check(_build.kernel_library().strom_host_register(
                    self.host_base, self.nbytes, device_index,
                    ctypes.byref(dev_ptr)), f"cudaHostRegister({self.what})")
                m = HostMapping(self.host_base, self.nbytes, dev_ptr.value)
                self._maps[device_index] = m
            return m

    def device_ptr(self, host_ptr: int, nbytes: int,
                   device_index: int) -> Optional[int]:
        """Device address of [host_ptr, host_ptr+nbytes) on
        ``device_index`` (registering the range first), or None when it
        lies outside the range or the range is released."""
        off = host_ptr - self.host_base
        if self._closed or off < 0 or off + nbytes > self.nbytes:
            return None
        return self.mapping(device_index).dev_base + off

    def on(self, device_index: int) -> "LazyMapping":
        """This range as a ``device_ptr(host_ptr, nbytes)`` mapping for
        one device, registered only when a copy reads it."""
        return LazyMapping(self, device_index)

    def unregister(self, final: bool = False) -> None:
        """Wait for every device the range is registered for (no queued
        copy still reads it), then unregister it.  ``final`` refuses
        any later registration (the range is about to be freed)."""
        with self._lock:
            maps, self._maps = self._maps, {}
            self._closed = self._closed or final
        if not maps:
            return
        import torch
        klib = _build.kernel_library()
        for dev in maps:
            torch.cuda.synchronize(dev)
            _build.check(klib.strom_host_unregister(self.host_base, dev),
                         f"cudaHostUnregister({self.what})")


class LazyMapping:
    """A :class:`CudaRegistration` bound to one device, shaped like a
    :class:`HostMapping` for ``ops/bridge.py host_to_device``."""

    __slots__ = ("reg", "device_index")

    def __init__(self, reg: CudaRegistration, device_index: int):
        self.reg = reg
        self.device_index = device_index

    def device_ptr(self, host_ptr: int, nbytes: int) -> Optional[int]:
        return self.reg.device_ptr(host_ptr, nbytes, self.device_index)


_declared = False


def _arena_lib() -> ctypes.CDLL:
    """The engine library with the ``strom_arena_*`` signatures."""
    global _declared
    lib = _build.engine_library()
    if not _declared:
        lib.strom_arena_create.restype = ctypes.c_void_p
        lib.strom_arena_create.argtypes = [ctypes.c_uint64]
        lib.strom_arena_destroy.restype = None
        lib.strom_arena_destroy.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.strom_arena_lock.restype = ctypes.c_int
        lib.strom_arena_lock.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        _declared = True
    return lib


class Slab:
    """One tagged carve: a zero-copy numpy view, the base address for
    the C ABI, and the carve's CUDA registration.  ``release()`` is
    idempotent."""

    __slots__ = ("arena", "offset", "nbytes", "tag", "addr", "view",
                 "locked", "cuda", "_released")

    def __init__(self, arena: "PinnedArena", offset: int, nbytes: int,
                 tag: str):
        self.arena = arena
        self.offset = offset
        self.nbytes = nbytes
        self.tag = tag
        self.addr = arena.base + offset
        self.view = arena.view[offset:offset + nbytes]
        #: whether THIS carve's mlock held
        self.locked = False
        self.cuda = CudaRegistration(self.addr, nbytes,
                                     f"arena {tag} carve")
        self._released = False

    def release(self) -> None:
        """Unregister from CUDA once every device is done with the
        carve, then return it to the free list."""
        if self._released:
            return
        self._released = True
        self.cuda.unregister(final=True)
        self.view = None
        self.arena._free(self.offset, self.nbytes)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


class PinnedArena:
    """First-fit slab allocator over one native reservation.

    Thread-safe.  The free list keeps ``(offset, nbytes)`` ranges sorted
    by offset and coalesces neighbours on release.  Tagged bytes are
    disjoint and sum with the free ranges to the arena's size."""

    def __init__(self, nbytes: int, lock_pages: bool = True):
        if nbytes <= 0:
            raise ValueError("arena nbytes must be > 0")
        nbytes = (nbytes + CARVE_ALIGN - 1) // CARVE_ALIGN * CARVE_ALIGN
        self.nbytes = nbytes
        self.lock_pages = lock_pages
        self._lock = make_lock("arena.PinnedArena._lock")
        self._free_list: List[Tuple[int, int]] = [(0, nbytes)]
        self._carved: Dict[int, Tuple[int, str]] = {}   # off → (n, tag)
        self._slabs: Dict[int, Slab] = {}               # off → live slab
        self._lib = _arena_lib()
        base = self._lib.strom_arena_create(nbytes)
        if not base:
            err = ctypes.get_errno()
            raise OSError(err, f"strom_arena_create({nbytes}) failed: "
                          + os.strerror(err))
        self.base = int(base)
        self.view = np.ctypeslib.as_array(
            ctypes.cast(self.base, ctypes.POINTER(ctypes.c_uint8)),
            shape=(nbytes,))
        self._closed = False

    # -- allocation --------------------------------------------------------

    def carve(self, nbytes: int, tag: str,
              lock: Optional[bool] = None) -> Optional[Slab]:
        """First-fit carve of ``nbytes`` (page-rounded) tagged ``tag``;
        None when no free range fits.  ``lock``: mlock this carve (None
        takes the arena's policy)."""
        if nbytes <= 0:
            raise ValueError(f"carve nbytes must be > 0, got {nbytes}")
        need = (nbytes + CARVE_ALIGN - 1) // CARVE_ALIGN * CARVE_ALIGN
        with self._lock:
            if self._closed:
                return None
            for i, (off, ln) in enumerate(self._free_list):
                if ln >= need:
                    if ln == need:
                        self._free_list.pop(i)
                    else:
                        self._free_list[i] = (off + need, ln - need)
                    self._carved[off] = (need, tag)
                    break
            else:
                return None
            slab = self._slabs[off] = Slab(self, off, need, tag)
        want_lock = self.lock_pages if lock is None else lock
        # best effort, outside the lock: mlock faults the pages in
        if want_lock and self._lib.strom_arena_lock(self.base + off,
                                                    need) == 0:
            slab.locked = True
        self._emit_occupancy()
        return slab

    def _emit_occupancy(self) -> None:
        """The ``strom.arena.occupancy`` counter track (bytes carved per
        tag, and free) at every carve and release, while a trace file is
        being written.  Called without the arena lock, which
        ``carves()`` and ``bytes_free`` take."""
        from nvme_strom_tpu_torch.utils.trace import global_tracer
        if not global_tracer.exports:
            return
        vals = {f"carved_{t}": n for t, n in self.carves().items()}
        vals["free"] = self.bytes_free
        global_tracer.add_counter("strom.arena.occupancy", vals)

    def _free(self, offset: int, nbytes: int) -> None:
        with self._lock:
            got = self._carved.pop(offset, None)
            if got is None or got[0] != nbytes:
                return   # a double free or a foreign range
            self._slabs.pop(offset, None)
            fl = self._free_list
            lo, hi = 0, len(fl)
            while lo < hi:
                mid = (lo + hi) // 2
                if fl[mid][0] < offset:
                    lo = mid + 1
                else:
                    hi = mid
            fl.insert(lo, (offset, nbytes))
            if lo + 1 < len(fl) and fl[lo][0] + fl[lo][1] == fl[lo + 1][0]:
                fl[lo] = (fl[lo][0], fl[lo][1] + fl[lo + 1][1])
                fl.pop(lo + 1)
            if lo > 0 and fl[lo - 1][0] + fl[lo - 1][1] == fl[lo][0]:
                fl[lo - 1] = (fl[lo - 1][0], fl[lo - 1][1] + fl[lo][1])
                fl.pop(lo)
        self._emit_occupancy()

    # -- introspection -----------------------------------------------------

    def carves(self) -> Dict[str, int]:
        """Bytes carved per tag."""
        with self._lock:
            out: Dict[str, int] = {}
            for _off, (n, tag) in self._carved.items():
                out[tag] = out.get(tag, 0) + n
            return out

    def live(self, tag: str) -> List[Slab]:
        """The live slabs of one tag."""
        with self._lock:
            return [s for s in self._slabs.values() if s.tag == tag]

    @property
    def bytes_carved(self) -> int:
        with self._lock:
            return sum(n for n, _t in self._carved.values())

    @property
    def bytes_free(self) -> int:
        with self._lock:
            return sum(ln for _off, ln in self._free_list)

    def close(self) -> None:
        """Unmap the reservation.  Callers have released their slabs."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            slabs = list(self._slabs.values())
        for s in slabs:
            s.cuda.unregister(final=True)
        self.view = None
        self._lib.strom_arena_destroy(self.base, self.nbytes)


# ---------------------------------------------------------------------------
# the process's arena
# ---------------------------------------------------------------------------

_singleton_lock = make_lock("arena._singleton_lock")
_arena: Optional[PinnedArena] = None
_arena_init = False


def _build_locked() -> None:
    global _arena, _arena_init
    if _arena is not None:
        _arena.close()
        _arena = None
    new = None
    if os.environ.get("STROM_ARENA", "1") != "0":
        try:
            mb = int(os.environ.get("STROM_ARENA_MB", 1024))
        except ValueError:
            mb = 1024
        if mb > 0:
            lock = os.environ.get("STROM_MLOCK", "1") != "0"
            try:
                new = PinnedArena(mb << 20, lock_pages=lock)
            except OSError:
                new = None   # no reservation: every consumer maps its own
    _arena = new
    _arena_init = True


def get_arena() -> Optional[PinnedArena]:
    """The process's arena, built from the environment on first use;
    None when ``STROM_ARENA=0``."""
    if _arena_init:
        return _arena
    with _singleton_lock:
        if not _arena_init:
            _build_locked()
        return _arena


def reset() -> None:
    """Tear the arena down; the next :func:`get_arena` reads the
    environment again.  Callers have released their slabs."""
    global _arena, _arena_init
    with _singleton_lock:
        if _arena is not None:
            _arena.close()
        _arena = None
        _arena_init = False


def carve_or_none(nbytes: int, tag: str, stats=None,
                  lock: Optional[bool] = None) -> Optional[Slab]:
    """Carve from the process's arena, or None (arena off, or full:
    counted as ``arena_fallbacks`` on ``stats``)."""
    a = get_arena()
    if a is None:
        return None
    slab = a.carve(nbytes, tag, lock=lock)
    if slab is None and stats is not None:
        stats.add(arena_fallbacks=1)
    return slab
