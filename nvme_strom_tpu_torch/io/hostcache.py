"""The pinned host-DRAM tier between NVMe and the device (counterpart
of nvme_strom_tpu/io/hostcache.py).

Repeat reads of hot spans (KV prefix pages, an offloaded session's
history) are served from page-locked host memory instead of the SSD,
under one budget shared by every engine of the process
(``STROM_HOSTCACHE_MB``; 0, the default, leaves the tier off and the
planner on its tier-less path).

  lines      fixed-size, keyed by ``(file_key, aligned_offset)``; the
             file key is the file's (dev, ino, mtime_ns, size) identity
             taken by ``StromEngine.open``.  The line size is the first
             engine's ``chunk_bytes`` (rounded down to a power of two,
             at least 64 KiB) unless ``STROM_HOSTCACHE_LINE_BYTES`` sets
             it.  A line may hold a valid prefix shorter than itself;
             hits are served only inside it.
  admission  a ghost list: a line is admitted only when it was already
             missed recently, so one-shot scans never fill the tier; a
             ``hot`` batch admits on first touch.  The fill copies the
             completed staging view into the line (``_FillOnWait``, in
             the miss read's ``wait()``, with the native
             ``strom_hostcache_copy``).
  quotas     each QoS class owns a share of the budget proportional to
             the scheduler's weights (``STROM_HOSTCACHE_CLASS_QUOTAS``
             overrides them).  Free space may be borrowed; under
             pressure over-quota classes pay first, chosen by deficit
             round-robin with inverse weights, then a second-chance
             clock inside the class.  Pinned lines are never reclaimed;
             ``hot`` lines are sticky while their class is within quota.
  integrity  every fill is CRC32C-stamped when ``STROM_VERIFY`` is on
             (utils/checksum.py); a hit is checked behind the same gate,
             and a line that fails drops itself and heals as a miss.
  writes     ``notify_write`` (every engine write, at submit and at
             completion) drops the lines a write overlaps and bumps their
             epoch, so a fill admitted before the write is refused.

The lines are one carve of the pinned arena (io/arena.py, tag
``hostcache``), or a private mapping when the arena is off or full
(``arena_fallbacks``).  New for CUDA: the lines are registered with
CUDA the first time a device copy reads one (``HostCache.arena.cuda``,
listed by ``StromEngine.cuda_mappings``), so a hit reaches the card
through the ``h2d_copy`` kernel reading the line in place; a
registration that fails raises.  The line arena is unregistered only
after the device has finished every copy out of it, and not while a hit
view still pins a line (``close`` raises).

  tenants    each line is stamped at fill with the tenant of the filling
             scope (io/tenants.py) and counts against that tenant's
             quota (``Tenant.quota_frac`` of the lines, 0 = 1/N of the
             tenants resident); a fill past the quota while space is
             free is a borrow (``tenant_borrows``).  Under pressure the
             most over-quota tenant pays first (``tenant_quota_evictions``)
             before any class does, and a ``hot`` line of an over-quota
             tenant is not sticky.  Outside any tenant scope none of
             this runs.

Hit spans never enter ``FaultyEngine`` or ``ResilientEngine``
(io/faults.py, io/resilient.py): the planner (io/plan.py) probes the
tier before it submits, so a DRAM hit takes no fault decision, retry or
hedge budget, while the misses are submitted through whatever wrapper
the caller holds and get its recovery.  The tier is the process's one,
whichever engine in a wrapper stack finds it.  A fill copies only a
view its read completed: a miss whose read a ring restart cancels fills
nothing until the resubmitted read's view arrives, so no torn line is
published, and a degraded read (io/health.py) fills its admitted lines
from its pread like any other read.  ``resident_spans`` lists a file's
resident bytes for the warm-hint manifests (io/warmup.py).  With the
tracer on, a fill is a ``strom.cache.fill`` span under the requester's
causal context (the planner emits ``strom.cache.hit``); a line evicted
before its first hit charges its bytes to the ledger's
``evicted_unused`` class (obs/ledger.py).
"""

from __future__ import annotations

import ctypes
import os
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from nvme_strom_tpu_torch import _build
from nvme_strom_tpu_torch.io import arena as _arena
from nvme_strom_tpu_torch.io.arena import CudaRegistration
from nvme_strom_tpu_torch.io.sched import (CLASS_ORDER, DEFAULT_CLASS,
                                           default_policies)
from nvme_strom_tpu_torch.io.tenants import current_tenant
from nvme_strom_tpu_torch.obs.ledger import charge_waste
from nvme_strom_tpu_torch.utils.config import HostCacheConfig
from nvme_strom_tpu_torch.utils.lockwitness import make_lock, make_rlock
from nvme_strom_tpu_torch.utils.trace import attach_context

#: line key: ((dev, ino, mtime_ns, size), line_offset)
LineKey = Tuple[tuple, int]

_declared = False


def _hostcache_lib() -> ctypes.CDLL:
    """The engine library with the ``strom_hostcache_*`` signatures."""
    global _declared
    lib = _build.engine_library()
    if not _declared:
        lib.strom_hostcache_arena_create.restype = ctypes.c_void_p
        lib.strom_hostcache_arena_create.argtypes = [
            ctypes.c_uint64, ctypes.c_int, ctypes.POINTER(ctypes.c_int32)]
        lib.strom_hostcache_arena_destroy.restype = None
        lib.strom_hostcache_arena_destroy.argtypes = [ctypes.c_void_p,
                                                      ctypes.c_uint64]
        lib.strom_hostcache_copy.restype = None
        lib.strom_hostcache_copy.argtypes = [ctypes.c_void_p,
                                             ctypes.c_void_p,
                                             ctypes.c_uint64]
        _declared = True
    return lib


def _scheduler_weights() -> Dict[str, float]:
    """The scheduler's effective class weights (``STROM_CLASS_WEIGHTS``
    included), the quotas' default."""
    try:
        policies = default_policies(os.environ.get("STROM_CLASS_WEIGHTS",
                                                   ""))
    except ValueError:
        policies = default_policies()
    return {k: p.weight for k, p in policies.items()}


class _Arena:
    """The lines' page-locked backing store: a ``hostcache`` carve of
    the process's arena, else a private mapping pre-faulted and
    (best effort) mlocked by ``strom_hostcache_arena_create``."""

    def __init__(self, nbytes: int, lock_pages: bool, stats=None):
        self.nbytes = nbytes
        self._lib = _hostcache_lib()
        self._slab = _arena.carve_or_none(nbytes, "hostcache", stats=stats,
                                          lock=lock_pages)
        if self._slab is not None:
            self.base = self._slab.addr
            self.view = self._slab.view
            self.locked = bool(self._slab.locked)
            #: the carve's registration, owned by the slab
            self.cuda = self._slab.cuda
            return
        locked = ctypes.c_int32(0)
        base = self._lib.strom_hostcache_arena_create(
            nbytes, 1 if lock_pages else 0, ctypes.byref(locked))
        if not base:
            err = ctypes.get_errno()
            raise OSError(err, "strom_hostcache_arena_create failed: "
                          + os.strerror(err))
        self.base = int(base)
        self.locked = bool(locked.value)
        self.view = np.ctypeslib.as_array(
            ctypes.cast(self.base, ctypes.POINTER(ctypes.c_uint8)),
            shape=(nbytes,))
        self.cuda = CudaRegistration(self.base, nbytes, "host tier lines")

    def copy_in(self, dst_off: int, src: np.ndarray) -> None:
        """Staging view → line bytes (memcpy with the GIL dropped); the
        source is free to recycle when this returns."""
        n = src.nbytes
        if n:
            src = np.ascontiguousarray(src)
            self._lib.strom_hostcache_copy(self.base + dst_off,
                                           src.ctypes.data, n)

    def close(self) -> None:
        """Unregister from CUDA (after the device has finished every
        copy out of the lines), then free the memory."""
        self.view = None
        if self._slab is not None:
            self._slab.release()
            self._slab = None
        elif self.base:
            self.cuda.unregister(final=True)
            self._lib.strom_hostcache_arena_destroy(self.base, self.nbytes)
        self.base = 0


class _Line:
    """One resident line (a valid prefix of ``line_bytes``)."""

    __slots__ = ("key", "slot", "valid", "klass", "crc", "pins", "ref",
                 "dead", "sticky", "hits", "tenant")

    def __init__(self, key: LineKey, slot: int, klass: str):
        self.key = key
        self.slot = slot
        self.valid = 0        # valid bytes from the line's start
        self.klass = klass
        t = current_tenant()
        #: the filling scope's tenant id, charged for the line while it
        #: is in the map (None outside any tenant scope)
        self.tenant = t.id if t is not None else None
        self.crc: Optional[int] = None
        self.pins = 0         # outstanding hit views (and a fill's copy)
        self.ref = False      # the second-chance bit
        self.hits = 0
        self.dead = False     # dropped while pinned: slot freed at the
        #                       last unpin
        self.sticky = False   # hot: eviction skips it within quota


class CacheHitRead:
    """A pending-read-shaped zero-copy view of a resident line:
    ``wait()`` returns a read-only slice of the line arena, and the line
    stays pinned (never evicted) until ``release()``."""

    __slots__ = ("_cache", "_line", "_lo", "_hi", "fh", "offset",
                 "_released")

    was_fallback = False

    def __init__(self, cache: "HostCache", line: _Line, lo: int, hi: int,
                 fh: int, offset: int):
        self._cache = cache
        self._line = line
        self._lo = lo
        self._hi = hi
        self.fh = fh
        self.offset = offset
        self._released = False

    @property
    def length(self) -> int:
        return self._hi - self._lo

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        del timeout   # resident by contract
        return self._cache.line_view(self._line, self._lo, self._hi)

    def is_ready(self) -> bool:
        return True

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._cache.unpin(self._line)


class _FillOnWait:
    """A miss span's pending read that, on its first successful
    ``wait()``, copies the admitted lines' bytes from the completed view
    into the tier, then returns the view untouched.  The copy only reads
    the staging buffer, and it ends before ``wait()`` returns: a device
    copy the caller starts from the view afterwards, and the caller's
    ``release()`` after that copy, never race it.  A tier failure never
    fails the read."""

    __slots__ = ("_pending", "_cache", "_fkey", "_off", "_keys",
                 "_klass", "_stats", "_filled", "_sticky", "_tracer",
                 "_ctx")

    def __init__(self, pending, cache: "HostCache", fkey: tuple,
                 span_off: int, keys: Dict[LineKey, int], klass, stats,
                 sticky: bool = False, tracer=None):
        self._pending = pending
        self._cache = cache
        self._fkey = fkey
        self._off = span_off
        self._keys = keys
        self._klass = klass
        self._stats = stats
        self._filled = False
        self._sticky = sticky
        # the fill span's tracer and causal identity, taken here: the
        # fill runs at wait(), maybe on another thread
        self._tracer = tracer if (tracer is not None
                                  and tracer.enabled) else None
        self._ctx = attach_context() if self._tracer is not None else None

    @property
    def length(self) -> int:
        return self._pending.length

    @property
    def fh(self) -> int:
        return self._pending.fh

    @property
    def offset(self) -> int:
        return self._pending.offset

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        view = self._pending.wait(timeout)
        if not self._filled:
            self._filled = True
            t0 = time.monotonic_ns()
            try:
                self._cache.fill_from_view(self._fkey, self._off, view,
                                           self._keys, self._klass,
                                           self._stats, sticky=self._sticky)
            except (OSError, ValueError):
                pass   # the tier accelerates; it never fails a read
            if self._tracer is not None:
                self._tracer.add_span(
                    "strom.cache.fill", t0, time.monotonic_ns(),
                    category="strom.cache", ctx=self._ctx,
                    lines=len(self._keys), bytes=int(view.nbytes),
                    klass=self._klass)
        return view

    def is_ready(self) -> bool:
        return self._pending.is_ready()

    def release(self) -> None:
        self._pending.release()


class HostCache:
    """The tier: line map, ghost-list admission and class quotas over
    one page-locked line arena.  Thread-safe; one a process
    (:func:`get_cache`), shared by every engine."""

    def __init__(self, line_bytes: int, budget_bytes: int,
                 quotas: Optional[Dict[str, float]] = None,
                 ghost_factor: int = 4, lock_arena: bool = True,
                 verify=None, stats=None):
        if line_bytes <= 0:
            raise ValueError("line_bytes must be > 0")
        self.line_bytes = line_bytes
        self.capacity = max(1, budget_bytes // line_bytes)
        self.arena = _Arena(self.capacity * line_bytes, lock_arena, stats)
        if quotas is None:
            quotas = _scheduler_weights()
        total_w = sum(quotas.values()) or 1.0
        #: soft per-class residency quota in slots
        self.quota_slots: Dict[str, float] = {
            k: self.capacity * w / total_w for k, w in quotas.items()}
        # eviction credits: the scheduler's deficit machinery with
        # inverse weights, so the class it protects most pays last
        max_w = max(quotas.values()) or 1.0
        self._evict_w = {k: max_w / w if w > 0 else max_w * 2
                         for k, w in quotas.items()}
        self._evict_deficit = {k: 0.0 for k in quotas}
        self._rev_order = [k for k in reversed(CLASS_ORDER) if k in quotas]
        for k in quotas:
            if k not in self._rev_order:
                self._rev_order.insert(0, k)
        self._lock = make_rlock("hostcache.HostCache._lock")
        self._lines: Dict[LineKey, _Line] = {}
        self._free: List[int] = list(range(self.capacity))
        self._ghost: "OrderedDict[LineKey, None]" = OrderedDict()
        self._ghost_cap = max(self.capacity * ghost_factor, 16)
        self._clock: Dict[str, deque] = {k: deque() for k in quotas}
        self._class_slots: Dict[str, int] = {k: 0 for k in quotas}
        # resident lines per tenant id, and each tenant's declared quota
        # fraction; both stay empty until a fill runs in a tenant scope
        self._tenant_slots: Dict[str, int] = {}
        self._tenant_quota_frac: Dict[str, float] = {}
        # per-line invalidation epoch: a fill whose admission predates a
        # write over its line is refused.  Bounded with a floor: a key
        # dropped from the map reads the largest epoch ever dropped, so
        # losing an entry can only refuse fills, never admit stale ones
        self._key_epoch: "OrderedDict[LineKey, int]" = OrderedDict()
        self._key_epoch_cap = max(4 * self.capacity, 4096)
        self._epoch_floor = 0
        self._write_seq = 0
        self._pins_out = 0         # pins held on lines, dead ones too
        self.bytes_resident = 0    # the resident lines' valid bytes
        if verify is None:
            from nvme_strom_tpu_torch.utils.checksum import VerifyPolicy
            verify = VerifyPolicy()
        self._verify = verify

    # -- introspection -----------------------------------------------------

    def counters(self) -> dict:
        with self._lock:
            return {"lines_resident": len(self._lines),
                    "bytes_resident": self.bytes_resident,
                    "capacity_lines": self.capacity,
                    "line_bytes": self.line_bytes,
                    "arena_locked": self.arena.locked,
                    "class_slots": dict(self._class_slots),
                    "tenant_slots": dict(self._tenant_slots)}

    def resident_spans(self, fkey: tuple) -> list:
        """Merged ``(offset, length)`` spans of one file resident in the
        tier, largest first: a ``.warmhints.json`` manifest's content
        (io/warmup.py)."""
        with self._lock:
            raw = sorted((key[1], line.valid)
                         for key, line in self._lines.items()
                         if key[0] == fkey and line.valid > 0
                         and not line.dead)
        merged: list = []
        for off, ln in raw:
            if merged and off <= merged[-1][0] + merged[-1][1]:
                last_off, last_len = merged[-1]
                merged[-1] = (last_off, max(last_len, off + ln - last_off))
            else:
                merged.append((off, ln))
        merged.sort(key=lambda sp: (-sp[1], sp[0]))
        return merged

    def _klass(self, klass: Optional[str]) -> str:
        return klass if klass in self.quota_slots else DEFAULT_CLASS

    def _epoch_of(self, key: LineKey) -> int:
        return self._key_epoch.get(key, self._epoch_floor)

    def _pin_locked(self, line: _Line) -> None:
        line.pins += 1
        self._pins_out += 1

    # -- hit serving -------------------------------------------------------

    def line_view(self, line: _Line, lo: int, hi: int) -> np.ndarray:
        """A read-only slice of a line: the line is shared state, so a
        consumer that mutates its view in place cannot corrupt it."""
        base = line.slot * self.line_bytes
        view = self.arena.view[base + lo:base + hi]
        view.flags.writeable = False
        return view

    def unpin(self, line: _Line) -> None:
        with self._lock:
            self.unpin_locked(line)

    def unpin_locked(self, line: _Line) -> None:
        line.pins -= 1
        self._pins_out -= 1
        if line.pins <= 0 and line.dead:
            self._free.append(line.slot)
            line.dead = False       # the slot goes back exactly once

    def _verify_ok(self, line: _Line, stats) -> bool:
        """The ``STROM_VERIFY`` check of a resident prefix; a line that
        fails drops itself (it heals as a miss) and counts
        ``checksum_failures``."""
        if line.crc is None or not self._verify.want():
            return True
        from nvme_strom_tpu_torch.io.engine import crc32c
        got = crc32c(self.line_view(line, 0, line.valid))
        if stats is not None:
            stats.add(bytes_verified=int(line.valid))
        if got == line.crc:
            return True
        if stats is not None:
            stats.add(checksum_failures=1)
        self._drop_line(line, stats)
        return False

    # -- probes (the planner boundary) -------------------------------------

    def probe_range(self, fkey: tuple, off: int, length: int,
                    klass: Optional[str], stats=None, hot: bool = False
                    ) -> Tuple[List[tuple], Dict[LineKey, int]]:
        """Split ``[off, off+length)`` into ordered segments: ``("hit",
        abs_off, ln, line)``, one a line, the line pinned, and ``("miss",
        abs_off, ln)`` runs.  Also returns the line keys the misses'
        completions should fill (the ghost list's verdict), each with
        its epoch now.  ``hot`` admits missed lines on first touch and
        makes resident ones sticky."""
        kl = self._klass(klass)
        lb = self.line_bytes
        segments: List[tuple] = []
        admitted: Dict[LineKey, int] = {}
        hits = misses = served = 0
        with self._lock:
            pos, end = off, off + length
            m_lo: Optional[int] = None       # the open miss run
            while pos < end:
                lo = pos - pos % lb
                take_end = min(end, lo + lb)
                line = self._lines.get((fkey, lo))
                if (line is not None and take_end - lo <= line.valid
                        and self._verify_ok(line, stats)):
                    if m_lo is not None:
                        segments.append(("miss", m_lo, pos - m_lo))
                        m_lo = None
                    self._pin_locked(line)
                    line.ref = True
                    line.hits += 1
                    if hot:
                        line.sticky = True
                    segments.append(("hit", pos, take_end - pos, line))
                    hits += 1
                    served += take_end - pos
                else:
                    misses += 1          # per line, like hits
                    if m_lo is None:
                        m_lo = pos
                    if pos == lo:
                        if (fkey, lo) in self._lines:
                            # resident but short: the longer read
                            # extends the prefix
                            admitted[(fkey, lo)] = self._epoch_of((fkey, lo))
                        else:
                            self._admit_or_note((fkey, lo), admitted,
                                                stats, hot=hot)
                pos = take_end
            if m_lo is not None:
                segments.append(("miss", m_lo, end - m_lo))
        if stats is not None and (hits or misses):
            stats.add(cache_hits=hits, cache_misses=misses,
                      bytes_served_cache=served)
            stats.add_class_stat(kl, cache_hits=hits, cache_misses=misses,
                                 bytes_served_cache=served)
        return segments, admitted

    def probe_span(self, fkey: tuple, off: int, length: int,
                   klass: Optional[str], stats=None, hot: bool = False
                   ) -> Tuple[Optional[_Line], Dict[LineKey, int]]:
        """The whole-span probe of ``DeviceStream.stream_ranges``: a
        span is a hit only inside ONE line's valid prefix (anything else
        would need a joining copy).  Otherwise only a line-aligned span
        within one line is put through admission, since only such a
        span can hit later."""
        kl = self._klass(klass)
        lb = self.line_bytes
        admitted: Dict[LineKey, int] = {}
        with self._lock:
            lo = off - off % lb
            line = self._lines.get((fkey, lo))
            if (line is not None and off + length <= lo + line.valid
                    and self._verify_ok(line, stats)):
                self._pin_locked(line)
                line.ref = True
                line.hits += 1
                if hot:
                    line.sticky = True
                if stats is not None:
                    stats.add(cache_hits=1, bytes_served_cache=length)
                    stats.add_class_stat(kl, cache_hits=1,
                                         bytes_served_cache=length)
                return line, admitted
            if off % lb == 0 and length <= lb:
                key = (fkey, off)
                if key in self._lines:
                    admitted[key] = self._epoch_of(key)
                else:
                    self._admit_or_note(key, admitted, stats, hot=hot)
        if stats is not None:
            n_lines = (off + length - 1) // lb - lo // lb + 1
            stats.add(cache_misses=n_lines)
            stats.add_class_stat(kl, cache_misses=n_lines)
        return None, admitted

    def _admit_or_note(self, key: LineKey, admitted: Dict[LineKey, int],
                       stats, hot: bool = False) -> None:
        """The ghost list's verdict (lock held): admit a line missed
        recently (or any line of a ``hot`` batch); refuse and remember a
        first touch."""
        if hot or key in self._ghost:
            self._ghost.pop(key, None)
            admitted[key] = self._epoch_of(key)
            return
        self._ghost[key] = None
        while len(self._ghost) > self._ghost_cap:
            self._ghost.popitem(last=False)
        if stats is not None:
            stats.add(cache_admission_rejections=1)

    # -- fills (miss completions) ------------------------------------------

    def fill_from_view(self, fkey: tuple, span_off: int, view: np.ndarray,
                       keys: Dict[LineKey, int], klass: Optional[str],
                       stats=None, sticky: bool = False) -> None:
        """Copy the admitted lines' bytes of a completed span read into
        lines (a short view at EOF fills a prefix)."""
        n = view.nbytes
        for key, epoch in keys.items():
            rel = key[1] - span_off
            if 0 <= rel < n:
                self.fill(fkey, key[1],
                          view[rel:rel + min(self.line_bytes, n - rel)],
                          klass, stats, epoch=epoch, sticky=sticky)

    def fill(self, fkey: tuple, line_off: int, payload: np.ndarray,
             klass: Optional[str], stats=None,
             epoch: Optional[int] = None, sticky: bool = False) -> bool:
        """Install ``payload`` as the line at ``line_off``, evicting
        under the quotas when the arena is full.  False when skipped:
        already resident with as much, pinned, nothing evictable, or a
        write since the admission (``epoch``).  The copy runs outside
        the lock, the line reserved with ``valid = 0`` and a pin."""
        kl = self._klass(klass)
        valid = int(payload.nbytes)
        if valid <= 0 or valid > self.line_bytes:
            return False
        key = (fkey, line_off)
        with self._lock:
            if epoch is not None and self._epoch_of(key) != epoch:
                if stats is not None:
                    stats.add(cache_fill_failures=1)
                return False
            line = self._lines.get(key)
            if line is not None:
                if line.valid >= valid or line.pins > 0:
                    return False
                self.bytes_resident -= line.valid
                line.valid = 0          # probes miss while it is rewritten
            else:
                slot = self._free.pop() if self._free else \
                    self._evict_one(kl, stats)
                if slot is None:
                    if stats is not None:
                        stats.add(cache_fill_failures=1)
                    return False
                line = _Line(key, slot, kl)
                self._lines[key] = line
                self._ghost.pop(key, None)
                self._class_slots[kl] = self._class_slots.get(kl, 0) + 1
                self._clock.setdefault(kl, deque()).append(key)
                if line.tenant is not None:
                    self._note_tenant_fill_locked(line, stats)
            if sticky:
                line.sticky = True
            self._pin_locked(line)      # the copy: unevictable
        try:
            self.arena.copy_in(line.slot * self.line_bytes, payload)
            crc = None
            if self._verify.enabled:
                from nvme_strom_tpu_torch.io.engine import crc32c
                crc = crc32c(payload)
        except BaseException:
            self.unpin(line)
            raise
        with self._lock:
            self.unpin_locked(line)
            if line.dead or self._lines.get(key) is not line:
                return False            # dropped during the copy
            line.valid = valid
            line.crc = crc
            self.bytes_resident += valid
            if stats is not None:
                stats.add(cache_admissions=1)
                stats.set_gauges(cache_bytes_resident=self.bytes_resident,
                                 cache_lines_resident=len(self._lines))
        return True

    # -- eviction: class quotas, deficit round-robin, second chance --------

    def _over_quota(self, klass: str) -> bool:
        return self._class_slots.get(klass, 0) > \
            self.quota_slots.get(klass, 0.0)

    # -- per-tenant residency quotas ---------------------------------------

    def _note_tenant_fill_locked(self, line: _Line, stats) -> None:
        """Charge a new line to its tenant; landing past the quota while
        a slot was free is a borrow."""
        tid = line.tenant
        t = current_tenant()
        if t is not None and t.id == tid:
            self._tenant_quota_frac[tid] = t.quota_frac
        else:
            self._tenant_quota_frac.setdefault(tid, 0.0)
        self._tenant_slots[tid] = self._tenant_slots.get(tid, 0) + 1
        if self._tenant_over(tid) and stats is not None:
            stats.add(tenant_borrows=1)
            stats.add_tenant_stat(tid, borrows=1)

    def _tenant_quota_slots(self, tid: str) -> float:
        """A tenant's quota in lines: its declared fraction of the tier,
        or with fraction 0 a fair share of the tenants resident."""
        frac = self._tenant_quota_frac.get(tid, 0.0)
        if frac <= 0.0:
            frac = 1.0 / max(1, len(self._tenant_slots))
        return frac * self.capacity

    def _tenant_over(self, tid: Optional[str]) -> bool:
        if tid is None or not self._tenant_slots:
            return False
        return self._tenant_slots.get(tid, 0) > \
            self._tenant_quota_slots(tid)

    def _tenant_drop_locked(self, line: _Line) -> None:
        """Refund a departing line's charge; a tenant whose last line
        left is forgotten, so fair shares count resident tenants."""
        tid = line.tenant
        if tid is None:
            return
        n = self._tenant_slots.get(tid, 0) - 1
        if n > 0:
            self._tenant_slots[tid] = n
        else:
            self._tenant_slots.pop(tid, None)
            self._tenant_quota_frac.pop(tid, None)

    def _tenant_evict_locked(self, stats) -> Optional[int]:
        """The quota pre-pass: reclaim a line of the most over-quota
        tenant (largest excess), preferring one whose second-chance bit
        is clear; sticky does not protect it.  None when no tenant is
        over its quota or all its lines are pinned."""
        over = [tid for tid in self._tenant_slots if self._tenant_over(tid)]
        if not over:
            return None
        over.sort(key=lambda tid: (self._tenant_slots.get(tid, 0)
                                   - self._tenant_quota_slots(tid)),
                  reverse=True)
        for tid in over:
            best = None
            for line in self._lines.values():
                if line.tenant != tid or line.pins > 0:
                    continue
                if not line.ref:
                    best = line
                    break
                if best is None:
                    best = line
            if best is None:
                continue
            del self._lines[best.key]
            self._class_slots[best.klass] -= 1
            self.bytes_resident -= best.valid
            self._tenant_drop_locked(best)
            if stats is not None:
                stats.add(cache_evictions=1, tenant_quota_evictions=1)
                stats.add_tenant_stat(tid, quota_evictions=1)
                if best.hits == 0 and best.valid:
                    charge_waste(stats, "evicted_unused", best.valid)
                stats.set_gauges(cache_bytes_resident=self.bytes_resident,
                                 cache_lines_resident=len(self._lines))
            return best.slot
        return None

    def _evict_one(self, incoming: str, stats) -> Optional[int]:
        """Reclaim one slot (lock held): the tenant-quota pre-pass, then
        over-quota classes, then every class with lines; among them the
        eviction credits pick the payer, and its clock the line."""
        if self._tenant_slots:
            slot = self._tenant_evict_locked(stats)
            if slot is not None:
                return slot
        over = [k for k in self._rev_order
                if self._over_quota(k) and self._clock.get(k)]
        every = [k for k in self._rev_order if self._clock.get(k)]
        for cands in (over, every):
            cands = list(cands)
            while cands:
                for k in cands:
                    w = self._evict_w.get(k, 1.0)
                    self._evict_deficit[k] = min(
                        self._evict_deficit[k] + w, 2 * w)
                cands.sort(key=lambda k: -self._evict_deficit[k])
                for k in list(cands):
                    if self._evict_deficit[k] < 1.0:
                        continue
                    slot = self._clock_evict(k, stats)
                    if slot is not None:
                        self._evict_deficit[k] -= 1.0
                        return slot
                    cands.remove(k)   # nothing evictable here now
        return None

    def _clock_evict(self, klass: str, stats) -> Optional[int]:
        """Second-chance sweep of one class's clock (lock held)."""
        q = self._clock.get(klass)
        if not q:
            return None
        for _ in range(2 * len(q)):
            key = q[0]
            line = self._lines.get(key)
            if line is None or line.klass != klass:
                q.popleft()            # a stale clock entry
                if not q:
                    return None
                continue
            if line.pins > 0 or (line.sticky
                                 and not self._over_quota(klass)
                                 and not self._tenant_over(line.tenant)):
                q.rotate(-1)
                continue
            if line.ref:
                line.ref = False       # the second chance
                q.rotate(-1)
                continue
            q.popleft()
            del self._lines[key]
            self._class_slots[klass] -= 1
            self.bytes_resident -= line.valid
            self._tenant_drop_locked(line)
            if stats is not None:
                stats.add(cache_evictions=1)
                if line.hits == 0 and line.valid:
                    # filled and never hit: the fill bought nothing
                    charge_waste(stats, "evicted_unused", line.valid)
                stats.set_gauges(cache_bytes_resident=self.bytes_resident,
                                 cache_lines_resident=len(self._lines))
            return line.slot
        return None

    # -- invalidation -------------------------------------------------------

    def _drop_line(self, line: _Line, stats) -> None:
        """Remove a line from the map now; its slot frees now, or at its
        last unpin (outstanding views keep the old bytes).  Lock held."""
        if self._lines.get(line.key) is not line:
            return
        del self._lines[line.key]
        self._class_slots[line.klass] -= 1
        self.bytes_resident -= line.valid
        self._tenant_drop_locked(line)
        if line.pins > 0:
            line.dead = True
        else:
            self._free.append(line.slot)
        q = self._clock.get(line.klass)
        if q is not None and len(q) > \
                2 * max(1, self._class_slots.get(line.klass, 0)) + 16:
            self._clock[line.klass] = deque(
                k for k in q if self._lines.get(k) is not None
                and self._lines[k].klass == line.klass)
        if stats is not None:
            stats.add(cache_invalidations=1)
            stats.set_gauges(cache_bytes_resident=self.bytes_resident,
                             cache_lines_resident=len(self._lines))

    def invalidate(self, fkey: tuple, offset: int, length: int,
                   stats=None) -> int:
        """Drop every line a written range overlaps and bump their
        epochs; returns the lines dropped."""
        if length <= 0:
            return 0
        lb = self.line_bytes
        n = 0
        with self._lock:
            self._write_seq += 1
            for line_off in range(offset - offset % lb, offset + length, lb):
                key = (fkey, line_off)
                self._key_epoch[key] = self._write_seq
                self._key_epoch.move_to_end(key)
                line = self._lines.get(key)
                if line is not None:
                    self._drop_line(line, stats)
                    n += 1
                self._ghost.pop(key, None)
            while len(self._key_epoch) > self._key_epoch_cap:
                _k, ev = self._key_epoch.popitem(last=False)
                self._epoch_floor = max(self._epoch_floor, ev)
        return n

    def close(self) -> None:
        """Free the line arena.  Raises while a hit view still pins a
        line: its bytes may be the source of a device copy."""
        with self._lock:
            if self._pins_out > 0:
                raise RuntimeError(
                    f"host tier: {self._pins_out} pinned line views are "
                    "still out; release them before closing the tier")
            self._lines.clear()
            self._ghost.clear()
            self._tenant_slots.clear()
            self._tenant_quota_frac.clear()
            self.bytes_resident = 0
        self.arena.close()


# ---------------------------------------------------------------------------
# the process's tier: one budget
# ---------------------------------------------------------------------------

_singleton_lock = make_lock("hostcache._singleton_lock")
_cache: Optional[HostCache] = None
_cache_init = False


def parse_class_quotas(spec: str) -> Optional[Dict[str, float]]:
    """Parse ``STROM_HOSTCACHE_CLASS_QUOTAS`` ("decode=8,restore=4");
    classes it does not name keep the scheduler's weights."""
    if not spec:
        return None
    out: Dict[str, float] = {}
    for part in filter(None, (s.strip() for s in spec.split(","))):
        name, eq, val = part.partition("=")
        name = name.strip()
        try:
            weight = float(val)
        except ValueError:
            weight = -1.0
        if not eq or name not in CLASS_ORDER or weight < 0:
            raise ValueError(
                f"STROM_HOSTCACHE_CLASS_QUOTAS entry {part!r}: expected "
                f"<class>=<non-negative weight> with class in "
                f"{CLASS_ORDER}")
        out[name] = weight
    for k, w in _scheduler_weights().items():
        out.setdefault(k, w)
    return out


def _default_line_bytes(engine) -> int:
    """The first engine's ``chunk_bytes`` (4 MiB without one), rounded
    down to a power of two and floored at 64 KiB."""
    ck = engine.config.chunk_bytes if engine is not None else 4 << 20
    p = 4096
    while p * 2 <= ck:
        p *= 2
    return max(p, 64 << 10)


def _build_locked(cfg: HostCacheConfig, engine) -> None:
    global _cache, _cache_init
    if _cache is not None:
        _cache.close()
        _cache = None
    new = None
    if cfg.budget_mb > 0:
        line = cfg.line_bytes or _default_line_bytes(engine)
        budget = cfg.budget_mb << 20
        if budget < line:
            # a budget below one line still wants a tier: shrink the line
            line = 4096
            while line * 2 <= budget:
                line *= 2
        new = HostCache(line_bytes=line, budget_bytes=budget,
                        quotas=parse_class_quotas(cfg.class_quotas),
                        ghost_factor=cfg.ghost_factor,
                        lock_arena=cfg.lock_arena,
                        stats=getattr(engine, "stats", None))
    _cache = new
    _cache_init = True


def configure(config: Optional[HostCacheConfig] = None,
              engine=None) -> Optional[HostCache]:
    """(Re)build the process's tier from ``config`` (default: the
    environment's); None when the budget is 0."""
    with _singleton_lock:
        _build_locked(config or HostCacheConfig(), engine)
        return _cache


def reset() -> None:
    """Tear the tier down; the next :func:`get_cache` reads the
    environment again."""
    global _cache, _cache_init
    with _singleton_lock:
        if _cache is not None:
            _cache.close()
        _cache = None
        _cache_init = False


def get_cache(engine=None) -> Optional[HostCache]:
    """The process's tier, built from the environment on first use;
    None while ``STROM_HOSTCACHE_MB`` is 0 (the default)."""
    if _cache_init:
        return _cache
    with _singleton_lock:
        if not _cache_init:
            _build_locked(HostCacheConfig(), engine)
        return _cache


def file_key_of(engine, fh: int) -> Optional[tuple]:
    """The engine's file identity of ``fh`` (None for an engine without
    one: the tier skips it)."""
    fn = getattr(engine, "file_key", None)
    return fn(fh) if fn is not None else None


def notify_write(fkey: Optional[tuple], offset: int, length: int,
                 stats=None) -> None:
    """Drop the lines an engine write overlaps (``StromEngine`` calls it
    at a write's submit and completion).  A no-op with the tier off."""
    c = _cache
    if c is not None and fkey is not None:
        c.invalidate(fkey, offset, length, stats=stats)


def spoil_span(engine, fh: int, offset: int, length: int,
               stats=None) -> None:
    """A consumer's check just failed on this span: drop the lines it
    may have filled, so a re-read reaches the device.  A no-op with the
    tier off."""
    c = _cache
    if c is None:
        return
    fkey = file_key_of(engine, fh)
    if fkey is not None:
        c.invalidate(fkey, offset, length, stats=stats)


def spoil_path(path, offset: int, length: int, stats=None) -> None:
    """:func:`spoil_span` by path: the ``stat`` identity equals the
    engine's key while the file is unmodified."""
    c = _cache
    if c is None:
        return
    try:
        st = os.stat(path)
    except OSError:
        return
    c.invalidate((st.st_dev, st.st_ino, st.st_mtime_ns, st.st_size),
                 offset, length, stats=stats)
