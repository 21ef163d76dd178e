"""The SSD-backed KV prefix store shared by the decode servers
(counterpart of nvme_strom_tpu/models/kv_offload.py ``PrefixStore`` and
``build_prefix_store``).

A page holds ``page_tokens`` positions of one sequence at kv-head width,
laid out ``[k block][v block]``, each ``(n_layers, n_kv_heads,
page_tokens, head_dim)`` of the model dtype, and is keyed by the rolling
SHA-1 of the token chain up to and including it, seeded with the model
identity.  The page file, its ``.kvman.json`` manifest and the keys are
the JAX package's byte for byte, so either package reattaches and
restores the other's store, and its ``strom-scrub`` checks the file.

The restore is the system's own path: ``restore_many`` reads every
requesting slot's due pages in one ``plan_and_submit`` batch into the
engine's staging buffers, and each piece goes to the device with
``ops/bridge.py`` ``host_to_device``, which on a CUDA device runs the
``h2d_copy`` kernel reading the (CUDA-registered) staging buffer in
place, so no host copy is made and ``bounce_bytes`` stays 0.  Under
``STROM_VERIFY`` the page's CRC32C is computed on those same staging
views before the copy.  A piece is released only after its copy has
completed.  On the CPU the same code makes the plain copy.

Left for the later parts of the port, each named where it would act:
the QoS class and host-tier hot pin of the reads (``klass="decode"``,
``hot=True``; ``warm_pages``' pin of the host-cache lines), the tenant
charge and quota pre-pass of the eviction, the SLO governor
(``STROM_KV_P99_MS``, refused by ``KVServeConfig``), and the tracer's
restore span.  Pages carry ``tenant: None``.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from nvme_strom_tpu_torch.device import resolve_device
from nvme_strom_tpu_torch.io.engine import StromEngine, crc32c
from nvme_strom_tpu_torch.io.plan import plan_and_submit
from nvme_strom_tpu_torch.models.transformer import TransformerConfig
from nvme_strom_tpu_torch.ops.bridge import host_to_device
from nvme_strom_tpu_torch.utils.checksum import VerifyPolicy
from nvme_strom_tpu_torch.utils.stats import percentiles_from_log2_hist

#: the JAX config's mixture-of-experts fields that the chain seed hashes;
#: the port has no MoE, and a dense model keeps their defaults
_DENSE_EXPERT_TOP_K = 2
_DENSE_MOE_EVERY = 2
#: an O_DIRECT write needs its source, offset and length on this boundary
_ALIGN = 4096


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype ("bfloat16", "float32", ...), the
    name the JAX store hashes."""
    return str(dtype).replace("torch.", "")


def _host_bytes(x) -> np.ndarray:
    """The bytes of a numpy array or a tensor as a flat uint8 array (a
    view where the memory is already contiguous on the host)."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        return t.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


class PrefixStore:
    """Content-addressed NVMe store of prompt KV pages, shared by decode
    servers and sessions (thread-safe; one instance per page file).

    ``put`` writes a page once; a resident key counts
    ``kv_pages_deduped`` / ``kv_bytes_saved`` instead.  ``restore_many``
    gathers every requesting slot's due pages into one read batch and
    hands them back on the caller's device.  Every page carries a
    write-time CRC32C, kept in the ``.kvman.json`` manifest and checked
    on restore under ``STROM_VERIFY``.  Eviction reclaims the lowest
    benefit score (reuse count × the histogram's restore cost, oldest
    first on a tie); a page pinned by a restore in flight is never
    reclaimed.  A failed restore (I/O or CRC) drops the entry, and the
    server prefills that page like any miss: the store never fails a
    request."""

    #: page writes kept in flight before ``put`` drains
    _MAX_PENDING = 4

    def __init__(self, cfg: TransformerConfig, engine: StromEngine,
                 path: str, page_tokens: int, capacity_bytes: int):
        if page_tokens < 1:
            raise ValueError(f"page_tokens must be >= 1, got {page_tokens}")
        self.cfg = cfg
        self.engine = engine
        self.path = str(path)
        self.page_tokens = page_tokens
        L, nkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        self._dtype = cfg.dtype
        itemsize = torch.empty(0, dtype=cfg.dtype).element_size()
        self._kv_shape = (L, nkv, page_tokens, hd)
        self.page_bytes = 2 * L * nkv * page_tokens * hd * itemsize
        # a non-zero budget means the caller wants the store: one page
        # at least
        capacity_bytes = max(capacity_bytes, self.page_bytes)
        self.capacity_pages = max(1, capacity_bytes // self.page_bytes)
        #: chain seed: every field of the model that changes the KV
        #: bytes a token chain produces, as the JAX store hashes them
        self._seed = hashlib.sha1(repr((
            "kvprefix-v1", cfg.vocab, cfg.d_model, cfg.n_layers,
            cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, float(cfg.rope_theta),
            cfg.rope_scaling, cfg.norm_eps, _dtype_name(cfg.dtype),
            cfg.n_experts, _DENSE_EXPERT_TOP_K, _DENSE_MOE_EVERY,
            page_tokens)).encode()).digest()
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._fh = engine.open(self.path, writable=True)
        self.stats = engine.stats
        self._lock = threading.Lock()
        self._wlock = threading.Lock()
        #: set by close() before its final flush: put() and
        #: restore_many() refuse new work from then on, so the drain
        #: converges; _io_inflight counts the puts and restores past
        #: that gate, and close() waits for it to reach 0 before it
        #: closes the file
        self._closed = False
        self._io_inflight = 0
        self._io_cv = threading.Condition(self._lock)
        #: thread id of the active drainer (the _drain_mu holder): a
        #: put() re-entered from one of the drain's own waits skips the
        #: backpressure acquire instead of deadlocking on it
        self._drain_owner: Optional[int] = None
        # serializes drainers only; put()'s maintenance drain only
        # try-acquires it, so a submitter never waits behind another
        # thread's I/O while the backlog is within twice the bound
        self._drain_mu = threading.Lock()
        #: key -> {"page", "hits", "seq", "crc", "pins", "ready",
        #: "tenant"}
        self._entries: Dict[bytes, dict] = {}
        # reversed, so pop() hands out slot 0 first and the file grows
        # from the front
        self._free = list(range(self.capacity_pages - 1, -1, -1))
        self._seq = 0
        self._pending_writes: list = []
        #: restore-batch latency, a log2 histogram in µs
        self._restore_hist = [0] * 40
        self._man_last = 0.0
        #: host→device copies the restores started (one a piece)
        self.copies = 0
        self._verify = VerifyPolicy()
        self._load_manifest()

    # -- identity / lookup --------------------------------------------------

    def chain_keys(self, tokens) -> List[bytes]:
        """One key per full page of the chain, at most
        ``(len - 1) // page_tokens`` of them, so at least one token
        always prefills (the first-token logits need a real forward; the
        paged server's block cache cuts at the same boundaries)."""
        P = self.page_tokens
        keys, h = [], self._seed
        for i in range(max(0, (len(tokens) - 1) // P)):
            chunk = np.asarray(tokens[i * P:(i + 1) * P], np.int32).tobytes()
            h = hashlib.sha1(h + chunk).digest()
            keys.append(h)
        return keys

    def match(self, keys) -> int:
        """Length of the longest resident chain prefix: pages whose
        write is fully submitted (a restore drains pending writes before
        it reads)."""
        with self._lock:
            n = 0
            for kx in keys:
                e = self._entries.get(kx)
                if e is None or not e["ready"]:
                    break
                n += 1
            return n

    def pages_resident(self) -> int:
        with self._lock:
            return len(self._entries)

    # -- restore ------------------------------------------------------------

    def restore_many(self, wants: Dict[object, tuple], device=None
                     ) -> Dict[object, Dict[int, tuple]]:
        """Restore every requesting slot's due pages in one read batch.

        ``wants``: slot -> (first chain index, [chain keys]).  Returns
        slot -> {chain index: (k, v)}, each ``(L, nkv, P, hd)`` of the
        model dtype on ``device`` (default ``cuda:0``), for the pages
        that restored cleanly.  A page two slots ask for is read and
        copied once; both get the same tensors.  A failed page drops its
        entry and is absent from the result: the caller prefills it."""
        dev = resolve_device(device)
        with self._lock:
            if self._closed:
                return {}
            self._io_inflight += 1
        try:
            return self._restore_many_gated(wants, dev)
        finally:
            with self._io_cv:
                self._io_inflight -= 1
                if self._io_inflight == 0:
                    self._io_cv.notify_all()

    def _restore_many_gated(self, wants, dev) -> Dict[object, Dict[int, tuple]]:
        plan: list = []            # (slot, chain index, key, entry)
        with self._lock:
            for slot, (start, keys) in wants.items():
                for j, kx in enumerate(keys):
                    e = self._entries.get(kx)
                    if e is None or not e["ready"]:
                        continue   # evicted since match(), or still
                        #            submitting: recompute
                    e["pins"] += 1
                    e["hits"] += 1
                    self._seq += 1
                    e["seq"] = self._seq
                    plan.append((slot, start + j, kx, e))
        if not plan:
            return {}
        t0 = time.monotonic()
        try:
            # a failed write surfacing here degrades to recompute, and
            # must not leak the pins just taken
            self._drain_writes()
            # the QoS class (decode) and the host tier's hot lines of
            # the JAX planner come with the scheduler and the host tier
            planned = plan_and_submit(
                self.engine, [(self._fh, e["page"] * self.page_bytes,
                               self.page_bytes) for _s, _i, _k, e in plan])
        except OSError:
            with self._lock:
                for _s, _i, _k, e in plan:
                    self._unpin_locked(e)
            self.stats.add(kv_restore_failures=len(plan))
            return {}
        out: Dict[object, Dict[int, tuple]] = {}
        failed: list = []
        transfers: list = []       # every copy started; all complete
        #                            before any staging buffer is released
        pages: dict = {}           # page slot -> its device parts, or
        #                            None when it failed
        try:
            for (_s, _i, kx, e), pieces in zip(plan, planned):
                if e["page"] not in pages:
                    pages[e["page"]] = self._start_copies(e, pieces, dev,
                                                          transfers)
            for t in transfers:
                t.synchronize()
            half = self.page_bytes // 2
            views: dict = {}
            for slot, idx, kx, e in plan:
                parts = pages[e["page"]]
                if parts is None:
                    failed.append((kx, e))
                    continue
                kv = views.get(e["page"])
                if kv is None:
                    flat = parts[0] if len(parts) == 1 else torch.cat(parts)
                    kv = views[e["page"]] = (
                        flat[:half].view(self._dtype).reshape(self._kv_shape),
                        flat[half:].view(self._dtype).reshape(self._kv_shape))
                out.setdefault(slot, {})[idx] = kv
        finally:
            for t in transfers:
                t.synchronize()
            for pieces in planned:
                for p in pieces:
                    p.release()
            with self._lock:
                for _s, _i, _k, e in plan:
                    self._unpin_locked(e)
        elapsed_us = max(1, int((time.monotonic() - t0) * 1e6))
        n_ok = sum(len(v) for v in out.values())
        with self._lock:
            # hist[i] counts [2^i, 2^(i+1)) µs; halved past 512 samples,
            # so the estimate follows current latency
            self._restore_hist[min(elapsed_us.bit_length() - 1,
                                   len(self._restore_hist) - 1)] += 1
            if sum(self._restore_hist) >= 512:
                self._restore_hist = [c // 2 for c in self._restore_hist]
        if failed:
            # damaged or vanished pages heal through recompute: drop the
            # entries, so the next admission writes fresh bytes
            with self._lock:
                for kx, e in failed:
                    if self._entries.get(kx) is e and e["pins"] == 0:
                        del self._entries[kx]
                        self._free.append(e["page"])
            self._save_manifest()
        self.stats.add(kv_pages_restored=n_ok, kv_prefix_hits=n_ok,
                       kv_restore_failures=len(failed))
        self.stats.set_gauges(
            kv_restore_p99_ms=self.restore_p99_ms() or 0.0,
            kv_store_pages_resident=self.pages_resident())
        return out

    def _start_copies(self, e: dict, pieces, dev, transfers: list):
        """Wait for one page's pieces, check its CRC32C on the staging
        views under ``STROM_VERIFY``, and start each piece's copy to
        ``dev`` (appended to ``transfers``).  Returns the page's device
        parts in order, or None when a read, the length or the check
        failed."""
        views, n = [], 0
        try:
            for p in pieces:
                v = p.wait()
                views.append(v)
                n += v.nbytes
        except OSError:
            return None
        if n != self.page_bytes:
            return None
        if self._verify.enabled and self._verify.want():
            crc = 0
            for v in views:
                crc = crc32c(v, crc)
            self.stats.add(bytes_verified=n)
            if crc != e["crc"]:
                self.stats.add(checksum_failures=1)
                return None
        parts = []
        for v in views:
            t = host_to_device(self.engine, v, dev)
            transfers.append(t)
            parts.append(t.tensor)
            self.copies += 1
        return parts

    def restore_p99_ms(self) -> Optional[float]:
        """p99 of the restore-batch latency from the log2 histogram."""
        with self._lock:
            hist = list(self._restore_hist)
        p = percentiles_from_log2_hist(hist, ps=(99,))[99]
        return p / 1000.0 if p else None

    def _restore_cost_ms(self) -> float:
        """Median restore cost (the benefit score's factor); the caller
        holds the lock."""
        p = percentiles_from_log2_hist(list(self._restore_hist),
                                       ps=(50,))[50]
        return max(p / 1000.0, 1e-3)

    # -- write side ---------------------------------------------------------

    def _drain_writes(self, keep: int = 0) -> None:
        """Complete pending page writes, oldest first.  A failed write
        never raises: its page drops, and the next admission recomputes
        and rewrites it.  A maintenance drain (``keep`` > 0, put()'s
        backlog bound) only try-acquires the drainer lock: an active
        drainer enforces the bound itself, unless the backlog has passed
        twice the bound, where the submitter blocks for backpressure.
        ``keep`` 0 (flush) blocks: its contract is completion."""
        bad: list = []
        me = threading.get_ident()
        if keep > 0:
            if not self._drain_mu.acquire(blocking=False):
                # a put() re-entered from the active drain's own wait()
                # is that drainer: blocking would deadlock on its lock
                if self._drain_owner == me:
                    return
                with self._wlock:
                    backlog = len(self._pending_writes)
                if backlog <= 2 * self._MAX_PENDING:
                    return
                self._drain_mu.acquire()
            self._drain_owner = me
            try:
                self._drain_loop(keep, bad)
            finally:
                self._drain_owner = None
                self._drain_mu.release()
        else:
            if self._drain_owner == me:
                return   # re-entered from our own drain: it does the work
            with self._drain_mu:
                self._drain_owner = me
                try:
                    self._drain_loop(0, bad)
                finally:
                    self._drain_owner = None
        if bad:
            self._drop_pages_at(bad)

    def _drain_all_and_snapshot(self) -> Optional[set]:
        """flush()'s drain: the keys proven drained, for the clean
        manifest.  Each round snapshots the ready keys first, then
        drains: put() appends a page's writes before it flips the entry
        ready, so a snapshotted entry's writes predate the drain.  An
        entry that turns ready after the last snapshot is left out of
        the stamp.  Rounds are bounded (8), so sustained puts cannot pin
        flush() or close(); their tail stays pending for the next drain.
        Returns None when re-entered from our own drain's wait (the
        outer flush saves)."""
        bad: list = []
        stamped: set = set()
        if self._drain_owner == threading.get_ident():
            return None
        with self._drain_mu:
            self._drain_owner = threading.get_ident()
            try:
                for _ in range(8):
                    with self._lock:
                        stamped = {kx for kx, e in self._entries.items()
                                   if e["ready"]}
                    self._drain_loop(0, bad)
                    with self._wlock:
                        if not self._pending_writes:
                            break
            finally:
                self._drain_owner = None
        if bad:
            # dropped entries leave _entries, and _save_manifest filters
            # against the live map
            self._drop_pages_at(bad)
        return stamped

    def _drain_loop(self, keep: int, bad: list) -> None:
        # the caller holds _drain_mu.  Drains a snapshot of the backlog:
        # batches appended while this one waits belong to the next drain
        with self._wlock:
            excess = len(self._pending_writes) - keep
        while excess > 0:
            excess -= 1
            with self._wlock:
                if len(self._pending_writes) <= keep:
                    break
                batch = self._pending_writes.pop(0)
            for p in batch:
                try:
                    p.wait()
                except OSError:
                    bad.append(getattr(p, "offset", None))

    def _drop_pages_at(self, offsets) -> None:
        """Drop the entries whose page a failed write touched; a pinned
        entry's slot is freed by the restore's last unpin instead."""
        slots = {off // self.page_bytes for off in offsets if off is not None}
        dropped = 0
        with self._lock:
            for kx, e in list(self._entries.items()):
                if e["page"] in slots:
                    del self._entries[kx]
                    if e["pins"] == 0:
                        self._free.append(e["page"])
                    else:
                        e["dropped"] = True
                    dropped += 1
        if dropped:
            self.stats.add(kv_restore_failures=dropped)

    def _unpin_locked(self, e: dict) -> None:
        e["pins"] -= 1
        if e["pins"] == 0 and e.pop("dropped", False):
            self._free.append(e["page"])

    def put(self, pages) -> int:
        """Persist computed pages: ``(chain key, k, v)`` with k and v
        ``(L, nkv, P, hd)`` of the model dtype (numpy arrays or CPU
        tensors).  A resident key dedupes.  Returns the pages written.
        Writes are asynchronous (a bounded pipeline); ``flush`` drains.

        Ordering: the entry is registered not ready first (a racing put
        of the same key dedupes) and turns ready only after its writes
        are submitted, so a restore that sees it ready and drains the
        pending writes never reads bytes the device has not been given.
        The page is assembled in a 4 KiB-aligned buffer, so its writes
        go O_DIRECT."""
        with self._lock:
            if self._closed:
                return 0   # closing: refuse work, never fail it
            self._io_inflight += 1
        try:
            return self._put_gated(pages)
        finally:
            with self._io_cv:
                self._io_inflight -= 1
                if self._io_inflight == 0:
                    self._io_cv.notify_all()

    def _page_host(self, k, v) -> np.ndarray:
        """The page's [k][v] bytes in a buffer aligned for O_DIRECT."""
        kb, vb = _host_bytes(k), _host_bytes(v)
        half = self.page_bytes // 2
        if kb.nbytes != half or vb.nbytes != half:
            raise ValueError(f"a page's k and v are {half} bytes each, got "
                             f"{kb.nbytes} and {vb.nbytes}")
        buf = np.empty(self.page_bytes + _ALIGN, np.uint8)
        off = (-buf.ctypes.data) % _ALIGN
        host = buf[off:off + self.page_bytes]
        host[:half] = kb
        host[half:] = vb
        return host

    def _put_gated(self, pages) -> int:
        written = deduped = 0
        for kx, k, v in pages:
            # membership first: the common dedupe must not pay the page
            # copy and CRC it would discard
            with self._lock:
                if self._closed:
                    break
                if kx in self._entries:
                    deduped += 1
                    continue
                if self._free:
                    slot = self._free.pop()
                else:
                    slot = self._evict_locked()
                    if slot is None:
                        continue   # everything pinned: skip, not fail
                self._seq += 1
                # the tenant charge comes with tenants
                self._entries[kx] = {"page": slot, "hits": 0,
                                     "seq": self._seq, "crc": None,
                                     "pins": 0, "ready": False,
                                     "tenant": None}
            host = self._page_host(k, v)
            crc = crc32c(host)
            off = slot * self.page_bytes
            chunk = self.engine.config.chunk_bytes
            pend: list = []
            try:
                self._drain_writes(keep=self._MAX_PENDING - 1)
                for p0 in range(0, self.page_bytes, chunk):
                    pend.append(self.engine.submit_write(
                        self._fh, off + p0, host[p0:p0 + chunk]))
            except OSError:
                # settle the chunks in flight, then reclaim the slot (a
                # never-ready entry is invisible to match and eviction)
                for p in pend:
                    try:
                        p.wait()
                    except OSError:
                        pass
                with self._lock:
                    e = self._entries.get(kx)
                    if e is not None and e["page"] == slot \
                            and not e["ready"]:
                        del self._entries[kx]
                        self._free.append(slot)
                break
            with self._wlock:
                self._pending_writes.append(pend)
            with self._lock:
                e = self._entries.get(kx)
                if e is not None and e["page"] == slot:
                    e["crc"] = crc
                    e["ready"] = True
            written += 1
        if written or deduped:
            self.stats.add(kv_pages_written=written,
                           kv_pages_deduped=deduped,
                           kv_bytes_saved=deduped * self.page_bytes)
            self.stats.set_gauges(
                kv_store_pages_resident=self.pages_resident())
        if written:
            self._save_manifest(throttle=True)
        return written

    def _evict_locked(self) -> Optional[int]:
        """Reclaim the lowest-benefit unpinned page (the caller holds the
        lock): score = reuse count × estimated restore cost, oldest
        first on a tie.  The tenant-quota pre-pass comes with tenants."""
        cost = self._restore_cost_ms()
        victim_key = victim_score = None
        for kx, e in self._entries.items():
            if e["pins"] > 0 or not e["ready"]:
                continue   # a restore in flight, or a put still writing
            score = (e["hits"] * cost, e["seq"])
            if victim_score is None or score < victim_score:
                victim_score, victim_key = score, kx
        if victim_key is None:
            return None
        e = self._entries.pop(victim_key)
        self.stats.add(kv_store_evictions=1)
        return e["page"]

    # -- cold-start warmup ----------------------------------------------------

    def warm_pages(self, budget_pages: int = 256) -> int:
        """Re-read the ``budget_pages`` top-benefit resident pages, the
        cold-start warming pass of a replica that just reattached a
        manifest.  Best effort: failures warm less and never raise.
        Returns the pages read.  Pinning their lines in the host-DRAM
        tier, which makes the next restore a memory hit, comes with that
        tier; until then the pass only reads."""
        if budget_pages <= 0:
            return 0
        with self._lock:
            if self._closed:
                return 0
            ranked = sorted(
                ((e["hits"], e["seq"], kx, e)
                 for kx, e in self._entries.items() if e["ready"]),
                reverse=True)[:budget_pages]
            for _h, _s, _k, e in ranked:
                e["pins"] += 1
            self._io_inflight += 1
        warmed = 0
        try:
            self._drain_writes()
            extents = [(self._fh, e["page"] * self.page_bytes,
                        self.page_bytes) for _h, _s, _k, e in ranked]
            if extents:
                for pieces in plan_and_submit(self.engine, extents):
                    ok = bool(pieces)
                    for p in pieces:
                        try:
                            p.wait()
                        except OSError:
                            ok = False
                        finally:
                            p.release()
                    warmed += ok
        except OSError:
            pass
        finally:
            with self._lock:
                for _h, _s, _k, e in ranked:
                    self._unpin_locked(e)
            with self._io_cv:
                self._io_inflight -= 1
                if self._io_inflight == 0:
                    self._io_cv.notify_all()
        return warmed

    # -- the manifest -------------------------------------------------------

    @property
    def manifest_path(self) -> str:
        return self.path + ".kvman.json"

    def _save_manifest(self, throttle: bool = False, clean: bool = False,
                       keys=None) -> None:
        """Atomically write {page slot: (key hex, crc)}, the file
        ``strom-scrub`` checks offline.  ``throttle`` (each put) writes
        at most once a second.  ``clean`` is set only by flush() and
        close(), after the write pipeline drained, and only a clean
        manifest reattaches: a manifest written mid-run may stamp pages
        whose writes never completed.  ``keys`` restricts the stamp to
        the entries proven drained."""
        if throttle:
            now = time.monotonic()
            if now - self._man_last < 1.0:
                return
            self._man_last = now
        with self._lock:
            pages = {str(e["page"]): {"key": kx.hex(), "crc": e["crc"]}
                     for kx, e in self._entries.items()
                     if e["ready"] and (keys is None or kx in keys)}
        man = {"version": 1, "page_bytes": self.page_bytes,
               "page_tokens": self.page_tokens, "clean": clean,
               "pages": pages}
        tmp = self.manifest_path + f".tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(man, f, sort_keys=True)
            os.replace(tmp, self.manifest_path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def _load_manifest(self) -> None:
        """Reattach a previous process's store from a clean manifest of
        the same page geometry.  Keys are content hashes, so another
        model's manifest simply never matches; any malformed content
        starts the store empty instead of failing."""
        try:
            with open(self.manifest_path) as f:
                man = json.load(f)
            if (man.get("version") != 1
                    or man.get("page_bytes") != self.page_bytes
                    or man.get("page_tokens") != self.page_tokens
                    or not man.get("clean")):
                return
            with self._lock:
                for slot_s, row in man.get("pages", {}).items():
                    slot = int(slot_s)
                    if slot >= self.capacity_pages:
                        continue
                    self._entries[bytes.fromhex(row["key"])] = {
                        "page": slot, "hits": 0, "seq": 0,
                        "crc": int(row["crc"]), "pins": 0, "ready": True,
                        "tenant": None}
                    if slot in self._free:
                        self._free.remove(slot)
        except (OSError, ValueError, TypeError, KeyError, AttributeError):
            with self._lock:
                self._entries.clear()
                self._free = list(range(self.capacity_pages - 1, -1, -1))

    # -- lifecycle ------------------------------------------------------------

    def flush(self) -> None:
        """Drain the writes and stamp a clean manifest of the pages
        proven written."""
        stamped = self._drain_all_and_snapshot()
        if stamped is None:
            return   # re-entered: the outer flush stamps
        self._save_manifest(clean=True, keys=stamped)

    def flush_for_handoff(self) -> list:
        """:meth:`flush`, returning the stamped keys (hex), so that a
        handoff bundle can be audited never to name a page whose write
        was not proven complete; ``[]`` when re-entered."""
        stamped = self._drain_all_and_snapshot()
        if stamped is None:
            return []
        self._save_manifest(clean=True, keys=stamped)
        return sorted(k.hex() for k in stamped)

    def ready_keys(self) -> list:
        """Hex keys of the pages proven complete (ready, CRC stamped)."""
        with self._lock:
            return sorted(k.hex() for k, e in self._entries.items()
                          if e.get("ready"))

    def close(self) -> None:
        """Refuse new work, wait for the puts and restores in flight,
        flush, close the page file."""
        if self._fh is None:
            return
        with self._lock:
            self._closed = True
        with self._io_cv:
            while self._io_inflight:
                self._io_cv.wait(timeout=1.0)
        try:
            self.flush()
        finally:
            self.engine.close(self._fh)
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def build_prefix_store(cfg: TransformerConfig, engine: StromEngine,
                       path: str, page_tokens: int,
                       kvcfg=None) -> Optional[PrefixStore]:
    """The environment-gated factory: None when ``STROM_KV_PREFIX`` is
    unset or 0, or the budget is 0, and the servers then run their
    store-less path bit for bit.  A zero budget disables rather than
    clamps: a one-page store would thrash every multi-page prefix."""
    from nvme_strom_tpu_torch.utils.config import KVServeConfig
    kvcfg = kvcfg or KVServeConfig()
    if not kvcfg.prefix_enabled or kvcfg.store_mb <= 0:
        return None
    return PrefixStore(cfg, engine, path,
                       page_tokens=kvcfg.page_tokens or page_tokens,
                       capacity_bytes=kvcfg.store_mb << 20)
