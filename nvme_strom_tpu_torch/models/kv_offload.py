"""SSD-backed KV caches (counterpart of
nvme_strom_tpu/models/kv_offload.py): the offloaded decode cache
``PagedKVCache`` with its generation functions, and the prefix store
``PrefixStore`` shared by the decode servers.

**Offloaded decode.**  A session whose attention history is larger than
the device budget keeps a window of ``page_len * window_pages`` recent
positions on the device, ``(n_layers, batch, n_kv_heads, window,
head_dim)`` for each of k and v, and spills older positions to a page
file through the engine's write path, one ``page_len``-position page at
a time.  A page is ``[k data][k scales][v data][v scales]``, each
section layer-major (scales only under ``quantize="int8"``: int8 data
with one float32 absmax scale per position and kv head), so one layer's
page is two (or four) contiguous spans.  Attention over the history is
an online-softmax sum at kv-head width: the window and each page give a
partial ``(m, l, acc)`` in float32, merged by ``_combine``, so pages
stream through one at a time and the whole history never sits on the
device.  The partials are plain torch ops, as the reference computes
them in jnp outside any kernel.

Each step streams a layer's cold spans with ``ops/bridge.py``
``DeviceStream.stream_ranges``: on a CUDA device the ``h2d_copy`` kernel
reads each span from the engine's registered staging buffer in place.
An evicted page is copied from the device into a page-locked,
4 KiB-aligned host buffer, so its writes go O_DIRECT where the sizes
allow, and the host tier (``host_cache_pages``) hands that same buffer
to ``h2d_copy`` with its mapping: neither path bounces.  Under
``STROM_VERIFY`` every evicted layer section is stamped with its CRC32C
and checked on the staging view before its copy; a mismatch raises
``ChecksumError``.  The page file, the session files and their
``session.json`` are the JAX package's, so either package resumes the
other's session.

**The prefix store.**  A page holds ``page_tokens`` positions of one
sequence at kv-head width, laid out ``[k block][v block]``, each
``(n_layers, n_kv_heads, page_tokens, head_dim)`` of the model dtype, and
is keyed by the rolling SHA-1 of the token chain up to and including it,
seeded with the model identity.  The page file, its ``.kvman.json``
manifest and the keys are the JAX package's byte for byte, so either
package reattaches and restores the other's store, and its
``strom-scrub`` checks the file.

The restore is the system's own path: ``restore_many`` reads every
requesting slot's due pages in one ``plan_and_submit`` batch into the
engine's staging buffers, and each piece goes to the device with
``ops/bridge.py`` ``host_to_device``, which on a CUDA device runs the
``h2d_copy`` kernel reading the (CUDA-registered) staging buffer in
place, so no host copy is made and ``bounce_bytes`` stays 0.  Under
``STROM_VERIFY`` the page's CRC32C is computed on those same staging
views before the copy.  A piece is released only after its copy has
completed.  On the CPU the same code makes the plain copy.

The reads carry the reference's QoS classes: the restore runs as
``klass="decode", hot=True`` (with the host-DRAM tier on, its pages are
admitted on first miss and pinned under the decode quota, so a repeat
restore is served from the tier's lines, copied by ``h2d_copy`` in
place), ``warm_pages`` as ``klass="prefetch", hot=True``, and
``PagedKVCache``'s page stream as ``klass="decode"``.

Tenants (io/tenants.py): a ``put`` charges each new page to the
tenant of the calling scope (the entry's ``tenant``), and eviction
first reclaims from a tenant holding more pages than its quota fraction
of the store allows, so one tenant's prompts pay for their own
borrowing; outside any tenant scope pages carry ``tenant: None`` and
eviction is the benefit scan alone.  The page manifest carries no
tenant, as the JAX store's does not.

``SloGovernor`` (``STROM_KV_P99_MS``, ``KVServeConfig.p99_target_ms``)
sees the restore-batch p99 after every restore batch and raises the
decode class's scheduler weight one notch while it is past the target,
and one notch back once it is under half; the servers feed its
per-tenant lane with each tenant's TTFT p99.  On a resilient engine
(``STROM_RESILIENT=1``, io/resilient.py) it also doubles the decode
class's concurrent-hedge budget a notch (``engine.set_hedge_budget``)
and halves it back as it decays; on a bare engine that lever is absent
and only the weight moves.

Recovery (io/faults.py, io/resilient.py): on a resilient engine every
page read above (the restore, ``warm_pages``, the offloaded page
stream) retries and hedges inside the engine and hands back the
winning attempt's staging view, so the copy still reads registered
memory; the eviction writes go through ``engine.submit_write`` and so
get the write mirror (a failed write resubmitted, a short one finished
from where it stopped).

The governor does not boost into a sick device: while the engine's
supervisor (io/health.py) reports any breaker not closed, or the device
degraded, a p99 past the target moves nothing, on either lane.  Each
boost dumps the engine's flight recorder (``slo_violation``,
io/flightrec.py).  ``PrefixStore.warm_pages`` is the cold-start warming
pass (io/coldstart.py) and counts ``coldstart_warm_pages``.  With the
engine's tracer on, each ``restore_many`` is a ``strom.kv.restore``
span, and its wait for the page copies a ``strom.h2d.sync`` span.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from nvme_strom_tpu_torch.device import resolve_device
from nvme_strom_tpu_torch.io.engine import StromEngine, crc32c
from nvme_strom_tpu_torch.io.plan import plan_and_submit
from nvme_strom_tpu_torch.io.tenants import SLO_MAX_BOOST, current_tenant
from nvme_strom_tpu_torch.models.transformer import (
    TransformerConfig, embed, mlp_block, project, qkv_project, rms_norm)
from nvme_strom_tpu_torch.ops.bridge import (DeviceStream, host_to_device,
                                             pinned_mapping, split_ranges,
                                             write_from_device)
from nvme_strom_tpu_torch.utils.checksum import ChecksumError, VerifyPolicy
from nvme_strom_tpu_torch.utils.config import ColdStartConfig
from nvme_strom_tpu_torch.utils.lockwitness import make_condition, make_lock
from nvme_strom_tpu_torch.utils.stats import percentiles_from_log2_hist
from nvme_strom_tpu_torch.utils.trace import live_tracer

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


def _aligned_host(nbytes: int, dev: torch.device):
    """A host buffer of ``nbytes`` whose first byte is 4 KiB-aligned:
    page-locked (with its mapping for ``dev``) when ``dev`` is a CUDA
    device.  Returns (flat uint8 tensor, mapping or None)."""
    pinned = dev.type == "cuda"
    buf = torch.empty(nbytes + _ALIGN, dtype=torch.uint8, pin_memory=pinned)
    off = (-buf.data_ptr()) % _ALIGN
    host = buf[off:off + nbytes]
    return host, (pinned_mapping(host, dev) if pinned else None)


# ---------------------------------------------------------------------------
# offloaded decode: the HBM window and its NVMe page file


@dataclass(frozen=True)
class OffloadConfig:
    """Shape of the device window and its NVMe backing file.

    ``window = page_len * window_pages`` recent positions stay on the
    device; older history lives in ``path`` in ``page_len``-position
    pages.  ``quantize="int8"`` stores cold pages as int8 with one
    float32 absmax scale per (position, kv head); the window and all
    compute stay full precision, and pages are dequantized on the device
    after the read.  ``host_cache_pages``: the newest N evicted pages
    keep their host copies, and attention reads those from host memory
    instead of the page file."""
    path: str
    page_len: int = 256
    window_pages: int = 4
    quantize: Optional[str] = None      # None | "int8"
    host_cache_pages: int = 0

    def __post_init__(self):
        if self.quantize not in (None, "int8"):
            raise ValueError(f"quantize must be None or 'int8', "
                             f"got {self.quantize!r}")

    @property
    def window(self) -> int:
        return self.page_len * self.window_pages


#: the score of a hidden slot: exp(-1e30 - m) is exactly 0 in float32,
#: and a partial whose every slot is hidden merges with weight 0, where
#: -inf would give exp(-inf - -inf) = NaN
_HIDDEN = -1e30


def _append_block(k_win, v_win, k_new, v_new, count: int):
    """Write (L, b, nkv, s, hd) new positions at window slot ``count``
    (in place)."""
    s = k_new.shape[3]
    k_win[:, :, :, count:count + s] = k_new
    v_win[:, :, :, count:count + s] = v_new
    return k_win, v_win


def _append_layer(k_win, v_win, k_new, v_new, layer: int, count: int):
    """Write one layer's (b, nkv, s, hd) positions at (layer, count)
    (in place)."""
    s = k_new.shape[2]
    k_win[layer, :, :, count:count + s] = k_new
    v_win[layer, :, :, count:count + s] = v_new
    return k_win, v_win


def _evict_pages(k_win, v_win, page_slots: int):
    """Split off the oldest ``page_slots`` positions and shift the rest
    down, zeroing the tail.  Returns (k_page, v_page, k_win, v_win): the
    pages are copies, taken before the shift, and the shift reads a
    copy, because its source and destination overlap."""
    W = k_win.shape[3]
    pages = []
    for win in (k_win, v_win):
        pages.append(win[:, :, :, :page_slots].clone())
        win[:, :, :, :W - page_slots] = win[:, :, :, page_slots:].clone()
        win[:, :, :, W - page_slots:] = 0
    return pages[0], pages[1], k_win, v_win


def _grouped(q, n_kv: int):
    """(b, nh, s, hd) queries → (b, n_kv, g*s, hd) grouped to kv heads;
    row kv*(g*s) + j*s + t is head kv*g + j at position t.  A copying
    reshape: the projections arrive as transposed views."""
    b, nh, s, hd = q.shape
    return q.reshape(b, n_kv, (nh // n_kv) * s, hd)


def _partial_impl(q, k, v, mask=None):
    """Online-softmax partial of grouped queries against one key block,
    in float32.  q (b, nkv, rows, hd); k/v (b, nkv, S, hd); optional
    ``mask`` broadcastable to the (b, nkv, rows, S) scores (False =
    hidden) → m (b, nkv, rows, 1), l, acc."""
    hd = q.shape[-1]
    # the reference's einsums "bkgd,bksd->bkgs" and "bkgs,bksd->bkgd"
    s = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(hd)
    if mask is not None:
        s = torch.where(mask, s, _HIDDEN)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = p @ v.float()
    return m, l, acc


_page_partial = _partial_impl


def _page_partial_q(q, k_q, k_s, v_q, v_s):
    """The int8 page's partial: dequantized (data × scale) first."""
    return _partial_impl(q, k_q.float() * k_s, v_q.float() * v_s)


def _window_partial(q, k_win_l, v_win_l, count: int):
    """Partial over the window's first ``count`` valid positions."""
    W = k_win_l.shape[2]
    valid = (torch.arange(W, device=q.device) < count)[None, None, None, :]
    return _partial_impl(q, k_win_l, v_win_l, mask=valid)


#: the reference writes ``m / 127.0``, which XLA compiles as a product
#: with the float32 reciprocal: the same product gives the same scales
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def _quantize_page(x):
    """(…, P, hd) page → (int8 data, float32 absmax scale over hd);
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    xf = x.float()
    m = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(m > 0, m * _INV_127, torch.ones_like(m))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _combine(m1, l1, a1, m2, l2, a2):
    """Associative online-softmax merge of two partials."""
    m = torch.maximum(m1, m2)
    w1 = torch.exp(m1 - m)
    w2 = torch.exp(m2 - m)
    return m, l1 * w1 + l2 * w2, a1 * w1 + a2 * w2


def _chunk_causal_partial(q, k, v, s_len: int):
    """Causal partial of a prefill chunk against its own k/v.  q (b,
    nkv, g*s, hd) grouped rows (row j*s+t is head j at position t); k/v
    (b, nkv, s, hd).  Row t sees keys 0..t."""
    rows = q.shape[2]
    t = torch.arange(rows, device=q.device) % s_len
    causal = (t[:, None] >= torch.arange(s_len, device=q.device)[None, :]
              )[None, None]
    return _partial_impl(q, k, v, mask=causal)


def _finish(m, l, acc):
    """(b, nkv, rows, hd) partials → normalized attention rows, in the
    flattened (head, position) order :func:`_grouped` made."""
    return acc / l


class PagedKVCache:
    """Mutable decode-session KV cache: a device window and NVMe pages.

    The host runs the tier boundary (append, evict, stream); every
    tensor op runs on ``device`` (default ``cuda:0``).  Not thread-safe;
    one instance per decode session."""

    #: page writes kept in flight before an eviction drains
    _MAX_PENDING_PAGES = 4

    def __init__(self, cfg: TransformerConfig, ocfg: OffloadConfig,
                 engine: StromEngine, batch: int, device=None):
        self.cfg = cfg
        self.ocfg = ocfg
        self.engine = engine
        self.batch = batch
        self.device = resolve_device(device)
        L, nkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        shape = (L, batch, nkv, ocfg.window, hd)
        self.k_win = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
        self.v_win = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
        self.count = 0            # valid positions in the window
        self.n_cold = 0           # pages already written to the file
        self._quant = ocfg.quantize == "int8"
        self._itemsize = (1 if self._quant
                          else torch.empty(0, dtype=cfg.dtype).element_size())
        # bytes of one layer of one page of k (or v): data, then scales
        self._pb_layer = batch * nkv * ocfg.page_len * hd * self._itemsize
        self._pb_block = self._pb_layer * L
        self._sb_layer = (batch * nkv * ocfg.page_len * 4 if self._quant
                          else 0)
        self._sb_block = self._sb_layer * L
        # page file stride: [k data][k scales][v data][v scales]
        self._page_stride = 2 * (self._pb_block + self._sb_block)
        self._fh = engine.open(ocfg.path, writable=True)
        self._stream = DeviceStream(engine, device=self.device,
                                    depth=engine.config.queue_depth,
                                    klass="decode")
        # in-flight eviction writes, a list of PendingWrites a page; each
        # keeps its host buffer alive until waited
        self._pending_writes: list = []
        # the host tier: page index → (section host views, mapping),
        # dropped in insertion order past host_cache_pages
        self._host_cache: Dict[int, tuple] = {}
        self.host_cache_hits = 0
        self.host_cache_misses = 0
        # STROM_VERIFY: (page, section, layer) → CRC32C stamped at
        # eviction, checked when the layer's section streams back
        self._verify = VerifyPolicy()
        self._page_crc: Dict[tuple, int] = {}

    # -- lifecycle --------------------------------------------------------

    def _drain_writes(self, keep: int = 0) -> None:
        """Complete in-flight eviction writes, oldest first, leaving at
        most ``keep`` pages' writes outstanding.  Every popped write is
        waited even when an earlier one fails (each keeps its source
        buffer alive while the engine reads it); the first error raises
        after the batch settles."""
        first_err: Optional[OSError] = None
        while len(self._pending_writes) > keep:
            for p in self._pending_writes.pop(0):
                try:
                    p.wait()
                except OSError as e:
                    if first_err is None:
                        first_err = e
        if first_err is not None:
            raise first_err

    def flush(self) -> None:
        """Block until every evicted page's write has completed (visible
        to readers of the file; no fsync)."""
        self._drain_writes()

    def close(self) -> None:
        if self._fh is not None:
            try:
                self._drain_writes()
            finally:
                self.engine.close(self._fh)
                self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def pos(self) -> int:
        """Total cached positions (cold + window)."""
        return self.n_cold * self.ocfg.page_len + self.count

    # -- write tier -------------------------------------------------------

    def _section_offsets(self, page: int) -> Tuple[int, int, int, int]:
        """(k data, k scales, v data, v scales) file offsets of a page
        (the scale sections are empty unquantized)."""
        base = page * self._page_stride
        return (base,
                base + self._pb_block,
                base + self._pb_block + self._sb_block,
                base + 2 * self._pb_block + self._sb_block)

    def _write_page(self, k_page, v_page) -> None:
        """An evicted (L, b, nkv, P, hd) pair → asynchronous engine
        writes of its sections (int8 data and float32 scales when
        quantizing), from one page-locked 4 KiB-aligned host buffer the
        device copies into first.  Every read drains the writes first."""
        self._drain_writes(keep=self._MAX_PENDING_PAGES - 1)
        kd, ks, vd, vs = self._section_offsets(self.n_cold)
        if self._quant:
            k_q, k_s = _quantize_page(k_page)
            v_q, v_s = _quantize_page(v_page)
            sections = ((k_q, kd), (k_s, ks), (v_q, vd), (v_s, vs))
        else:
            sections = ((k_page, kd), (v_page, vd))
        base = kd
        buf, mapping = _aligned_host(self._page_stride, self.device)
        hosts = []
        for arr, off in sections:
            flat = arr.contiguous().reshape(-1).view(torch.uint8)
            dst = buf[off - base:off - base + flat.numel()]
            dst.copy_(flat, non_blocking=True)
            hosts.append(dst.numpy())
        if self.device.type == "cuda":
            # the writes and the CRC read the buffer: the copies first
            torch.cuda.current_stream(self.device).synchronize()
        sec_lens = (self._pb_layer, self._sb_layer,
                    self._pb_layer, self._sb_layer)
        chunk = self.engine.config.chunk_bytes
        pend = []
        for sec_idx, ((_arr, off), host) in enumerate(zip(sections, hosts)):
            if self._verify.enabled:
                # one stamp a layer slice, the span the read tier streams;
                # sampling gates here, so the read side checks exactly
                # the stamped spans
                ln = sec_lens[sec_idx] if self._quant else self._pb_layer
                for layer in range(self.cfg.n_layers):
                    if self._verify.want():
                        self._page_crc[(self.n_cold, sec_idx, layer)] = \
                            crc32c(host[layer * ln:(layer + 1) * ln])
            for p0 in range(0, host.nbytes, chunk):
                pend.append(self.engine.submit_write(
                    self._fh, off + p0, host[p0:p0 + chunk]))
        self._pending_writes.append(pend)
        if self.ocfg.host_cache_pages > 0:
            # the host tier keeps the buffer the writes read: no copy
            self._host_cache[self.n_cold] = (hosts, mapping)
            while len(self._host_cache) > self.ocfg.host_cache_pages:
                self._host_cache.pop(next(iter(self._host_cache)))
        self.n_cold += 1

    def _evict_one(self) -> None:
        k_page, v_page, self.k_win, self.v_win = _evict_pages(
            self.k_win, self.v_win, self.ocfg.page_len)
        self._write_page(k_page, v_page)
        self.count -= self.ocfg.page_len

    def append(self, k_new, v_new) -> None:
        """Push (L, b, nkv, s, hd) new positions; evict pages as needed.
        Post-condition: ``count < window`` (a free slot, which the
        append_layer / commit_step cycle relies on)."""
        W = self.ocfg.window
        s = k_new.shape[3]
        done = 0
        while done < s:
            take = min(W - self.count, s - done)
            if take > 0:
                _append_block(
                    self.k_win, self.v_win,
                    k_new[:, :, :, done:done + take].to(self.cfg.dtype),
                    v_new[:, :, :, done:done + take].to(self.cfg.dtype),
                    self.count)
                self.count += take
                done += take
            if self.count == W:
                self._evict_one()

    def append_layer(self, layer: int, k, v) -> None:
        """Stage one layer's (b, nkv, s, hd) positions at slot ``count``
        without advancing it: every layer of a step or chunk writes the
        same slots, and :meth:`commit_step` / :meth:`commit_block`
        advance.  Needs count + s <= window."""
        _append_layer(self.k_win, self.v_win, k.to(self.cfg.dtype),
                      v.to(self.cfg.dtype), layer, self.count)

    def commit_step(self) -> None:
        """Advance past the slot all layers just staged; evict if full."""
        self.commit_block(1)

    def commit_block(self, s: int) -> None:
        """Advance past ``s`` staged slots; evict until count < window."""
        self.count += s
        if self.count > self.ocfg.window:
            raise RuntimeError(
                f"commit_block({s}) overran the window "
                f"({self.count} > {self.ocfg.window})")
        while self.count >= self.ocfg.window:
            self._evict_one()

    def ensure_room(self, s: int) -> None:
        """Evict until ``s`` more positions fit in the window (the
        evicted slots predate the block being staged)."""
        P, W = self.ocfg.page_len, self.ocfg.window
        if s > W:
            raise ValueError(f"block of {s} exceeds window {W}")
        while self.count + s > W:
            if self.count < P:
                raise RuntimeError(
                    f"cannot make room: count={self.count} < page "
                    f"{P} but {s} more positions requested")
            self._evict_one()

    # -- session persistence ----------------------------------------------

    def save_session(self, directory) -> None:
        """Persist the session beside its page file: the window (through
        the engine's write path) and the counters in ``session.json``.
        With the page file (flushed here) this is the whole decode
        state; either package's :meth:`load_session` resumes it."""
        os.makedirs(directory, exist_ok=True)
        self.flush()
        for name, arr in (("k_win.bin", self.k_win),
                          ("v_win.bin", self.v_win)):
            path = os.path.join(directory, name)
            # the engine opens without O_TRUNC: a smaller re-save would
            # keep stale trailing bytes
            open(path, "wb").close()
            write_from_device(self.engine, arr, path)
        meta = {"count": self.count, "n_cold": self.n_cold,
                "batch": self.batch, "page_len": self.ocfg.page_len,
                "window_pages": self.ocfg.window_pages,
                "quantize": self.ocfg.quantize,
                "host_cache_pages": self.ocfg.host_cache_pages,
                "page_file": os.path.abspath(self.ocfg.path),
                "dtype": _dtype_name(self.cfg.dtype),
                "window_shape": list(self.k_win.shape)}
        tmp = os.path.join(directory, "session.json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(directory, "session.json"))

    @classmethod
    def load_session(cls, cfg: TransformerConfig, engine: StromEngine,
                     directory, device=None) -> "PagedKVCache":
        """Rebuild a saved session: the window streams back through the
        engine, the page file reattaches in place."""
        with open(os.path.join(directory, "session.json")) as f:
            meta = json.load(f)
        ocfg = OffloadConfig(
            path=meta["page_file"], page_len=meta["page_len"],
            window_pages=meta["window_pages"], quantize=meta["quantize"],
            host_cache_pages=meta.get("host_cache_pages", 0))
        if meta.get("dtype") != _dtype_name(cfg.dtype):
            raise ValueError(
                f"session saved with dtype {meta.get('dtype')}, cfg has "
                f"{_dtype_name(cfg.dtype)}: a bitcast would silently "
                f"corrupt the cache")
        self = cls(cfg, ocfg, engine, meta["batch"], device=device)
        try:
            shape = tuple(self.k_win.shape)
            if list(shape) != meta.get("window_shape"):
                raise ValueError(
                    f"session window shape {meta.get('window_shape')} "
                    f"does not match cfg's {list(shape)}")
            # free the zero windows before the saved ones arrive
            self.k_win = self.v_win = None
            for attr, name in (("k_win", "k_win.bin"),
                               ("v_win", "v_win.bin")):
                setattr(self, attr, self._stream.read_to_device(
                    os.path.join(directory, name), dtype=cfg.dtype,
                    shape=shape))
            self.count = meta["count"]
            self.n_cold = meta["n_cold"]
        except BaseException:
            self.close()
            raise
        return self

    # -- read tier --------------------------------------------------------

    def _make_verify_cb(self, layer: int, span_meta, n_sub):
        """The ``stream_ranges`` hook checking each stamped span's
        CRC32C on its staging views: a span split over several ranges
        accumulates, and its last range compares with the eviction-time
        stamp.  An unstamped span (not sampled, or evicted before
        verification was on) is skipped.  A mismatch raises
        ``ChecksumError``: there is no other copy of the history."""
        range_span = []          # range index → (span, last of span)
        for si, cnt in enumerate(n_sub):
            for j in range(cnt):
                range_span.append((si, j == cnt - 1))
        running: Dict[int, int] = {}
        stats = self.engine.stats

        def verify(ri: int, view) -> None:
            si, last = range_span[ri]
            page, sec = span_meta[si]
            expected = self._page_crc.get((page, sec, layer))
            if expected is None:
                return
            running[si] = crc32c(view, running.get(si, 0))
            stats.add(bytes_verified=int(view.nbytes))
            if not last:
                return
            got = running.pop(si)
            if got != expected:
                stats.add(checksum_failures=1)
                raise ChecksumError(
                    f"KV page {page} section {sec} layer {layer} of "
                    f"{self.ocfg.path} fails its eviction-time CRC32C "
                    f"({got:#010x} != {expected:#010x}): corrupt history "
                    f"must not reach attention")

        return verify

    def _iter_layer_pages(self, layer: int):
        """(k_page, v_page) device pairs of one layer's cold history, in
        file order, streamed at queue depth across all pages (a span
        larger than a staging buffer is read in chunks and joined on the
        device); host-tier pages are copied from their host buffers."""
        self._drain_writes()     # a just-evicted page must not read stale
        P = self.ocfg.page_len
        _L, b, nkv, _W, hd = self.k_win.shape
        sec_lens = tuple(ln for ln in (self._pb_layer, self._sb_layer,
                                       self._pb_layer, self._sb_layer)
                         if ln)
        spans = []          # per uncached page: k data[, sc], v data[, sc]
        span_meta = []      # (page, write-section index) of each span
        for page in range(self.n_cold):
            if page in self._host_cache:
                continue
            kd, ks, vd, vs = self._section_offsets(page)
            for sec_idx, (base, ln) in enumerate(
                    ((kd, self._pb_layer), (ks, self._sb_layer),
                     (vd, self._pb_layer), (vs, self._sb_layer))):
                if ln:
                    spans.append((base + layer * ln, ln))
                    # the eviction numbered the sections it wrote:
                    # k, v unquantized; k, ks, v, vs quantized
                    span_meta.append(
                        (page, sec_idx if self._quant else sec_idx // 2))
        ranges, n_sub = split_ranges(spans, self.engine.config.chunk_bytes)
        verify_cb = (self._make_verify_cb(layer, span_meta, n_sub)
                     if self._verify.enabled else None)
        it = self._stream.stream_ranges(self._fh, ranges, verify=verify_cb)
        counts = iter(n_sub)
        host_copies = []     # host-tier transfers, waited before return

        def stream_flat():
            parts = [next(it) for _ in range(next(counts))]
            return parts[0] if len(parts) == 1 else torch.cat(parts)

        def read_kv(take):
            if self._quant:
                data = take().view(torch.int8).reshape(b, nkv, P, hd)
                scale = take().view(torch.float32).reshape(b, nkv, P, 1)
                return data, scale
            return take().view(self.cfg.dtype).reshape(b, nkv, P, hd)

        try:
            for page in range(self.n_cold):
                entry = self._host_cache.get(page)
                if entry is not None:
                    self.host_cache_hits += 1
                    hosts, mapping = entry
                    flats = []
                    for sec, ln in zip(hosts, sec_lens):
                        t = host_to_device(
                            self.engine, sec[layer * ln:(layer + 1) * ln],
                            self.device,
                            mappings=(mapping,) if mapping else ())
                        if t.event is not None:
                            torch.cuda.current_stream(
                                self.device).wait_event(t.event)
                        host_copies.append(t)
                        flats.append(t.tensor)
                    take = iter(flats).__next__
                else:
                    self.host_cache_misses += 1
                    take = stream_flat
                yield read_kv(take), read_kv(take)
        finally:
            it.close()
            # the host tier may drop a buffer at the next eviction: its
            # copies end first
            for t in host_copies:
                t.synchronize()

    def _history_partials(self, layer: int, qf, valid: int):
        """(m, l, acc) of grouped queries over the cold pages and
        ``valid`` window slots: the window first, then the pages in file
        order."""
        m, l, acc = _window_partial(qf, self.k_win[layer],
                                    self.v_win[layer], valid)
        for k_item, v_item in self._iter_layer_pages(layer):
            if self._quant:
                pm, pl, pacc = _page_partial_q(qf, *k_item, *v_item)
            else:
                pm, pl, pacc = _page_partial(qf, k_item, v_item)
            m, l, acc = _combine(m, l, acc, pm, pl, pacc)
        return m, l, acc

    def attend(self, layer: int, q, valid: Optional[int] = None):
        """Full-history attention of one layer's query block.  q (b,
        n_heads, s, hd): every row attends all cold pages and ``valid``
        window slots (default ``count``; a decode step passes count + 1
        after :meth:`append_layer`, so its own position is visible).
        Returns (b, n_heads, s, hd) in the model dtype."""
        b, nh, s_q, hd = q.shape
        # cast once: every partial would cast it again for each page
        qf = _grouped(q, self.cfg.n_kv_heads).float()
        m, l, acc = self._history_partials(
            layer, qf, self.count if valid is None else valid)
        out = _finish(m, l, acc)
        return out.reshape(b, nh, s_q, hd).to(self.cfg.dtype)

    def attend_chunk(self, layer: int, q, k_chunk, v_chunk):
        """Chunked-prefill attention: every row sees the whole cached
        history plus its own chunk causally.  q (b, n_heads, s, hd);
        k_chunk / v_chunk (b, nkv, s, hd), not yet in the window."""
        b, nh, s_q, hd = q.shape
        qf = _grouped(q, self.cfg.n_kv_heads).float()    # cast once
        m, l, acc = self._history_partials(layer, qf, self.count)
        cm, cl, cacc = _chunk_causal_partial(
            qf, k_chunk.to(self.cfg.dtype), v_chunk.to(self.cfg.dtype),
            s_q)
        m, l, acc = _combine(m, l, acc, cm, cl, cacc)
        out = _finish(m, l, acc)
        return out.reshape(b, nh, s_q, hd).to(self.cfg.dtype)


# ---------------------------------------------------------------------------
# generation on the paged cache


def _layer_forward(params: Dict, i: int, x, cfg: TransformerConfig,
                   positions, attend):
    """One transformer layer against the paged cache, shared by the
    decode step and chunked prefill; ``attend(i, q, k, v)`` orders the
    append and the attention and returns (b, nh, s, hd)."""
    b, s, _ = x.shape
    Lk = f"layers.{i}."
    h = rms_norm(x, params[Lk + "attn_norm"], cfg.norm_eps)
    q, k, v = qkv_project(h, params, Lk, cfg, positions)
    a = attend(i, q, k, v)
    a = a.transpose(1, 2).reshape(b, s, -1)
    x = x + project(a, params, Lk + "wo")
    h = rms_norm(x, params[Lk + "mlp_norm"], cfg.norm_eps)
    return (x + mlp_block(h, params, Lk, cfg)).to(cfg.dtype)


def _final_logits(params: Dict, x_last, cfg: TransformerConfig):
    x_last = rms_norm(x_last, params["final_norm"], cfg.norm_eps)
    return project(x_last, params, "lm_head").float()


def offload_decode_step(params: Dict, token, cfg: TransformerConfig,
                        cache: PagedKVCache):
    """One decode step against the paged cache: token (b,) at position
    ``cache.pos`` → next-token logits (b, vocab) float32.  Each layer's
    k/v land in the window before its attention, so the new position
    sees itself; the count advances once, in ``commit_step``."""
    x = embed(params, token[:, None], cfg)
    positions = torch.tensor([cache.pos], dtype=torch.float32,
                             device=x.device)

    def attend(i, q, k, v):
        cache.append_layer(i, k, v)
        return cache.attend(i, q, valid=cache.count + 1)

    for i in range(cfg.n_layers):
        x = _layer_forward(params, i, x, cfg, positions, attend)
    cache.commit_step()
    return _final_logits(params, x[:, 0], cfg)


def offloaded_prefill(params: Dict, tokens, cfg: TransformerConfig,
                      cache: PagedKVCache):
    """Prefill a prompt of any length with a bounded window: chunks of
    ``page_len`` tokens each attend the whole cached history plus
    themselves causally, then join the window (evicting as needed).
    Needs ``window_pages >= 2``.  Returns the last position's logits
    (b, vocab) float32."""
    if cache.ocfg.window_pages < 2:
        raise ValueError("chunked prefill needs window_pages >= 2")
    _b, total = tokens.shape
    P = cache.ocfg.page_len

    def attend(i, q, k, v):
        a = cache.attend_chunk(i, q, k, v)
        cache.append_layer(i, k, v)
        return a

    x_last = None
    for c0 in range(0, total, P):
        chunk = tokens[:, c0:c0 + P]
        s = chunk.shape[1]
        cache.ensure_room(s)
        pos0 = cache.pos
        x = embed(params, chunk, cfg)
        positions = torch.arange(pos0, pos0 + s, dtype=torch.float32,
                                 device=x.device)
        for i in range(cfg.n_layers):
            x = _layer_forward(params, i, x, cfg, positions, attend)
        cache.commit_block(s)
        x_last = x[:, -1]
    return _final_logits(params, x_last, cfg)


# ---------------------------------------------------------------------------
# the serving prefix store: content-addressed cross-request KV pages on NVMe


class SloGovernor:
    """The restore p99 target turned into scheduling policy.

    ``observe`` takes the store's restore-batch p99: past ``target_ms``
    it raises ``klass``'s scheduler weight to (1 + boost) × its base
    (``engine.scheduler.set_weight``), and under half the target it
    lowers it a notch; boosts are at most SLO_MAX_BOOST and at most one
    a ``_MIN_INTERVAL_S``.  ``observe_tenant`` does the same for one
    tenant's TTFT p99 against its ``slo_p99_ms``, on that tenant's
    ``share_boost`` only (never a device-wide lever).  With no target,
    or an engine without the lever, it does nothing."""

    _MAX_BOOST = SLO_MAX_BOOST
    _MIN_INTERVAL_S = 0.5

    def __init__(self, target_ms: float, klass: str = "decode"):
        self.target_ms = float(target_ms)
        self.klass = klass
        self.boost = 0
        self._base_budget: Optional[int] = None
        self._base_weight: Optional[float] = None
        self._last = 0.0
        #: per-tenant rate-limit clocks (observe_tenant)
        self._tenant_last: Dict[str, float] = {}

    def observe(self, engine, p99_ms: Optional[float], stats=None) -> None:
        """Feed one restore-p99 sample; applies or decays the boost."""
        if self.target_ms <= 0 or not p99_ms:
            return
        now = time.monotonic()
        if now - self._last < self._MIN_INTERVAL_S:
            return
        step = 0
        if p99_ms > self.target_ms and self.boost < self._MAX_BOOST:
            step = 1
        elif p99_ms < 0.5 * self.target_ms and self.boost > 0:
            step = -1
        if step == 0:
            return
        sup = getattr(engine, "supervisor", None)
        if step > 0 and sup is not None and sup.unhealthy():
            # a p99 a sick device blew is not a scheduling problem
            return
        self._last = now
        self.boost += step
        set_budget = getattr(engine, "set_hedge_budget", None)
        if set_budget is not None:
            if self._base_budget is None:
                self._base_budget = int(getattr(engine, "hedge_budgets",
                                                {}).get(self.klass, 8))
            set_budget(self.klass, self._base_budget * (2 ** self.boost))
        sched = getattr(engine, "scheduler", None)
        if sched is not None:
            try:
                if self._base_weight is None:
                    self._base_weight = sched.policies[self.klass].weight
                sched.set_weight(self.klass,
                                 self._base_weight * (1 + self.boost))
            except (KeyError, AttributeError):
                pass
        if step > 0:
            if stats is not None:
                stats.add(kv_slo_boosts=1)
            # the post-mortem wants the reads that blew the p99, now
            flight = getattr(engine, "flight", None)
            if flight is not None:
                flight.dump("slo_violation",
                            extra={"p99_ms": p99_ms,
                                   "target_ms": self.target_ms,
                                   "boost": self.boost})

    def observe_tenant(self, engine, tenant, p99_ms, stats=None) -> None:
        """Feed one tenant's TTFT p99 against its own target: the same
        bound, decay, rate limit and device gate as ``observe``, on the
        tenant's ``share_boost``."""
        if tenant is None or tenant.slo_p99_ms <= 0 or not p99_ms:
            return
        now = time.monotonic()
        if now - self._tenant_last.get(tenant.id, 0.0) \
                < self._MIN_INTERVAL_S:
            return
        step = 0
        if (p99_ms > tenant.slo_p99_ms
                and tenant.share_boost < self._MAX_BOOST):
            step = 1
        elif p99_ms < 0.5 * tenant.slo_p99_ms and tenant.share_boost > 0:
            step = -1
        if step == 0:
            return
        sup = getattr(engine, "supervisor", None)
        if step > 0 and sup is not None and sup.unhealthy():
            return
        self._tenant_last[tenant.id] = now
        tenant.share_boost += step
        if step > 0:
            if stats is not None:
                stats.add(tenant_slo_boosts=1)
                stats.add_tenant_stat(tenant.id, slo_boosts=1)
            flight = getattr(engine, "flight", None)
            if flight is not None:
                flight.dump("slo_violation",
                            extra={"tenant": tenant.id, "p99_ms": p99_ms,
                                   "target_ms": tenant.slo_p99_ms,
                                   "share_boost": tenant.share_boost})


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
                 path: str, page_tokens: int, capacity_bytes: int,
                 p99_target_ms: float = 0.0):
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
            cfg.n_experts, cfg.expert_top_k, cfg.moe_every,
            page_tokens)).encode()).digest()
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._fh = engine.open(self.path, writable=True)
        self.stats = engine.stats
        self._lock = make_lock("kv_offload.PrefixStore._lock")
        self._wlock = make_lock("kv_offload.PrefixStore._wlock")
        #: set by close() before its final flush: put() and
        #: restore_many() refuse new work from then on, so the drain
        #: converges; _io_inflight counts the puts and restores past
        #: that gate, and close() waits for it to reach 0 before it
        #: closes the file
        self._closed = False
        self._io_inflight = 0
        self._io_cv = make_condition("kv_offload.PrefixStore._io_cv",
                                     self._lock)
        #: thread id of the active drainer (the _drain_mu holder): a
        #: put() re-entered from one of the drain's own waits skips the
        #: backpressure acquire instead of deadlocking on it
        self._drain_owner: Optional[int] = None
        # serializes drainers only; put()'s maintenance drain only
        # try-acquires it, so a submitter never waits behind another
        # thread's I/O while the backlog is within twice the bound
        self._drain_mu = make_lock("kv_offload.PrefixStore._drain_mu")
        #: key -> {"page", "hits", "seq", "crc", "pins", "ready",
        #: "tenant"}
        self._entries: Dict[bytes, dict] = {}
        #: tenant id -> its declared quota fraction, set as puts run in
        #: tenant scopes (empty, and eviction tenant-blind, until one
        #: does)
        self._tenant_quota_frac: Dict[str, float] = {}
        self.slo = SloGovernor(p99_target_ms)
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
        tracer = live_tracer(self.engine)
        t0_ns = time.monotonic_ns()
        try:
            # a failed write surfacing here degrades to recompute, and
            # must not leak the pins just taken
            self._drain_writes()
            planned = plan_and_submit(
                self.engine, [(self._fh, e["page"] * self.page_bytes,
                               self.page_bytes) for _s, _i, _k, e in plan],
                klass="decode", hot=True)
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
            t_sync = time.monotonic_ns()
            for t in transfers:
                t.synchronize()
            if tracer is not None:
                tracer.add_span("strom.h2d.sync", t_sync,
                                time.monotonic_ns(), category="strom.h2d",
                                copies=len(transfers))
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
        if tracer is not None:
            # the store's own restore (NVMe reads, checks, copies), under
            # the serving restore's context
            tracer.add_span("strom.kv.restore", t0_ns, time.monotonic_ns(),
                            category="strom.kv", pages=len(plan), ok=n_ok,
                            failed=len(failed),
                            bytes=len(plan) * self.page_bytes)
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
        self.slo.observe(self.engine, self.restore_p99_ms(), self.stats)
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
        host = _aligned_host(self.page_bytes, torch.device("cpu"))[0].numpy()
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
                t = current_tenant()
                if t is not None:
                    self._tenant_quota_frac[t.id] = t.quota_frac
                # charged to the tenant whose admission computed it
                self._entries[kx] = {"page": slot, "hits": 0,
                                     "seq": self._seq, "crc": None,
                                     "pins": 0, "ready": False,
                                     "tenant": (t.id if t is not None
                                                else None)}
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
        first on a tie.  While a tenant holds more pages than its quota
        allows, the scan first looks at those tenants' pages only; a
        pinned page counts against its owner but is never taken."""
        cost = self._restore_cost_ms()
        over = (self._tenant_over_locked() if self._tenant_quota_frac
                else None)
        for restrict in ((over, None) if over else (None,)):
            victim_key = victim_score = None
            for kx, e in self._entries.items():
                if e["pins"] > 0 or not e["ready"]:
                    continue   # a restore in flight, or a put writing
                if restrict is not None and e.get("tenant") not in restrict:
                    continue
                score = (e["hits"] * cost, e["seq"])
                if victim_score is None or score < victim_score:
                    victim_score, victim_key = score, kx
            if victim_key is None:
                continue
            e = self._entries.pop(victim_key)
            self.stats.add(kv_store_evictions=1)
            if restrict is not None:
                self.stats.add(tenant_quota_evictions=1)
                self.stats.add_tenant_stat(e.get("tenant"),
                                           quota_evictions=1)
            return e["page"]
        return None

    def _tenant_over_locked(self) -> set:
        """The tenant ids holding more resident pages than their quota
        fraction of the store (0: a fair share of the tenants
        resident)."""
        counts: Dict[str, int] = {}
        for e in self._entries.values():
            tid = e.get("tenant")
            if tid is not None:
                counts[tid] = counts.get(tid, 0) + 1
        over = set()
        for tid, n in counts.items():
            frac = self._tenant_quota_frac.get(tid, 0.0)
            if frac <= 0.0:
                frac = 1.0 / max(1, len(counts))
            if n > frac * self.capacity_pages:
                over.add(tid)
        return over

    # -- cold-start warmup ----------------------------------------------------

    def warm_pages(self, budget_pages: Optional[int] = None) -> int:
        """Re-read the ``budget_pages`` (default
        ``ColdStartConfig.warm_pages``, ``STROM_WARM_PAGES``) top-benefit
        resident pages, the cold-start warming pass of a replica that
        just reattached a manifest, as ``klass="prefetch", hot=True``:
        with the host-DRAM tier on, their lines are admitted and pinned,
        so the next restore of these pages is a memory hit.  Best
        effort: failures warm less and never raise.  Returns the pages
        read."""
        if budget_pages is None:
            budget_pages = ColdStartConfig().warm_pages
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
                for pieces in plan_and_submit(self.engine, extents,
                                              klass="prefetch", hot=True):
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
        if warmed and self.stats is not None:
            self.stats.add(coldstart_warm_pages=warmed)
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
                       capacity_bytes=kvcfg.store_mb << 20,
                       p99_target_ms=kvcfg.p99_target_ms)


def offloaded_generate(params: Dict, prompt, cfg: TransformerConfig,
                       ocfg: OffloadConfig, engine: StromEngine,
                       max_new_tokens: int, eos_id: Optional[int] = None,
                       pad_id: int = 0, chunked_prefill: bool = False):
    """Greedy generation with the SSD-backed cache on ``prompt``'s
    device.  prompt (b, s) → (b, max_new_tokens) int32.  By default the
    prompt prefills through the dense path (``models/decode.py``; it
    must fit on the device once) and its k/v seed the cache;
    ``chunked_prefill`` runs :func:`offloaded_prefill` instead.  After
    ``eos_id`` a row emits ``pad_id``."""
    from nvme_strom_tpu_torch.models import decode as _dec
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, "
                         f"got {max_new_tokens}")
    b, s = prompt.shape
    with PagedKVCache(cfg, ocfg, engine, b, device=prompt.device) as cache:
        if chunked_prefill:
            logits = offloaded_prefill(params, prompt, cfg, cache)
        else:
            dense = _dec.init_cache(cfg, b, s, device=prompt.device)
            logits, dense = _dec.prefill(params, prompt, cfg, dense)
            # the dense cache is updated in place: its first s positions
            cache.append(dense["k"][..., :s, :], dense["v"][..., :s, :])
            del dense
        tok = logits.argmax(dim=-1).to(torch.int32)
        done = (torch.zeros(b, dtype=torch.bool, device=prompt.device)
                if eos_id is None else tok == eos_id)
        out = [tok]
        for _ in range(max_new_tokens - 1):
            logits = offload_decode_step(params, tok, cfg, cache)
            nxt = logits.argmax(dim=-1).to(torch.int32)
            if eos_id is not None:
                nxt = torch.where(done, torch.full_like(nxt, pad_id), nxt)
                done = done | (nxt == eos_id)
            out.append(nxt)
            tok = nxt
        return torch.stack(out, dim=1)
