"""Scatter-read byte store: serve reads from gathered shares
(counterpart of nvme_strom_tpu/io/scatter.py).

The read-once scatter restore (ops/ici.py) splits a file set into
per-host contiguous byte shares, reads each share from NVMe once, and
all-gathers the shares.  This module is the serving half: the partition
rule (:func:`partition_files`), the gathered-byte index
(:class:`ScatterStore`) and an engine front-end
(:class:`ScatterServeEngine`) that satisfies any read of the scattered
files from the store, so consumers built on ``plan_and_submit`` and
``submit_readv`` (checkpoint restore, weight loading) run unchanged and
read the same bytes without touching flash again.

The gathered bytes live in one host tensor, page-locked when the
exchange ran on CUDA devices.  The serve engine then offers that
tensor's device mapping beside the staging pool's
(:meth:`ScatterServeEngine.cuda_mappings`), so ``host_to_device`` copies
store views to the card in place.  Reads of other files, or of ranges
past a file's partitioned size, go to the wrapped engine; every other
attribute (``stats``, ``config``, ``n_buffers``) is the wrapped
engine's.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nvme_strom_tpu_torch.io.engine import HostMapping


@dataclass(frozen=True)
class ShareManifest:
    """Per-host partition of a file set into contiguous byte shares.

    Each file splits into ``n_hosts`` contiguous spans on ``unit_bytes``
    boundaries (balanced to within one unit), so every host's share of
    every file coalesces into large aligned reads and the union of all
    shares covers every byte exactly once.

    ``units``       (file_idx, offset, length, host, row_pos) — row_pos
                    is the span's byte position inside its host's packed
                    share row (spans pack in file order).
    ``host_bytes``  total share bytes per host (≤ ceil(total/n) + one
                    unit per file).
    """

    n_hosts: int
    unit_bytes: int
    sizes: Tuple[int, ...]
    units: Tuple[Tuple[int, int, int, int, int], ...]
    host_bytes: Tuple[int, ...]

    @property
    def total_bytes(self) -> int:
        return sum(self.sizes)

    def units_for(self, host: int) -> List[Tuple[int, int, int]]:
        """Host ``host``'s ordered (file_idx, offset, length) spans."""
        return [(fi, off, ln) for fi, off, ln, h, _ in self.units
                if h == host]


def partition_files(sizes: Sequence[int], n_hosts: int,
                    unit_bytes: int) -> ShareManifest:
    """Partition files of ``sizes`` bytes into ``n_hosts`` contiguous
    per-file shares on ``unit_bytes`` boundaries."""
    if n_hosts < 1:
        raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
    if unit_bytes < 1:
        raise ValueError(f"unit_bytes must be >= 1, got {unit_bytes}")
    per_host: List[List[Tuple[int, int, int]]] = [[] for _ in range(n_hosts)]
    for fi, size in enumerate(sizes):
        if size < 0:
            raise ValueError(f"file {fi}: negative size {size}")
        nunits = -(-size // unit_bytes)
        q, r = divmod(nunits, n_hosts)
        start_u = 0
        for h in range(n_hosts):
            take = q + (1 if h < r else 0)
            off = start_u * unit_bytes
            end = min(size, (start_u + take) * unit_bytes)
            start_u += take
            if end > off:
                per_host[h].append((fi, off, end - off))
    units: List[Tuple[int, int, int, int, int]] = []
    host_bytes = []
    for h in range(n_hosts):
        pos = 0
        for fi, off, ln in per_host[h]:
            units.append((fi, off, ln, h, pos))
            pos += ln
        host_bytes.append(pos)
    return ShareManifest(n_hosts=n_hosts, unit_bytes=unit_bytes,
                         sizes=tuple(int(s) for s in sizes),
                         units=tuple(units), host_bytes=tuple(host_bytes))


class ScatterStore:
    """Gathered share rows indexed for (path, offset, length) lookup.

    ``rows`` is the (n_hosts, row_bytes) uint8 host tensor out of
    :meth:`IciExchange.all_gather`; the manifest says which slice of
    which row holds each file span.  ``view()`` is zero-copy when the
    request falls inside one span and joins across span boundaries
    otherwise (a copy, like any join of pieces).  ``host_bytes_read``
    records the bytes each emulated host pulled off NVMe for its
    share."""

    def __init__(self, paths: Sequence[str], manifest: ShareManifest,
                 rows: torch.Tensor,
                 host_bytes_read: Optional[Dict[int, int]] = None):
        self.manifest = manifest
        self.rows = rows
        self._np = rows.numpy()
        self.host_bytes_read = dict(host_bytes_read or {})
        self.paths = [os.path.realpath(str(p)) for p in paths]
        self._by_path: Dict[str, int] = {
            p: i for i, p in enumerate(self.paths)}
        # per file: (offset, end, host, row_pos) spans sorted by offset
        self._spans: List[List[Tuple[int, int, int, int]]] = [
            [] for _ in self.paths]
        for fi, off, ln, h, pos in manifest.units:
            self._spans[fi].append((off, off + ln, h, pos))
        for spans in self._spans:
            spans.sort()

    def view(self, path: str, offset: int, length: int
             ) -> Optional[np.ndarray]:
        """The bytes of ``path[offset:offset+length]``, or None when the
        range is not fully inside the scattered file set."""
        fi = self._by_path.get(os.path.realpath(str(path)))
        if fi is None or offset < 0 or length < 0 \
                or offset + length > self.manifest.sizes[fi]:
            return None
        if length == 0:
            return np.empty(0, dtype=np.uint8)
        pieces: List[np.ndarray] = []
        need_lo, need_hi = offset, offset + length
        for lo, hi, h, pos in self._spans[fi]:
            if hi <= need_lo or lo >= need_hi:
                continue
            a, b = max(lo, need_lo), min(hi, need_hi)
            pieces.append(self._np[h][pos + a - lo: pos + b - lo])
        if sum(p.nbytes for p in pieces) != length:
            return None             # partition hole: never by construction
        if len(pieces) == 1:
            return pieces[0]
        return np.concatenate(pieces)


class StoreRead:
    """PendingRead-shaped completion over store bytes: ready at once;
    the store owns the memory for the serve engine's lifetime, so
    release has nothing to return."""

    __slots__ = ("_view", "fh", "offset", "length")

    def __init__(self, view: np.ndarray, fh: int, offset: int):
        self._view = view
        self.fh = fh
        self.offset = offset
        self.length = int(view.nbytes)

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        return self._view

    def release(self) -> None:
        pass


class ScatterServeEngine:
    """Engine front-end serving scattered-file reads from a
    :class:`ScatterStore`, delegating everything else.

    ``open`` records which handles name scattered files;
    ``submit_read``/``submit_readv`` satisfy covered spans from the
    store (uncovered spans go to the wrapped engine as one batch, order
    kept); ``close``/``close_all`` drop the handle records before
    delegating, so a handle number reused for another file is never
    served stale store bytes."""

    def __init__(self, engine, store: ScatterStore):
        self._engine = engine
        self.scatter_store = store
        self._paths: Dict[int, str] = {}
        self._maps: Dict[int, HostMapping] = {}
        self._lock = threading.Lock()

    # -- handle tracking ----------------------------------------------

    def open(self, path, *args, **kwargs) -> int:
        fh = self._engine.open(path, *args, **kwargs)
        with self._lock:
            self._paths[fh] = os.path.realpath(str(path))
        return fh

    def close(self, fh: int) -> None:
        with self._lock:
            self._paths.pop(fh, None)
        self._engine.close(fh)

    def close_all(self) -> None:
        with self._lock:
            self._paths.clear()
        self._engine.close_all()

    # -- the serving read path ----------------------------------------

    def _store_view(self, fh: int, offset: int,
                    length: int) -> Optional[np.ndarray]:
        with self._lock:
            path = self._paths.get(fh)
        if path is None:
            return None
        return self.scatter_store.view(path, offset, length)

    def submit_read(self, fh: int, offset: int, length: int):
        v = self._store_view(fh, offset, length)
        if v is not None:
            return StoreRead(v, fh, offset)
        return self._engine.submit_read(fh, offset, length)

    def submit_readv(self, reads) -> list:
        reads = list(reads)
        out: List[object] = [None] * len(reads)
        miss_idx: List[int] = []
        for i, (fh, off, ln) in enumerate(reads):
            v = self._store_view(fh, off, ln)
            if v is not None:
                out[i] = StoreRead(v, fh, off)
            else:
                miss_idx.append(i)
        if miss_idx:
            pend = self._engine.submit_readv([reads[i] for i in miss_idx])
            for i, p in zip(miss_idx, pend):
                out[i] = p
        return out

    # -- CUDA ---------------------------------------------------------

    def cuda_mappings(self, device_index: int) -> List[HostMapping]:
        """The store's page-locked rows mapped for the device (when the
        exchange ran on CUDA), then the wrapped engine's staging pool."""
        maps = list(self._engine.cuda_mappings(device_index))
        rows = self.scatter_store.rows
        if rows.numel() and rows.is_pinned():
            m = self._maps.get(device_index)
            if m is None:
                from nvme_strom_tpu_torch.ops.bridge import pinned_mapping
                m = self._maps[device_index] = pinned_mapping(
                    rows, torch.device("cuda", device_index))
            maps.insert(0, m)
        return maps

    # -- everything else is the wrapped engine -------------------------

    def __getattr__(self, name):
        return getattr(self._engine, name)
