"""Counter block of the stream path (counterpart of
nvme_strom_tpu/utils/stats.py ``StromStats``, trimmed to its counters).

* ``bytes_direct`` / ``bytes_fallback`` — payload the engine read with
  O_DIRECT / through the page cache (drained from the C engine);
* ``bytes_written_direct`` — payload the engine wrote with O_DIRECT
  (checkpoints);
* ``bounce_bytes`` — bytes copied on the host after landing or before a
  write: by the engine, by a host-side join, by the checkpoint writer's
  aligned scratch buffers, or because a copy to the device had to start
  from memory CUDA had not page-locked;
* ``bytes_to_device`` — bytes handed to a device transfer;
* ``overlap_chunks`` / ``overlap_bytes`` — chunks and bytes that went
  through the double-buffered host→device stage (one host copy each,
  staging buffer → pinned slab);
* ``ici_bytes_read`` — payload bytes the read-once scatter restore read
  from this host's NVMe for its own share(s) (ops/ici.py; in the
  single-process emulation every virtual host's share, so the payload
  total);
* ``ici_bytes_received`` — payload bytes obtained from peers over the
  interconnect instead of local NVMe (0 in the single-process emulation,
  which has no peers);
* ``ici_fallbacks`` — scatter set-ups that browned out to the read-all
  path (a one-rank group, a failed share read, a failed or corrupted
  exchange);
* ``restore_fallbacks`` — damaged checkpoint steps a restore stepped
  past to an older intact one;
* ``bytes_verified`` / ``checksum_failures`` — bytes checked against
  their write-time CRC32C under ``STROM_VERIFY`` (utils/checksum.py),
  and the checks that failed;
* the KV prefix store (models/kv_offload.py ``PrefixStore``):
  ``kv_pages_written`` pages written, ``kv_pages_deduped`` puts of a
  page already resident (``kv_bytes_saved`` their bytes),
  ``kv_pages_restored`` pages restored, ``kv_prefix_hits`` /
  ``kv_prefix_misses`` chain pages an admission found resident or not,
  ``kv_restore_failures`` pages whose read, check or write failed (they
  heal through recompute), ``kv_store_evictions`` pages evicted for
  room.

Gauges are point-in-time values that overwrite (``set_gauges``), carried
in ``snapshot()`` beside the counters: ``kv_restore_p99_ms`` (the store's
restore-batch p99 from its log2 histogram) and
``kv_store_pages_resident``.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field, fields

COUNTERS = ("bytes_direct", "bytes_fallback", "bytes_written_direct",
            "bounce_bytes", "bytes_to_device", "overlap_chunks",
            "overlap_bytes", "ici_bytes_read", "ici_bytes_received",
            "ici_fallbacks", "restore_fallbacks", "bytes_verified",
            "checksum_failures", "kv_pages_written", "kv_pages_deduped",
            "kv_bytes_saved", "kv_pages_restored", "kv_prefix_hits",
            "kv_prefix_misses", "kv_restore_failures",
            "kv_store_evictions")
GAUGES = ("kv_restore_p99_ms", "kv_store_pages_resident")


@dataclass
class StromStats:
    """Mutable counter block; thread-safe increments."""

    bytes_direct: int = 0
    bytes_fallback: int = 0
    bytes_written_direct: int = 0
    bounce_bytes: int = 0
    bytes_to_device: int = 0
    overlap_chunks: int = 0
    overlap_bytes: int = 0
    ici_bytes_read: int = 0
    ici_bytes_received: int = 0
    ici_fallbacks: int = 0
    restore_fallbacks: int = 0
    bytes_verified: int = 0
    checksum_failures: int = 0
    kv_pages_written: int = 0
    kv_pages_deduped: int = 0
    kv_bytes_saved: int = 0
    kv_pages_restored: int = 0
    kv_prefix_hits: int = 0
    kv_prefix_misses: int = 0
    kv_restore_failures: int = 0
    kv_store_evictions: int = 0
    _gauges: dict = field(default_factory=dict, repr=False, compare=False)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def add(self, **deltas: int) -> None:
        with self._lock:
            for name, d in deltas.items():
                if name not in COUNTERS:
                    raise KeyError(f"unknown counter {name!r}")
                setattr(self, name, getattr(self, name) + int(d))

    def set_gauges(self, **values) -> None:
        """Point-in-time values; unlike counters they overwrite."""
        with self._lock:
            for name in values:
                if name not in GAUGES:
                    raise KeyError(f"unknown gauge {name!r}")
            self._gauges.update(values)

    def merge_engine(self, engine_stats: dict) -> None:
        """Fold counters drained from the C engine into this block
        (the engine's other counters have no field here)."""
        self.add(**{k: v for k, v in engine_stats.items()
                    if k in COUNTERS})

    def snapshot(self) -> dict:
        """Every counter, and the gauges that have been set."""
        with self._lock:
            snap = {f.name: getattr(self, f.name) for f in fields(self)
                    if f.name in COUNTERS}
            snap.update(self._gauges)
            return snap


#: a log2 bucket [2^i, 2^(i+1)) reports its geometric mean, 2^i·√2
_LOG2_BUCKET_MEAN = math.sqrt(2.0)


def percentiles_from_log2_hist(hist: list, ps=(50, 90, 99)) -> dict:
    """Approximate percentiles of a log2-bucketed histogram: ``hist[i]``
    counts samples in [2^i, 2^(i+1)), and each percentile reports its
    bucket's geometric mean (at most a √2 factor from the exact sample).
    Returns {p: value}, 0 where the histogram is empty."""
    total = sum(hist)
    out = {}
    for p in ps:
        if total == 0:
            out[p] = 0
            continue
        rank = total * p / 100.0
        acc = 0
        val = 0
        for i, c in enumerate(hist):
            acc += c
            if acc >= rank and c > 0:
                val = int((2 ** i) * _LOG2_BUCKET_MEAN)
                break
        out[p] = val
    return out
