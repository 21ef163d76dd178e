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
  staging buffer → pinned slab).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field, fields

COUNTERS = ("bytes_direct", "bytes_fallback", "bytes_written_direct",
            "bounce_bytes", "bytes_to_device", "overlap_chunks",
            "overlap_bytes")


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
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def add(self, **deltas: int) -> None:
        with self._lock:
            for name, d in deltas.items():
                if name not in COUNTERS:
                    raise KeyError(f"unknown counter {name!r}")
                setattr(self, name, getattr(self, name) + int(d))

    def merge_engine(self, engine_stats: dict) -> None:
        """Fold counters drained from the C engine into this block
        (the engine's other counters have no field here)."""
        self.add(**{k: v for k, v in engine_stats.items()
                    if k in COUNTERS})

    def snapshot(self) -> dict:
        with self._lock:
            return {f.name: getattr(self, f.name) for f in fields(self)
                    if f.name in COUNTERS}
