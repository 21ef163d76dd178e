"""Engine configuration (counterpart of nvme_strom_tpu/utils/config.py
``EngineConfig``, trimmed to what the stream and weight paths read).

Sizes are these defaults or explicit arguments: nothing here is read
from the environment or from a tuning ledger."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class EngineConfig:
    """strom-io engine knobs.  ``chunk_bytes`` is the largest single
    read (and staging buffer); it must be a multiple of the O_DIRECT
    ``alignment``.  The staging pool holds ``buffer_pool_bytes /
    chunk_bytes`` buffers (2..64)."""

    chunk_bytes: int = 4 << 20
    queue_depth: int = 16
    alignment: int = 4096
    buffer_pool_bytes: int = 256 << 20
    use_io_uring: bool = True
    lock_buffers: bool = True

    def __post_init__(self):
        if (self.alignment < 512 or self.alignment > (1 << 22)
                or (self.alignment & (self.alignment - 1))):
            raise ValueError(
                f"alignment ({self.alignment}) must be a power of two in "
                "[512, 4MiB] (O_DIRECT logical-block constraint)")
        if self.chunk_bytes <= 0 or self.chunk_bytes % self.alignment:
            raise ValueError(
                f"chunk_bytes ({self.chunk_bytes}) must be a positive "
                f"multiple of alignment ({self.alignment})")
        if not 1 <= self.queue_depth <= 4096:
            raise ValueError(
                f"queue_depth ({self.queue_depth}) must be in [1, 4096]")
        if self.buffer_pool_bytes < self.chunk_bytes:
            raise ValueError(
                f"buffer_pool_bytes ({self.buffer_pool_bytes}) must hold "
                f"at least one chunk ({self.chunk_bytes})")

    @property
    def n_buffers(self) -> int:
        return max(2, min(64, self.buffer_pool_bytes // self.chunk_bytes))
