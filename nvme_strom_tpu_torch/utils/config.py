"""Engine and loader configuration (counterpart of
nvme_strom_tpu/utils/config.py ``EngineConfig`` and ``LoaderConfig``,
trimmed to what the port's paths read).

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


@dataclass(frozen=True)
class LoaderConfig:
    """Dataloader knobs (the JAX package's ``LoaderConfig`` without its
    shard-quarantine budget and tfrecord index switch, which this port
    does not have, and without ``batch_size`` and ``drop_remainder``:
    the batch is ``ShardedLoader``'s ``global_batch``, and a partial
    final batch is always dropped)."""

    #: host batches assembled ahead of the consumer
    prefetch: int = 4
    #: nonzero: shard order and sample order are permuted per epoch
    #: from ``seed`` (data/sharding.shuffled_indices)
    shuffle_buffer: int = 0
    seed: int = 0
    #: cached index entries (samples) across shards before the oldest
    #: shard's index is dropped
    index_cache_samples: int = 1_000_000
