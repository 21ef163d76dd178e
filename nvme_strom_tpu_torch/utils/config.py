"""Engine, loader and KV-store configuration (counterpart of
nvme_strom_tpu/utils/config.py ``EngineConfig``, ``LoaderConfig`` and
``KVServeConfig``, trimmed to what the port's paths read).

Engine and loader sizes are these defaults or explicit arguments: they
are never read from the environment or from a tuning ledger.  Only
``KVServeConfig`` reads the environment (its ``STROM_KV_*`` switches, as
the JAX package's does)."""

from __future__ import annotations

import os
from dataclasses import dataclass, field


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


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


@dataclass(frozen=True)
class KVServeConfig:
    """The serving KV prefix store's switches (models/kv_offload.py
    ``PrefixStore`` through ``build_prefix_store``), read from the
    environment at construction.

    ``STROM_KV_P99_MS`` is the restore-latency target of the JAX
    package's SLO governor, which this port does not have yet: a
    non-zero target raises instead of being ignored."""

    #: STROM_KV_PREFIX=1 enables the store; 0 (default) leaves the
    #: servers on their store-less path, bit for bit
    prefix_enabled: bool = field(
        default_factory=lambda: os.environ.get("STROM_KV_PREFIX",
                                               "0") == "1")
    #: the page file's budget in MiB; 0 disables the store
    store_mb: int = field(
        default_factory=lambda: _env_int("STROM_KV_STORE_MB", 64))
    #: tokens a page holds; 0 (default) takes the server's own
    #: granularity (the paged server's block_len)
    page_tokens: int = field(
        default_factory=lambda: _env_int("STROM_KV_PAGE_TOKENS", 0))
    #: restore p99 target in ms; only 0 (no target) is supported
    p99_target_ms: float = field(
        default_factory=lambda: _env_float("STROM_KV_P99_MS", 0.0))

    def __post_init__(self):
        if self.store_mb < 0:
            raise ValueError("store_mb must be >= 0")
        if self.page_tokens < 0:
            raise ValueError("page_tokens must be >= 0")
        if self.p99_target_ms < 0:
            raise ValueError("p99_target_ms must be >= 0")
        if self.p99_target_ms:
            raise NotImplementedError(
                f"STROM_KV_P99_MS={self.p99_target_ms}: the restore SLO "
                "governor comes with tenants and load shedding, which are "
                "not ported yet")
