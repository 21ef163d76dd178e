"""Engine, scheduler, host-tier, recovery, supervision, loader, KV-store,
cold-start and handoff configuration (counterpart of
nvme_strom_tpu/utils/config.py ``EngineConfig``, ``SchedConfig``,
``HostCacheConfig``, ``ResilientConfig``, ``BreakerConfig``,
``FlightConfig``, ``LoaderConfig``, ``KVServeConfig``, ``TenantConfig``,
``ColdStartConfig`` and ``HandoffConfig``, trimmed to what the port's
paths read).

Engine and loader sizes are these defaults or explicit arguments: they
are never read from a tuning ledger, and of the engine's knobs only the
ring count reads the environment (``STROM_RINGS``).  The other configs
read their ``STROM_*`` switches at construction, as the JAX package's
do; the pinned arena's ``STROM_ARENA`` and
``STROM_ARENA_MB`` are read by ``io/arena.py``, and ``STROM_FAULTS`` /
``STROM_RESILIENT`` by ``io/faults.py`` ``build_engine``."""

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
    #: submission rings the engine shards into, each with its own
    #: io_uring (or worker pool) over the one staging pool; 0 = auto
    #: from the CPU count and the NVMe hardware queues (io/engine.py
    #: ``auto_ring_count``), capped by what the queue depth and pool can
    #: feed; 1 (``STROM_RINGS=1``) is the one-ring engine, no scheduler
    n_rings: int = field(default_factory=lambda: _env_int("STROM_RINGS", 0))

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
        if not 0 <= self.n_rings <= 64:
            raise ValueError(
                f"n_rings ({self.n_rings}) must be in [0, 64] (0 = auto; "
                "64 = the request ids' ring bits)")

    @property
    def n_buffers(self) -> int:
        return max(2, min(64, self.buffer_pool_bytes // self.chunk_bytes))


@dataclass(frozen=True)
class SchedConfig:
    """QoS scheduler knobs (io/sched.py), read from the environment at
    construction.  The scheduler sits over a multi-ring engine: classes
    share rings by weighted fair-share in priority order, and a batch
    queued longer than ``aging_rounds`` dispatch rounds is promoted
    ahead of every class."""

    #: STROM_SCHED=0 leaves a multi-ring engine without a scheduler
    #: (batches then go round-robin like scalar reads)
    enabled: bool = field(
        default_factory=lambda: os.environ.get("STROM_SCHED", "1") != "0")
    #: the starvation bound in dispatch rounds
    aging_rounds: int = field(
        default_factory=lambda: _env_int("STROM_SCHED_AGING_K", 16))
    #: per-ring in-flight I/O budget of admission; 0 = the ring's queue
    #: depth.  Submitted minus completed, so views held after completion
    #: never wedge admission
    max_inflight_per_ring: int = field(
        default_factory=lambda: _env_int("STROM_SCHED_INFLIGHT", 0))
    #: "decode=8,restore=4,prefetch=2,scan=2,scrub=1" overrides the
    #: class weights
    class_weights: str = field(
        default_factory=lambda: os.environ.get("STROM_CLASS_WEIGHTS", ""))

    def __post_init__(self):
        if self.aging_rounds < 1:
            raise ValueError("aging_rounds must be >= 1")
        if self.max_inflight_per_ring < 0:
            raise ValueError("max_inflight_per_ring must be >= 0")


@dataclass(frozen=True)
class HostCacheConfig:
    """The pinned host-DRAM tier's knobs (io/hostcache.py), read from
    the environment at construction."""

    #: the tier's budget in MiB; 0 (default) disables it, and the
    #: planner's submit path is then the tier-less one
    budget_mb: int = field(
        default_factory=lambda: _env_int("STROM_HOSTCACHE_MB", 0))
    #: line size in bytes; 0 = the first engine's ``chunk_bytes``
    #: (rounded down to a power of two, at least 64 KiB)
    line_bytes: int = field(
        default_factory=lambda: _env_int("STROM_HOSTCACHE_LINE_BYTES", 0))
    #: "decode=8,restore=4,..." residency quota weights; empty = the
    #: scheduler's class weights
    class_quotas: str = field(
        default_factory=lambda: os.environ.get(
            "STROM_HOSTCACHE_CLASS_QUOTAS", ""))
    #: the ghost list's length as a multiple of the line capacity
    ghost_factor: int = field(
        default_factory=lambda: _env_int("STROM_HOSTCACHE_GHOST_FACTOR", 4))
    #: mlock the lines (the engine pool's STROM_MLOCK switch)
    lock_arena: bool = field(
        default_factory=lambda: os.environ.get("STROM_MLOCK", "1") != "0")

    def __post_init__(self):
        if self.budget_mb < 0:
            raise ValueError("budget_mb must be >= 0")
        if self.line_bytes and (self.line_bytes < 4096
                                or self.line_bytes & (self.line_bytes - 1)):
            raise ValueError(
                f"line_bytes ({self.line_bytes}) must be 0 (auto) or a "
                "power of two >= 4096 (O_DIRECT block alignment)")
        if self.ghost_factor < 1:
            raise ValueError("ghost_factor must be >= 1")
        if self.class_quotas:
            from nvme_strom_tpu_torch.io.hostcache import parse_class_quotas
            parse_class_quotas(self.class_quotas)


@dataclass(frozen=True)
class ResilientConfig:
    """Recovery policy of ``io/resilient.py``'s ``ResilientEngine``:
    bounded retry with exponential backoff and seeded jitter, a hedged
    duplicate read past a latency threshold, and cancel-and-resubmit of
    a stuck request (the reference's knobs and defaults)."""

    #: failed, short or stuck read resubmissions before a loud error
    max_retries: int = field(
        default_factory=lambda: _env_int("STROM_RETRY_MAX", 3))
    #: first backoff sleep; doubles an attempt up to backoff_max_s
    backoff_base_s: float = field(
        default_factory=lambda: _env_float("STROM_RETRY_BACKOFF_S", 0.01))
    backoff_max_s: float = field(
        default_factory=lambda: _env_float("STROM_RETRY_BACKOFF_MAX_S", 1.0))
    #: uniform jitter fraction of every backoff sleep (0..1), from a
    #: generator seeded with ``seed``
    jitter: float = field(
        default_factory=lambda: _env_float("STROM_RETRY_JITTER", 0.5))
    #: hedge a read still in flight after this many seconds; 0 = derive
    #: it from the engine's latency histogram (hedge_percentile ×
    #: hedge_multiplier, at least hedge_min_s)
    hedge_after_s: float = field(
        default_factory=lambda: _env_float("STROM_HEDGE_AFTER_S", 0.0))
    hedge_percentile: int = 99
    hedge_multiplier: float = field(
        default_factory=lambda: _env_float("STROM_HEDGE_MULTIPLIER", 3.0))
    hedge_min_s: float = field(
        default_factory=lambda: _env_float("STROM_HEDGE_MIN_S", 0.005))
    #: STROM_HEDGE=0 turns hedging off (retries and stuck handling stay)
    hedging: bool = field(
        default_factory=lambda: os.environ.get("STROM_HEDGE", "1") != "0")
    #: a request in flight this long is presumed wedged: it is released
    #: and resubmitted, against the retry budget
    stuck_timeout_s: float = field(
        default_factory=lambda: _env_float("STROM_STUCK_TIMEOUT_S", 30.0))
    #: seed of the backoff jitter
    seed: int = field(
        default_factory=lambda: _env_int("STROM_RETRY_SEED", 0))

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.backoff_base_s < 0 or self.backoff_max_s < 0:
            raise ValueError("backoff times must be >= 0")
        if not 0 <= self.jitter <= 1:
            raise ValueError(f"jitter ({self.jitter}) must be in [0, 1]")
        if self.hedge_after_s < 0 or self.hedge_min_s < 0:
            raise ValueError("hedge thresholds must be >= 0")
        if self.stuck_timeout_s <= 0:
            raise ValueError("stuck_timeout_s must be > 0")


@dataclass(frozen=True)
class LoaderConfig:
    """Dataloader knobs (the JAX package's ``LoaderConfig`` without its
    tfrecord index switch, which this port does not have, and without
    ``batch_size`` and ``drop_remainder``: the batch is
    ``ShardedLoader``'s ``global_batch``, and a partial final batch is
    always dropped)."""

    #: host batches assembled ahead of the consumer
    prefetch: int = 4
    #: nonzero: shard order and sample order are permuted per epoch
    #: from ``seed`` (data/sharding.shuffled_indices)
    shuffle_buffer: int = 0
    seed: int = 0
    #: cached index entries (samples) across shards before the oldest
    #: shard's index is dropped
    index_cache_samples: int = 1_000_000
    #: shards the loader may quarantine: a shard whose index, read,
    #: check or decode fails is skipped for this and every later epoch
    #: (counted ``shards_quarantined``) while fewer than this many are
    #: out; past it the failure raises with the quarantine list.  0
    #: (default) raises at the first failure, naming the shard
    shard_error_budget: int = 0


@dataclass(frozen=True)
class KVServeConfig:
    """The serving KV prefix store's switches (models/kv_offload.py
    ``PrefixStore`` through ``build_prefix_store``), read from the
    environment at construction."""

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
    #: restore-batch p99 target in ms: past it the store's SLO governor
    #: raises the decode class's scheduler weight until the p99
    #: recovers; 0 (default) sets no target
    p99_target_ms: float = field(
        default_factory=lambda: _env_float("STROM_KV_P99_MS", 0.0))

    def __post_init__(self):
        if self.store_mb < 0:
            raise ValueError("store_mb must be >= 0")
        if self.page_tokens < 0:
            raise ValueError("page_tokens must be >= 0")
        if self.p99_target_ms < 0:
            raise ValueError("p99_target_ms must be >= 0")


@dataclass(frozen=True)
class TenantConfig:
    """The tenant layer's switches (io/tenants.py), read from the
    environment at construction.  ``STROM_TENANTS=1`` turns it on; 0
    (the default) leaves every path as it is without tenants, bit for
    bit.  ``STROM_TENANT_SPEC`` declares tenants (tier, weight, quota,
    rate, burst and SLO per id); an id it does not name registers on
    first sight with the ``STROM_TENANT_*`` defaults."""

    enabled: bool = field(
        default_factory=lambda: os.environ.get("STROM_TENANTS",
                                               "0") == "1")
    #: ";"-separated tenants, each ``<id>[:key=value,...]`` with keys
    #: tier/weight/quota/rate/burst/slo_ms
    spec: str = field(
        default_factory=lambda: os.environ.get("STROM_TENANT_SPEC", ""))
    #: admission token-bucket refill (requests/s) of a tenant the spec
    #: does not name; 0 = unlimited
    default_rate: float = field(
        default_factory=lambda: _env_float("STROM_TENANT_RATE", 0.0))
    #: token-bucket depth of an unnamed tenant (at least 1)
    default_burst: float = field(
        default_factory=lambda: _env_float("STROM_TENANT_BURST", 8.0))
    #: residency-quota fraction of an unnamed tenant; 0 = a fair share
    #: (1/N of the tenants resident)
    default_quota_frac: float = field(
        default_factory=lambda: _env_float("STROM_TENANT_QUOTA_FRAC",
                                           0.0))
    #: sheds of one tenant that close a storm window (the servers count
    #: them in ``_storm_window``)
    storm_sheds: int = field(
        default_factory=lambda: _env_int("STROM_TENANT_STORM_SHEDS", 32))

    def __post_init__(self):
        if self.default_rate < 0 or self.default_burst < 0:
            raise ValueError("tenant default rate/burst must be >= 0")
        if not 0.0 <= self.default_quota_frac <= 1.0:
            raise ValueError(
                f"default_quota_frac ({self.default_quota_frac}) must "
                f"be in [0, 1]")


@dataclass(frozen=True)
class BreakerConfig:
    """Failure-domain supervision (io/health.py), read from the
    environment at construction.  Per-ring rolling error windows and a
    completion-stall detector feed one circuit breaker a ring (trip →
    routed around → hot restart → half-open → closed) and a device
    breaker whose open state is the degraded buffered mode."""

    #: master switch; ``STROM_BREAKER=0`` builds no supervisor at all
    enabled: bool = field(
        default_factory=lambda: os.environ.get("STROM_BREAKER",
                                               "1") != "0")
    #: span of the rolling error windows (s)
    window_s: float = field(
        default_factory=lambda: _env_float("STROM_BREAKER_WINDOW_S", 5.0))
    #: errors of one ring inside the window that trip its breaker
    ring_errors: int = field(
        default_factory=lambda: _env_int("STROM_BREAKER_ERRORS", 8))
    #: errors across all rings inside the window that open the device
    #: breaker (degraded mode)
    device_errors: int = field(
        default_factory=lambda: _env_int("STROM_BREAKER_DEVICE_ERRORS",
                                         16))
    #: a ring whose oldest request in flight is older than this (s) is
    #: stalled and trips
    stall_s: float = field(
        default_factory=lambda: _env_float("STROM_BREAKER_STALL_S", 5.0))
    #: how long a hot restart waits for dispatched I/O to drain (s)
    drain_s: float = field(
        default_factory=lambda: _env_float("STROM_BREAKER_DRAIN_S", 0.5))
    #: clean time a restarted (half-open) ring serves before it closes
    half_open_s: float = field(
        default_factory=lambda: _env_float("STROM_BREAKER_HALF_OPEN_S",
                                           2.0))
    #: least time between two restarts of one ring (s)
    restart_backoff_s: float = field(
        default_factory=lambda: _env_float("STROM_BREAKER_RESTART_S", 5.0))
    #: while degraded, one probe read every ``probe_s`` rides the real
    #: path; its success restores it
    probe_s: float = field(
        default_factory=lambda: _env_float("STROM_DEGRADED_PROBE_S", 1.0))
    #: wait budget of one probe (s)
    probe_timeout_s: float = field(
        default_factory=lambda: _env_float(
            "STROM_DEGRADED_PROBE_TIMEOUT_S", 2.0))

    def __post_init__(self):
        if self.window_s <= 0:
            raise ValueError("window_s must be > 0")
        if self.ring_errors < 1 or self.device_errors < 1:
            raise ValueError("error budgets must be >= 1")
        if self.stall_s <= 0 or self.drain_s <= 0:
            raise ValueError("stall_s/drain_s must be > 0")
        if self.half_open_s < 0 or self.restart_backoff_s < 0:
            raise ValueError("half_open_s/restart_backoff_s must be >= 0")
        if self.probe_s < 0 or self.probe_timeout_s <= 0:
            raise ValueError("probe_s must be >= 0, probe_timeout_s > 0")


@dataclass(frozen=True)
class FlightConfig:
    """The flight recorder (io/flightrec.py), read from the environment
    at construction: a bounded ring of recent op records that dumps
    itself to a JSON file when a failure trigger fires."""

    #: master switch; ``STROM_FLIGHT=0`` builds no recorder at all
    enabled: bool = field(
        default_factory=lambda: os.environ.get("STROM_FLIGHT",
                                               "1") != "0")
    #: op records kept
    ops: int = field(
        default_factory=lambda: _env_int("STROM_FLIGHT_OPS", 4096))
    #: dump directory; empty = the system temp directory (dumps are
    #: ``strom_flight_<pid>_<reason>_<n>.json``)
    dir: str = field(
        default_factory=lambda: os.environ.get("STROM_FLIGHT_DIR", ""))
    #: least seconds between two dumps of one reason
    min_interval_s: float = field(
        default_factory=lambda: _env_float("STROM_FLIGHT_MIN_S", 5.0))

    def __post_init__(self):
        if self.ops < 16:
            raise ValueError(f"ops ({self.ops}) must be >= 16 — a "
                             "post-mortem of 15 ops explains nothing")
        if self.min_interval_s < 0:
            raise ValueError("min_interval_s must be >= 0")


def coldstart_enabled() -> bool:
    """The ``STROM_COLDSTART`` gate: ``ColdStartConfig.enabled``'s
    default."""
    return os.environ.get("STROM_COLDSTART", "0") == "1"


@dataclass(frozen=True)
class ColdStartConfig:
    """Cold-start knobs (io/coldstart.py, io/warmup.py,
    parallel/weights.py ``FaultingCheckpoint``), read from the
    environment at construction.

    ``STROM_COLDSTART=1`` arms the boot from a retiring replica's
    handoff bundle: with the default 0,
    ``ColdStartCoordinator.consume_handoff`` replays nothing and returns
    None, and the replica boots as the plain stack it was given.  The
    warming budgets are honoured by the code that warms:
    ``warm_hint_spans`` by io/warmup.py ``collect_warm_hints`` /
    ``refresh_hints`` (a handoff bundle's hint snapshots included),
    ``warm_pages`` by models/kv_offload.py ``PrefixStore.warm_pages``."""

    #: the gate; 0 (default) = no bundle replay at boot
    enabled: bool = field(default_factory=coldstart_enabled)
    #: demand-fault p99 target (ms) of the ``faulting`` phase; past it
    #: the coordinator dumps ``coldstart_stall``; 0 = no trigger
    fault_slo_ms: float = field(
        default_factory=lambda: _env_float("STROM_COLDSTART_FAULT_SLO_MS",
                                           0.0))
    #: demand-fault latencies kept for that p99
    fault_window: int = field(
        default_factory=lambda: _env_int("STROM_COLDSTART_WINDOW", 64))
    #: host-tier spans kept per ``.warmhints.json`` manifest, largest
    #: first
    warm_hint_spans: int = field(
        default_factory=lambda: _env_int("STROM_WARM_HINT_SPANS", 1024))
    #: prefix-store pages the warming phase re-reads at ``prefetch``
    #: class, most reused first
    warm_pages: int = field(
        default_factory=lambda: _env_int("STROM_WARM_PAGES", 256))

    def __post_init__(self):
        if self.fault_slo_ms < 0:
            raise ValueError("fault_slo_ms must be >= 0")
        if self.fault_window < 8:
            raise ValueError("fault_window must be >= 8")
        if self.warm_hint_spans < 0 or self.warm_pages < 0:
            raise ValueError("warm hint/page budgets must be >= 0")


def handoff_enabled() -> bool:
    """The ``STROM_HANDOFF`` gate: ``HandoffConfig.enabled``'s
    default."""
    return os.environ.get("STROM_HANDOFF", "0") == "1"


@dataclass(frozen=True)
class HandoffConfig:
    """Drain and warm handoff knobs (io/handoff.py), read from the
    environment at construction.

    ``STROM_HANDOFF=1`` arms the rolling replacement: a retiring
    replica defers new prefills (never drops them), lets in-flight
    sessions run for up to ``deadline_s``, then publishes an atomic
    ``.handoff.json`` bundle that the replacement consumes at boot.
    With the default 0 a ``DrainCoordinator`` never leaves ``serving``
    (its drain, publish and signal hooks do nothing) and
    ``consume_bundle`` replays nothing.  The JAX
    config's ``poll_ms`` (``STROM_DRAIN_POLL_MS``) is left out: its drain
    loop only yields between serving steps, and the port's steps pace the
    loop themselves."""

    #: the gate; 0 (default) = no drain, no bundle, no ``drain_phase``
    #: gauge
    enabled: bool = field(default_factory=handoff_enabled)
    #: seconds the draining phase waits for in-flight sessions before
    #: exporting the rest into the bundle; 0 = export at once
    deadline_s: float = field(
        default_factory=lambda: _env_float("STROM_DRAIN_DEADLINE_S",
                                           30.0))
    #: 1 = ``install_drain_signals`` hooks SIGTERM/SIGINT: drain,
    #: publish, then a forced flight dump on the way out
    drain_on_sigterm: bool = field(
        default_factory=lambda: os.environ.get("STROM_DRAIN_ON_SIGTERM",
                                               "0") == "1")
    #: sessions one bundle exports at most, in-flight slots first
    max_sessions: int = field(
        default_factory=lambda: _env_int("STROM_HANDOFF_MAX_SESSIONS",
                                         256))

    def __post_init__(self):
        if self.deadline_s < 0:
            raise ValueError("deadline_s must be >= 0")
        if self.max_sessions < 0:
            raise ValueError("max_sessions must be >= 0")

