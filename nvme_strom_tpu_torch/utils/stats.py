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
  total; one rank a process, that process's share);
* ``ici_bytes_received`` — payload bytes obtained from peers over the
  interconnect instead of local NVMe (0 in the single-process emulation,
  which has no peers; one rank a process, the other ranks' shares);
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
* the load shedding and tenants of the servers (io/tenants.py):
  ``serve_admissions_shed`` admission opportunities a server's shed
  probe deferred, ``tenant_admissions_shed`` the requests the tenant
  layer passed over (tier shed under backlog pressure, or an empty
  token bucket), ``tenant_quota_evictions`` host-tier lines and store
  pages reclaimed from an over-quota tenant, ``tenant_borrows`` lines a
  tenant filled past its quota while space was free, and the SLO
  governor's boosts, ``kv_slo_boosts`` (the decode class's weight) and
  ``tenant_slo_boosts`` (one tenant's share).  ``add_tenant_stat``
  keeps the per-tenant breakdown, carried as ``tenant_stats`` in
  ``snapshot()`` once a tenant has a tally.
* recovery (io/faults.py, io/resilient.py): ``faults_injected`` faults
  a ``FaultPlan`` injected; ``resilient_retries`` failed, short or stuck
  reads resubmitted after backoff, ``stuck_cancelled`` of them stuck;
  ``hedges_issued`` duplicate reads of a straggler, ``hedges_won`` of
  them first to complete, ``hedges_denied`` refused by their class's
  hedge budget; ``write_retries`` failed or short writes resubmitted;
  ``shards_quarantined`` loader shards skipped under
  ``shard_error_budget``; ``requests_failed`` requests the C engine
  completed with an error (drained from it).  ``add_class_stat`` keeps
  the per-class ``hedges_issued``, ``hedges_won``, ``hedges_denied``
  and ``retries``.
* the waste ledger (obs/ledger.py): ``waste_hedge_loss_bytes`` (the
  losing side of a hedge), ``waste_retry_reread_bytes`` (bytes a retry
  read again), ``waste_degraded_bytes`` (bytes served by the degraded
  brown-out), ``waste_coalesce_gap_bytes`` (gap bytes the planner read
  through to merge extents), ``waste_evicted_unused_bytes`` (host-tier
  lines evicted before a hit); ``trace_spans_dropped`` spans the
  tracer dropped at its cap (utils/trace.py).
* attribution (obs/attrib.py): ``attrib_requests`` requests folded at
  retirement, ``attrib_spans_dropped`` spans past a trace's bound.
* failure domains (io/health.py): ``breaker_trips`` ring and device
  breakers opened, ``ring_restarts`` hot restarts, ``extents_requeued``
  requests a restart cancelled for their waiters to resubmit,
  ``degraded_reads`` / ``degraded_bytes`` reads and bytes served by
  buffered preads while the device was degraded, ``degraded_probes``
  half-open probes; ``flight_dumps`` flight-recorder dumps written
  (io/flightrec.py), ``tenant_storm_dumps`` of them by the servers'
  storm trigger.
* cold start (io/coldstart.py, io/warmup.py, parallel/weights.py
  ``FaultingCheckpoint``): ``coldstart_faults`` / ``_fault_bytes``
  tensors and bytes demand-faulted at decode class,
  ``coldstart_bulk_tensors`` tensors the bulk lane loaded,
  ``coldstart_warm_spans`` / ``_warm_pages`` hint spans and store pages
  warmed, ``coldstart_stall_dumps`` stall dumps, ``coldstart_brownouts``
  degraded entries during a cold start.
* drain and handoff (io/handoff.py, the servers' drain gate):
  ``handoff_drains`` drains begun, ``handoff_deferred`` admissions the
  closed gate deferred, ``handoff_sessions_exported`` /
  ``_restored`` sessions shipped in a bundle and re-admitted from one,
  ``handoff_bundles`` / ``_bundle_bytes`` bundles published and their
  size, ``handoff_brownouts`` boots whose bundle was missing, torn or
  stale, ``handoff_stall_dumps`` drains that outlived their deadline.

Gauges are point-in-time values that overwrite (``set_gauges``), carried
in ``snapshot()`` beside the counters: ``kv_restore_p99_ms`` (the store's
restore-batch p99 from its log2 histogram),
``kv_store_pages_resident``, ``ring_health`` (each ring's breaker
state) and ``engine_degraded``, ``boot_phase`` /
``boot_phase_code``, ``drain_phase`` / ``drain_phase_code`` and
``handoff_source`` (``bundle`` once a boot consumed one), and
``ring_state_s`` (each ring's cumulative seconds per state,
obs/ledger.py ``RingTimeLedger``), and ``lat_read_p50_us`` /
``lat_read_p99_us`` (the engine's read latency over the interval since
its previous ``sync_stats``).  :func:`openmetrics_from_snapshot`
renders a snapshot as OpenMetrics text (the debug server's
``/metrics``).

Export, with the JAX package's knobs: :meth:`StromStats.maybe_export`,
which every engine's ``sync_stats`` calls, writes the snapshot as JSON
to ``$STROM_STATS_EXPORT`` (with ``_exported_at`` and ``_pid``; the
file ``tools/strom_stat.py`` reads) and as OpenMetrics text to
``$STROM_METRICS_FILE``, each atomically and each on its own;
:func:`maybe_start_metrics_writer` starts the process's one periodic
writer of ``$STROM_METRICS_FILE`` (every ``STROM_METRICS_INTERVAL_S``,
default 10 s) with the first engine.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import threading
import time
from dataclasses import dataclass, field, fields
from typing import List, Optional

COUNTERS = ("bytes_direct", "bytes_fallback", "bytes_written_direct",
            "bounce_bytes", "bytes_to_device", "overlap_chunks",
            "overlap_bytes", "ici_bytes_read", "ici_bytes_received",
            "ici_fallbacks", "restore_fallbacks", "bytes_verified",
            "checksum_failures", "kv_pages_written", "kv_pages_deduped",
            "kv_bytes_saved", "kv_pages_restored", "kv_prefix_hits",
            "kv_prefix_misses", "kv_restore_failures",
            "kv_store_evictions", "sched_enqueued", "sched_dispatches",
            "sched_promotions", "arena_fallbacks", "cache_hits",
            "cache_misses", "bytes_served_cache", "cache_admissions",
            "cache_admission_rejections", "cache_fill_failures",
            "cache_evictions", "cache_invalidations",
            "serve_admissions_shed", "tenant_admissions_shed",
            "tenant_quota_evictions", "tenant_borrows", "kv_slo_boosts",
            "tenant_slo_boosts", "requests_failed", "faults_injected",
            "resilient_retries", "hedges_issued", "hedges_won",
            "hedges_denied", "stuck_cancelled", "write_retries",
            "shards_quarantined", "trace_spans_dropped",
            "waste_hedge_loss_bytes", "waste_retry_reread_bytes",
            "waste_coalesce_gap_bytes", "waste_evicted_unused_bytes",
            "waste_degraded_bytes", "breaker_trips", "ring_restarts",
            "extents_requeued", "degraded_reads", "degraded_bytes",
            "degraded_probes", "flight_dumps", "tenant_storm_dumps",
            "coldstart_faults", "coldstart_fault_bytes",
            "coldstart_bulk_tensors", "coldstart_warm_spans",
            "coldstart_warm_pages", "coldstart_stall_dumps",
            "coldstart_brownouts", "handoff_drains", "handoff_deferred",
            "handoff_sessions_exported", "handoff_sessions_restored",
            "handoff_bundles", "handoff_bundle_bytes", "handoff_brownouts",
            "handoff_stall_dumps", "attrib_requests",
            "attrib_spans_dropped", "sql_scans", "sql_rowgroups_scanned",
            "sql_rowgroups_skipped", "sql_bytes_skipped", "sql_pages_skipped",
            "sql_parallel_scans")
GAUGES = ("kv_restore_p99_ms", "kv_store_pages_resident", "ring_depths",
          "cache_bytes_resident", "cache_lines_resident", "ring_health",
          "engine_degraded", "boot_phase", "boot_phase_code", "drain_phase",
          "drain_phase_code", "handoff_source", "ring_state_s",
          "lat_read_p50_us", "lat_read_p99_us")


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
    sched_enqueued: int = 0
    sched_dispatches: int = 0
    sched_promotions: int = 0
    arena_fallbacks: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    bytes_served_cache: int = 0
    cache_admissions: int = 0
    cache_admission_rejections: int = 0
    cache_fill_failures: int = 0
    cache_evictions: int = 0
    cache_invalidations: int = 0
    serve_admissions_shed: int = 0
    tenant_admissions_shed: int = 0
    tenant_quota_evictions: int = 0
    tenant_borrows: int = 0
    kv_slo_boosts: int = 0
    tenant_slo_boosts: int = 0
    requests_failed: int = 0
    faults_injected: int = 0
    resilient_retries: int = 0
    hedges_issued: int = 0
    hedges_won: int = 0
    hedges_denied: int = 0
    stuck_cancelled: int = 0
    write_retries: int = 0
    shards_quarantined: int = 0
    trace_spans_dropped: int = 0
    waste_hedge_loss_bytes: int = 0
    waste_retry_reread_bytes: int = 0
    waste_coalesce_gap_bytes: int = 0
    waste_evicted_unused_bytes: int = 0
    waste_degraded_bytes: int = 0
    breaker_trips: int = 0
    ring_restarts: int = 0
    extents_requeued: int = 0
    degraded_reads: int = 0
    degraded_bytes: int = 0
    degraded_probes: int = 0
    flight_dumps: int = 0
    tenant_storm_dumps: int = 0
    coldstart_faults: int = 0
    coldstart_fault_bytes: int = 0
    coldstart_bulk_tensors: int = 0
    coldstart_warm_spans: int = 0
    coldstart_warm_pages: int = 0
    coldstart_stall_dumps: int = 0
    coldstart_brownouts: int = 0
    handoff_drains: int = 0
    handoff_deferred: int = 0
    handoff_sessions_exported: int = 0
    handoff_sessions_restored: int = 0
    handoff_bundles: int = 0
    handoff_bundle_bytes: int = 0
    handoff_brownouts: int = 0
    handoff_stall_dumps: int = 0
    attrib_requests: int = 0
    attrib_spans_dropped: int = 0
    # Direct SQL pushdown scans (sql/scan_plan.py): zone-map planned
    # scans, row groups read and skipped, selected-column bytes never
    # read (skipped groups and late materialization's skipped pages),
    # pages skipped, scans fanned across the partition-parallel pool
    sql_scans: int = 0
    sql_rowgroups_scanned: int = 0
    sql_rowgroups_skipped: int = 0
    sql_bytes_skipped: int = 0
    sql_pages_skipped: int = 0
    sql_parallel_scans: int = 0
    _gauges: dict = field(default_factory=dict, repr=False, compare=False)
    _class_stats: dict = field(default_factory=dict, repr=False,
                               compare=False)
    _tenant_stats: dict = field(default_factory=dict, repr=False,
                                compare=False)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def add(self, **deltas: int) -> None:
        with self._lock:
            for name, d in deltas.items():
                if name not in COUNTERS:
                    raise KeyError(f"unknown counter {name!r}")
                setattr(self, name, getattr(self, name) + int(d))

    def add_class_stat(self, klass: str, **deltas) -> None:
        """Accumulate per-class counters under the block's lock."""
        with self._lock:
            blk = self._class_stats.setdefault(klass, {})
            for name, d in deltas.items():
                blk[name] = blk.get(name, 0) + d

    def class_stat_gauges(self, klass: str, **values: float) -> None:
        """Per-class point-in-time values: each keeps its running max,
        sum and count (``<name>_max``, ``_sum``, ``_n``)."""
        with self._lock:
            blk = self._class_stats.setdefault(klass, {})
            for name, v in values.items():
                blk[f"{name}_max"] = max(blk.get(f"{name}_max", 0.0), v)
                blk[f"{name}_sum"] = blk.get(f"{name}_sum", 0.0) + v
                blk[f"{name}_n"] = blk.get(f"{name}_n", 0) + 1

    @property
    def class_stats(self) -> dict:
        with self._lock:
            return {k: dict(v) for k, v in self._class_stats.items()}

    def add_tenant_stat(self, tenant: str, **deltas) -> None:
        """Accumulate per-tenant counters (dispatches, sheds, borrows,
        quota evictions, boosts) under the block's lock."""
        with self._lock:
            blk = self._tenant_stats.setdefault(tenant, {})
            for name, d in deltas.items():
                blk[name] = blk.get(name, 0) + d

    @property
    def tenant_stats(self) -> dict:
        with self._lock:
            return {k: dict(v) for k, v in self._tenant_stats.items()}

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
        """Every counter, the gauges that have been set, and
        ``class_stats`` / ``tenant_stats`` once a class / tenant has a
        tally."""
        with self._lock:
            snap = {f.name: getattr(self, f.name) for f in fields(self)
                    if f.name in COUNTERS}
            snap.update(self._gauges)
            if self._class_stats:
                snap["class_stats"] = {k: dict(v) for k, v in
                                       self._class_stats.items()}
            if self._tenant_stats:
                snap["tenant_stats"] = {k: dict(v) for k, v in
                                        self._tenant_stats.items()}
            return snap

    def maybe_export(self) -> None:
        """Write the snapshot to ``$STROM_STATS_EXPORT`` (JSON, with
        ``_exported_at`` and ``_pid``) and to ``$STROM_METRICS_FILE``
        (OpenMetrics), each when set and each atomically; a failed
        write is skipped, the caller's sync goes on."""
        path = os.environ.get("STROM_STATS_EXPORT")
        mpath = os.environ.get("STROM_METRICS_FILE")
        if not path and not mpath:
            return
        snap = self.snapshot()
        snap["_exported_at"] = time.time()
        snap["_pid"] = os.getpid()
        if path:
            try:
                atomic_write_text(path, json.dumps(snap, sort_keys=True))
            except OSError:
                pass
        if mpath:
            try:
                write_openmetrics_file(mpath, snap)
            except OSError:
                pass


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


def human_bytes(n: float) -> str:
    """1536 → '1.50 KiB'; negative deltas (a counter reset) too."""
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024:
            return f"{n:.2f} {unit}"
        n /= 1024
    return f"{n:.2f} TiB"


class Log2Histogram:
    """Log2-bucketed histogram: ``observe(v)`` lands v in bucket
    ``floor(log2(v))``, the convention of the engine's latency histogram
    and :func:`percentiles_from_log2_hist`.  Thread-safe."""

    def __init__(self, buckets: int = 40):
        self._lock = threading.Lock()
        self._counts = [0] * buckets

    def observe(self, v: float) -> None:
        i = max(0, int(v).bit_length() - 1) if v >= 1 else 0
        with self._lock:
            self._counts[min(i, len(self._counts) - 1)] += 1

    def counts(self) -> List[int]:
        with self._lock:
            return list(self._counts)

    def percentile(self, p: int) -> int:
        return percentiles_from_log2_hist(self.counts(), ps=(p,))[p]


def _om_escape(v) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"') \
        .replace("\n", r"\n")


def _om_value(v) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def _om_labels(pairs) -> str:
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{_om_escape(v)}"' for k, v in pairs) + "}"


#: the class_stats entries that are running max / sum / n triplets,
#: exported as gauges (the rest are counters)
_CLASS_GAUGE_SUFFIXES = ("_max", "_sum", "_n")


def openmetrics_from_snapshot(snap: dict) -> str:
    """A :meth:`StromStats.snapshot` as OpenMetrics text, with the JAX
    package's family names: counters ``strom_<name>_total``, gauges
    ``strom_<name>``, ``class_stats`` labelled ``{klass=}``,
    ``tenant_stats`` as ``strom_by_tenant_<name>{tenant=}``,
    ``ring_depths`` / ``ring_health`` / ``ring_state_s`` per ``{ring=}``;
    families sorted by name, ``# EOF`` last."""
    fams: dict = {}    # name → (kind, help, [(label pairs, value)])

    def add(name, kind, help_, value, pairs=()):
        fams.setdefault(name, (kind, help_, []))[2].append((pairs, value))

    for name in COUNTERS:
        add(f"strom_{name}", "counter", f"strom-io counter {name}",
            int(snap.get(name, 0)))
    for key, label, word, prefix in (
            ("class_stats", "klass", "class", "strom_class_"),
            ("tenant_stats", "tenant", "tenant", "strom_by_tenant_")):
        blocks = snap.get(key) or {}
        for n in sorted({n for blk in blocks.values() for n in blk}):
            gauge = (key == "class_stats"
                     and n.endswith(_CLASS_GAUGE_SUFFIXES))
            what = "gauge" if gauge else "counter"
            for owner, blk in sorted(blocks.items()):
                if n in blk:
                    add(prefix + n, what, f"per-{word} {what} {n}", blk[n],
                        ((label, owner),))
    for i, d in enumerate(snap.get("ring_depths") or ()):
        add("strom_ring_depth", "gauge", "in-flight I/O per ring", int(d),
            (("ring", i),))
    for i, st in enumerate(snap.get("ring_health") or ()):
        add("strom_ring_breaker_open", "gauge",
            "1 while the ring's circuit breaker is not closed",
            0 if st == "closed" else 1, (("ring", i), ("state", st)))
    for state, per_ring in sorted((snap.get("ring_state_s") or {}).items()):
        for i, v in enumerate(per_ring):
            add("strom_ring_state_seconds", "gauge",
                "cumulative seconds per ring per state",
                round(float(v), 3), (("ring", i), ("state", state)))
    skip = set(COUNTERS) | {"class_stats", "tenant_stats", "ring_depths",
                            "ring_health", "ring_state_s"}
    for name in sorted(snap):
        v = snap[name]
        if name not in skip and not name.startswith("_") \
                and isinstance(v, (int, float)) and not isinstance(v, bool):
            add(f"strom_{name}", "gauge", f"strom-io gauge {name}", v)
    lines = []
    for name in sorted(fams):
        kind, help_, samples = fams[name]
        lines.append(f"# TYPE {name} {kind}")
        lines.append(f"# HELP {name} {_om_escape(help_)}")
        suffix = "_total" if kind == "counter" else ""
        for pairs, v in samples:
            lines.append(f"{name}{suffix}{_om_labels(pairs)} "
                         f"{_om_value(v)}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


_write_seq = itertools.count()


def atomic_write_text(path: str, text: str) -> None:
    """Publish ``text`` at ``path`` atomically: written to a temp file
    unique to this process, thread and call, then renamed over ``path``
    (a reader sees the old file or the new one, never a prefix).  The
    temp file is removed on failure; OSError propagates."""
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}." \
          f"{next(_write_seq)}"
    try:
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def write_openmetrics_file(path: str, snap: dict) -> None:
    """``snap`` as OpenMetrics text at ``path``, atomically (the
    ``STROM_METRICS_FILE`` textfile)."""
    atomic_write_text(path, openmetrics_from_snapshot(snap))


class MetricsSnapshotter:
    """Every ``interval_s`` a daemon thread runs ``sync`` (an engine's
    ``sync_stats``, when attached), snapshots ``stats`` into ``series``
    (the newest ``keep``) and rewrites ``path`` as OpenMetrics text.
    ``close()`` takes one last snapshot, so a short run exports too."""

    def __init__(self, stats: StromStats, interval_s: float = 10.0,
                 path: Optional[str] = None, keep: int = 512, sync=None):
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        self.stats = stats
        self.interval_s = interval_s
        self.path = path
        self.keep = keep
        #: run before each snapshot; swapped under ``_sync_lock`` so an
        #: engine detaching at close never races a drain of its handle
        self._sync = sync
        self._sync_lock = threading.Lock()
        self.series: List[dict] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="strom-metrics")
        self._thread.start()

    def set_sync(self, sync) -> None:
        """Attach (or, with None, detach) the pre-snapshot hook; waits
        for a drain in progress."""
        with self._sync_lock:
            self._sync = sync

    def detach_sync(self, sync) -> None:
        """Detach ``sync`` only if it is still the hook: a closing
        engine leaves a later engine's hook in place."""
        with self._sync_lock:
            if self._sync == sync:
                self._sync = None

    def snap_once(self) -> None:
        with self._sync_lock:
            if self._sync is not None:
                try:
                    self._sync()
                except Exception:   # noqa: BLE001 — the writer goes on
                    pass
        snap = self.stats.snapshot()
        snap["_t"] = time.time()
        self.series.append(snap)
        del self.series[:max(0, len(self.series) - self.keep)]
        if self.path:
            try:
                write_openmetrics_file(self.path, snap)
            except OSError:
                pass

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.snap_once()

    def close(self) -> None:
        if not self._stop.is_set():
            self._stop.set()
            self._thread.join(timeout=5)
            self.snap_once()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


_writer_lock = threading.Lock()
_writer: Optional[MetricsSnapshotter] = None


def maybe_start_metrics_writer(stats: StromStats, sync=None
                               ) -> Optional[MetricsSnapshotter]:
    """The process's ``STROM_METRICS_FILE`` writer, started on the first
    call with that variable set (interval ``STROM_METRICS_INTERVAL_S``,
    default 10 s, at least 0.05); None without it."""
    global _writer
    path = os.environ.get("STROM_METRICS_FILE")
    if not path:
        return None
    with _writer_lock:
        if _writer is None:
            try:
                interval = float(os.environ.get("STROM_METRICS_INTERVAL_S",
                                                10.0))
            except ValueError:
                interval = 10.0
            _writer = MetricsSnapshotter(stats, max(0.05, interval),
                                         path=path, sync=sync)
        return _writer
