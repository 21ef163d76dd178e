"""strom_stat — print the counters an engine exported.

An engine's ``sync_stats`` writes its counter block to
``$STROM_STATS_EXPORT`` (an atomic JSON file, utils/stats.py
``StromStats.maybe_export``); this tool reads that file:

    STROM_STATS_EXPORT=/tmp/strom.json python -m nvme_strom_tpu_torch.train_lm &
    python -m nvme_strom_tpu_torch.tools.strom_stat /tmp/strom.json --watch 1
    python -m nvme_strom_tpu_torch.tools.strom_stat /tmp/strom.json --prom

The last line is the north-star check: direct bytes with
``bounce_bytes == 0``.  Counterpart of nvme_strom_tpu/tools/strom_stat.py
with the port's counters: the layout and wording of every line the two
packages share are the same, and every counter of the port's
``StromStats`` is in one of the blocks below.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from nvme_strom_tpu_torch.utils.stats import human_bytes as _human

_COUNTERS = (
    "bytes_direct", "bytes_fallback", "bounce_bytes", "bytes_to_device",
    "bytes_written_direct", "requests_failed",
)

#: recovery (io/resilient.py, io/faults.py, the loader's quarantine, the
#: restore's fallback); shown only when one is nonzero
_RESILIENCE_COUNTERS = (
    "faults_injected", "resilient_retries", "hedges_issued",
    "hedges_won", "stuck_cancelled", "shards_quarantined",
    "restore_fallbacks", "write_retries",
)

#: STROM_VERIFY and the write-time CRC32C stamps (utils/checksum.py)
_INTEGRITY_COUNTERS = (
    "bytes_verified", "checksum_failures",
)

#: the arena and the bridge's overlap stage (io/arena.py, ops/bridge.py)
_ENGINE_COUNTERS = (
    "arena_fallbacks", "overlap_chunks", "overlap_bytes",
)

#: the QoS scheduler over the rings (io/sched.py), with per-ring depth
#: and per-class tallies
_SCHED_COUNTERS = (
    "sched_enqueued", "sched_dispatches", "sched_promotions",
    "hedges_denied",
)

#: the host-DRAM tier (io/hostcache.py)
_HOSTCACHE_COUNTERS = (
    "cache_hits", "cache_misses", "bytes_served_cache",
    "cache_admissions", "cache_admission_rejections",
    "cache_fill_failures", "cache_evictions", "cache_invalidations",
)

#: the KV prefix store (models/kv_offload.py PrefixStore)
_KV_COUNTERS = (
    "kv_prefix_hits", "kv_prefix_misses", "kv_pages_deduped",
    "kv_bytes_saved", "kv_pages_written", "kv_pages_restored",
    "kv_store_evictions", "kv_slo_boosts", "kv_restore_failures",
)

#: failure domains (io/health.py) and the servers' shed probe
_HEALTH_COUNTERS = (
    "breaker_trips", "ring_restarts", "extents_requeued",
    "degraded_reads", "degraded_bytes", "degraded_probes",
    "serve_admissions_shed",
)

#: the tracer's drops, flight dumps, attribution (utils/trace.py,
#: io/flightrec.py, obs/attrib.py)
_OBS_COUNTERS = (
    "trace_spans_dropped", "flight_dumps", "attrib_requests",
    "attrib_spans_dropped",
)

#: the waste ledger (obs/ledger.py), with the derived goodput line
_LEDGER_COUNTERS = (
    "waste_hedge_loss_bytes", "waste_retry_reread_bytes",
    "waste_coalesce_gap_bytes", "waste_evicted_unused_bytes",
    "waste_degraded_bytes",
)

#: the read-once scatter restore (ops/ici.py)
_ICI_COUNTERS = (
    "ici_bytes_read", "ici_bytes_received", "ici_fallbacks",
)

#: tenants (io/tenants.py), with the per-tenant breakdown
_TENANT_COUNTERS = (
    "tenant_admissions_shed", "tenant_quota_evictions",
    "tenant_borrows", "tenant_slo_boosts", "tenant_storm_dumps",
)

#: Direct SQL's pushdown scans (sql/scan_plan.py)
_SQL_COUNTERS = (
    "sql_scans", "sql_parallel_scans", "sql_rowgroups_scanned",
    "sql_rowgroups_skipped", "sql_pages_skipped", "sql_bytes_skipped",
)

#: cold start (io/coldstart.py, parallel/weights.py FaultingCheckpoint)
_COLDSTART_COUNTERS = (
    "coldstart_faults", "coldstart_fault_bytes",
    "coldstart_bulk_tensors", "coldstart_warm_spans",
    "coldstart_warm_pages", "coldstart_stall_dumps",
    "coldstart_brownouts",
)

#: drain and warm handoff (io/handoff.py)
_HANDOFF_COUNTERS = (
    "handoff_drains", "handoff_deferred",
    "handoff_sessions_exported", "handoff_sessions_restored",
    "handoff_bundles", "handoff_bundle_bytes",
    "handoff_brownouts", "handoff_stall_dumps",
)

#: every block, in render order; their union is utils/stats.py COUNTERS
#: (tests/test_torch_tools.py holds it so)
ALL_COUNTER_BLOCKS = (
    _COUNTERS, _RESILIENCE_COUNTERS, _INTEGRITY_COUNTERS,
    _ENGINE_COUNTERS, _SCHED_COUNTERS, _HOSTCACHE_COUNTERS, _KV_COUNTERS,
    _HEALTH_COUNTERS, _OBS_COUNTERS, _LEDGER_COUNTERS, _ICI_COUNTERS,
    _TENANT_COUNTERS, _SQL_COUNTERS, _COLDSTART_COUNTERS,
    _HANDOFF_COUNTERS,
)


def render_device(path: str) -> str:
    """The backing block device of ``path``: an md array shows its
    members, so a striped rig is checked before any read."""
    from nvme_strom_tpu_torch.io.engine import block_device
    d = block_device(path)
    lines = [f"device topology for {path}:"]
    if not d["device"]:
        lines.append("  no visible backing blockdev "
                     "(overlay/tmpfs/network fs)")
        return "\n".join(lines)
    kind = ("nvme" if d["is_nvme"] else
            "rotational" if d["rotational"] == 1 else "non-nvme")
    lines.append(f"  blockdev    {d['device']} ({kind})")
    if d["is_raid"]:
        lvl = (f"raid{d['raid_level']}" if d["raid_level"] >= 0
               else "md (unknown)")
        lines.append(f"  md level    {lvl}, {len(d['members'])} members")
        for m in d["members"]:
            tag = "nvme" if m.startswith("nvme") else "non-nvme"
            lines.append(f"    member    {m} ({tag})")
    lines.append(f"  direct-DMA eligible (nvme or all-nvme raid0): "
                 f"{'yes' if d['nvme_backed'] else 'no'}")
    return "\n".join(lines)


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _any(snap: dict, names) -> bool:
    return any(int(snap.get(n, 0)) for n in names)


def render(snap: dict, prev: dict | None = None, dt: float | None = None
           ) -> str:
    """The table of one snapshot; with ``prev`` and ``dt`` (``--watch``)
    byte counters carry their rate and recovery counters their delta.
    A block other than the first shows only once it has something to
    say."""
    lines = []
    exported = snap.get("_exported_at")
    if exported:
        age = time.time() - exported
        lines.append(f"exported {age:.1f}s ago by pid {snap.get('_pid', '?')}")
    for name in _COUNTERS:
        v = int(snap.get(name, 0))
        suffix = ""
        if prev is not None and dt and name.startswith(("bytes", "bounce")):
            rate = (v - int(prev.get(name, 0))) / dt
            suffix = f"   ({_human(rate)}/s)"
        shown = _human(v) if name.startswith(("bytes", "bounce")) else str(v)
        lines.append(f"  {name:<22} {shown:>14}{suffix}")
    for name in sorted(k for k in snap if k.startswith("lat_")):
        lines.append(f"  {name:<22} {snap[name]:>14.1f}")
    if _any(snap, _ENGINE_COUNTERS):
        lines.append("  engine (zero-copy submission: registered bufs/"
                     "files, SQPOLL, arena, overlap):")
        for name in _ENGINE_COUNTERS:
            v = int(snap.get(name, 0))
            shown = _human(v) if name.endswith("bytes") else str(v)
            lines.append(f"    {name:<22} {shown:>14}")
    if (_any(snap, _SCHED_COUNTERS) or snap.get("class_stats")
            or snap.get("ring_depths")):
        lines.append("  scheduler (QoS classes over the ring shards):")
        for name in _SCHED_COUNTERS:
            lines.append(f"    {name:<20} {int(snap.get(name, 0)):>14}")
        depths = snap.get("ring_depths")
        if depths:
            shown = " ".join(str(int(d)) for d in depths)
            lines.append(f"    ring depth           {shown:>14}   "
                         "(in-flight I/O per ring)")
        cls = snap.get("class_stats") or {}
        for k in sorted(cls, key=lambda c: -cls[c].get("dispatches", 0)):
            blk = cls[k]
            n_w = int(blk.get("queue_wait_s_n", 0))
            avg_ms = (1000.0 * blk.get("queue_wait_s_sum", 0.0) / n_w
                      if n_w else 0.0)
            max_ms = 1000.0 * blk.get("queue_wait_s_max", 0.0)
            lines.append(
                f"    class {k:<12} "
                f"dispatches={int(blk.get('dispatches', 0))} "
                f"spans={int(blk.get('spans', 0))} "
                f"promoted={int(blk.get('promotions', 0))} "
                f"wait avg/max={avg_ms:.2f}/{max_ms:.2f} ms "
                f"hedges={int(blk.get('hedges_issued', 0))}"
                f"/{int(blk.get('hedges_won', 0))} "
                f"denied={int(blk.get('hedges_denied', 0))} "
                f"retries={int(blk.get('retries', 0))}")
    if _any(snap, _HOSTCACHE_COUNTERS) or snap.get("cache_bytes_resident"):
        lines.append("  host cache (pinned DRAM tier, NVMe<->HBM):")
        for name in _HOSTCACHE_COUNTERS:
            v = int(snap.get(name, 0))
            shown = _human(v) if name.startswith("bytes") else str(v)
            lines.append(f"    {name:<26} {shown:>14}")
        resident = snap.get("cache_bytes_resident")
        if resident is not None:
            lines.append(f"    {'bytes_resident (lines)':<26} "
                         f"{_human(int(resident)):>14}   "
                         f"({int(snap.get('cache_lines_resident', 0))} "
                         f"lines)")
        hits = int(snap.get("cache_hits", 0))
        misses = int(snap.get("cache_misses", 0))
        if hits + misses:
            lines.append(f"    {'hit rate':<26} "
                         f"{hits / (hits + misses):>14.3f}")
        cls = snap.get("class_stats") or {}
        for k in sorted(cls):
            ch = int(cls[k].get("cache_hits", 0))
            cm = int(cls[k].get("cache_misses", 0))
            if ch + cm:
                served = _human(int(cls[k].get("bytes_served_cache", 0)))
                lines.append(
                    f"    class {k:<12} hits={ch} misses={cm} "
                    f"rate={ch / (ch + cm):.3f} served={served}")
    if _any(snap, _KV_COUNTERS) or snap.get("kv_store_pages_resident"):
        lines.append("  kv serving (content-addressed prefix store):")
        for name in _KV_COUNTERS:
            v = int(snap.get(name, 0))
            shown = _human(v) if "bytes" in name else str(v)
            lines.append(f"    {name:<22} {shown:>14}")
        hits = int(snap.get("kv_prefix_hits", 0))
        misses = int(snap.get("kv_prefix_misses", 0))
        if hits + misses:
            lines.append(f"    {'prefix hit rate':<22} "
                         f"{hits / (hits + misses):>14.3f}")
        resident = snap.get("kv_store_pages_resident")
        if resident is not None:
            lines.append(f"    {'pages resident':<22} "
                         f"{int(resident):>14}")
        p99 = snap.get("kv_restore_p99_ms")
        if p99:
            lines.append(f"    {'restore p99':<22} "
                         f"{float(p99):>11.2f} ms")
    ring_health = snap.get("ring_health") or []
    if (_any(snap, _HEALTH_COUNTERS)
            or any(s != "closed" for s in ring_health)
            or int(snap.get("engine_degraded", 0))):
        lines.append("  health (failure domains: breakers / restarts "
                     "/ degraded mode):")
        for name in _HEALTH_COUNTERS:
            v = int(snap.get(name, 0))
            shown = _human(v) if name == "degraded_bytes" else str(v)
            lines.append(f"    {name:<22} {shown:>14}")
        if ring_health:
            lines.append(f"    {'ring breakers':<22} "
                         f"{' '.join(ring_health):>14}")
        degraded = int(snap.get("engine_degraded", 0))
        state = "DEGRADED (buffered brown-out)" if degraded else "ok"
        lines.append(f"    {'device state':<22} {state:>14}")
        if degraded:
            lines.append(
                "    BROWNED OUT — all fast domains unhealthy; serving "
                "rides plain preads until a half-open probe recovers")
    if _any(snap, _ICI_COUNTERS):
        lines.append("  ici scatter (read-once restore over the "
                     "interconnect):")
        for name in _ICI_COUNTERS:
            v = int(snap.get(name, 0))
            shown = _human(v) if "bytes" in name else str(v)
            lines.append(f"    {name:<22} {shown:>14}")
        read = int(snap.get("ici_bytes_read", 0))
        recv = int(snap.get("ici_bytes_received", 0))
        if read + recv:
            lines.append(
                f"    {'flash share':<22} "
                f"{read / (read + recv):>14.3f}   "
                "(local NVMe / restore payload)")
    if _any(snap, _RESILIENCE_COUNTERS):
        lines.append("  resilience (recoveries + degradations):")
        for name in _RESILIENCE_COUNTERS:
            v = int(snap.get(name, 0))
            suffix = ""
            if prev is not None and dt:
                d = v - int(prev.get(name, 0))
                if d:
                    suffix = f"   (+{d})" if d > 0 else f"   ({d})"
            lines.append(f"    {name:<20} {v:>14}{suffix}")
    if _any(snap, _INTEGRITY_COUNTERS):
        lines.append("  integrity (STROM_VERIFY checksums):")
        for name in _INTEGRITY_COUNTERS:
            v = int(snap.get(name, 0))
            shown = _human(v) if name.startswith("bytes") else str(v)
            lines.append(f"    {name:<20} {shown:>14}")
        if int(snap.get("checksum_failures", 0)):
            lines.append(
                "    CORRUPTION CAUGHT — scrub the namespace "
                "(strom-scrub) before trusting older data")
    if _any(snap, _LEDGER_COUNTERS):
        lines.append("  ledger (goodput vs waste, per-ring "
                     "time-in-state — docs/OBSERVABILITY.md):")
        from nvme_strom_tpu_torch.obs.ledger import ledger_view
        view = ledger_view(snap)
        lines.append(f"    {'delivered':<26} "
                     f"{_human(view['delivered_bytes']):>14}")
        lines.append(f"    {'goodput':<26} "
                     f"{_human(view['goodput_bytes']):>14}   "
                     f"(fraction {view['goodput_fraction']:.4f})")
        for name in _LEDGER_COUNTERS:
            v = int(snap.get(name, 0))
            if v:
                lines.append(f"    {name:<26} {_human(v):>14}")
        rs = view.get("ring_state_s")
        if rs:
            for state in ("busy", "idle", "stalled", "restarting"):
                vals = rs.get(state)
                if vals and any(v > 0 for v in vals):
                    shown = " ".join(f"{v:.1f}" for v in vals)
                    lines.append(f"    ring {state + '_s':<21} "
                                 f"{shown:>14}")
    if _any(snap, _TENANT_COUNTERS) or snap.get("tenant_stats"):
        lines.append("  multi-tenant (tier shedding / quotas / SLO "
                     "boosts — docs/RESILIENCE.md):")
        for name in _TENANT_COUNTERS:
            lines.append(f"    {name:<24} {int(snap.get(name, 0)):>14}")
        ten = snap.get("tenant_stats") or {}
        for t in sorted(ten, key=lambda t: -ten[t].get(
                "admissions_shed", 0)):
            blk = ten[t]
            lines.append(
                f"    tenant {t:<12} "
                f"finished={int(blk.get('requests_finished', 0))} "
                f"shed={int(blk.get('admissions_shed', 0))} "
                f"dispatches={int(blk.get('dispatches', 0))} "
                f"borrows={int(blk.get('borrows', 0))} "
                f"evicted={int(blk.get('quota_evictions', 0))} "
                f"boosts={int(blk.get('slo_boosts', 0))} "
                f"hedges={int(blk.get('hedges_issued', 0))}")
    if _any(snap, _SQL_COUNTERS):
        lines.append("  sql scan (pushdown-planned direct scans — "
                     "docs/PERF.md §8):")
        for name in _SQL_COUNTERS:
            v = int(snap.get(name, 0))
            shown = _human(v) if name == "sql_bytes_skipped" else v
            lines.append(f"    {name:<24} {shown:>14}")
        scanned = int(snap.get("sql_rowgroups_scanned", 0))
        skipped = int(snap.get("sql_rowgroups_skipped", 0))
        if scanned + skipped:
            lines.append(
                f"    {'zone-map elimination':<24} "
                f"{100.0 * skipped / (scanned + skipped):>13.1f}%")
    if _any(snap, _COLDSTART_COUNTERS) or snap.get("boot_phase"):
        lines.append("  cold start (serve-while-restoring — "
                     "docs/RESILIENCE.md):")
        phase = snap.get("boot_phase")
        if phase:
            lines.append(f"    {'boot_phase':<24} {str(phase):>14}")
        for name in _COLDSTART_COUNTERS:
            v = int(snap.get(name, 0))
            shown = _human(v) if name == "coldstart_fault_bytes" else v
            lines.append(f"    {name:<24} {shown:>14}")
    if _any(snap, _HANDOFF_COUNTERS) or snap.get("drain_phase"):
        lines.append("  handoff (drain & warm handoff — "
                     "docs/RESILIENCE.md):")
        phase = snap.get("drain_phase")
        if phase:
            lines.append(f"    {'drain_phase':<24} {str(phase):>14}")
        for name in _HANDOFF_COUNTERS:
            v = int(snap.get(name, 0))
            shown = _human(v) if name == "handoff_bundle_bytes" else v
            lines.append(f"    {name:<24} {shown:>14}")
    if _any(snap, _OBS_COUNTERS):
        lines.append("  observability (tracer / flight recorder):")
        for name in _OBS_COUNTERS:
            lines.append(f"    {name:<22} {int(snap.get(name, 0)):>14}")
        if int(snap.get("trace_spans_dropped", 0)):
            lines.append(
                "    TRACE INCOMPLETE — the span buffer capped out; "
                "raise STROM_TRACE_MAX_EVENTS or trace a shorter window")
    direct = int(snap.get("bytes_direct", 0))
    bounce = int(snap.get("bounce_bytes", 0))
    if direct and bounce == 0:
        lines.append("north star: OK — direct path with zero host bounces")
    elif bounce:
        pct = 100.0 * bounce / max(1, direct + int(snap.get(
            "bytes_fallback", 0)))
        lines.append(f"north star: {_human(bounce)} bounced "
                     f"({pct:.1f}% of payload)")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="strom_stat", description="strom-io counter reader")
    ap.add_argument("path", nargs="?",
                    default=os.environ.get("STROM_STATS_EXPORT"),
                    help="stats export file (default: $STROM_STATS_EXPORT)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="the raw JSON instead of the table")
    ap.add_argument("--prom", action="store_true", dest="as_prom",
                    help="OpenMetrics text instead of the table "
                         "(counters as strom_*_total, class, tenant and "
                         "ring labels)")
    ap.add_argument("--watch", type=float, default=None, metavar="SECS",
                    help="re-read every SECS seconds, with rates")
    ap.add_argument("--device", metavar="PATH", default=None,
                    help="print the backing block device of PATH and exit")
    args = ap.parse_args(argv)

    if args.device is not None:
        try:
            print(render_device(args.device))
        except OSError as e:
            print(f"strom_stat: cannot resolve {args.device}: {e}",
                  file=sys.stderr)
            return 2
        return 0

    if not args.path:
        print("strom_stat: no stats file — pass a path or set "
              "STROM_STATS_EXPORT in the producing process", file=sys.stderr)
        return 2
    try:
        snap = load(args.path)
    except (OSError, json.JSONDecodeError) as e:
        print(f"strom_stat: cannot read {args.path}: {e}", file=sys.stderr)
        return 2

    def emit(s, prev=None, dt=None):
        if args.as_prom:
            from nvme_strom_tpu_torch.utils.stats import \
                openmetrics_from_snapshot
            print(openmetrics_from_snapshot(s), end="")
        elif args.as_json:
            print(json.dumps(s, sort_keys=True))
        else:
            print(render(s, prev, dt))

    emit(snap)
    if args.watch is None:
        return 0
    prev, t_prev = snap, time.monotonic()
    try:
        while True:
            time.sleep(args.watch)
            try:
                snap = load(args.path)
            except (OSError, json.JSONDecodeError):
                continue
            now = time.monotonic()
            if not args.as_prom:
                # an OpenMetrics record already ends at its '# EOF'
                print("---")
            emit(snap, prev, now - t_prev)
            prev, t_prev = snap, now
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
