"""Critical-path attribution: where each request's time went
(counterpart of nvme_strom_tpu/obs/attrib.py).

The tracer (utils/trace.py) records what happened; this module folds
it per request: a decode request spent so many µs queued at the
scheduler, on NVMe, in the host→device hop, and the rest in compute.

  collect    an :class:`AttributionCollector` is a span sink of a
             :class:`~nvme_strom_tpu_torch.utils.trace.Tracer`
             (``Tracer.add_sink``) and buffers each trace's spans,
             bounded per trace and across traces, drops counted in
             ``attrib_spans_dropped``.  A sink needs no export path, so
             ``STROM_ATTRIB=1`` costs the span emits and a list append,
             never a trace file.
  fold       at a request's retirement (models/serving.py calls
             :meth:`AttributionCollector.request_retired`) its spans
             fold into the fixed components below.  Each component's
             intervals are clipped to the request window and unioned, so
             parallel reads charge their covered wall time once;
             ``unattributed`` is the wall time no component covers
             (compute, host work, gaps), so ``coverage + unattributed ==
             wall`` by construction.
  aggregate  folds roll into per-class profiles: a ``Log2Histogram``
             (µs) per (class, component) gives p50/p99, the view the
             debug server's ``/attrib`` serves (obs/debugsrv.py).

Components (span names in ``NAME_TO_COMPONENT``):

  ``sched_queue``    QoS scheduler queue wait (``strom.sched.queue``)
  ``hostcache``      host-DRAM tier hits and fills (``strom.cache.*``)
  ``nvme_read``      engine device time (``strom.read[.fallback]``,
                     ``strom.write``)
  ``retry_backoff``  resilient retries (``strom.resilient.retry``)
  ``hedge``          hedges (``strom.resilient.hedge*``)
  ``degraded``       the buffered brown-out (``strom.read.degraded``,
                     ``strom.health.*``)
  ``bridge``         the host→device hop (``strom.bridge.hop``,
                     ``strom.h2d.*``)
  ``ici_scatter``    the read-once restore's exchange (``strom.ici.*``)
  ``unattributed``   the rest of the wall time

``STROM_ATTRIB=1`` (default off) builds the process's collector; every
engine attaches it to its tracer and the servers fold at retirement.
Unset, no collector exists and nothing changes.
"""

from __future__ import annotations

import os
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

from nvme_strom_tpu_torch.utils.lockwitness import make_lock
from nvme_strom_tpu_torch.utils.stats import Log2Histogram

#: the fixed breakdown, in render order (``unattributed`` is derived,
#: always last)
COMPONENTS = ("sched_queue", "hostcache", "nvme_read", "retry_backoff",
              "hedge", "degraded", "bridge", "ici_scatter")

#: span name → component; :func:`component_of` adds prefix rules
NAME_TO_COMPONENT = {
    "strom.sched.queue": "sched_queue",
    "strom.cache.hit": "hostcache",
    "strom.cache.fill": "hostcache",
    "strom.read": "nvme_read",
    "strom.read.fallback": "nvme_read",
    "strom.write": "nvme_read",
    "strom.read.degraded": "degraded",
    "strom.health.probe": "degraded",
    "strom.health.ring_restart": "degraded",
    "strom.resilient.retry": "retry_backoff",
    "strom.resilient.write_retry": "retry_backoff",
    "strom.resilient.hedge": "hedge",
    "strom.resilient.hedge_won": "hedge",
    "strom.bridge.hop": "bridge",
    "strom.h2d.dispatch": "bridge",
    "strom.h2d.sync": "bridge",
    "strom.ici.exchange": "ici_scatter",
    "strom.ici.scatter": "ici_scatter",
}

#: serving spans are structure, not cost: the admission span contains
#: the prefill and the engine's I/O, and would shadow them
_STRUCTURAL = ("strom.serve.",)


def component_of(name: str) -> Optional[str]:
    """The component of a span name; None for a structural or unknown
    name (it counts toward ``unattributed`` only)."""
    c = NAME_TO_COMPONENT.get(name)
    if c is not None:
        return c
    if name.startswith(_STRUCTURAL):
        return None
    if name.startswith("strom.resilient."):
        return "retry_backoff"
    if name.startswith("strom.ici."):
        return "ici_scatter"
    return None


def _merge_intervals(ivals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The sorted union of intervals."""
    if not ivals:
        return []
    ivals.sort()
    out = [list(ivals[0])]
    for b, e in ivals[1:]:
        if b <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([b, e])
    return [(b, e) for b, e in out]


def _union_ns(ivals: List[Tuple[int, int]]) -> int:
    return sum(e - b for b, e in _merge_intervals(list(ivals)))


def fold_events(spans, t0_ns: int, t1_ns: int) -> dict:
    """Fold one request's spans, ``(name, begin_ns, end_ns)`` tuples,
    over the window ``[t0_ns, t1_ns)`` into the components (µs).

    ``coverage_us`` is the union across components and
    ``unattributed_us`` the rest of the wall, so their sum is the wall;
    ``overlap_us`` is the component sum past the coverage (parallel work
    in two components at once)."""
    wall = max(0, t1_ns - t0_ns)
    per: Dict[str, List[Tuple[int, int]]] = {}
    everything: List[Tuple[int, int]] = []
    for name, b, e in spans:
        comp = component_of(name)
        if comp is None:
            continue
        b, e = max(b, t0_ns), min(e, t1_ns)
        if e <= b:
            continue
        per.setdefault(comp, []).append((b, e))
        everything.append((b, e))
    comps = {c: _union_ns(iv) / 1000.0 for c, iv in per.items()}
    coverage = _union_ns(everything) / 1000.0
    comp_sum = sum(comps.values())
    return {
        "wall_us": wall / 1000.0,
        "components": {c: round(comps.get(c, 0.0), 3) for c in COMPONENTS},
        "coverage_us": round(coverage, 3),
        "unattributed_us": round(wall / 1000.0 - coverage, 3),
        "overlap_us": round(max(0.0, comp_sum - coverage), 3),
        "spans": len(spans),
    }


class AttributionCollector:
    """Bounded span buffer and per-class profiles.

    :meth:`sink` is the tracer's sink: each completed span with a trace
    id is buffered under it.  Traces are LRU-bounded (``max_traces``:
    a request that never retires ages out) and each keeps at most
    ``max_spans`` spans (drops counted)."""

    #: retired folds kept for the flight recorder's summary
    _RECENT = 64

    def __init__(self, max_traces: int = 256, max_spans: int = 1024,
                 stats=None):
        self._lock = make_lock("attrib.AttributionCollector._lock")
        self.max_traces = max_traces
        self.max_spans = max_spans
        #: trace id (hex, as stamped in span args) → span tuples
        self._traces: "OrderedDict[str, list]" = OrderedDict()
        self.stats = stats
        self.dropped = 0
        self.requests = 0
        #: (class, component or "wall") → Log2Histogram of µs
        self._hists: Dict[Tuple[str, str], Log2Histogram] = {}
        #: (class, component or "wall") → cumulative µs
        self._totals: Dict[Tuple[str, str], float] = {}
        self._class_n: Dict[str, int] = {}
        self._recent: deque = deque(maxlen=self._RECENT)

    # -- collection (the tracer sink) ----------------------------------------

    def sink(self, ev: dict) -> None:
        """One completed span event; spans without a trace id (the flat
        majority of a bulk run) return after two lookups."""
        if ev.get("ph") == "C":
            return
        args = ev.get("args")
        if not args:
            return
        tid = args.get("trace")
        if tid is None:
            return
        b_ns = int(ev["ts"] * 1000.0)
        e_ns = b_ns + int(ev.get("dur", 0.0) * 1000.0)
        dropped = False
        with self._lock:
            spans = self._traces.get(tid)
            if spans is None:
                while len(self._traces) >= self.max_traces:
                    self._traces.popitem(last=False)
                spans = self._traces[tid] = []
            else:
                # a long-lived request still emitting must outlive
                # traces abandoned after it
                self._traces.move_to_end(tid)
            if len(spans) >= self.max_spans:
                self.dropped += 1
                dropped = True
            else:
                spans.append((ev["name"], b_ns, e_ns))
        if dropped and self.stats is not None:
            self.stats.add(attrib_spans_dropped=1)

    # -- the fold at retirement ----------------------------------------------

    def _observe_locked(self, klass: str, comp: str, us: float) -> None:
        key = (klass, comp)
        self._totals[key] = self._totals.get(key, 0.0) + us
        if us > 0 or comp == "wall":
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = Log2Histogram()
            h.observe(max(us, 0))

    def request_retired(self, trace_id, t0_ns: int, t1_ns: int,
                        klass: str = "decode",
                        extra: Optional[dict] = None) -> dict:
        """Fold the retired request's spans and roll the fold into the
        ``klass`` profile.  ``trace_id``: the root context's id (int) or
        the hex string its spans carry.  Returns the fold."""
        tid = trace_id if isinstance(trace_id, str) else f"{trace_id:x}"
        with self._lock:
            spans = self._traces.pop(tid, [])
        fold = fold_events(spans, t0_ns, t1_ns)
        fold["klass"] = klass
        if extra:
            fold.update(extra)
        with self._lock:
            self.requests += 1
            self._class_n[klass] = self._class_n.get(klass, 0) + 1
            for comp, us in fold["components"].items():
                self._observe_locked(klass, comp, us)
            self._observe_locked(klass, "unattributed",
                                 fold["unattributed_us"])
            self._observe_locked(klass, "wall", fold["wall_us"])
            self._recent.append(fold)
        if self.stats is not None:
            self.stats.add(attrib_requests=1)
        return fold

    # -- views ----------------------------------------------------------------

    def profiles(self) -> dict:
        """Per class and component: p50/p99 (µs), cumulative µs and the
        share of the class's wall time."""
        with self._lock:
            out: dict = {"requests": self.requests,
                         "spans_dropped": self.dropped, "classes": {}}
            for kl in sorted(self._class_n):
                wall_total = max(self._totals.get((kl, "wall"), 0.0), 1e-9)
                comps = {}
                for comp in COMPONENTS + ("unattributed",):
                    total = self._totals.get((kl, comp), 0.0)
                    h = self._hists.get((kl, comp))
                    comps[comp] = {
                        "p50_us": h.percentile(50) if h is not None else 0,
                        "p99_us": h.percentile(99) if h is not None else 0,
                        "total_us": round(total, 1),
                        "share": round(total / wall_total, 4),
                    }
                wh = self._hists.get((kl, "wall"))
                out["classes"][kl] = {
                    "n": self._class_n[kl],
                    "wall_p50_us": wh.percentile(50) if wh else 0,
                    "wall_p99_us": wh.percentile(99) if wh else 0,
                    "wall_total_us": round(wall_total, 1),
                    "components": comps,
                }
            return out

    def summary(self) -> dict:
        """The flight recorder's dump field: the last few folds and each
        class's mean component shares."""
        with self._lock:
            recent = list(self._recent)[-8:]
        prof = self.profiles()
        shares = {kl: {c: v["share"] for c, v in blk["components"].items()}
                  for kl, blk in prof["classes"].items()}
        return {"requests": prof["requests"], "shares": shares,
                "recent": recent}

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()
            self._hists.clear()
            self._totals.clear()
            self._class_n.clear()
            self._recent.clear()
            self.requests = 0
            self.dropped = 0


# -- the process's collector (STROM_ATTRIB) ----------------------------------

_singleton_lock = make_lock("attrib._singleton_lock")
_collector: Optional[AttributionCollector] = None
_collector_init = False


def get_collector() -> Optional[AttributionCollector]:
    """The process's collector under ``STROM_ATTRIB=1``; None otherwise
    (the default)."""
    global _collector, _collector_init
    if _collector_init:
        return _collector
    with _singleton_lock:
        if not _collector_init:
            if os.environ.get("STROM_ATTRIB", "0") == "1":
                _collector = AttributionCollector()
            _collector_init = True
        return _collector


def reset() -> None:
    """Drop the collector; the next :func:`get_collector` reads the
    environment again.  Sinks already attached keep feeding the old
    one: detach them (``tracer.remove_sink``) too."""
    global _collector, _collector_init
    with _singleton_lock:
        _collector = None
        _collector_init = False


def attach(tracer, stats=None) -> Optional[AttributionCollector]:
    """Attach the process's collector, when enabled, to ``tracer`` as a
    sink (idempotent); the engine calls this at construction."""
    col = get_collector()
    if col is None or tracer is None:
        return None
    if stats is not None and col.stats is None:
        col.stats = stats
    tracer.add_sink(col.sink)
    return col
