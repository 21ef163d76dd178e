"""Failure-domain supervision: ring health, circuit breakers, hot ring
restart and the degraded buffered mode (counterpart of
nvme_strom_tpu/io/health.py).

A retry makes one bad read survivable; the supervisor makes a whole
failure domain survivable: a wedged ring, or a device that throws an
EIO storm.  It keeps

  health    a rolling error window per ring, fed by the C engine's ring
            counters (``failed``, polled in ``tick``) and by the
            resilient engine's failed attempts (``note_error``: a
            Python fault plan never moves the C counters), and a stall
            detector on each ring's ``oldest_inflight_ns``;
  breaker   one breaker per ring (closed → open → half-open → closed)
            and one for the device.  An open ring reports no admission
            headroom to the QoS scheduler (``mask_free_slots``) and is
            skipped by scalar submissions (``pick_ring``);
  restart   an open ring is hot-restarted (``strom_ring_restart``): its
            parked requests complete ``-ECANCELED``, and their waiters'
            retries (io/resilient.py) resubmit them onto healthy rings;
            the ring then serves half-open until a clean interval
            closes it;
  degraded  when every ring is open, or the device window overflows,
            the planner (io/plan.py ``submit_spans``) serves synchronous
            buffered preads (:class:`DegradedRead`,
            ``strom_read_buffered``) while one probe every ``probe_s``
            rides the real path; its success restores it.  The servers
            shed new prefills meanwhile (models/serving.py), and the SLO
            governor does not boost hedges into the device.

There is no thread: ``tick`` runs on callers' threads (the scheduler's
admission poll, the planner's submit, the resilient wait loop, a
shedding server), time-gated at ``_TICK_S``, and ``tick(force=True)``
runs a round at once.  Every action is counted (``breaker_trips``,
``ring_restarts``, ``extents_requeued``, ``degraded_reads`` /
``degraded_bytes``, ``degraded_probes``; gauges ``ring_health`` and
``engine_degraded``), traced (``strom.health.*``,
``strom.read.degraded``) and dumped to the flight recorder
(``breaker_trip``, ``ring_restart``, ``device_degraded``).

New for CUDA: a degraded read's bytes land in pageable memory, which
the engine counts as fallback and bounce at its pread; the bridge
(ops/bridge.py) copies them to the card through its pinned bounce
buffer and ``h2d_copy`` without counting them twice.
"""

from __future__ import annotations

import errno
import time
from collections import deque
from typing import List, Optional, Sequence

import numpy as np

from nvme_strom_tpu_torch.obs.ledger import charge_waste
from nvme_strom_tpu_torch.utils.config import BreakerConfig
from nvme_strom_tpu_torch.utils.lockwitness import make_rlock
from nvme_strom_tpu_torch.utils.trace import NO_CONTEXT, attach_context

#: breaker states (the ``ring_health`` gauge)
CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"

#: largest half-open probe read
_PROBE_BYTES = 64 << 10

#: least time between two polled supervision rounds (s)
_TICK_S = 0.25


class _Window:
    """Rolling event counter: ``count`` forgets events older than
    ``span_s`` (``add`` prunes too, so a long outage cannot grow it)."""

    __slots__ = ("span_s", "_events")

    def __init__(self, span_s: float):
        self.span_s = span_s
        self._events: deque = deque()

    def _prune(self, now: float) -> None:
        horizon = now - self.span_s
        ev = self._events
        while ev and ev[0][0] < horizon:
            ev.popleft()

    def add(self, n: int = 1, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        self._prune(now)
        self._events.append((now, n))

    def count(self, now: Optional[float] = None) -> int:
        self._prune(time.monotonic() if now is None else now)
        return sum(n for _, n in self._events)

    def clear(self) -> None:
        self._events.clear()


class _RingBreaker:
    """One ring's breaker and error window."""

    __slots__ = ("state", "window", "opened_at", "half_open_at",
                 "last_restart", "last_failed")

    def __init__(self, window_s: float):
        self.state = CLOSED
        self.window = _Window(window_s)
        self.opened_at = 0.0
        self.half_open_at = 0.0
        self.last_restart = -1e9   # the first restart is never gated
        self.last_failed = 0       # the C failed counter already seen


class DegradedRead:
    """A pending-shaped degraded read: one synchronous buffered pread
    (``strom_read_buffered``) at the first ``wait()``; no ring, no
    staging buffer, no retry.  An EOF tail comes back short, as from an
    engine read."""

    __slots__ = ("_engine", "fh", "offset", "_length", "_stats", "_view",
                 "_ctx")

    #: the bytes came through the page cache
    was_fallback = True

    def __init__(self, base_engine, fh: int, offset: int, length: int,
                 stats=None):
        self._engine = base_engine
        self.fh = fh
        self.offset = offset
        self._length = length
        self._stats = stats
        self._view: Optional[np.ndarray] = None
        # the pread runs at wait(), maybe on another thread: its span
        # keeps the submitting scope
        self._ctx = NO_CONTEXT
        tracer = getattr(base_engine, "tracer", None)
        if tracer is not None and tracer.enabled:
            self._ctx = attach_context()

    @property
    def length(self) -> int:
        return self._length

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        del timeout   # synchronous: the pread is bounded by the I/O
        if self._view is None:
            t0 = time.monotonic_ns()
            self._view = self._engine.read_buffered(self.fh, self.offset,
                                                    self._length)
            t1 = time.monotonic_ns()
            n = int(self._view.nbytes)
            if self._stats is not None:
                self._stats.add(degraded_bytes=n)
                charge_waste(self._stats, "degraded", n)
            tracer = getattr(self._engine, "tracer", None)
            if tracer is not None and tracer.enabled:
                tracer.add_span("strom.read.degraded", t0, t1,
                                category="strom.health", ctx=self._ctx,
                                bytes=n)
            flight = getattr(self._engine, "flight", None)
            if flight is not None:
                flight.record("read", None, -1, self.fh, self.offset, n,
                              max(0, t1 - t0) // 1000, "degraded")
        return self._view

    def is_ready(self) -> bool:
        return True

    def release(self) -> None:
        self._view = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


class EngineSupervisor:
    """The failure-domain supervisor of one StromEngine (the base engine,
    under any wrappers)."""

    def __init__(self, engine, config: Optional[BreakerConfig] = None):
        self._engine = engine
        self.cfg = config or BreakerConfig()
        n = getattr(engine, "n_rings", 1)
        self.rings = [_RingBreaker(self.cfg.window_s) for _ in range(n)]
        self.device_window = _Window(self.cfg.window_s)
        self._degraded = False         # the device breaker is open
        self._lock = make_rlock("health.EngineSupervisor._lock")
        self._next_tick = 0.0
        self._next_probe = 0.0
        self._rr = 0                   # healthy-ring round-robin cursor
        self._probe_zombies: list = []
        #: (engine, fh, offset, length) of the last degraded span: tick()
        #: probes from it when shedding has stopped every batch
        self._probe_hint: Optional[tuple] = None
        self._closed = False
        #: called outside the lock with True on entering degraded mode
        #: and False on recovery (io/coldstart.py counts brown-outs)
        self._degraded_listeners: list = []

    # -- queries (hot paths read these without the lock) -------------------

    def degraded(self) -> bool:
        """The device breaker is open: serve the buffered path."""
        return self._degraded

    def unhealthy(self) -> bool:
        """Degraded, or any ring breaker not closed: the SLO governor
        does not boost hedges then."""
        return self._degraded or any(r.state != CLOSED for r in self.rings)

    def ring_states(self) -> List[str]:
        return [r.state for r in self.rings]

    def mask_free_slots(self, free: List[int]) -> List[int]:
        """The scheduler's admission filter: an OPEN ring reports no
        headroom.  Half-open rings admit (that is how they prove
        themselves); while degraded nothing is masked, so a straggler
        batch cannot starve in the grant loop."""
        if self._degraded or all(r.state != OPEN for r in self.rings):
            return free
        return [0 if self.rings[i].state == OPEN else f
                for i, f in enumerate(free[:len(self.rings)])]

    def pick_ring(self) -> Optional[int]:
        """A healthy ring for a scalar submission; None when every ring
        is trusted (the C round-robin stays) or none is."""
        states = [r.state for r in self.rings]
        if OPEN not in states:
            return None
        healthy = [i for i, s in enumerate(states) if s != OPEN]
        if not healthy:
            return None
        self._rr += 1
        return healthy[self._rr % len(healthy)]

    # -- ingestion ---------------------------------------------------------

    def note_error(self, ring: int = -1, err: Optional[int] = None,
                   engine_counted: bool = False) -> None:
        """One failed attempt seen above the C engine.  A cancellation is
        a requeue, not damage, and an error the C engine counted
        (``engine_counted``: tick() reads it from the ring counters) is
        not counted twice."""
        if err == errno.ECANCELED or engine_counted or self._closed:
            return
        now = time.monotonic()
        stats = getattr(self._engine, "stats", None)
        with self._lock:
            self.device_window.add(now=now)
            if 0 <= ring < len(self.rings):
                rb = self.rings[ring]
                rb.window.add(now=now)
                if (rb.state in (CLOSED, HALF_OPEN)
                        and rb.window.count(now) >= self.cfg.ring_errors):
                    self._trip_ring(ring, now, stats)
            self._check_device(now, stats)

    # -- the supervision round ---------------------------------------------

    def tick(self, force: bool = False) -> None:
        """One round: read the ring counters, trip stalled or failing
        rings, restart open ones (backoff-gated), close clean half-open
        ones, and while degraded probe from the last degraded span.
        Time-gated unless ``force``; a round already running absorbs the
        call."""
        now = time.monotonic()
        if not force and now < self._next_tick:
            return
        if not self._lock.acquire(blocking=force):
            return
        probe_hint = None
        try:
            if self._closed:
                return
            self._next_tick = now + _TICK_S
            stats = getattr(self._engine, "stats", None)
            self._reap_probe_zombies()
            for i, rb in enumerate(self.rings):
                try:
                    info = self._engine.ring_info(i)
                except (OSError, AttributeError):
                    continue
                failed = int(info.get("failed", 0))
                delta = failed - rb.last_failed
                rb.last_failed = failed
                if delta > 0:
                    rb.window.add(delta, now=now)
                    self.device_window.add(delta, now=now)
                stalled = (int(info.get("oldest_inflight_ns", 0))
                           > self.cfg.stall_s * 1e9)
                if rb.state in (CLOSED, HALF_OPEN) and (
                        stalled
                        or rb.window.count(now) >= self.cfg.ring_errors):
                    self._trip_ring(i, now, stats)
                if rb.state == OPEN and (now - rb.last_restart
                                         >= self.cfg.restart_backoff_s):
                    self._restart_ring(i, now, stats)
                if rb.state == HALF_OPEN and (
                        now - rb.half_open_at >= self.cfg.half_open_s
                        and rb.window.count(now) == 0):
                    rb.state = CLOSED
            self._check_device(now, stats)
            self._export_gauges(stats)
            if self._degraded:
                probe_hint = self._probe_hint
        finally:
            self._lock.release()
        if probe_hint is not None:
            # outside the lock: a probe waits on real I/O
            eng, fh, off, ln = probe_hint
            self._maybe_probe(eng, [(fh, off, ln)],
                              getattr(eng, "stats", None))

    def _flight_dump(self, reason: str, **extra) -> None:
        flight = getattr(self._engine, "flight", None)
        if flight is not None:
            flight.dump(reason, extra=extra or None)

    def _trip_ring(self, ring: int, now: float, stats) -> None:
        rb = self.rings[ring]
        rb.state = OPEN
        rb.opened_at = now
        if stats is not None:
            stats.add(breaker_trips=1)
        self._flight_dump("breaker_trip", ring=ring,
                          window_errors=rb.window.count(now))
        # no healthy ring left is the device verdict, taken here so the
        # scheduler never faces every ring masked outside degraded mode
        if all(r.state == OPEN for r in self.rings):
            self._enter_degraded(now, stats)

    def _restart_ring(self, ring: int, now: float, stats) -> None:
        """Hot restart: the ring's parked requests complete -ECANCELED
        for their waiters to resubmit; a ring whose dispatched I/O does
        not drain stays open (the degraded path is the fallback)."""
        rb = self.rings[ring]
        rb.last_restart = now
        t0 = time.monotonic_ns()
        try:
            cancelled = self._engine.ring_restart(ring, self.cfg.drain_s)
        except TimeoutError:
            return
        except (OSError, AttributeError):
            return        # a restart already running, or teardown
        if stats is not None:
            stats.add(ring_restarts=1,
                      **({"extents_requeued": cancelled}
                         if cancelled else {}))
        tracer = getattr(self._engine, "tracer", None)
        if tracer is not None and tracer.enabled:
            tracer.add_span("strom.health.ring_restart", t0,
                            time.monotonic_ns(), category="strom.health",
                            ring=ring, cancelled=cancelled)
        self._flight_dump("ring_restart", ring=ring, cancelled=cancelled)
        rb.window.clear()
        rb.state = HALF_OPEN
        rb.half_open_at = time.monotonic()

    def _check_device(self, now: float, stats) -> None:
        if not self._degraded and \
                self.device_window.count(now) >= self.cfg.device_errors:
            self._enter_degraded(now, stats)

    def _enter_degraded(self, now: float, stats) -> None:
        if self._degraded:
            return
        self._degraded = True
        self._next_probe = now + self.cfg.probe_s
        if stats is not None:
            stats.add(breaker_trips=1)   # the device breaker's trip
        tenants = stats.tenant_stats if stats is not None else {}
        self._flight_dump("device_degraded",
                          device_errors=self.device_window.count(now),
                          **({"tenant_stats": tenants} if tenants else {}))
        self._export_gauges(stats)
        self._notify_degraded(True)

    def _recover(self, stats) -> None:
        """A probe succeeded: the fast path is back.  Open ring breakers
        go half-open and close after a clean interval."""
        with self._lock:
            self._degraded = False
            self._probe_hint = None
            self.device_window.clear()
            now = time.monotonic()
            for rb in self.rings:
                if rb.state == OPEN:
                    rb.state = HALF_OPEN
                    rb.half_open_at = now
                rb.window.clear()
            self._export_gauges(stats)
        self._notify_degraded(False)

    def add_degraded_listener(self, fn) -> None:
        """Register ``fn(on)``, called on entering (True) and leaving
        (False) degraded mode."""
        self._degraded_listeners.append(fn)

    def _notify_degraded(self, on: bool) -> None:
        for fn in list(self._degraded_listeners):
            try:
                fn(on)
            except Exception:   # noqa: BLE001 — an observer never
                pass            # wedges the breaker

    def _export_gauges(self, stats) -> None:
        if stats is not None:
            stats.set_gauges(ring_health=self.ring_states(),
                             engine_degraded=int(self._degraded))

    # -- degraded service --------------------------------------------------

    def serve_degraded(self, engine, spans: Sequence,
                       stats=None) -> Optional[list]:
        """``(fh, offset, length)`` spans as :class:`DegradedRead`
        preads.  First the probe (one real read a ``probe_s`` through
        ``engine``, the top of the wrapper stack, so a Python fault plan
        gates recovery as a device fault does): its success recovers
        and returns None, and the caller takes the fast path for this
        very batch."""
        if stats is None:
            stats = getattr(engine, "stats", None)
        if spans:
            fh, off, ln = next(((f, o, n) for f, o, n in spans if n > 0),
                               spans[0])
            self._probe_hint = (engine, fh, off, ln)
            if self._maybe_probe(engine, spans, stats):
                return None
        out = [DegradedRead(self._engine, fh, off, ln, stats)
               for fh, off, ln in spans]
        if stats is not None and out:
            stats.add(degraded_reads=len(out))
        return out

    def degraded_pending(self, fh: int, offset: int, length: int,
                         stats=None, probe_engine=None) -> DegradedRead:
        """One counted degraded read: the resilient retry's next attempt
        once the device breaker has opened.  ``probe_engine`` is what
        the recovery probe rides (the layer below the resilient wrapper,
        faults included); the base engine by default."""
        if stats is None:
            stats = getattr(self._engine, "stats", None)
        if stats is not None:
            stats.add(degraded_reads=1)
        # the newest live span: an older hint may name a closed fh
        self._probe_hint = (probe_engine or self._engine, fh, offset,
                            length)
        return DegradedRead(self._engine, fh, offset, length, stats)

    def _maybe_probe(self, engine, spans, stats) -> bool:
        """True when a probe ran and succeeded (and recovered)."""
        now = time.monotonic()
        if self.cfg.probe_s > 0 and now < self._next_probe:
            return False
        with self._lock:
            if now < self._next_probe and self.cfg.probe_s > 0:
                return False           # another thread probed first
            self._next_probe = now + max(self.cfg.probe_s, 1e-9)
        fh, off, ln = next(((f, o, n) for f, o, n in spans if n > 0),
                           spans[0])
        # the probe rides the raw path: a resilient wrapper would retry
        # it into the degraded fallback and hide the failure probed; a
        # fault layer stays, so a Python storm gates recovery too
        from nvme_strom_tpu_torch.io.resilient import ResilientEngine
        while isinstance(engine, ResilientEngine):
            engine = engine._engine
        ok = False
        pending = None
        t0 = time.monotonic_ns()
        try:
            pending = engine.submit_read(fh, off, min(ln, _PROBE_BYTES))
            pending.wait(timeout=self.cfg.probe_timeout_s)
            ok = True
        except TimeoutError:
            # still in flight: park it (a release would block on the
            # wedge probed) for later rounds to reap
            with self._lock:
                self._probe_zombies.append(pending)
            pending = None
        except OSError:
            if pending is None:
                # the submit itself failed (a closed fh): drop a hint
                # naming it, or tick() would probe it forever
                with self._lock:
                    if (self._probe_hint is not None
                            and self._probe_hint[1] == fh):
                        self._probe_hint = None
            pending = None             # a failed wait released it
        finally:
            if pending is not None:
                try:
                    pending.release()
                except OSError:
                    pass
        if stats is not None:
            stats.add(degraded_probes=1)
        tracer = getattr(self._engine, "tracer", None)
        if tracer is not None and tracer.enabled:
            tracer.add_span("strom.health.probe", t0, time.monotonic_ns(),
                            category="strom.health", fh=fh, offset=off,
                            ok=ok)
        if ok:
            self._recover(stats)
        return ok

    def _reap_probe_zombies(self) -> None:
        survivors = []
        for p in self._probe_zombies:
            try:
                if p.is_ready():
                    p.release()
                else:
                    survivors.append(p)
            except OSError:
                pass
        self._probe_zombies = survivors

    def close(self) -> None:
        """Stop supervising and release the probes that have landed."""
        with self._lock:
            self._closed = True
            self._reap_probe_zombies()
            self._probe_zombies = []
