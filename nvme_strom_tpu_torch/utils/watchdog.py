"""Step watchdog: turn a silent training hang into a diagnosis
(counterpart of nvme_strom_tpu/utils/watchdog.py ``StepWatchdog``).

A daemon thread holds a deadline around each armed section; past it, it
dumps every Python thread's stack and the engine's counters to the
stream (with a health line once a breaker or the degraded mode has
acted), writes a ``watchdog_stall`` flight-recorder dump
(io/flightrec.py) when the engine has a recorder, then keeps waiting
(``on_timeout="report"``) or ends the process with code 124 for a
supervisor to restart (``"abort"``).

    wd = StepWatchdog(deadline_s=120, engine=engine)
    for batch in loader:
        with wd.step():
            loss = train_step(params, batch)
"""

from __future__ import annotations

import faulthandler
import io
import os
import sys
import threading
import time
from contextlib import contextmanager
from typing import Optional

from nvme_strom_tpu_torch.utils.lockwitness import make_condition, make_lock


class StepWatchdog:
    """Deadline monitor for an iterative loop.

    ``deadline_s``: wall-clock budget per armed section.  ``on_timeout``:
    "report" (dump, keep waiting; at most ``max_reports`` dumps per
    section) or "abort" (dump, then ``os._exit(124)``: the process is
    presumed wedged, so no Python cleanup runs).  ``engine``: an optional
    StromEngine whose counters join the dump."""

    def __init__(self, deadline_s: float, engine=None,
                 on_timeout: str = "report", max_reports: int = 3,
                 stream=None):
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        if on_timeout not in ("report", "abort"):
            raise ValueError(f"on_timeout must be 'report' or 'abort', "
                             f"got {on_timeout!r}")
        self.deadline_s = deadline_s
        self.engine = engine
        self.on_timeout = on_timeout
        self.max_reports = max_reports
        self.stream = stream or sys.stderr
        self.timeouts = 0                 # deadline overruns seen
        self._gen = 0                     # bumped on every arm/disarm
        self._armed_at: Optional[float] = None
        self._started_at = 0.0
        self._label = ""
        self._lock = make_lock("watchdog.StepWatchdog._lock")
        self._wake = make_condition("watchdog.StepWatchdog._wake", self._lock)
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="strom-watchdog")
        self._thread.start()

    @contextmanager
    def step(self, label: str = "step"):
        """Arm the deadline for the enclosed block."""
        with self._lock:
            self._gen += 1
            gen = self._gen
            self._armed_at = time.monotonic()
            self._started_at = self._armed_at
            self._label = label
            self._wake.notify()
        try:
            yield
        finally:
            with self._lock:
                if self._gen == gen:
                    self._armed_at = None
                self._gen += 1
                self._wake.notify()

    def close(self) -> None:
        with self._lock:
            self._stop = True
            self._wake.notify()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _run(self) -> None:
        reports = 0
        gen_seen = -1
        while True:
            with self._lock:
                if self._stop:
                    return
                if self._armed_at is None:
                    self._wake.wait()
                    continue
                if self._gen != gen_seen:
                    gen_seen = self._gen
                    reports = 0
                remain = self.deadline_s - (time.monotonic()
                                            - self._armed_at)
                if remain > 0:
                    self._wake.wait(timeout=remain)
                    continue
                label = self._label
                self.timeouts += 1
                self._armed_at = time.monotonic()   # re-arm for a repeat
                total = self._armed_at - self._started_at
                reports += 1
                do_report = reports <= self.max_reports
            if do_report:
                try:
                    self._dump(label, total)
                except Exception as e:   # the monitor must outlive it
                    print(f"watchdog dump failed: {e!r}", file=sys.stderr)
            if self.on_timeout == "abort":
                try:
                    self.stream.flush()
                except (OSError, ValueError):
                    pass                 # a broken pipe must not stop
                os._exit(124)            # the kill

    def _dump(self, label: str, total: float) -> None:
        w = self.stream
        print(f"\n=== strom watchdog: {label!r} exceeded "
              f"{self.deadline_s:.1f}s (running {total:.1f}s total) ===",
              file=w, flush=True)
        try:
            w.fileno()
            faulthandler.dump_traceback(file=w)
        except (AttributeError, OSError, ValueError,
                io.UnsupportedOperation):
            import traceback
            for tid, frame in sys._current_frames().items():
                print(f"Thread {tid}:", file=w)
                traceback.print_stack(frame, file=w)
        if self.engine is not None:
            self.engine.sync_stats()
            s = self.engine.stats
            print(f"engine: {s.snapshot()}", file=w, flush=True)
            # an open breaker or the degraded flag is a supervised
            # brown-out in progress, not a silent wedge
            snap = s.snapshot()
            ring_health = snap.get("ring_health")
            if (s.breaker_trips or s.ring_restarts or s.degraded_reads
                    or s.serve_admissions_shed
                    or (ring_health and any(x != "closed"
                                            for x in ring_health))):
                states = " ".join(ring_health) if ring_health else "-"
                print(f"health: breakers=[{states}] "
                      f"degraded={int(snap.get('engine_degraded', 0))} "
                      f"trips={s.breaker_trips} "
                      f"restarts={s.ring_restarts} "
                      f"requeued={s.extents_requeued} "
                      f"degraded_reads={s.degraded_reads} "
                      f"degraded_bytes={s.degraded_bytes} "
                      f"probes={s.degraded_probes} "
                      f"shed={s.serve_admissions_shed}", file=w,
                      flush=True)
            # recovery counters that move mean a step fighting the
            # device, not a wedged one
            print(f"resilience: retries={s.resilient_retries} "
                  f"hedges={s.hedges_issued}/{s.hedges_won} "
                  f"stuck_cancelled={s.stuck_cancelled} "
                  f"write_retries={s.write_retries} "
                  f"quarantined={s.shards_quarantined} "
                  f"faults_injected={s.faults_injected}", file=w,
                  flush=True)
            if s.trace_spans_dropped or s.flight_dumps:
                print(f"observability: "
                      f"trace_spans_dropped={s.trace_spans_dropped} "
                      f"flight_dumps={s.flight_dumps}", file=w, flush=True)
            # a stalled step is a flight-recorder trigger (forced: the
            # abort path must not rate-limit away its last evidence)
            flight = getattr(self.engine, "flight", None)
            if flight is not None:
                fpath = flight.dump("watchdog_stall", force=True,
                                    extra={"label": label,
                                           "running_s": round(total, 3)})
                if fpath:
                    print(f"flight recorder: dumped {fpath}", file=w,
                          flush=True)
        print("=== end watchdog dump ===", file=w, flush=True)
