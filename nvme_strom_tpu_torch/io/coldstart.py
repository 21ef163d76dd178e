"""Serve-while-restoring cold start: the boot-phase machine (counterpart
of nvme_strom_tpu/io/coldstart.py).

A replica that restarts or scales out takes traffic before its weights
are resident: a request that needs a missing tensor faults it in at
``decode`` class (parallel/weights.py ``FaultingCheckpoint``), the bulk
of the checkpoint streams in from the other end at ``restore`` class,
and warm-up work (the prefix store's ``warm_pages``, host-tier hint
manifests of io/warmup.py) runs at ``prefetch`` class once the weights
are in.  The coordinator ties the lanes together:

    cold ──serving started──▶ faulting ──weights resident──▶ warming
                                                               │
                                               warm-up drained ▼
                                                            steady

* ``faulting``: the only phase where the stall trigger is armed: a
  rolling demand-fault p99 past ``ColdStartConfig.fault_slo_ms`` dumps
  ``coldstart_stall`` to the flight recorder, with the phase and the
  scheduler's backlog a class.
* ``warming``: the registered warm-up thunks drain on a thread.
* ``steady``: the replica is as one that never restarted.

The phase is the ``boot_phase`` gauge (and ``boot_phase_code``), and a
listener on the engine supervisor's degraded mode (io/health.py) counts
``coldstart_brownouts``: brown-outs that landed before steady, absorbed
rather than surfaced.  Engine work (dumps, backlog reads, warm-up I/O)
runs outside the lock.

``consume_handoff`` boots from a retiring replica's handoff bundle
(io/handoff.py) under ``STROM_COLDSTART=1`` and ``STROM_HANDOFF=1``:
its exported sessions are re-admitted first, its hot set pre-faulted,
and its warm hints queued on this coordinator's warming phase.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from nvme_strom_tpu_torch.utils.config import ColdStartConfig
from nvme_strom_tpu_torch.utils.lockwitness import make_lock

#: boot phases in order; the index is the ``boot_phase_code`` gauge
PHASES = ("cold", "faulting", "warming", "steady")


class ColdStartCoordinator:
    """One replica's boot progression.  Thread-safe; every ``note_*``
    is cheap and a no-op once it no longer applies."""

    def __init__(self, engine=None, cfg: Optional[ColdStartConfig] = None):
        self.cfg = cfg or ColdStartConfig()
        self.engine = engine
        self._lock = make_lock("coldstart.ColdStartCoordinator._lock")
        self._phase = "cold"
        self._t0 = time.monotonic()
        self._t_phase: Dict[str, float] = {"cold": 0.0}
        self._fault_ms: List[float] = []   # the rolling fault window
        self._warmups: List[Callable[[], None]] = []
        self._warm_thread: Optional[threading.Thread] = None
        self._degraded_seen = False
        sup = getattr(engine, "supervisor", None)
        if sup is not None and hasattr(sup, "add_degraded_listener"):
            sup.add_degraded_listener(self._on_degraded)

    @property
    def phase(self) -> str:
        with self._lock:
            return self._phase

    def phase_times(self) -> Dict[str, float]:
        """Seconds from construction at which each phase was entered."""
        with self._lock:
            return dict(self._t_phase)

    def _advance(self, new: str) -> bool:
        """Forward only: a late note never rewinds the machine.  True on
        a real transition."""
        with self._lock:
            if PHASES.index(new) <= PHASES.index(self._phase):
                return False
            self._phase = new
            self._t_phase[new] = round(time.monotonic() - self._t0, 6)
        stats = getattr(self.engine, "stats", None)
        if stats is not None:
            stats.set_gauges(boot_phase=new,
                             boot_phase_code=PHASES.index(new))
        return True

    def note_serving_started(self) -> None:
        """The server accepts submissions (weights may be cold)."""
        self._advance("faulting")

    def note_weights_resident(self) -> None:
        """Every tensor is on the device: start draining the warm-ups."""
        if not self._advance("warming"):
            return
        with self._lock:
            thunks, self._warmups = self._warmups, []
        if not thunks:
            self._advance("steady")
            return
        t = threading.Thread(target=self._warm_run, args=(thunks,),
                             name="strom-coldstart-warmup", daemon=True)
        with self._lock:
            self._warm_thread = t
        t.start()

    def add_warmup(self, fn: Callable[[], None]) -> None:
        """Register a warming-phase thunk; once warming has begun it runs
        at once, on the caller's thread."""
        with self._lock:
            if self._phase in ("cold", "faulting"):
                self._warmups.append(fn)
                return
        try:
            fn()
        except Exception:   # noqa: BLE001 — warm-up is best effort
            pass

    def _warm_run(self, thunks: List[Callable[[], None]]) -> None:
        for fn in thunks:
            try:
                fn()
            except Exception:   # noqa: BLE001 — a failed warm-up costs
                pass            # later hits, never correctness
        self._advance("steady")

    def consume_handoff(self, base: str, server=None, checkpoint=None
                        ) -> Optional[dict]:
        """Boot from a retiring replica's handoff bundle (io/handoff.py
        ``consume_bundle``): exported sessions are re-admitted first at
        decode class, the shipped hot set is pre-faulted at restore class
        ahead of the bulk lane, and the warm-hint replays run in this
        coordinator's warming phase at prefetch class.  A torn, stale or
        missing bundle returns None and counts one ``handoff_brownouts``:
        the boot goes on as the plain cold start it already is.  With
        this config's gate off (``STROM_COLDSTART``), or the handoff's
        (``STROM_HANDOFF``), it returns None and counts nothing."""
        if not self.cfg.enabled:
            return None
        from nvme_strom_tpu_torch.io.handoff import consume_bundle
        return consume_bundle(base, engine=self.engine, server=server,
                              coordinator=self, checkpoint=checkpoint)

    def wait_steady(self, timeout: Optional[float] = None) -> bool:
        """Block until the warm-up drain finishes; True once steady."""
        with self._lock:
            t = self._warm_thread
        if t is not None:
            t.join(timeout)
        return self.phase == "steady"

    def note_fault_ms(self, ms: float) -> None:
        """One demand fault's service time; in the faulting phase a
        rolling p99 past the target trips the stall dump."""
        slo = self.cfg.fault_slo_ms
        with self._lock:
            if self._phase != "faulting":
                return
            self._fault_ms.append(float(ms))
            if len(self._fault_ms) > self.cfg.fault_window:
                del self._fault_ms[:-self.cfg.fault_window]
            if slo <= 0.0 or len(self._fault_ms) < 8:
                return
            window = sorted(self._fault_ms)
            p99 = window[min(len(window) - 1, int(0.99 * len(window)))]
            if p99 <= slo:
                return
            degraded = self._degraded_seen
        self._stall_dump(p99, degraded)

    def _stall_dump(self, p99_ms: float, degraded: bool) -> None:
        flight = getattr(self.engine, "flight", None)
        if flight is None:
            return
        sched = getattr(self.engine, "scheduler", None)
        path = flight.dump("coldstart_stall", extra={
            "boot_phase": self.phase,
            "fault_p99_ms": round(p99_ms, 3),
            "fault_slo_ms": self.cfg.fault_slo_ms,
            "backlog": sched.backlog() if sched is not None else {},
            "browned_out": degraded})
        stats = getattr(self.engine, "stats", None)
        if path is not None and stats is not None:
            stats.add(coldstart_stall_dumps=1)

    def _on_degraded(self, on: bool) -> None:
        if not on:
            return
        with self._lock:
            self._degraded_seen = True
            count = self._phase != "steady"
        stats = getattr(self.engine, "stats", None)
        if count and stats is not None:
            stats.add(coldstart_brownouts=1)
