"""Goodput/waste ledger: where every delivered byte went (counterpart
of nvme_strom_tpu/obs/ledger.py ``charge_waste`` and ``ledger_view``).

Each completed byte is goodput or one waste class:

  hedge_loss      the losing side of a hedge race (io/resilient.py);
  retry_reread    bytes recovery read again that an earlier attempt had
                  already delivered (io/resilient.py);
  coalesce_gap    gap bytes the planner reads through when it merges
                  extents;
  evicted_unused  host-tier lines filled and evicted before a hit;
  degraded        bytes served by the buffered brown-out of io/health.py.

Goodput is derived (delivered minus waste), so the classes never count
it twice.  The counters are ``StromStats.waste_*_bytes``.  The
resilient engine charges ``hedge_loss`` and ``retry_reread``; a
degraded read (io/health.py ``DegradedRead``) charges the bytes its
pread returned to ``degraded``, once, when it is first waited, as the
reference does; the planner (io/plan.py) charges the gap bytes it reads
through to ``coalesce_gap``; the host tier (io/hostcache.py) charges a
line evicted before its first hit to ``evicted_unused``.

:class:`RingTimeLedger` keeps each ring's cumulative seconds busy, idle,
stalled and restarting, sampled at completion reaping (io/engine.py,
time-gated) and at every stats sync, and exported as the
``ring_state_s`` gauge: a ring stalled 40% of the time explains a
goodput dip that no byte counter can.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

from nvme_strom_tpu_torch.utils.lockwitness import make_lock

#: waste class → its StromStats counter
WASTE_COUNTERS = {
    "hedge_loss": "waste_hedge_loss_bytes",
    "retry_reread": "waste_retry_reread_bytes",
    "coalesce_gap": "waste_coalesce_gap_bytes",
    "evicted_unused": "waste_evicted_unused_bytes",
    "degraded": "waste_degraded_bytes",
}


#: ring states, in render order
RING_STATES = ("busy", "idle", "stalled", "restarting")


def charge_waste(stats, kind: str, nbytes: int) -> None:
    """Charge ``nbytes`` of waste class ``kind`` to ``stats`` (None or a
    non-positive count charges nothing)."""
    if stats is None or nbytes <= 0:
        return
    stats.add(**{WASTE_COUNTERS[kind]: int(nbytes)})


def ledger_view(snap: dict) -> dict:
    """Fold a ``StromStats.snapshot()`` into the goodput/waste view:
    delivered = engine payload (direct + fallback) + host-tier served
    bytes; goodput = delivered minus every waste class."""
    delivered = (int(snap.get("bytes_direct", 0))
                 + int(snap.get("bytes_fallback", 0))
                 + int(snap.get("bytes_served_cache", 0)))
    waste = {kind: int(snap.get(counter, 0))
             for kind, counter in WASTE_COUNTERS.items()}
    waste_total = sum(waste.values())
    goodput = max(0, delivered - waste_total)
    out = {
        "delivered_bytes": delivered,
        "goodput_bytes": goodput,
        "waste_bytes": waste_total,
        "waste": waste,
        "goodput_fraction": round(goodput / delivered, 4)
        if delivered else 1.0,
    }
    rs = snap.get("ring_state_s")
    if rs:
        out["ring_state_s"] = {k: [round(float(v), 3) for v in vals]
                               for k, vals in rs.items()}
    return out


class RingTimeLedger:
    """Cumulative per-ring time in state.

    ``sample(depths, breaker_states)`` charges the time since the last
    sample to each ring's current state: busy (I/O in flight), idle, or
    stalled (its breaker open), an integral of cheap instantaneous
    reads.  ``note_restart`` charges a hot restart's wall time, which
    the sampler would mostly miss.  Callers gate the sampling in time
    (the engine at ~10 Hz)."""

    def __init__(self, n_rings: int):
        self.n_rings = max(1, int(n_rings))
        self._lock = make_lock("ledger.RingTimeLedger._lock")
        self._t: Dict[str, List[float]] = {
            s: [0.0] * self.n_rings for s in RING_STATES}
        self._last = time.monotonic()

    def sample(self, depths: Sequence[int],
               breaker_states: Optional[Sequence[str]] = None,
               now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            dt = now - self._last
            self._last = now
            if dt <= 0:
                return
            for r in range(self.n_rings):
                depth = depths[r] if r < len(depths) else 0
                state = "busy" if depth > 0 else "idle"
                if breaker_states is not None \
                        and r < len(breaker_states) \
                        and breaker_states[r] == "open":
                    state = "stalled"
                self._t[state][r] += dt

    def note_restart(self, ring: int, seconds: float) -> None:
        """Charge one restart window to ``ring``, and move the sampler's
        mark past it so no sample charges the window again: the states'
        seconds never sum past the wall time."""
        if seconds <= 0 or not 0 <= ring < self.n_rings:
            return
        with self._lock:
            self._t["restarting"][ring] += seconds
            self._last = max(self._last, time.monotonic())

    def snapshot(self) -> Dict[str, List[float]]:
        with self._lock:
            return {s: list(v) for s, v in self._t.items()}

    def export(self, stats) -> None:
        """Publish the seconds as the ``ring_state_s`` gauge."""
        if stats is not None:
            stats.set_gauges(ring_state_s=self.snapshot())
