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
reference does.  The planner's and the tier's charges, and the
reference's per-ring ``RingTimeLedger``, come with ROADMAP Queue 1 item
14.
"""

from __future__ import annotations

#: waste class → its StromStats counter
WASTE_COUNTERS = {
    "hedge_loss": "waste_hedge_loss_bytes",
    "retry_reread": "waste_retry_reread_bytes",
    "coalesce_gap": "waste_coalesce_gap_bytes",
    "evicted_unused": "waste_evicted_unused_bytes",
    "degraded": "waste_degraded_bytes",
}


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
    return {
        "delivered_bytes": delivered,
        "goodput_bytes": goodput,
        "waste_bytes": waste_total,
        "waste": waste,
        "goodput_fraction": round(goodput / delivered, 4)
        if delivered else 1.0,
    }
