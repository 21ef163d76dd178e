"""StromStats counter-drift check (counterpart of
nvme_strom_tpu/analysis/counters.py).

Contract: every counter in the port's ``COUNTERS``
(utils/stats.py) must

- belong to some ``tools/strom_stat.py`` render block
  (``ALL_COUNTER_BLOCKS``),
- actually render (a snapshot with every counter non-zero prints every
  name), and
- appear in the ``--json`` snapshot and the ``--prom`` OpenMetrics
  export as ``strom_<name>_total``.

A counter that skips the tooling fails lint, not a production triage
session.  Unlike the abi and locks passes this one imports the live
modules: the registry IS the artifact under test."""

from __future__ import annotations

from typing import List

from nvme_strom_tpu_torch.analysis.driver import Violation

CHECK = "counters"
_STAT = "nvme_strom_tpu_torch/tools/strom_stat.py"
_STATS = "nvme_strom_tpu_torch/utils/stats.py"


def check_counter_drift() -> List[Violation]:
    from nvme_strom_tpu_torch.tools.strom_stat import (ALL_COUNTER_BLOCKS,
                                                       render)
    from nvme_strom_tpu_torch.utils.stats import (
        COUNTERS as COUNTER_FIELDS, StromStats, openmetrics_from_snapshot)

    out: List[Violation] = []
    rendered = {n for blk in ALL_COUNTER_BLOCKS for n in blk}
    for n in sorted(set(COUNTER_FIELDS) - rendered):
        out.append(Violation(
            CHECK, _STAT, 1,
            f"counter {n} is absent from every strom_stat block — add "
            f"it to a block in tools/strom_stat.py", key=n))

    snap_all = {n: 1 for n in COUNTER_FIELDS}
    text = render(snap_all)
    for n in COUNTER_FIELDS:
        if n in rendered and n not in text:
            out.append(Violation(
                CHECK, _STAT, 1,
                f"counter {n} is in a block but the render output "
                f"drops it", key=f"render:{n}"))

    snap = StromStats().snapshot()
    for n in COUNTER_FIELDS:
        if n not in snap:
            out.append(Violation(
                CHECK, _STATS, 1,
                f"counter {n} missing from StromStats.snapshot() "
                f"(--json)", key=f"json:{n}"))
    prom = openmetrics_from_snapshot(snap)
    for n in COUNTER_FIELDS:
        if f"strom_{n}_total" not in prom:
            out.append(Violation(
                CHECK, _STATS, 1,
                f"counter {n} missing from the OpenMetrics export "
                f"(--prom)", key=f"prom:{n}"))
    return out
