"""Observability analysis (counterpart of nvme_strom_tpu/obs/): the
goodput/waste ledger and the per-ring time ledger (``obs.ledger``),
critical-path attribution (``obs.attrib``) and the debug server
(``obs.debugsrv``)."""

from nvme_strom_tpu_torch.obs.ledger import (RING_STATES, WASTE_COUNTERS,
                                             RingTimeLedger, charge_waste,
                                             ledger_view)

__all__ = ["RING_STATES", "WASTE_COUNTERS", "RingTimeLedger",
           "charge_waste", "ledger_view"]
