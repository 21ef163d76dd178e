"""Observability analysis (counterpart of nvme_strom_tpu/obs/): so far
the goodput/waste ledger (``obs.ledger``)."""

from nvme_strom_tpu_torch.obs.ledger import (WASTE_COUNTERS, charge_waste,
                                             ledger_view)

__all__ = ["WASTE_COUNTERS", "charge_waste", "ledger_view"]
