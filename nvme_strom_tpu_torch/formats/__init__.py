"""Format readers (counterpart of nvme_strom_tpu/formats/): metadata read
on the host, payload planned for the engine.  The .npy / .npz readers
are exported here."""

from nvme_strom_tpu_torch.formats.npy import (plan_npy, plan_npz,
                                              read_npy_to_device,
                                              read_npz_to_device)

__all__ = ["plan_npy", "plan_npz", "read_npy_to_device",
           "read_npz_to_device"]
