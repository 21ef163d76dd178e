"""Restore manifest of the read-once scatter restore: which bytes of a
checkpoint step each virtual host reads (counterpart of
nvme_strom_tpu/checkpoint/scatter.py).

Every host must agree, without talking, on a partition of the step's
payload into per-host byte shares.  The agreement is the step's data
files in a deterministic order (sorted names) and the shared
contiguous-span partition rule (``io.scatter.partition_files``).  The
partition is by byte range over whole files, not by tensor tile: the
shares cover every byte of every ``*.safetensors`` file exactly once, so
the gathered bytes serve any tile read, including slivers of tiles that
no writer-side partition anticipated.  ``meta.json`` stays an ordinary
local read: it is the few-KiB index both paths parse first.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Tuple

from nvme_strom_tpu_torch.io.scatter import ShareManifest, partition_files


def scatter_data_paths(step_dir: str) -> List[str]:
    """The step's payload files in manifest order: every
    ``*.safetensors`` under ``step_dir``, sorted by name."""
    try:
        names = sorted(n for n in os.listdir(step_dir)
                       if n.endswith(".safetensors"))
    except OSError:
        return []
    return [os.path.join(step_dir, n) for n in names]


@dataclass(frozen=True)
class RestoreManifest:
    """A checkpoint step's read-once partition: the ordered payload
    files and their per-host byte shares."""

    step_dir: str
    paths: Tuple[str, ...]
    shares: ShareManifest

    @property
    def n_hosts(self) -> int:
        return self.shares.n_hosts

    @property
    def total_bytes(self) -> int:
        return self.shares.total_bytes

    @property
    def host_bytes(self) -> Tuple[int, ...]:
        """Bytes host h reads from NVMe (≤ total/N + one unit per
        file)."""
        return self.shares.host_bytes


def build_restore_manifest(step_dir: str, n_hosts: int,
                           unit_bytes: int) -> RestoreManifest:
    """The deterministic per-host partition of ``step_dir``'s payload.
    Raises OSError when a payload file is unreadable: the restore's
    fallback to an older step owns that decision."""
    paths = scatter_data_paths(step_dir)
    sizes = [os.path.getsize(p) for p in paths]
    return RestoreManifest(
        step_dir=str(step_dir), paths=tuple(paths),
        shares=partition_files(sizes, n_hosts, unit_bytes))
