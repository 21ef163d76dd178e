"""WebDataset (POSIX tar) sample indexing and a shard writer
(counterpart of nvme_strom_tpu/formats/wds.py).

A shard is an uncompressed tar whose members are grouped into samples by
basename: ``000123.bin`` + ``000123.cls`` are sample ``000123`` with
parts ``bin`` and ``cls``.  Indexing parses only the 512-byte tar
headers (Python's ``tarfile``); member payloads are planned as engine
reads.  The walk's pages are dropped from the page cache afterwards, so
the payload reads that follow still take the O_DIRECT path.
"""

from __future__ import annotations

import io
import os
import tarfile
from typing import Dict, List, Optional

from nvme_strom_tpu_torch.formats.base import (PlanEntry, ReadPlan,
                                               pread_nopollute)


def _split_key(name: str):
    """WebDataset convention: the key is the path up to the first dot of
    the basename, the extension everything after it."""
    slash = name.rfind("/")
    dot = name.find(".", slash + 1)
    if dot < 0:
        return name, ""
    return name[:dot], name[dot + 1:]


class WdsShardIndex:
    """Sample → {ext: (offset, length)} map of one tar shard, samples in
    archive order."""

    def __init__(self, path):
        self.path = str(path)
        self.samples: Dict[str, Dict[str, tuple]] = {}
        self.order: List[str] = []
        if pread_nopollute(self.path, 2) == b"\x1f\x8b":
            raise ValueError(
                f"{self.path}: gzip-compressed shard (.tar.gz) has no "
                "random access; store shards as plain .tar")
        for name, off, size in self._members():
            key, ext = _split_key(name)
            if key not in self.samples:
                self.samples[key] = {}
                self.order.append(key)
            self.samples[key][ext] = (off, size)

    def _members(self):
        """(name, data offset, size) of each regular member."""
        out = []
        with tarfile.open(self.path, "r:") as tf:
            for m in tf:
                if m.isfile():
                    out.append((m.name, m.offset_data, m.size))
        fd = os.open(self.path, os.O_RDONLY)
        try:
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        except OSError:
            pass
        finally:
            os.close(fd)
        return out

    def __len__(self) -> int:
        return len(self.order)

    def plan(self, keys: Optional[List[str]] = None,
             exts: Optional[List[str]] = None) -> ReadPlan:
        keys = keys if keys is not None else self.order
        entries = []
        for k in keys:
            for ext, (off, ln) in self.samples[k].items():
                if exts is not None and ext not in exts:
                    continue
                entries.append(PlanEntry(key=f"{k}.{ext}", offset=off,
                                         length=ln))
        return ReadPlan(self.path, tuple(entries))


def write_wds_shard(path, samples: List[Dict[str, bytes]],
                    keys: Optional[List[str]] = None) -> None:
    """Write samples (each a {ext: payload} dict) as an uncompressed tar
    (keys default to the sample's index, 8 digits).  A checksum sidecar
    of an earlier file at ``path`` is removed first: its stamps are not
    the new bytes'."""
    from nvme_strom_tpu_torch.utils.checksum import sidecar_path
    try:
        os.unlink(sidecar_path(path))
    except OSError:
        pass
    with tarfile.open(path, "w", format=tarfile.USTAR_FORMAT) as tf:
        for i, sample in enumerate(samples):
            key = keys[i] if keys else f"{i:08d}"
            for ext, payload in sample.items():
                info = tarfile.TarInfo(name=f"{key}.{ext}")
                info.size = len(payload)
                tf.addfile(info, io.BytesIO(payload))
