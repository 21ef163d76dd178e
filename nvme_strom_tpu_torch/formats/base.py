"""Read-plan primitives of the format readers (counterpart of
nvme_strom_tpu/formats/base.py): metadata is read with small buffered
reads that leave no page-cache residue; payload ranges are planned for
the engine."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence


def pread_nopollute(path: str, length: int, offset: int = 0,
                    fd: Optional[int] = None) -> bytes:
    """Read header bytes without leaving them in the page cache: a
    resident span makes the engine choose the buffered path for the
    payload reads that follow.  Readahead is suppressed and the touched
    pages (rounded out to page boundaries) are dropped afterwards."""
    close = fd is None
    if fd is None:
        fd = os.open(path, os.O_RDONLY)
    try:
        try:
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_RANDOM)
        except OSError:
            pass
        out = os.pread(fd, length, offset)
        lo = offset & ~4095
        hi = (offset + len(out) + 4095) & ~4095
        try:
            os.posix_fadvise(fd, lo, hi - lo, os.POSIX_FADV_DONTNEED)
        except OSError:
            pass
        return out
    finally:
        if close:
            os.close(fd)


@dataclass(frozen=True)
class PlanEntry:
    """One contiguous payload range inside a file."""

    key: str
    offset: int
    length: int
    dtype: Optional[str] = None
    shape: Optional[tuple] = None


@dataclass(frozen=True)
class ReadPlan:
    path: str
    entries: tuple

    def ranges(self) -> list:
        """Each entry's (offset, length), in plan order."""
        return [(e.offset, e.length) for e in self.entries]

    def subset(self, keys: Sequence[str]) -> "ReadPlan":
        """The entries named in ``keys``, in plan order; raises KeyError
        naming any key the plan lacks."""
        keep = set(keys)
        entries = tuple(e for e in self.entries if e.key in keep)
        missing = keep - {e.key for e in entries}
        if missing:
            raise KeyError(f"keys not in plan: {sorted(missing)}")
        return ReadPlan(self.path, entries)
