"""Read-plan primitives of the format readers (counterpart of
nvme_strom_tpu/formats/base.py): metadata is read with small buffered
reads that leave no page-cache residue; payload ranges are planned for
the engine."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional


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
