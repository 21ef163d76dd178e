"""Read-side payload integrity: the ``STROM_VERIFY`` policy and its
re-read-once protocol (counterpart of nvme_strom_tpu/utils/checksum.py
``ChecksumError``, ``verify_mode``, ``sample_every`` and
``VerifyPolicy``).

``STROM_VERIFY`` is ``off`` (the default: no CRC work, the direct path
untouched), ``sample`` (every ``STROM_VERIFY_SAMPLE``-th eligible span,
default 16) or ``full`` (every eligible span).  Verified bytes count
``bytes_verified``; a mismatch counts ``checksum_failures`` and raises
:class:`ChecksumError`, an ``OSError``, so a consumer's damage path (the
KV prefix store's recompute, a checkpoint restore's step back) treats it
as a failed read.  CRC32C is the engine's (``io/engine.py`` ``crc32c``).

The sidecar files of the JAX package (offset-keyed ``.crc.json`` stamps
for record formats) belong to the loader's verify and are not part of
this port yet.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional

import numpy as np

from nvme_strom_tpu_torch.io.engine import crc32c

_log = logging.getLogger(__name__)

VERIFY_MODES = ("off", "sample", "full")


class ChecksumError(OSError):
    """A stamped checksum did not match the bytes read.  An OSError, so
    every damage path treats it as a failed read."""


def verify_mode() -> str:
    """``$STROM_VERIFY`` → off (default) | sample | full."""
    mode = os.environ.get("STROM_VERIFY", "off").strip().lower()
    if mode in ("", "0", "no", "false"):
        return "off"
    if mode in ("1", "yes", "true", "on"):
        return "full"
    if mode not in VERIFY_MODES:
        raise ValueError(
            f"STROM_VERIFY={mode!r}: expected one of {VERIFY_MODES}")
    return mode


def sample_every() -> int:
    try:
        return max(1, int(os.environ.get("STROM_VERIFY_SAMPLE", 16)))
    except ValueError:
        return 16


class VerifyPolicy:
    """One consumer's verification gate, read from the environment once
    at construction so that its behaviour cannot change mid-run."""

    def __init__(self, mode: Optional[str] = None):
        self.mode = mode if mode is not None else verify_mode()
        self._every = sample_every()
        self._seen = 0
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self.mode != "off"

    def want(self) -> bool:
        """Whether the next eligible span is verified: always under
        ``full``, every Nth call under ``sample`` (one counter shared by
        the consumer's threads)."""
        if self.mode == "off":
            return False
        if self.mode == "full":
            return True
        with self._lock:
            self._seen += 1
            return self._seen % self._every == 0

    def check(self, data, expected: int, stats=None, *,
              where: str = "") -> None:
        """Verify ``data`` (a numpy array or bytes) against the
        ``expected`` CRC32C; counts ``bytes_verified`` and
        ``checksum_failures`` on ``stats`` and raises
        :class:`ChecksumError` on a mismatch."""
        arr = (data if isinstance(data, np.ndarray)
               else np.frombuffer(data, np.uint8))
        got = crc32c(arr)
        if stats is not None:
            stats.add(bytes_verified=int(arr.nbytes))
        if got != expected:
            if stats is not None:
                stats.add(checksum_failures=1)
            raise ChecksumError(
                f"checksum mismatch{' for ' + where if where else ''}: "
                f"crc32c {got:#010x} != stamped {expected:#010x} "
                f"({arr.nbytes} bytes)")

    def check_with_reread(self, data, expected: int, reread, stats=None,
                          *, where: str = "", spoil=None):
        """Verify ``data``; on a mismatch call ``spoil`` (when given: a
        host-tier invalidation, so the re-read cannot be served the same
        bytes from memory), re-read once with ``reread()`` and verify
        again.  A transient corruption heals here; a second mismatch
        raises :class:`ChecksumError`.  Returns the verified payload."""
        try:
            self.check(data, expected, stats, where=where)
            return data
        except ChecksumError:
            _log.warning("checksum mismatch for %s; re-reading once",
                         where or "span")
        if spoil is not None:
            try:
                spoil()
            except Exception:
                pass        # the heal goes on even if spoiling fails
        data = reread()
        self.check(data, expected, stats,
                   where=where + " (after a re-read)")
        return data
