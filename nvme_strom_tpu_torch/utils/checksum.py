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

Record formats are stamped by an offset-keyed sidecar next to the data
file, ``<file>.crc.json`` (``write_sidecar``, ``stamp_wds``,
``stamp_fixedrec``, ``stamp_tfrecord``; read back by ``load_sidecar``),
in the JAX package's format, so either package reads
what the other wrote; the WebDataset loader checks each sample part
against it.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from nvme_strom_tpu_torch.io.engine import crc32c
from nvme_strom_tpu_torch.utils.lockwitness import make_lock

_log = logging.getLogger(__name__)

VERIFY_MODES = ("off", "sample", "full")

#: the stamp algorithm a sidecar names
CRC_ALGO = "crc32c"


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
        self._lock = make_lock("checksum.VerifyPolicy._lock")

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


# -- offset-keyed sidecars --------------------------------------------------

SIDECAR_SUFFIX = ".crc.json"
_SIDECAR_VERSION = 1


def sidecar_path(path) -> str:
    return str(path) + SIDECAR_SUFFIX


def write_sidecar(path, spans: Iterable[Tuple[int, int, object]]) -> str:
    """Stamp ``path`` with an offset-keyed checksum sidecar: ``spans``
    are (offset, length, payload) triples, one a separately read span
    (a tar member, a record).  Written atomically next to the file."""
    entries: Dict[str, list] = {}
    for off, length, payload in spans:
        arr = (payload if isinstance(payload, np.ndarray)
               else np.frombuffer(payload, np.uint8))
        entries[str(int(off))] = [int(length), crc32c(arr)]
    out = sidecar_path(path)
    tmp = f"{out}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"version": _SIDECAR_VERSION, "algo": CRC_ALGO,
                   "spans": entries}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, out)
    return out


class Sidecar:
    """A parsed ``<file>.crc.json``: span offset → (length, crc32c)."""

    def __init__(self, path):
        self.path = str(path)
        with open(self.path) as f:
            doc = json.load(f)
        if doc.get("version") != _SIDECAR_VERSION:
            raise ValueError(f"{self.path}: unsupported sidecar version "
                             f"{doc.get('version')}")
        self.algo = doc.get("algo", CRC_ALGO)
        if self.algo != CRC_ALGO:
            raise ValueError(f"{self.path}: sidecar algo {self.algo!r} is "
                             f"not {CRC_ALGO!r}")
        self.spans: Dict[int, Tuple[int, int]] = {
            int(k): (int(v[0]), int(v[1]))
            for k, v in doc.get("spans", {}).items()}

    def lookup(self, offset: int, length: int) -> Optional[int]:
        """The stamp of the span at ``offset``; None when there is none
        or its length differs (an unstamped span is not a failure)."""
        ent = self.spans.get(int(offset))
        if ent is None or ent[0] != int(length):
            return None
        return ent[1]

    def __len__(self) -> int:
        return len(self.spans)


def load_sidecar(path) -> Optional[Sidecar]:
    """The sidecar of data file ``path``; None when it is absent or
    unreadable (unstamped data verifies nothing)."""
    sc = sidecar_path(path)
    if not os.path.exists(sc):
        return None
    try:
        return Sidecar(sc)
    except (OSError, ValueError):
        return None


def stamp_wds(path) -> str:
    """Stamp a WebDataset tar shard: one span a member payload."""
    from nvme_strom_tpu_torch.formats.wds import WdsShardIndex
    idx = WdsShardIndex(path)

    def spans():
        with open(path, "rb") as f:
            for key in idx.order:
                for _ext, (off, ln) in idx.samples[key].items():
                    f.seek(off)
                    yield off, ln, f.read(ln)

    return write_sidecar(path, spans())


def stamp_fixedrec(path) -> str:
    """Stamp a fixedrec shard: one span a record."""
    from nvme_strom_tpu_torch.formats.fixedrec import FixedRecIndex
    idx = FixedRecIndex(path)
    rb = idx.record_bytes

    def spans():
        with open(path, "rb") as f:
            for i in range(idx.count):
                f.seek(i * rb)
                yield i * rb, rb, f.read(rb)

    return write_sidecar(path, spans())


def stamp_tfrecord(path) -> str:
    """Stamp a TFRecord shard: one span a record payload."""
    from nvme_strom_tpu_torch.formats.tfrecord import TFRecordIndex
    idx = TFRecordIndex(path)

    def spans():
        with open(path, "rb") as f:
            for off, ln in zip(idx.offsets, idx.lengths):
                f.seek(off)
                yield off, ln, f.read(ln)

    return write_sidecar(path, spans())
