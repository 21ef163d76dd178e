"""Fixed-size-record shards, the loader's zero-copy format (counterpart
of nvme_strom_tpu/formats/fixedrec.py).

Records of one byte size packed back to back with a small JSON footer,
so any run of records is one contiguous file span that the engine reads
O_DIRECT into staging and the bridge copies to the device untouched:

    [record 0][record 1]…[record n-1][json meta][8B LE meta len][SFR1]

The footer is read with ordinary buffered I/O once; payload reads go
through the engine.  The bytes equal the JAX package's.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Iterable, Union

import numpy as np

MAGIC = b"SFR1"
_TAIL = struct.Struct("<Q4s")   # meta length + magic


def write_fixedrec(path: Union[str, os.PathLike],
                   records: Union[np.ndarray, Iterable[bytes]],
                   dtype=None, shape=None,
                   checksums: bool = False) -> int:
    """Write records to ``path``; returns the record count.

    ``records``: an (n, *shape) array (its dtype and record shape go in
    the footer) or equal-length bytes objects (uint8 vectors).  The file
    is written under a temporary name and renamed into place; an earlier
    checksum sidecar is removed first.  ``checksums=True`` stamps a
    per-record CRC32C sidecar (``<path>.crc.json``): the zero-copy read
    path never sees payload bytes on the host, so its integrity check is
    the offline scrubber's, against these stamps."""
    if isinstance(records, np.ndarray):
        if records.ndim < 1:
            raise ValueError("records array must have a leading dim")
        dtype = records.dtype
        shape = records.shape[1:]
        payload = [memoryview(np.ascontiguousarray(records)).cast("B")]
        count = records.shape[0]
        rec_bytes = records.dtype.itemsize * int(
            np.prod(shape, dtype=np.int64)) if shape else \
            records.dtype.itemsize
    else:
        payload = [memoryview(r) for r in records]
        if not payload:
            raise ValueError("no records")
        rec_bytes = payload[0].nbytes
        if any(r.nbytes != rec_bytes for r in payload):
            raise ValueError("records must be one fixed size")
        count = len(payload)
        if dtype is None:
            dtype, shape = np.dtype(np.uint8), (rec_bytes,)
    meta = json.dumps({
        "record_bytes": rec_bytes, "count": count,
        "dtype": np.dtype(dtype).str,
        "shape": list(shape if shape is not None else (rec_bytes,)),
    }).encode()
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        for p in payload:
            f.write(p)
        f.write(meta)
        f.write(_TAIL.pack(len(meta), MAGIC))
        f.flush()
        os.fsync(f.fileno())
    from nvme_strom_tpu_torch.utils.checksum import (sidecar_path,
                                                     write_sidecar)
    try:
        os.unlink(sidecar_path(path))
    except OSError:
        pass
    os.replace(tmp, path)
    if checksums:
        flat = payload[0] if len(payload) == 1 else None

        def spans():
            if flat is not None:
                for i in range(count):
                    yield (i * rec_bytes, rec_bytes,
                           flat[i * rec_bytes:(i + 1) * rec_bytes])
            else:
                for i, p in enumerate(payload):
                    yield i * rec_bytes, rec_bytes, p

        write_sidecar(path, ((o, n, np.frombuffer(p, np.uint8))
                             for o, n, p in spans()))
    return count


class FixedRecIndex:
    """The footer of one fixedrec shard: ``record_bytes``, ``count``,
    ``dtype``, ``shape``; ``span(i, n)`` is the (offset, length) of
    records [i, i + n), always one contiguous range."""

    def __init__(self, path: Union[str, os.PathLike]):
        self.path = str(path)
        with open(self.path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            if size < _TAIL.size:
                raise ValueError(f"{self.path}: not a fixedrec file")
            f.seek(size - _TAIL.size)
            meta_len, magic = _TAIL.unpack(f.read(_TAIL.size))
            if magic != MAGIC:
                raise ValueError(f"{self.path}: bad magic {magic!r}")
            f.seek(size - _TAIL.size - meta_len)
            meta = json.loads(f.read(meta_len))
        self.record_bytes = int(meta["record_bytes"])
        self.count = int(meta["count"])
        self.dtype = np.dtype(meta["dtype"])
        self.shape = tuple(meta["shape"])
        if self.record_bytes * self.count > size - _TAIL.size - meta_len:
            raise ValueError(f"{self.path}: truncated payload")

    def span(self, i: int, n: int) -> tuple:
        if i < 0 or i + n > self.count:
            raise IndexError(f"records [{i},{i + n}) out of "
                             f"[0,{self.count})")
        return i * self.record_bytes, n * self.record_bytes

    def __len__(self) -> int:
        return self.count
