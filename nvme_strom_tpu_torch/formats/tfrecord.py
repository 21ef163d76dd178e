"""TFRecord: index scan, read plans and a writer (counterpart of
nvme_strom_tpu/formats/tfrecord.py).

Wire format per record: ``u64le length | u32le masked_crc32c(length) |
payload | u32le masked_crc32c(payload)``.  Indexing reads only the
framing (one buffered pass); payloads are then planned as engine reads.
CRC32C is the engine's (``io/engine.py`` ``crc32c``).
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, Optional

import numpy as np

from nvme_strom_tpu_torch.formats.base import PlanEntry, ReadPlan
from nvme_strom_tpu_torch.io.engine import crc32c as _crc32c


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32C (Castagnoli) of ``data``; ``crc`` chains spans."""
    return _crc32c(np.frombuffer(bytes(data), np.uint8), crc)


def masked_crc(data: bytes) -> int:
    """TFRecord's masked CRC32C."""
    c = crc32c(data)
    return ((c >> 15 | c << 17) + 0xA282EAD8) & 0xFFFFFFFF


class TFRecordIndex:
    """Payload offsets and lengths of every record of a TFRecord file."""

    def __init__(self, path, verify_framing_crc: bool = False):
        self.path = str(path)
        self.offsets: list = []
        self.lengths: list = []
        fsize = os.path.getsize(self.path)
        pos = 0
        with open(self.path, "rb") as f:
            if f.read(2) == b"\x1f\x8b":
                raise ValueError(
                    f"{self.path}: gzip-compressed TFRecord has no random "
                    "access, so the direct-read path cannot serve it; "
                    "decompress the shards at prep time")
            f.seek(0)
            while True:
                hdr = f.read(12)
                if not hdr:
                    break
                if len(hdr) < 12:
                    raise ValueError(f"truncated framing at {pos}")
                (ln,) = struct.unpack("<Q", hdr[:8])
                (lcrc,) = struct.unpack("<I", hdr[8:])
                if verify_framing_crc and masked_crc(hdr[:8]) != lcrc:
                    raise ValueError(f"length crc mismatch at {pos}")
                if pos + 12 + ln + 4 > fsize:
                    raise ValueError(
                        f"record at {pos} claims {ln} payload bytes but the "
                        f"file ends at {fsize}: truncated or corrupt shard")
                self.offsets.append(pos + 12)
                self.lengths.append(ln)
                pos += 12 + ln + 4
                f.seek(pos)

    def __len__(self) -> int:
        return len(self.offsets)

    def plan(self, indices: Optional[list] = None) -> ReadPlan:
        idx = indices if indices is not None else range(len(self))
        return ReadPlan(self.path, tuple(
            PlanEntry(key=str(i), offset=self.offsets[i],
                      length=self.lengths[i]) for i in idx))


def read_records(path, verify: bool = True) -> Iterator[bytes]:
    """Every payload through buffered reads, each CRC checked when
    ``verify``: the integrity-check path, not the streaming one."""
    with open(path, "rb") as f:
        pos = 0
        while True:
            hdr = f.read(12)
            if not hdr:
                return
            (ln,) = struct.unpack("<Q", hdr[:8])
            payload = f.read(ln)
            (pcrc,) = struct.unpack("<I", f.read(4))
            if verify:
                (lcrc,) = struct.unpack("<I", hdr[8:])
                if masked_crc(hdr[:8]) != lcrc:
                    raise ValueError(f"length crc mismatch at {pos}")
                if masked_crc(payload) != pcrc:
                    raise ValueError(f"payload crc mismatch at {pos}")
            pos += 12 + ln + 4
            yield payload


def write_tfrecords(path, payloads) -> None:
    """Write each payload (bytes-like) as one record."""
    with open(path, "wb") as f:
        for p in payloads:
            p = bytes(p)
            hdr = struct.pack("<Q", len(p))
            f.write(hdr)
            f.write(struct.pack("<I", masked_crc(hdr)))
            f.write(p)
            f.write(struct.pack("<I", masked_crc(p)))
