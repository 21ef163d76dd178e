"""NumPy ``.npy`` files and stored ``.npz`` archives, payload straight to
the device (counterpart of nvme_strom_tpu/formats/npy.py).

One header and one contiguous payload: the header is read with
``pread_nopollute`` (buffered, leaving no page-cache residue), the
payload is planned as ranges the engine reads O_DIRECT into its staging
buffers, ``DeviceStream.stream_ranges`` copies each range to the device
with ``h2d_copy``, and the "decode" is a view of the bytes as the
header's dtype and shape there.  Fortran-ordered, object, structured and
big-endian arrays are refused with a reason.

An ``.npz`` is planned from the zip's central directory: each STORED
member's payload starts past its local header; a compressed member is
refused (its bytes need a host decode).

8-byte dtypes (int64, uint64, float64, complex64) are read bitwise: torch
has them, so nothing truncates.  The JAX package refuses them unless
JAX's x64 mode is on.
"""

from __future__ import annotations

import ast
import os
import struct
import zipfile
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from nvme_strom_tpu_torch.formats.base import (PlanEntry, ReadPlan,
                                               pread_nopollute)

_MAGIC = b"\x93NUMPY"


class _HeaderWindow(ValueError):
    """The header runs past the bytes read; ``needed`` bytes hold it."""

    def __init__(self, needed: int):
        super().__init__(f"header needs {needed} bytes")
        self.needed = needed


def _parse_npy_header(buf: bytes) -> Tuple[dict, int]:
    """(header dict, payload offset) of a version 1, 2 or 3 header;
    ValueError on anything else, :class:`_HeaderWindow` when ``buf``
    stops inside the header."""
    if buf[:6] != _MAGIC:
        raise ValueError("not a .npy file (bad magic)")
    major = buf[6]
    if major == 1:
        (hlen,) = struct.unpack_from("<H", buf, 8)
        start = 10
    elif major in (2, 3):
        (hlen,) = struct.unpack_from("<I", buf, 8)
        start = 12
    else:
        raise ValueError(f"unsupported .npy version {major}")
    if start + hlen > len(buf):
        raise _HeaderWindow(start + hlen)
    header = ast.literal_eval(buf[start:start + hlen].decode("latin1"))
    return header, start + hlen


def plan_npy(path, name: Optional[str] = None, base_offset: int = 0,
             header_window: int = 4096, read_at=None) -> PlanEntry:
    """The payload entry of one .npy file, or of a member whose header
    starts at ``base_offset`` (``read_at(offset, length) -> bytes``
    reads the header; default ``pread_nopollute`` on ``path``)."""
    if read_at is None:
        def read_at(off: int, ln: int) -> bytes:
            return pread_nopollute(str(path), ln, off)
    buf = read_at(base_offset, header_window)
    try:
        header, payload_off = _parse_npy_header(buf)
    except _HeaderWindow as hw:
        # a corrupt length field must not drive a huge read: any real
        # header is far smaller, and a still-short buffer raises plainly
        buf = read_at(base_offset, min(hw.needed, 1 << 26))
        header, payload_off = _parse_npy_header(buf)
    descr, shape = header["descr"], tuple(header["shape"])
    if header.get("fortran_order"):
        raise ValueError("fortran_order arrays need a host transpose — "
                         "load via numpy instead")
    dt = np.dtype(descr)
    if dt.hasobject:
        raise ValueError("object arrays are pickle payloads, not raw "
                         "bytes")
    if dt.names is not None or dt.kind == "V":
        raise ValueError(f"structured dtype {descr!r} has no device "
                         "representation — load via numpy instead")
    if dt.byteorder == ">":
        raise ValueError(f"big-endian dtype {descr!r}: the device view is "
                         "little-endian — byteswap and re-save, or load "
                         "via numpy")
    length = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
    return PlanEntry(key=name or str(path),
                     offset=base_offset + payload_off, length=length,
                     dtype=dt.str, shape=shape)


def plan_npz(path) -> ReadPlan:
    """One entry per member of a .npz archive, keyed by the member name
    without ``.npy``; a compressed member raises."""
    entries = []
    with zipfile.ZipFile(path) as z, open(path, "rb") as f:
        fd = f.fileno()

        def read_at(off: int, ln: int) -> bytes:
            return pread_nopollute(str(path), ln, off, fd=fd)

        for info in z.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(
                    f"member {info.filename!r} is compressed (type "
                    f"{info.compress_type}): a host decode; use np.load "
                    "or save with np.savez (uncompressed)")
            # the local header: 30 fixed bytes, the name, the extra field
            lh = read_at(info.header_offset, 30)
            if lh[:4] != b"PK\x03\x04":
                raise ValueError(f"bad local header for {info.filename!r}")
            nlen, elen = struct.unpack_from("<HH", lh, 26)
            name = info.filename
            if name.endswith(".npy"):
                name = name[:-4]
            entries.append(plan_npy(
                path, name=name,
                base_offset=info.header_offset + 30 + nlen + elen,
                read_at=read_at))
    return ReadPlan(str(path), tuple(entries))


def read_npy_to_device(engine, path, device=None) -> torch.Tensor:
    """A whole .npy array on ``device`` (default ``cuda:0``), its
    payload streamed through the engine and ``h2d_copy``."""
    out = _read_plan_to_device(engine, path,
                               ReadPlan(str(path), (plan_npy(path),)),
                               device)
    return next(iter(out.values()))


def read_npz_to_device(engine, path, device=None,
                       keys=None) -> Dict[str, torch.Tensor]:
    """.npz members (all, or ``keys``) → {name: tensor on ``device``},
    every member's ranges in one stream, so the queue stays full across
    member boundaries."""
    plan = plan_npz(path)
    if keys is not None:
        plan = plan.subset(list(keys))
    return _read_plan_to_device(engine, path, plan, device)


def _read_plan_to_device(engine, path, plan: ReadPlan,
                         device=None) -> Dict[str, torch.Tensor]:
    from nvme_strom_tpu_torch.ops.bridge import (DeviceStream, split_ranges,
                                                 torch_dtype)
    ds = DeviceStream(engine, device=device,
                      depth=engine.config.queue_depth)
    ranges, counts = split_ranges(plan.ranges(), engine.config.chunk_bytes)
    out: Dict[str, torch.Tensor] = {}
    fh = engine.open(path)
    try:
        it = ds.stream_ranges(fh, ranges)
        for entry, n in zip(plan.entries, counts):
            parts = [next(it) for _ in range(n)]
            if not parts:
                flat = torch.zeros(0, dtype=torch.uint8, device=ds.device)
            else:
                flat = parts[0] if len(parts) == 1 else torch.cat(parts)
            out[entry.key] = flat.view(torch_dtype(entry.dtype)).reshape(
                entry.shape)
    finally:
        engine.close(fh)
    return out
