"""safetensors header parsing, ranged-read planning and a writer
(counterpart of nvme_strom_tpu/formats/safetensors.py).

Format: ``u64le header_len | header_json | tensor data``; the JSON maps
tensor name → {"dtype", "shape", "data_offsets": [begin, end)} relative
to the end of the header.  Only the header is parsed; payload bytes are
planned as engine reads.  The writer takes torch tensors (bfloat16
included) or numpy arrays.  The JAX writer's per-tensor CRC32C stamps
are not written by this port yet.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from nvme_strom_tpu_torch.formats.base import (PlanEntry, ReadPlan,
                                               pread_nopollute)

#: safetensors dtype tag → (dtype name, torch dtype)
_DTYPES: Dict[str, tuple] = {
    "BOOL": ("bool", torch.bool), "U8": ("uint8", torch.uint8),
    "I8": ("int8", torch.int8), "I16": ("int16", torch.int16),
    "I32": ("int32", torch.int32), "I64": ("int64", torch.int64),
    "F16": ("float16", torch.float16), "BF16": ("bfloat16", torch.bfloat16),
    "F32": ("float32", torch.float32), "F64": ("float64", torch.float64),
}
_TAG_OF = {td: tag for tag, (_, td) in _DTYPES.items()}
TORCH_DTYPES = {name: td for name, td in _DTYPES.values()}


def torch_dtype(name: str) -> torch.dtype:
    """Torch dtype of a header dtype name ("bfloat16", "float32", ...)."""
    try:
        return TORCH_DTYPES[name]
    except KeyError:
        raise TypeError(f"unsupported safetensors dtype {name!r}") from None


def itemsize(name: str) -> int:
    return torch.empty(0, dtype=torch_dtype(name)).element_size()


class SafetensorsFile:
    """Lazily parsed safetensors header; never reads tensor payloads."""

    def __init__(self, path):
        self.path = str(path)
        fd = os.open(self.path, os.O_RDONLY)
        try:
            (hlen,) = struct.unpack("<Q", pread_nopollute(self.path, 8,
                                                          fd=fd))
            if hlen > 100 << 20:
                raise ValueError(f"implausible safetensors header: {hlen}")
            header = json.loads(pread_nopollute(self.path, hlen, 8, fd=fd))
        finally:
            os.close(fd)
        self.data_start = 8 + hlen
        self.metadata = header.pop("__metadata__", {})
        self.tensors: Dict[str, dict] = {}
        for name, info in header.items():
            begin, end = info["data_offsets"]
            tag = info["dtype"]
            self.tensors[name] = {
                "dtype": _DTYPES[tag][0] if tag in _DTYPES else tag.lower(),
                "shape": tuple(info["shape"]),
                "offset": self.data_start + begin,
                "nbytes": end - begin,
            }

    def keys(self):
        return self.tensors.keys()

    def plan(self, names: Optional[Sequence[str]] = None) -> ReadPlan:
        names = list(names) if names is not None else list(self.tensors)
        return ReadPlan(self.path, tuple(
            PlanEntry(key=n, offset=self.tensors[n]["offset"],
                      length=self.tensors[n]["nbytes"],
                      dtype=self.tensors[n]["dtype"],
                      shape=self.tensors[n]["shape"]) for n in names))

    def slice_plan(self, name: str, start_row: int, num_rows: int
                   ) -> PlanEntry:
        """Byte range of rows [start_row, start_row+num_rows): rows
        along axis 0 are contiguous on disk."""
        t = self.tensors[name]
        shape = t["shape"]
        if not shape:
            raise ValueError(f"{name} is a scalar; cannot row-slice")
        if start_row < 0 or start_row + num_rows > shape[0]:
            raise ValueError(
                f"rows [{start_row}, {start_row + num_rows}) out of bounds "
                f"for {name} with shape {shape}")
        row_bytes = int(np.prod(shape[1:], dtype=np.int64)) \
            * itemsize(t["dtype"])
        return PlanEntry(key=name, offset=t["offset"] + start_row * row_bytes,
                         length=num_rows * row_bytes, dtype=t["dtype"],
                         shape=(num_rows,) + tuple(shape[1:]))


def _as_cpu_tensor(arr) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr.detach().to("cpu").contiguous()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(arr)))


#: the data section starts on an O_DIRECT block boundary
DATA_ALIGN = 4096


def build_header(tensors: Dict[str, torch.Tensor]) -> bytes:
    """The header for ``tensors`` (insertion order), padded with JSON
    spaces (spec-legal) so the data section starts on a ``DATA_ALIGN``
    boundary."""
    header: Dict[str, dict] = {}
    pos = 0
    for name, t in tensors.items():
        if t.dtype not in _TAG_OF:
            raise TypeError(f"{name}: unsupported dtype {t.dtype}")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _TAG_OF[t.dtype], "shape": list(t.shape),
                        "data_offsets": [pos, pos + nbytes]}
        pos += nbytes
    hjson = json.dumps(header, separators=(",", ":")).encode()
    hjson += b" " * ((-(8 + len(hjson))) % DATA_ALIGN)
    return struct.pack("<Q", len(hjson)) + hjson


def write_safetensors(path, tensors: Dict[str, object]) -> None:
    """Write ``tensors`` (torch or numpy) as one safetensors file.  The
    bytes are on disk when this returns (fdatasync) and dropped from the
    page cache, so a following engine read takes the O_DIRECT path."""
    cpu = {n: _as_cpu_tensor(a) for n, a in tensors.items()}
    head = build_header(cpu)
    with open(path, "wb") as f:
        f.write(head)
        for t in cpu.values():
            f.write(t.reshape(-1).view(torch.uint8).numpy().tobytes())
        f.flush()
        os.fdatasync(f.fileno())
        try:
            os.posix_fadvise(f.fileno(), 0, 0, os.POSIX_FADV_DONTNEED)
        except OSError:
            pass
