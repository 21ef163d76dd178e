"""safetensors header parsing, ranged-read planning and writers
(counterpart of nvme_strom_tpu/formats/safetensors.py).

Format: ``u64le header_len | header_json | tensor data``; the JSON maps
tensor name → {"dtype", "shape", "data_offsets": [begin, end)} relative
to the end of the header.  Only the header is parsed; payload bytes are
planned as engine reads.  The writers take torch tensors (bfloat16
included) or numpy arrays.  ``write_safetensors_engine`` writes through
the engine's O_DIRECT path and stamps every tensor's CRC32C in
``__metadata__`` as the JAX writer does (``tensor_checksums`` reads the
stamps back); ``write_safetensors`` is the plain buffered writer.
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
            raw = pread_nopollute(self.path, 8, fd=fd)
            if len(raw) != 8:
                raise ValueError(f"{self.path}: truncated safetensors "
                                 "header")
            (hlen,) = struct.unpack("<Q", raw)
            if hlen > 100 << 20:
                raise ValueError(f"implausible safetensors header: {hlen}")
            header = json.loads(pread_nopollute(self.path, hlen, 8, fd=fd))
        finally:
            os.close(fd)
        self.data_start = 8 + hlen
        self.metadata = header.pop("__metadata__", {})
        # integrity stamps ride __metadata__ on disk but are not user
        # metadata: split them out, as the JAX reader does
        self._integrity = {
            k: self.metadata.pop(k) for k in list(self.metadata)
            if k.startswith(_CRC_PREFIX) or k == _CRC_ALGO_KEY}
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

#: __metadata__ key prefix of the per-tensor CRC32C stamps and the
#: algorithm tag beside them (the JAX writer's keys)
_CRC_PREFIX = "crc32c."
_CRC_ALGO_KEY = "checksum_algo"
CRC_ALGO = "crc32c"


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """The bytes of a contiguous CPU tensor as a uint8 numpy view."""
    return t.reshape(-1).view(torch.uint8).numpy()


def _checksum_metadata(tensors: Dict[str, torch.Tensor]) -> dict:
    from nvme_strom_tpu_torch.io.engine import crc32c
    meta = {_CRC_ALGO_KEY: CRC_ALGO}
    for name, t in tensors.items():
        meta[_CRC_PREFIX + name] = str(crc32c(_host_bytes(t)))
    return meta


def tensor_checksums(sf: SafetensorsFile) -> Dict[str, int]:
    """The stamped per-tensor CRC32C of a parsed file ({} when the file
    carries no stamps or another algorithm's)."""
    md = sf._integrity
    if md.get(_CRC_ALGO_KEY) != CRC_ALGO:
        return {}
    out = {}
    for k, v in md.items():
        if k.startswith(_CRC_PREFIX):
            try:
                out[k[len(_CRC_PREFIX):]] = int(v)
            except ValueError:
                continue
    return out


def build_header(tensors: Dict[str, torch.Tensor],
                 metadata: Optional[dict] = None,
                 align: int = DATA_ALIGN) -> bytes:
    """The header for ``tensors`` (insertion order), padded with JSON
    spaces (spec-legal) so the data section starts on an ``align``
    boundary."""
    header: Dict[str, dict] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v)
                                  for k, v in metadata.items()}
    pos = 0
    for name, t in tensors.items():
        if t.dtype not in _TAG_OF:
            raise TypeError(f"{name}: unsupported dtype {t.dtype}")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _TAG_OF[t.dtype], "shape": list(t.shape),
                        "data_offsets": [pos, pos + nbytes]}
        pos += nbytes
    hjson = json.dumps(header, separators=(",", ":")).encode()
    hjson += b" " * ((-(8 + len(hjson))) % max(align, 8))
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


def _aligned_scratch(nbytes: int, align: int) -> np.ndarray:
    """A uint8 buffer whose data pointer is ``align``-aligned."""
    raw = np.empty(nbytes + align, np.uint8)
    off = (-raw.ctypes.data) % align
    return raw[off:off + nbytes]


def write_safetensors_engine(path, tensors: Dict[str, object], engine,
                             metadata: Optional[dict] = None) -> None:
    """safetensors over the engine's O_DIRECT write path.

    The header is padded so the data section starts aligned; the data
    section streams as whole aligned chunks copied into rotating
    aligned scratch buffers (one host copy, counted as bounce) that the
    engine writes O_DIRECT, ``queue_depth`` writes in flight; only the
    last partial chunk (or everything, on a filesystem without
    O_DIRECT) goes through the page cache.  Every tensor's CRC32C is
    stamped in ``__metadata__``.  The bytes are on disk (fdatasync)
    when this returns."""
    cpu = {n: _as_cpu_tensor(a) for n, a in tensors.items()}
    align = engine.config.alignment
    md = dict(metadata or {})
    md.update(_checksum_metadata(cpu))
    head = build_header(cpu, md, align=align)
    open(path, "wb").close()           # truncate a previous file
    fh = engine.open(path, writable=True)
    # direct chunks and buffered spans must never share a page
    direct_ok = (engine.file_is_direct(fh)
                 and align % os.sysconf("SC_PAGESIZE") == 0)
    chunk = engine.config.chunk_bytes
    depth = engine.config.queue_depth
    n_scratch = max(2, min(depth, engine.n_buffers))
    scratches: list = [None] * n_scratch
    free_idx = list(range(n_scratch))
    pend: list = []                     # (PendingWrite, scratch index)

    def drain_one():
        p, sidx = pend.pop(0)
        p.wait()
        if sidx is not None:
            free_idx.append(sidx)

    try:
        pend.append((engine.submit_write(
            fh, 0, np.frombuffer(head, np.uint8)), None))
        data_start = len(head)
        parts = [_host_bytes(t) for t in cpu.values()]
        total = sum(p.nbytes for p in parts)
        n_full = total // chunk if direct_ok else 0
        stream = iter(parts)
        cur = next(stream, np.empty(0, np.uint8))
        cur_pos = 0
        for ci in range(n_full):
            while not free_idx:
                drain_one()
            sidx = free_idx.pop()
            if scratches[sidx] is None:
                scratches[sidx] = _aligned_scratch(chunk, align)
            buf = scratches[sidx]
            filled = 0
            while filled < chunk:
                if cur_pos >= cur.nbytes:
                    cur, cur_pos = next(stream), 0
                n = min(chunk - filled, cur.nbytes - cur_pos)
                buf[filled:filled + n] = cur[cur_pos:cur_pos + n]
                filled += n
                cur_pos += n
            engine.stats.add(bounce_bytes=chunk)
            pend.append((engine.submit_write(
                fh, data_start + ci * chunk, buf), sidx))
        pos = data_start + n_full * chunk
        tail = ([cur[cur_pos:]] if cur_pos < cur.nbytes else []) + \
            list(stream)
        for part in tail:
            for p0 in range(0, part.nbytes, chunk):
                piece = part[p0:p0 + chunk]
                pend.append((engine.submit_write(fh, pos, piece), None))
                pos += piece.nbytes
                if len(pend) >= depth:
                    drain_one()
        while pend:
            drain_one()
    finally:
        for p, _ in pend:              # in-flight writes target fh
            try:
                p.wait()
            except OSError:
                pass
        engine.close(fh)
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fdatasync(fd)
    finally:
        os.close(fd)
