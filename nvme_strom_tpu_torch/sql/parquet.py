"""Parquet scan through the strom-io engine (counterpart of
nvme_strom_tpu/sql/parquet.py), with no pyarrow.

:class:`ParquetScanner` reads the footer with the port's own Thrift
reader (sql/pqmeta.py) and plans the scan's byte ranges.  The direct path
is sql/pq_direct.py.  The host path, which takes the place of the JAX
package's pyarrow fallback, reads each selected column chunk through
:class:`EngineFile` (engine reads, counted as bounce: the host decodes
them) and decodes it with numpy: PLAIN (fixed width, BYTE_ARRAY and
BOOLEAN), dictionary, BYTE_STREAM_SPLIT and definition levels, under the
GZIP and SNAPPY codecs.  What neither path decodes (repeated or nested
fields, the DELTA encodings, INT96 and FIXED_LEN_BYTE_ARRAY, ZSTD,
BROTLI and LZ4) raises ``NotImplementedError`` naming the column and the
reason: the scan never returns a silent or approximate answer.
"""

from __future__ import annotations

import io
import struct
from typing import Dict, List, Optional

import numpy as np
import torch

from nvme_strom_tpu_torch.formats.base import (PlanEntry, ReadPlan,
                                               pread_nopollute)
from nvme_strom_tpu_torch.io.engine import StromEngine
from nvme_strom_tpu_torch.sql import codecs, pqmeta


class EngineFile(io.RawIOBase):
    """Read-only file-like view over an engine file handle.  Each serviced
    byte is copied once out of the staging buffers; that copy is counted
    as bounce."""

    def __init__(self, engine: StromEngine, path):
        super().__init__()
        self.engine = engine
        self.path = str(path)
        self._fh = engine.open(path)
        self._size = engine.file_size(self._fh)
        self._pos = 0

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def seek(self, offset: int, whence: int = io.SEEK_SET) -> int:
        if whence == io.SEEK_SET:
            self._pos = offset
        elif whence == io.SEEK_CUR:
            self._pos += offset
        elif whence == io.SEEK_END:
            self._pos = self._size + offset
        else:
            raise ValueError(f"bad whence {whence}")
        return self._pos

    def tell(self) -> int:
        return self._pos

    def readinto(self, b) -> int:
        n = min(len(b), self._size - self._pos)
        if n <= 0:
            return 0
        eng = self.engine
        chunk = eng.config.chunk_bytes
        pend = [eng.submit_read(self._fh, self._pos + o,
                                min(chunk, n - o), klass="scan")
                for o in range(0, n, chunk)]
        pos = 0
        mv = memoryview(b).cast("B")
        try:
            while pend:
                p = pend.pop(0)
                view = p.wait()
                mv[pos:pos + view.nbytes] = view  # single handoff copy
                pos += view.nbytes
                p.release()
        finally:
            for p in pend:
                p.release()
        eng.stats.add(bounce_bytes=pos)
        self._pos += pos
        return pos

    def read_at(self, offset: int, length: int) -> bytes:
        self.seek(offset)
        buf = bytearray(length)
        got = self.readinto(buf)
        return bytes(buf[:got])

    def close(self) -> None:
        if not self.closed and getattr(self, "_fh", None) is not None:
            self.engine.close(self._fh)
            self._fh = None
        super().close()

    @property
    def size(self) -> int:
        return self._size


class ParquetScanner:
    """Row-group scan planning, the direct path's entry, and the host
    path."""

    def __init__(self, path, engine: StromEngine):
        self.path = str(path)
        self.engine = engine
        # the footer is metadata: buffered reads that leave no residue
        self.metadata = pqmeta.read_metadata(
            self.path, read_at=lambda off, ln: pread_nopollute(self.path,
                                                               ln, off))
        self.schema = self.metadata.schema

    @property
    def num_row_groups(self) -> int:
        return self.metadata.num_row_groups

    @property
    def num_rows(self) -> int:
        return self.metadata.num_rows

    def _ci(self) -> Dict[str, int]:
        return {self.metadata.schema.column(i).name: i
                for i in range(self.metadata.num_columns)}

    def plan(self, columns: Optional[List[str]] = None) -> ReadPlan:
        """Byte ranges of the selected column chunks, per row group — the
        scan's I/O footprint."""
        known = set(self._ci())
        names = columns or sorted(known)
        missing = set(names) - known
        if missing:
            raise KeyError(f"columns not in schema: {sorted(missing)}")
        entries = []
        for rg in range(self.metadata.num_row_groups):
            g = self.metadata.row_group(rg)
            for ci in range(g.num_columns):
                col = g.column(ci)
                name = col.path_in_schema
                if name not in names:
                    continue
                entries.append(PlanEntry(
                    key=f"rg{rg}.{name}", offset=_chunk_start(col),
                    length=col.total_compressed_size))
        return ReadPlan(self.path, tuple(entries))

    def iter_row_groups(self, columns: Optional[List[str]] = None,
                        row_groups: Optional[List[int]] = None,
                        nulls: str = "forbid"):
        """The host path: per (selected) row group, ``{name: ndarray}``
        decoded on the host from engine-served reads; under
        ``nulls="mask"``, ``({name: values}, {name: valid mask})`` with
        null slots zero (empty for strings).  "forbid" raises on a null."""
        if nulls not in ("forbid", "mask"):
            raise ValueError(f"bad nulls={nulls!r}")
        name_to_ci = self._ci()
        names = columns or [self.metadata.schema.column(i).name
                            for i in range(self.metadata.num_columns)]
        for c in names:
            if c not in name_to_ci:
                raise KeyError(f"column {c!r} not in schema")
        f = EngineFile(self.engine, self.path)
        try:
            groups = (range(self.metadata.num_row_groups)
                      if row_groups is None else row_groups)
            for rg in groups:
                vals, masks = {}, {}
                for c in names:
                    v, m = decode_chunk_host(self.metadata, rg,
                                             name_to_ci[c], f.read_at)
                    if m is not None and nulls == "forbid":
                        raise ValueError(
                            f"column {c} has nulls; pass nulls='mask'")
                    vals[c] = v
                    masks[c] = (m if m is not None
                                else np.ones(len(v), np.bool_))
                yield (vals, masks) if nulls == "mask" else vals
        finally:
            f.close()

    def prune_row_groups(self, ranges) -> List[int]:
        """Row groups whose column statistics can satisfy every
        ``(column, lo, hi)`` range (None = unbounded): a group survives
        unless some range provably excludes it.  Callers still apply the
        exact predicate on the device."""
        ranges = list(ranges)
        name_to_ci = self._ci()
        keep: List[int] = []
        for rg in range(self.metadata.num_row_groups):
            g = self.metadata.row_group(rg)
            alive = True
            for col, lo, hi in ranges:
                if col not in name_to_ci:
                    raise KeyError(f"column {col!r} not in schema")
                st = g.column(name_to_ci[col]).statistics
                if st is None or st.min is None or st.max is None:
                    continue
                if ((lo is not None and st.max < lo)
                        or (hi is not None and st.min > hi)):
                    alive = False
                    break
            if alive:
                keep.append(rg)
        return keep

    def direct_reasons(self, columns: List[str]) -> Dict[str, Optional[str]]:
        """Per column: None if EVERY row-group chunk can decode on the
        device, else the first blocking reason."""
        from nvme_strom_tpu_torch.sql import pq_direct
        name_to_ci = self._ci()
        out: Dict[str, Optional[str]] = {}
        for c in columns:
            out[c] = None
            for rg in range(self.metadata.num_row_groups):
                why = pq_direct.eligible_chunk(self.metadata, rg,
                                               name_to_ci[c])
                if why is not None:
                    out[c] = f"rg{rg}: {why}"
                    break
        return out

    def read_columns_to_device(self, columns: List[str], device=None,
                               dtype_map: Optional[Dict] = None,
                               direct: str = "auto",
                               nulls: str = "forbid"):
        """Scan → device-resident columns (row groups joined on the
        device).

        ``direct``: "auto" takes the pq_direct page-span path whenever
        every selected column plans, else the host path; "always" raises
        on a column that does not plan; "never" forces the host path.
        ``nulls``: "forbid" raises on nulls; "mask" returns ``(values,
        valid_mask)`` per column, null slots zero (both paths)."""
        from nvme_strom_tpu_torch.device import resolve_device
        from nvme_strom_tpu_torch.ops.bridge import to_device
        from nvme_strom_tpu_torch.sql import pq_direct
        dev = resolve_device(device)

        if direct not in ("auto", "always", "never"):
            raise ValueError(f"bad direct={direct!r}")
        if nulls not in ("forbid", "mask"):
            raise ValueError(f"bad nulls={nulls!r}")
        if direct != "never":
            try:
                plans = pq_direct.plan_columns(
                    self, columns, allow_nulls=nulls == "mask")
            except ValueError:
                if direct == "always":
                    raise
                plans = None
            if plans is not None:
                cols = pq_direct.read_plain_columns_to_device(
                    self, columns, device=dev, plans=plans, nulls=nulls)
                if dtype_map:
                    def cast(c, v):
                        if c not in dtype_map:
                            return v
                        dt = _torch_dtype(dtype_map[c])
                        if isinstance(v, tuple):
                            return v[0].to(dt), v[1]
                        return v.to(dt)
                    cols = {c: cast(c, v) for c, v in cols.items()}
                return cols

        parts: Dict[str, list] = {c: [] for c in columns}
        masks: Dict[str, list] = {c: [] for c in columns}
        for item in self.iter_row_groups(columns, nulls=nulls):
            vals, hmask = item if nulls == "mask" else (item, None)
            for c in columns:
                arr = _device_ready(vals[c], c)
                if dtype_map and c in dtype_map:
                    arr = arr.astype(dtype_map[c])
                parts[c].append(to_device(self.engine, arr, dev))
                if hmask is not None:
                    masks[c].append(to_device(self.engine, hmask[c], dev))
        cat = lambda v: v[0] if len(v) == 1 else torch.cat(v)  # noqa: E731
        if nulls == "mask":
            return {c: (cat(parts[c]), cat(masks[c])) for c in columns}
        return {c: cat(v) for c, v in parts.items()}


def _torch_dtype(dt):
    if isinstance(dt, torch.dtype):
        return dt
    return torch.from_numpy(np.empty(0, np.dtype(dt))).dtype


def _device_ready(arr: np.ndarray, column: str) -> np.ndarray:
    if arr.dtype == object:
        raise TypeError(f"column {column} holds strings: the device takes "
                        "numeric columns (string keys group by dictionary "
                        "code, sql_groupby_str)")
    return arr


def _chunk_start(col) -> int:
    start = col.data_page_offset
    if (col.dictionary_page_offset or 0) > 0:
        start = min(start, col.dictionary_page_offset)
    return start


# -- the host decode -------------------------------------------------------

_FIXED = {"INT32": "<i4", "INT64": "<i8", "FLOAT": "<f4", "DOUBLE": "<f8"}
_HOST_ENCODINGS = {"PLAIN", "RLE", "PLAIN_DICTIONARY", "RLE_DICTIONARY",
                   "BYTE_STREAM_SPLIT", "BIT_PACKED"}


def _refuse(column: str, why: str):
    raise NotImplementedError(
        f"column {column!r}: {why} — neither the direct path nor the host "
        "path decodes it")


def host_reason(meta, rg: int, ci: int) -> Optional[str]:
    """None if the host path decodes the chunk, else why not."""
    col = meta.row_group(rg).column(ci)
    sc = meta.schema.column(ci)
    if sc.max_repetition_level != 0:
        return "repeated or nested field"
    if "." in sc.path:
        return "nested field"
    if col.physical_type not in (*_FIXED, "BYTE_ARRAY", "BOOLEAN"):
        return f"physical type {col.physical_type}"
    codec = col.compression or "UNCOMPRESSED"
    if codec != "UNCOMPRESSED" and not codecs.available(codec):
        return f"compression {codec}"
    encs = set(col.encodings) - _HOST_ENCODINGS
    if encs:
        return f"encodings {sorted(encs)}"
    return None


def _plain_values(body, ptype: str, n: int, is_string: bool):
    """``n`` PLAIN values from the start of ``body`` → (array, bytes used)."""
    if ptype in _FIXED:
        dt = np.dtype(_FIXED[ptype])
        if n * dt.itemsize > len(body):
            raise ValueError("PLAIN page shorter than its value count")
        return np.frombuffer(body, dt, n).copy(), n * dt.itemsize
    if ptype == "BOOLEAN":
        nb = (n + 7) // 8
        bits = np.unpackbits(np.frombuffer(body, np.uint8, nb),
                             bitorder="little")[:n]
        return bits.astype(np.bool_), nb
    out = np.empty(n, object)
    pos = 0
    for i in range(n):
        (ln,) = struct.unpack_from("<I", body, pos)
        pos += 4
        v = bytes(body[pos:pos + ln])
        out[i] = v.decode("utf-8") if is_string else v
        pos += ln
    return out, pos


def _bss_values(body, ptype: str, n: int):
    dt = np.dtype(_FIXED[ptype])
    raw = np.frombuffer(body, np.uint8, n * dt.itemsize)
    return raw.reshape(dt.itemsize, n).T.copy().reshape(-1).view(dt)


def decode_chunk_host(meta, rg: int, ci: int, read_at):
    """One column chunk decoded on the host → (values, valid mask | None);
    ``read_at(offset, length) -> bytes`` reads the chunk (the scanner
    passes :meth:`EngineFile.read_at`)."""
    from nvme_strom_tpu_torch.sql.pq_direct import (_PAGE_DATA,
                                                    _PAGE_DATA_V2,
                                                    _PAGE_DICTIONARY,
                                                    decode_rle_hybrid,
                                                    parse_page_header)
    col = meta.row_group(rg).column(ci)
    sc = meta.schema.column(ci)
    why = host_reason(meta, rg, ci)
    if why is not None:
        _refuse(sc.name, why)
    ptype = col.physical_type
    codec = col.compression or "UNCOMPRESSED"
    codec = None if codec == "UNCOMPRESSED" else codec
    max_def = sc.max_definition_level
    dbw = max_def.bit_length()
    start = _chunk_start(col)
    buf = read_at(start, col.total_compressed_size)
    if len(buf) != col.total_compressed_size:
        raise ValueError(f"column {sc.name!r}: short chunk read")
    pos = 0
    remaining = col.num_values
    dictionary = None
    vals_out, masks = [], []
    any_null = False
    while remaining > 0:
        if pos >= len(buf):
            raise ValueError(f"column {sc.name!r}: pages end early")
        ph = parse_page_header(memoryview(buf)[pos:])
        body = memoryview(buf)[pos + ph.header_len:
                               pos + ph.header_len + ph.compressed_size]
        pos += ph.header_len + ph.compressed_size
        if ph.type == _PAGE_DICTIONARY:
            if codec is not None:
                body = codecs.decompress(codec, body, ph.uncompressed_size)
            dictionary, _ = _plain_values(body, ptype, ph.num_values,
                                          sc.is_string)
            continue
        if ph.type not in (_PAGE_DATA, _PAGE_DATA_V2):
            continue
        n = ph.num_values
        if n > remaining:
            raise ValueError(f"column {sc.name!r}: page of {n} values "
                             f"exceeds the chunk's remainder {remaining}")
        remaining -= n
        if ph.type == _PAGE_DATA_V2:
            lb = ph.rep_levels_len + ph.def_levels_len
            levels = body[ph.rep_levels_len:lb]
            values = body[lb:]
            if codec is not None and ph.v2_is_compressed:
                values = codecs.decompress(codec, values,
                                           ph.uncompressed_size - lb)
            lev = (decode_rle_hybrid(bytes(levels), dbw, n)
                   if max_def and ph.def_levels_len else None)
        else:
            if codec is not None:
                body = codecs.decompress(codec, body, ph.uncompressed_size)
            lev = None
            values = body
            if max_def:
                (ln,) = struct.unpack_from("<I", body, 0)
                lev = decode_rle_hybrid(bytes(body[4:4 + ln]), dbw, n)
                values = memoryview(body)[4 + ln:]
        mask = None if lev is None else (lev == max_def)
        nv = n if mask is None else int(mask.sum())
        enc = ph.encoding
        if enc == 0:
            dense, _ = _plain_values(values, ptype, nv, sc.is_string)
        elif enc in (2, 8):
            if dictionary is None:
                raise ValueError(f"column {sc.name!r}: dictionary-encoded "
                                 "page before the dictionary page")
            idx = decode_rle_hybrid(bytes(values[1:]), values[0], nv) \
                if nv else np.zeros(0, np.int32)
            if idx.size and (idx.min() < 0 or idx.max() >= len(dictionary)):
                raise ValueError(f"column {sc.name!r}: dictionary index "
                                 "out of range")
            dense = dictionary[idx]
        elif enc == 9 and ptype in _FIXED:
            dense = _bss_values(values, ptype, nv)
        elif enc == 3 and ptype == "BOOLEAN":
            (ln,) = struct.unpack_from("<I", values, 0)
            dense = decode_rle_hybrid(bytes(values[4:4 + ln]), 1,
                                      nv).astype(np.bool_)
        else:
            _refuse(sc.name, f"page encoding {enc}")
        if mask is not None and not mask.all():
            any_null = True
            fill = (np.empty(n, object) if dense.dtype == object
                    else np.zeros(n, dense.dtype))
            if dense.dtype == object:
                fill[:] = "" if sc.is_string else b""
            fill[mask] = dense
            dense = fill
        vals_out.append(dense)
        masks.append(np.ones(n, np.bool_) if mask is None else mask)
    if vals_out:
        values = (vals_out[0] if len(vals_out) == 1
                  else np.concatenate(vals_out))
    elif ptype in _FIXED:
        values = np.zeros(0, np.dtype(_FIXED[ptype]))
    else:
        values = np.zeros(0, np.bool_ if ptype == "BOOLEAN" else object)
    mask = np.concatenate(masks) if any_null else None
    return values, mask
