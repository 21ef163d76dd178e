"""Apache Arrow IPC files, read without pyarrow (counterpart of
nvme_strom_tpu/formats/arrow.py).

File layout: ``ARROW1\\0\\0 | messages... | footer | i32 footer_len |
ARROW1``.  The footer, the schema it holds and each record batch's
``Message`` are flatbuffers, read here with a cursor of ~40 lines
(:class:`_FlatBuf`): tables through their vtables, the ``Message.header``
union, vectors of inline structs (``Block``, ``FieldNode``, ``Buffer``).
Only metadata is read on the host (buffered reads that leave no page
cache behind).  Each fixed-width column's data buffer is a byte span of
the file: the spans of every record batch stream through the engine and
``DeviceStream.stream_ranges`` (``h2d_copy``) straight into the column
tensors, so ``bounce_bytes`` stays 0.

Integer and floating-point columns without nulls are read; a message
that carries body compression, a column with nulls, and any other type
raise with the reason.  :func:`write_arrow_file` writes such files
(integer and float columns) with the same flatbuffer layout.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from nvme_strom_tpu_torch.formats.base import (PlanEntry, ReadPlan,
                                               pread_nopollute)

_MAGIC = b"ARROW1"
_CONTINUATION = 0xFFFFFFFF
_HEADER_SCHEMA, _HEADER_RECORD_BATCH = 1, 3
_TYPE_INT, _TYPE_FLOAT = 2, 3
_TYPE_NAMES = {1: "Null", 2: "Int", 3: "FloatingPoint", 4: "Binary",
               5: "Utf8", 6: "Bool", 7: "Decimal", 8: "Date", 9: "Time",
               10: "Timestamp", 11: "Interval", 12: "List", 13: "Struct",
               14: "Union", 15: "FixedSizeBinary", 16: "FixedSizeList",
               17: "Map", 18: "Duration", 19: "LargeBinary",
               20: "LargeUtf8", 21: "LargeList"}
_FLOAT_DTYPES = {0: "<f2", 1: "<f4", 2: "<f8"}     # HALF, SINGLE, DOUBLE
_METADATA_V5 = 4


class _FlatBuf:
    """Minimal flatbuffer cursor: tables, vectors, strings, unions."""

    def __init__(self, buf: bytes):
        self.buf = buf

    def u16(self, pos):
        return struct.unpack_from("<H", self.buf, pos)[0]

    def i32(self, pos):
        return struct.unpack_from("<i", self.buf, pos)[0]

    def u32(self, pos):
        return struct.unpack_from("<I", self.buf, pos)[0]

    def i64(self, pos):
        return struct.unpack_from("<q", self.buf, pos)[0]

    def root(self) -> int:
        return self.u32(0)

    def field(self, table: int, field_id: int) -> int:
        """Absolute position of a table field, or 0 if absent."""
        vtable = table - self.i32(table)
        vlen = self.u16(vtable)
        slot = 4 + 2 * field_id
        if slot >= vlen:
            return 0
        off = self.u16(vtable + slot)
        return table + off if off else 0

    def table(self, field_pos: int) -> int:
        """The table an offset field points to."""
        return field_pos + self.u32(field_pos)

    def vector(self, field_pos: int):
        """(element_start, length) of a vector field."""
        vec = field_pos + self.u32(field_pos)
        return vec + 4, self.u32(vec)

    def string(self, field_pos: int) -> str:
        start, n = self.vector(field_pos)
        return bytes(self.buf[start:start + n]).decode("utf-8")

    def scalar(self, table: int, field_id: int, fmt: str, default=0):
        pos = self.field(table, field_id)
        return (struct.unpack_from("<" + fmt, self.buf, pos)[0]
                if pos else default)


def _parse_footer_blocks(footer: bytes) -> List[tuple]:
    """RecordBatch Blocks from the Footer flatbuffer (fields 0=version,
    1=schema, 2=dictionaries, 3=recordBatches; a Block is an inline
    24-byte struct: i64 offset, i32 metaDataLength (+4 pad), i64
    bodyLength)."""
    fb = _FlatBuf(footer)
    table = fb.root()
    field = fb.field(table, 3)
    if not field:
        return []
    start, n = fb.vector(field)
    return [(fb.i64(start + 24 * i), fb.i32(start + 24 * i + 8),
             fb.i64(start + 24 * i + 16)) for i in range(n)]


@dataclass(frozen=True)
class ArrowField:
    """One schema field: its name, Arrow type name and, for integer and
    float types, the numpy dtype of its values."""
    name: str
    type_name: str
    dtype: Optional[str]
    nullable: bool


def _parse_schema(fb: _FlatBuf, schema: int) -> List[ArrowField]:
    fpos = fb.field(schema, 1)
    if not fpos:
        return []
    start, n = fb.vector(fpos)
    out = []
    for i in range(n):
        f = fb.table(start + 4 * i)
        npos = fb.field(f, 0)
        name = fb.string(npos) if npos else ""
        nullable = bool(fb.scalar(f, 1, "B"))
        ttype = fb.scalar(f, 2, "B")
        dtype = None
        tpos = fb.field(f, 3)
        if ttype == _TYPE_INT and tpos:
            t = fb.table(tpos)
            bits = fb.scalar(t, 0, "i")
            signed = bool(fb.scalar(t, 1, "B"))
            if bits in (8, 16, 32, 64):
                dtype = f"<{'i' if signed else 'u'}{bits // 8}"
        elif ttype == _TYPE_FLOAT and tpos:
            dtype = _FLOAT_DTYPES.get(fb.scalar(fb.table(tpos), 0, "h"))
        cpos = fb.field(f, 5)
        if cpos and fb.vector(cpos)[1]:
            dtype = None                   # nested: not a flat column
        out.append(ArrowField(name, _TYPE_NAMES.get(ttype, str(ttype)),
                              dtype, nullable))
    return out


def _message_flatbuffer(meta: bytes) -> bytes:
    """The Message flatbuffer inside an encapsulated message prefix
    (``0xFFFFFFFF``, i32 length; or the legacy bare i32 length)."""
    (first,) = struct.unpack_from("<I", meta, 0)
    if first == _CONTINUATION:
        (n,) = struct.unpack_from("<i", meta, 4)
        return meta[8:8 + n]
    return meta[4:4 + first]


@dataclass(frozen=True)
class BatchLayout:
    """One record batch: its row count and, per column, the file span of
    its data buffer."""
    length: int
    spans: Dict[str, tuple]


def parse_record_batch(meta: bytes, body_offset: int,
                       fields: Sequence[ArrowField]) -> BatchLayout:
    """A RecordBatch message → its layout; raises on compression, nulls,
    or a type this reader does not stream."""
    fb = _FlatBuf(_message_flatbuffer(meta))
    msg = fb.root()
    if fb.scalar(msg, 1, "B") != _HEADER_RECORD_BATCH:
        raise ValueError("message is not a RecordBatch")
    rb = fb.table(fb.field(msg, 2))
    if fb.field(rb, 3):
        raise ValueError("record batch carries body compression: a host "
                         "decode, which this reader does not do")
    for f in fields:
        if f.dtype is None:
            raise ValueError(f"column {f.name}: type {f.type_name} is not "
                             "a fixed-width integer or float")
    length = fb.scalar(rb, 0, "q")
    nstart, nn = fb.vector(fb.field(rb, 1)) if fb.field(rb, 1) else (0, 0)
    bstart, nb = fb.vector(fb.field(rb, 2)) if fb.field(rb, 2) else (0, 0)
    if nn != len(fields) or nb != 2 * len(fields):
        raise ValueError(f"record batch has {nn} nodes / {nb} buffers for "
                         f"{len(fields)} flat fields")
    spans = {}
    for i, f in enumerate(fields):
        nulls = fb.i64(nstart + 16 * i + 8)
        if nulls:
            raise ValueError(f"column {f.name} has nulls; dense scan only")
        off = fb.i64(bstart + 16 * (2 * i + 1))
        ln = fb.i64(bstart + 16 * (2 * i + 1) + 8)
        need = length * np.dtype(f.dtype).itemsize
        if ln < need:
            raise ValueError(f"column {f.name}: data buffer of {ln} bytes "
                             f"for {length} values")
        spans[f.name] = (body_offset + off, need)
    return BatchLayout(length, spans)


class ArrowFileReader:
    """Plan and stream an Arrow IPC file through the direct engine."""

    def __init__(self, path):
        self.path = str(path)
        fd = os.open(self.path, os.O_RDONLY)
        try:
            size = os.fstat(fd).st_size
            head = pread_nopollute(self.path, 8, fd=fd)
            if head[:6] != _MAGIC:
                raise ValueError(f"{path}: not an Arrow IPC file")
            tail = pread_nopollute(self.path, 10, size - 10, fd=fd)
            if tail[4:] != _MAGIC:
                raise ValueError(f"{path}: bad trailing magic")
            (flen,) = struct.unpack("<i", tail[:4])
            footer = pread_nopollute(self.path, flen, size - 10 - flen,
                                     fd=fd)
            self.blocks = _parse_footer_blocks(footer)
            fb = _FlatBuf(footer)
            spos = fb.field(fb.root(), 1)
            self.fields = (_parse_schema(fb, fb.table(spos)) if spos
                           else [])
            self._layouts = [
                parse_record_batch(pread_nopollute(self.path, mlen, off,
                                                   fd=fd),
                                   off + mlen, self.fields)
                for off, mlen, _ in self.blocks]
        finally:
            os.close(fd)

    @property
    def names(self) -> List[str]:
        return [f.name for f in self.fields]

    @property
    def num_batches(self) -> int:
        return len(self.blocks)

    @property
    def num_rows(self) -> int:
        return sum(b.length for b in self._layouts)

    def column_plan(self, columns: Optional[List[str]] = None) -> ReadPlan:
        """The data-buffer spans of ``columns`` (all), batch by batch."""
        names = columns or self.names
        known = set(self.names)
        missing = [n for n in names if n not in known]
        if missing:
            raise KeyError(f"columns not in schema: {missing}")
        dt = {f.name: f.dtype for f in self.fields}
        return ReadPlan(self.path, tuple(
            PlanEntry(key=f"batch{i}.{n}", offset=lay.spans[n][0],
                      length=lay.spans[n][1], dtype=dt[n],
                      shape=(lay.length,))
            for i, lay in enumerate(self._layouts) for n in names))

    def read_columns_to_device(self, engine, columns: Optional[List[str]]
                               = None, device=None, depth: int = 3
                               ) -> Dict[str, torch.Tensor]:
        """Every record batch's column spans in ONE pipelined stream
        (``depth`` ranges in flight) → per-column tensors joined on
        ``device`` (default ``cuda:0``)."""
        from nvme_strom_tpu_torch.ops.bridge import (DeviceStream,
                                                     split_ranges,
                                                     torch_dtype)
        names = columns or self.names
        plan = self.column_plan(names)
        chunk = engine.config.chunk_bytes
        # a message's column spans must fit the staging pool: the stream
        # holds at most its depth's worth of buffers, and a pool smaller
        # than one span's pieces could never make progress
        max_subs = max((-(-e.length // chunk) for e in plan.entries),
                       default=1)
        if max_subs > engine.n_buffers:
            raise ValueError(
                f"one column span needs {max_subs} staging buffers "
                f"but the pool has {engine.n_buffers}; raise "
                "EngineConfig.chunk_bytes or buffer_pool_bytes")
        ds = DeviceStream(engine, device=device,
                          depth=max(1, min(depth, engine.n_buffers // 3)))
        ranges, counts = split_ranges(plan.ranges(), chunk)
        parts: Dict[str, list] = {n: [] for n in names}
        fh = engine.open(self.path)
        try:
            it = ds.stream_ranges(fh, ranges)
            for e, n in zip(plan.entries, counts):
                got = [next(it) for _ in range(n)]
                if got:
                    parts[e.key.split(".", 1)[1]].append(
                        got[0] if len(got) == 1 else torch.cat(got))
        finally:
            engine.close(fh)
        dt = {f.name: f.dtype for f in self.fields}
        out = {}
        for n in names:
            p = parts[n]
            flat = (torch.zeros(0, dtype=torch.uint8, device=ds.device)
                    if not p else p[0] if len(p) == 1 else torch.cat(p))
            out[n] = flat.view(torch_dtype(dt[n]))
        return out


# -- the writer -----------------------------------------------------------

class _Builder:
    """Front-to-back flatbuffer writer: each table's vtable precedes it,
    and every object an offset points to follows the offset (uoffset is
    unsigned).  Objects: ``("table", [(slot, fmt, value)])`` with a
    struct format or ``"off"`` and a child object; ``("str", bytes)``;
    ``("tables", [tables])``; ``("structs", align, bytes, count)``."""

    def __init__(self):
        self.buf = bytearray(4)            # the root offset

    def _align(self, n: int, extra: int = 0) -> None:
        while (len(self.buf) + extra) % n:
            self.buf.append(0)

    def _patch_off(self, at: int, target: int) -> None:
        struct.pack_into("<I", self.buf, at, target - at)

    def emit(self, obj) -> int:
        kind = obj[0]
        if kind == "str":
            self._align(4)
            pos = len(self.buf)
            self.buf += struct.pack("<I", len(obj[1])) + obj[1] + b"\0"
            return pos
        if kind == "structs":
            _, align, data, count = obj
            self._align(max(4, align), 4)   # the elements, past the length
            pos = len(self.buf)
            self.buf += struct.pack("<I", count) + data
            return pos
        if kind == "tables":
            self._align(4)
            pos = len(self.buf)
            self.buf += struct.pack("<I", len(obj[1]))
            slots = []
            for _ in obj[1]:
                slots.append(len(self.buf))
                self.buf += b"\0\0\0\0"
            for at, child in zip(slots, obj[1]):
                self._patch_off(at, self.emit(child))
            return pos
        fields = obj[1]
        nslots = max((s for s, _, _ in fields), default=-1) + 1
        layout, off = {}, 4
        for slot, fmt, _ in sorted(fields, key=lambda f: -_size(f[1])):
            sz = _size(fmt)
            off = (off + sz - 1) // sz * sz
            layout[slot] = off
            off += sz
        tsize = (off + 3) // 4 * 4
        self._align(2)
        vt = len(self.buf)
        self.buf += struct.pack(f"<{2 + nslots}H", 4 + 2 * nslots, tsize,
                                *[layout.get(s, 0) for s in range(nslots)])
        self._align(8)
        pos = len(self.buf)
        self.buf += bytes(tsize)
        struct.pack_into("<i", self.buf, pos, pos - vt)
        children = []
        for slot, fmt, value in fields:
            if fmt == "off":
                children.append((pos + layout[slot], value))
            else:
                struct.pack_into("<" + fmt, self.buf, pos + layout[slot],
                                 value)
        for at, child in children:
            self._patch_off(at, self.emit(child))
        return pos

    def finish(self, root) -> bytes:
        self._patch_off(0, self.emit(root))
        self._align(8)
        return bytes(self.buf)


def _size(fmt: str) -> int:
    return 4 if fmt == "off" else struct.calcsize("<" + fmt)


def _structs(rows: Sequence[tuple], fmt: str) -> tuple:
    data = b"".join(struct.pack("<" + fmt, *r) for r in rows)
    return ("structs", 8, data, len(rows))


def _type_of(dtype: np.dtype) -> tuple:
    if dtype.kind in "iu":
        return _TYPE_INT, ("table", [(0, "i", dtype.itemsize * 8),
                                     (1, "B", int(dtype.kind == "i"))])
    if dtype.kind == "f" and dtype.itemsize in (2, 4, 8):
        prec = {2: 0, 4: 1, 8: 2}[dtype.itemsize]
        return _TYPE_FLOAT, ("table", [(0, "h", prec)])
    raise TypeError(f"write_arrow_file writes integer and float columns, "
                    f"not {dtype}")


def _schema_table(columns: Dict[str, np.ndarray]) -> tuple:
    fields = []
    for name, arr in columns.items():
        ttype, tobj = _type_of(arr.dtype)
        fields.append(("table", [(0, "off", ("str", name.encode())),
                                 (1, "B", 0), (2, "B", ttype),
                                 (3, "off", tobj),
                                 (5, "off", ("tables", []))]))
    return ("table", [(0, "h", 0), (1, "off", ("tables", fields))])


def _encapsulate(fb: bytes) -> bytes:
    pad = (-(8 + len(fb))) % 8
    return struct.pack("<Ii", _CONTINUATION, len(fb) + pad) + fb + \
        bytes(pad)


def write_arrow_file(path, columns: Dict[str, np.ndarray],
                     batch_rows: Optional[int] = None) -> int:
    """Write integer / float ``columns`` (equal lengths, no nulls) as an
    Arrow IPC file of record batches of ``batch_rows`` rows (default:
    one batch).  Returns the file's size."""
    cols = {n: np.ascontiguousarray(a, dtype=np.asarray(a).dtype
                                    .newbyteorder("<"))
            for n, a in columns.items()}
    rows = {len(a) for a in cols.values()}
    if len(rows) != 1:
        raise ValueError(f"columns of unequal lengths {sorted(rows)}")
    n_rows = rows.pop()
    batch_rows = batch_rows or max(1, n_rows)
    schema = _schema_table(cols)
    blocks = []
    with open(path, "wb") as f:
        f.write(_MAGIC + b"\0\0")
        msg = _Builder().finish(("table", [
            (0, "h", _METADATA_V5), (1, "B", _HEADER_SCHEMA),
            (2, "off", schema), (3, "q", 0)]))
        f.write(_encapsulate(msg))
        for lo in range(0, max(n_rows, 1), batch_rows):
            n = min(batch_rows, n_rows - lo)
            bufs, body = [], 0
            for a in cols.values():
                ln = n * a.dtype.itemsize
                bufs.append((body, 0))              # validity: none
                bufs.append((body, ln))
                body += (ln + 63) // 64 * 64
            rb = ("table", [
                (0, "q", n),
                (1, "off", _structs([(n, 0)] * len(cols), "qq")),
                (2, "off", _structs(bufs, "qq"))])
            meta = _encapsulate(_Builder().finish(("table", [
                (0, "h", _METADATA_V5), (1, "B", _HEADER_RECORD_BATCH),
                (2, "off", rb), (3, "q", body)])))
            off = f.tell()
            f.write(meta)
            for a in cols.values():
                data = a[lo:lo + n].tobytes()
                f.write(data + bytes((-len(data)) % 64))
            blocks.append((off, len(meta), body))
            if n_rows == 0:
                break
        f.write(struct.pack("<Ii", _CONTINUATION, 0))     # end of stream
        footer = _Builder().finish(("table", [
            (0, "h", _METADATA_V5), (1, "off", schema),
            (2, "off", _structs([], "qiiq")),
            (3, "off", _structs([(o, m, 0, b) for o, m, b in blocks],
                                "qiiq"))]))
        f.write(footer)
        f.write(struct.pack("<i", len(footer)) + _MAGIC)
        return f.tell()
