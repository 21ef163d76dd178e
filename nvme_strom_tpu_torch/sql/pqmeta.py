"""The Parquet footer, read without pyarrow.

A Thrift compact-protocol reader for ``FileMetaData`` (parquet-format's
``parquet.thrift``) and the objects the SQL modules read from it, under
pyarrow's attribute names and values: ``metadata.num_rows``,
``schema.column(i).max_definition_level``, ``row_group(rg).column(ci)
.compression == "SNAPPY"``, ``.encodings`` as strings such as
``"RLE_DICTIONARY"``, ``.statistics.min`` typed from the column's
physical type.  So the scan modules read a footer the same way whether
it came from here or from ``pyarrow.parquet.read_metadata``.

The compact protocol: a field header is one byte, a field-id delta in
the high nibble (0: a zigzag i16 id follows) and the wire type in the
low nibble; a struct field of type bool carries its value in that type
nibble (1 true, 2 false); a list header holds its size in the high
nibble, 15 meaning a varint size follows.  Fields this reader does not
know (``ColumnIndex`` offsets, ``SizeStatistics``, bloom filters,
encryption, geospatial statistics) are decoded generically and ignored.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Tuple

# Thrift compact-protocol wire types
CT_STOP = 0
CT_BOOL_TRUE = 1
CT_BOOL_FALSE = 2
CT_BYTE = 3
CT_I16 = 4
CT_I32 = 5
CT_I64 = 6
CT_DOUBLE = 7
CT_BINARY = 8
CT_LIST = 9
CT_SET = 10
CT_MAP = 11
CT_STRUCT = 12

#: parquet-format enums under pyarrow's names
TYPES = ("BOOLEAN", "INT32", "INT64", "INT96", "FLOAT", "DOUBLE",
         "BYTE_ARRAY", "FIXED_LEN_BYTE_ARRAY")
ENCODINGS = ("PLAIN", "GROUP_VAR_INT", "PLAIN_DICTIONARY", "RLE",
             "BIT_PACKED", "DELTA_BINARY_PACKED", "DELTA_LENGTH_BYTE_ARRAY",
             "DELTA_BYTE_ARRAY", "RLE_DICTIONARY", "BYTE_STREAM_SPLIT")
#: (pyarrow names the codec LZ4_RAW "LZ4" and the legacy framed one
#: "LZ4_HADOOP")
CODECS = ("UNCOMPRESSED", "SNAPPY", "GZIP", "LZO", "BROTLI", "LZ4_HADOOP",
          "ZSTD", "LZ4")
CONVERTED = ("UTF8", "MAP", "MAP_KEY_VALUE", "LIST", "ENUM", "DECIMAL",
             "DATE", "TIME_MILLIS", "TIME_MICROS", "TIMESTAMP_MILLIS",
             "TIMESTAMP_MICROS", "UINT_8", "UINT_16", "UINT_32", "UINT_64",
             "INT_8", "INT_16", "INT_32", "INT_64", "JSON", "BSON",
             "INTERVAL")
#: LogicalType union members (field id → name)
LOGICAL = {1: "String", 2: "Map", 3: "List", 4: "Enum", 5: "Decimal",
           6: "Date", 7: "Time", 8: "Timestamp", 10: "Int", 11: "Null",
           12: "JSON", 13: "BSON", 14: "UUID", 15: "Float16",
           16: "Variant", 17: "Geometry", 18: "Geography"}
_REQUIRED, _OPTIONAL, _REPEATED = 0, 1, 2


class ThriftError(ValueError):
    """Malformed or truncated Thrift compact data (or too few bytes read:
    callers retry with a larger window before giving up)."""


class Compact:
    """A cursor over Thrift compact-protocol bytes."""

    def __init__(self, buf, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def byte(self) -> int:
        if self.pos >= len(self.buf):
            raise ThriftError("truncated")
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.byte()
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7
            if shift > 63:
                raise ThriftError("varint overflow")

    def zigzag(self) -> int:
        v = self.varint()
        return (v >> 1) ^ -(v & 1)

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.buf):
            raise ThriftError("truncated")
        out = bytes(self.buf[self.pos:self.pos + n])
        self.pos += n
        return out

    def read_field_header(self, last_id: int) -> Tuple[int, int]:
        """→ (wire type, field id); wire type 0 is the struct's stop."""
        b = self.byte()
        if b == CT_STOP:
            return 0, 0
        delta, ctype = b >> 4, b & 0x0F
        fid = last_id + delta if delta else self.zigzag()
        return ctype, fid

    def _collection_header(self) -> Tuple[int, int]:
        b = self.byte()
        n, et = b >> 4, b & 0x0F
        if n == 15:
            n = self.varint()
        if n > len(self.buf) - self.pos:
            raise ThriftError(f"collection count {n} exceeds buffer")
        return n, et

    def value(self, ctype: int):
        """One value of wire type ``ctype``: ints, floats, bytes, lists
        and ``{field id: value}`` dicts for structs (unions included)."""
        if ctype == CT_BOOL_TRUE:
            return True
        if ctype == CT_BOOL_FALSE:
            return False
        if ctype == CT_BYTE:
            b = self.byte()
            return b - 256 if b > 127 else b
        if ctype in (CT_I16, CT_I32, CT_I64):
            return self.zigzag()
        if ctype == CT_DOUBLE:
            return struct.unpack("<d", self.take(8))[0]
        if ctype == CT_BINARY:
            return self.take(self.varint())
        if ctype in (CT_LIST, CT_SET):
            n, et = self._collection_header()
            if et in (CT_BOOL_TRUE, CT_BOOL_FALSE):
                # a bool element is one byte (1 true), unlike a field
                return [self.byte() == 1 for _ in range(n)]
            return [self.value(et) for _ in range(n)]
        if ctype == CT_MAP:
            n = self.varint()
            if n > len(self.buf) - self.pos:
                raise ThriftError(f"map count {n} exceeds buffer")
            if not n:
                return {}
            b = self.byte()
            kt, vt = b >> 4, b & 0x0F
            return {self.value(kt): self.value(vt) for _ in range(n)}
        if ctype == CT_STRUCT:
            return self.struct()
        raise ThriftError(f"bad compact type {ctype}")

    def struct(self) -> Dict[int, object]:
        out: Dict[int, object] = {}
        last = 0
        while True:
            t, fid = self.read_field_header(last)
            if t == 0:
                return out
            last = fid
            out[fid] = self.value(t)

    def skip(self, ctype: int) -> None:
        self.value(ctype)


def _enum(names, i):
    return names[i] if 0 <= i < len(names) else f"UNKNOWN({i})"


def _decode_stat(raw: Optional[bytes], ptype: str, is_string: bool):
    if raw is None:
        return None
    if ptype == "INT32":
        return struct.unpack("<i", raw[:4])[0]
    if ptype == "INT64":
        return struct.unpack("<q", raw[:8])[0]
    if ptype == "FLOAT":
        return struct.unpack("<f", raw[:4])[0]
    if ptype == "DOUBLE":
        return struct.unpack("<d", raw[:8])[0]
    if ptype == "BOOLEAN":
        return bool(raw[0]) if raw else None
    if is_string:
        return raw.decode("utf-8", "replace")
    return raw


class Statistics:
    """A chunk's footer statistics; ``min`` / ``max`` are typed from the
    physical type, read from ``min_value`` / ``max_value`` first and from
    the deprecated ``min`` / ``max`` only where the column's order is
    signed (as pyarrow reads them)."""

    def __init__(self, d: dict, ptype: str, is_string: bool,
                 signed_order: bool):
        lo, hi = d.get(6), d.get(5)
        if lo is None and hi is None and signed_order:
            lo, hi = d.get(2), d.get(1)
        self.has_min_max = lo is not None and hi is not None
        self.min = _decode_stat(lo, ptype, is_string) \
            if self.has_min_max else None
        self.max = _decode_stat(hi, ptype, is_string) \
            if self.has_min_max else None
        self.null_count = d.get(3)


class ColumnSchema:
    """One leaf of the schema: name, physical and logical types, and the
    maximum definition and repetition levels of its path."""

    def __init__(self, path: List[str], el: dict, max_def: int,
                 max_rep: int):
        self.path = ".".join(path)
        self.name = path[-1]
        self.physical_type = _enum(TYPES, el.get(1, -1))
        self.converted_type = ("NONE" if 6 not in el
                               else _enum(CONVERTED, el[6]))
        self.logical_type = _logical_name(el.get(10))
        self.max_definition_level = max_def
        self.max_repetition_level = max_rep

    @property
    def is_string(self) -> bool:
        return self.logical_type == "String" or self.converted_type == "UTF8"


def _logical_name(lt) -> str:
    """A LogicalType union → its name as pyarrow prints it."""
    if not lt:
        return "None"
    fid, body = next(iter(lt.items()))
    name = LOGICAL.get(fid, "Unknown")
    if name == "Int" and isinstance(body, dict):
        return (f"Int(bitWidth={body.get(1, 0)}, "
                f"isSigned={'true' if body.get(2) else 'false'})")
    return name


class Schema:
    def __init__(self, columns: List[ColumnSchema]):
        self._cols = columns

    def column(self, i: int) -> ColumnSchema:
        return self._cols[i]

    def __len__(self) -> int:
        return len(self._cols)


def _signed_order(cs: ColumnSchema) -> bool:
    if cs.physical_type in ("INT32", "INT64"):
        return not cs.converted_type.startswith("UINT")
    return cs.physical_type in ("FLOAT", "DOUBLE", "BOOLEAN")


class ColumnChunkMetaData:
    def __init__(self, cc: dict, cs: ColumnSchema):
        md = cc.get(3) or {}
        self.file_offset = cc.get(2, 0)
        self.physical_type = _enum(TYPES, md.get(1, -1))
        self.encodings = tuple(_enum(ENCODINGS, e) for e in md.get(2, ()))
        self.path_in_schema = ".".join(p.decode() for p in md.get(3, ()))
        self.compression = _enum(CODECS, md.get(4, 0))
        self.num_values = md.get(5, 0)
        self.total_uncompressed_size = md.get(6, 0)
        self.total_compressed_size = md.get(7, 0)
        self.data_page_offset = md.get(9, 0)
        self.dictionary_page_offset = md.get(11)
        st = md.get(12)
        self.statistics = (None if st is None
                           else Statistics(st, self.physical_type,
                                           cs.is_string, _signed_order(cs)))


class RowGroupMetaData:
    def __init__(self, rg: dict, schema: Schema):
        self._cols = [ColumnChunkMetaData(cc, schema.column(i))
                      for i, cc in enumerate(rg.get(1, ()))]
        self.total_byte_size = rg.get(2, 0)
        self.num_rows = rg.get(3, 0)
        self.num_columns = len(self._cols)

    def column(self, i: int) -> ColumnChunkMetaData:
        return self._cols[i]


class FileMetaData:
    """The decoded footer of one Parquet file."""

    def __init__(self, d: dict):
        self.schema = Schema(_leaves(d.get(2, [])))
        self.num_rows = d.get(3, 0)
        self._groups = [RowGroupMetaData(rg, self.schema)
                        for rg in d.get(4, ())]
        self.created_by = d[6].decode() if 6 in d else None
        self.num_row_groups = len(self._groups)
        self.num_columns = len(self.schema)
        for g in self._groups:
            if g.num_columns != self.num_columns:
                raise ThriftError(
                    f"row group has {g.num_columns} column chunks, the "
                    f"schema {self.num_columns} leaves")

    def row_group(self, i: int) -> RowGroupMetaData:
        return self._groups[i]


def _leaves(elements: list) -> List[ColumnSchema]:
    """The flattened schema tree (root first, each group followed by its
    ``num_children`` children) → its leaf columns with their levels."""
    if not elements:
        return []
    out: List[ColumnSchema] = []
    pos = 1

    def walk(n_children: int, path: List[str], max_def: int, max_rep: int):
        nonlocal pos
        for _ in range(n_children):
            if pos >= len(elements):
                raise ThriftError("schema tree ends early")
            el = elements[pos]
            pos += 1
            rep = el.get(3, _REQUIRED)
            d = max_def + (rep != _REQUIRED)
            r = max_rep + (rep == _REPEATED)
            name = el.get(4, b"").decode()
            kids = el.get(5, 0)
            if kids:
                walk(kids, path + [name], d, r)
            else:
                out.append(ColumnSchema(path + [name], el, d, r))

    walk(elements[0].get(5, 0), [], 0, 0)
    return out


_MAGIC = b"PAR1"


def parse_footer(buf) -> FileMetaData:
    """``FileMetaData`` from the footer's Thrift bytes."""
    return FileMetaData(Compact(buf).struct())


def read_metadata(path, read_at=None) -> FileMetaData:
    """The footer of the Parquet file at ``path``: its last 8 bytes are
    the footer length and ``PAR1``.  ``read_at(offset, length) -> bytes``
    reads the metadata (default: a plain ``pread``; the scanner passes
    its no-residue read)."""
    path = str(path)
    if read_at is None:
        def read_at(off: int, ln: int) -> bytes:
            with open(path, "rb") as f:
                return os.pread(f.fileno(), ln, off)
    size = os.path.getsize(path)
    if size < 12:
        raise ValueError(f"{path}: {size} bytes is too small for Parquet")
    tail = read_at(size - 8, 8)
    if tail[4:] != _MAGIC:
        raise ValueError(f"{path}: not a Parquet file (bad trailing magic)")
    (flen,) = struct.unpack("<I", tail[:4])
    if flen + 8 > size - 4:
        raise ValueError(f"{path}: footer length {flen} exceeds the file")
    return parse_footer(read_at(size - 8 - flen, flen))
