"""A Parquet writer of the port's own, for the tables its entry point and
its card check make from a seed (the JAX package writes them with
pyarrow).

Columns: INT32, INT64, FLOAT and DOUBLE from numpy arrays, and
BYTE_ARRAY from arrays of strings or bytes (dictionary-encoded only).
Encodings: PLAIN, and RLE_DICTIONARY with a PLAIN dictionary page and a
bit-packed index stream packed with numpy.  Pages: v1 or v2 data pages
of about ``page_bytes`` of values.  Codecs: UNCOMPRESSED or GZIP.
Optional columns take a validity mask (``nulls={name: mask}``) and carry
RLE definition levels.  The footer records min / max / null-count
statistics, so zone maps can prune.  The footer and page headers are
Thrift compact structs (sql/pqmeta.py reads them back).
"""

from __future__ import annotations

import struct
from typing import Dict, Iterable, Optional

import numpy as np

from nvme_strom_tpu_torch.sql import codecs

_TYPE = {"i4": (1, 4), "i8": (2, 8), "f4": (4, 4), "f8": (5, 8)}
_BYTE_ARRAY = 6
_PLAIN, _RLE, _RLE_DICTIONARY = 0, 3, 8
_CODEC = {"none": 0, "uncompressed": 0, "gzip": 2}
_PAGE_DATA, _PAGE_DICTIONARY, _PAGE_DATA_V2 = 0, 2, 3

# Thrift compact wire types
_BOOL_TRUE, _BOOL_FALSE, _I16, _I32, _I64 = 1, 2, 4, 5, 6
_BINARY, _LIST, _STRUCT = 8, 9, 12


class _Thrift:
    """Thrift compact-protocol writer.  A struct is a list of ``(field id,
    kind, value)`` in ascending id order; kinds: "i16", "i32", "i64",
    "bool", "bin", "struct", ("list", elem kind)."""

    def __init__(self):
        self.b = bytearray()

    def varint(self, n: int) -> None:
        while True:
            if n < 0x80:
                self.b.append(n)
                return
            self.b.append((n & 0x7F) | 0x80)
            n >>= 7

    def zigzag(self, n: int) -> None:
        self.varint((n << 1) ^ (n >> 63))

    _CT = {"i16": _I16, "i32": _I32, "i64": _I64, "bin": _BINARY,
           "struct": _STRUCT}

    def _ctype(self, kind, value=None) -> int:
        if kind == "bool":
            return _BOOL_TRUE if value else _BOOL_FALSE
        if isinstance(kind, tuple):
            return _LIST
        return self._CT[kind]

    def value(self, kind, v) -> None:
        if kind in ("i16", "i32", "i64"):
            self.zigzag(int(v))
        elif kind == "bin":
            self.varint(len(v))
            self.b += v
        elif kind == "struct":
            self.struct(v)
        elif kind == "bool":          # a list element: one byte
            self.b.append(1 if v else 2)
        else:
            et = kind[1]
            n = len(v)
            ct = _BOOL_TRUE if et == "bool" else self._ctype(et)
            if n < 15:
                self.b.append((n << 4) | ct)
            else:
                self.b.append(0xF0 | ct)
                self.varint(n)
            for x in v:
                self.value(et, x)

    def struct(self, fields) -> None:
        last = 0
        for fid, kind, v in fields:
            if v is None:
                continue
            ct = self._ctype(kind, v)
            delta = fid - last
            if 0 < delta <= 15:
                self.b.append((delta << 4) | ct)
            else:
                self.b.append(ct)
                self.zigzag(fid)
            last = fid
            if kind != "bool":
                self.value(kind, v)
        self.b.append(0)


def _thrift(fields) -> bytes:
    w = _Thrift()
    w.struct(fields)
    return bytes(w.b)


def _varint(n: int) -> bytes:
    w = _Thrift()
    w.varint(n)
    return bytes(w.b)


def encode_bitpacked(values: np.ndarray, bit_width: int) -> bytes:
    """An RLE / bit-packed hybrid stream of ``values``: one RLE run for a
    bit width of 0, else bit-packed runs of at most 2^20 groups of 8
    values (LSB first; the last group padded with zeros)."""
    n = len(values)
    if n == 0:
        return b""
    if bit_width == 0:
        return _varint(n << 1)
    out = []
    step = 8 << 20
    for lo in range(0, n, step):
        v = np.asarray(values[lo:lo + step], np.uint64)
        groups = -(-len(v) // 8)
        padded = np.zeros(groups * 8, np.uint64)
        padded[:len(v)] = v
        bits = ((padded[:, None] >> np.arange(bit_width, dtype=np.uint64))
                & np.uint64(1)).astype(np.uint8).reshape(-1)
        out.append(_varint((groups << 1) | 1))
        out.append(np.packbits(bits, bitorder="little").tobytes())
    return b"".join(out)


def _levels(mask: np.ndarray) -> bytes:
    return encode_bitpacked(mask.astype(np.uint8), 1)


def _stat_bytes(arr: np.ndarray, is_str: bool):
    if len(arr) == 0:
        return None, None
    if is_str:
        vals = [x.encode() if isinstance(x, str) else bytes(x)
                for x in arr]
        return min(vals), max(vals)
    if arr.dtype.kind == "f":
        ok = arr[~np.isnan(arr)]
        if len(ok) == 0:
            return None, None
        lo, hi = ok.min(), ok.max()
    else:
        lo, hi = arr.min(), arr.max()
    return (np.asarray(lo, arr.dtype).tobytes(),
            np.asarray(hi, arr.dtype).tobytes())


def _plain_strings(vals) -> bytes:
    out = bytearray()
    for x in vals:
        b = x.encode() if isinstance(x, str) else bytes(x)
        out += struct.pack("<I", len(b)) + b
    return bytes(out)


class _Column:
    def __init__(self, name, arr, mask, dictionary: bool):
        self.name = name
        self.labels = None
        if isinstance(arr, tuple):            # (labels, codes)
            labels, codes = arr
            self.labels = np.asarray(labels)
            arr = np.asarray(codes, np.int64)
            if not dictionary:
                raise ValueError(f"column {name}: (labels, codes) is a "
                                 "dictionary column (pass it in "
                                 "dictionary=)")
            self.is_str = self.labels.dtype.kind in "OUS"
            self.ptype, self.width = ((_BYTE_ARRAY, 0) if self.is_str
                                      else _TYPE[self.labels.dtype.str[1:]])
            self.arr = arr
            self.mask = None if mask is None else np.asarray(mask, np.bool_)
            self.dictionary = True
            return
        arr = np.asarray(arr)
        self.is_str = arr.dtype.kind in "OUS"
        if self.is_str:
            if not dictionary:
                raise ValueError(f"column {name}: strings are written "
                                 "dictionary-encoded (pass it in "
                                 "dictionary=)")
            self.ptype, self.width = _BYTE_ARRAY, 0
            self.arr = np.asarray(arr, object)
        else:
            key = np.dtype(arr.dtype).str[1:]
            if key not in _TYPE:
                raise TypeError(f"column {name}: dtype {arr.dtype} has no "
                                "Parquet physical type here")
            self.ptype, self.width = _TYPE[key]
            self.arr = np.ascontiguousarray(arr, np.dtype("<" + key))
        self.mask = None if mask is None else np.asarray(mask, np.bool_)
        self.dictionary = dictionary


def write_parquet(path, columns: Dict[str, np.ndarray],
                  row_group_size: Optional[int] = None,
                  page_bytes: int = 1 << 20,
                  data_page_version: str = "1.0",
                  compression: str = "none",
                  compression_level: int = 1,
                  dictionary: Iterable[str] = (),
                  nulls: Optional[Dict[str, np.ndarray]] = None) -> int:
    """Write ``columns`` (equal lengths) as one Parquet file; returns its
    size.  A column is an array, or a ``(labels, codes)`` pair: a
    dictionary column given by its labels and the rows' codes into them.
    ``nulls``: {name: validity mask} makes a column OPTIONAL (its
    masked-out values are not written).  ``dictionary``: the columns to
    write RLE_DICTIONARY (every string column must be among them)."""
    if compression not in _CODEC:
        raise ValueError(f"compression {compression!r}: the writer has "
                         f"{sorted(set(_CODEC) - {'uncompressed'})}")
    if data_page_version not in ("1.0", "2.0"):
        raise ValueError(f"bad data_page_version {data_page_version!r}")
    nulls = dict(nulls or {})
    dictionary = set(dictionary)
    cols = [_Column(n, a, nulls.get(n), n in dictionary)
            for n, a in columns.items()]
    n_rows = {len(c.arr) for c in cols}
    if len(n_rows) != 1:
        raise ValueError(f"columns of unequal lengths {sorted(n_rows)}")
    n_rows = n_rows.pop()
    rg_rows = row_group_size or max(1, n_rows)
    codec = _CODEC[compression]
    v2 = data_page_version == "2.0"
    row_groups = []
    with open(path, "wb") as f:
        f.write(b"PAR1")
        for lo in range(0, max(n_rows, 1), rg_rows):
            hi = min(n_rows, lo + rg_rows)
            chunks = [_write_chunk(f, c, lo, hi, page_bytes, v2, codec,
                                   compression_level) for c in cols]
            row_groups.append((chunks, hi - lo))
            if n_rows == 0:
                break
        schema = [[(4, "bin", b"schema"), (5, "i32", len(cols))]]
        for c in cols:
            el = [(1, "i32", c.ptype),
                  (3, "i32", 1 if c.mask is not None else 0),
                  (4, "bin", c.name.encode())]
            if c.is_str:
                el += [(6, "i32", 0), (10, "struct", [(1, "struct", [])])]
            schema.append(el)
        rgs = []
        for chunks, nr in row_groups:
            rgs.append([
                (1, ("list", "struct"), [ch for ch, _ in chunks]),
                (2, "i64", sum(u for _, u in chunks)),
                (3, "i64", nr)])
        footer = _thrift([
            (1, "i32", 2 if v2 else 1),
            (2, ("list", "struct"), schema),
            (3, "i64", n_rows),
            (4, ("list", "struct"), rgs),
            (6, "bin", b"nvme_strom_tpu_torch pqwrite"),
            # TypeDefinedOrder for every column: without column orders a
            # reader may not trust the min_value / max_value statistics
            (7, ("list", "struct"), [[(1, "struct", [])] for _ in cols])])
        f.write(footer)
        f.write(struct.pack("<I", len(footer)) + b"PAR1")
        return f.tell()


def _write_chunk(f, c: _Column, lo: int, hi: int, page_bytes: int,
                 v2: bool, codec: int, level: int):
    """One column chunk: [dictionary page] + data pages → (ColumnChunk
    struct fields, uncompressed bytes)."""
    start = f.tell()
    arr = c.arr[lo:hi]
    mask = None if c.mask is None else c.mask[lo:hi]
    dense = arr if mask is None else arr[mask]
    n = hi - lo
    total_u = total_c = 0
    dict_off = None
    encs = [_PLAIN, _RLE]

    def compress(body: bytes) -> bytes:
        return (codecs.compress_gzip(body, level) if codec == 2 else body)

    if c.labels is not None:
        used = np.unique(dense)
        remap = np.zeros(len(c.labels), np.int64)
        remap[used] = np.arange(len(used))
        uniq, idx = c.labels[used], remap[dense]
        dict_body = (_plain_strings(uniq) if c.is_str
                     else np.ascontiguousarray(uniq).tobytes())
    if c.dictionary:
        if c.labels is not None:
            pass                         # uniq, idx, dict_body set above
        elif c.is_str:
            keys = np.array([x.encode() if isinstance(x, str) else bytes(x)
                             for x in dense], object)
            uniq, idx = np.unique(keys, return_inverse=True) \
                if len(keys) else (np.array([], object),
                                   np.zeros(0, np.int64))
            dict_body = _plain_strings(uniq)
        else:
            uniq, idx = np.unique(dense, return_inverse=True)
            dict_body = uniq.tobytes()
        idx = idx.reshape(-1)
        bw = max(0, int(len(uniq) - 1).bit_length())
        comp = compress(dict_body)
        hdr = _thrift([(1, "i32", _PAGE_DICTIONARY),
                       (2, "i32", len(dict_body)),
                       (3, "i32", len(comp)),
                       (7, "struct", [(1, "i32", len(uniq)),
                                      (2, "i32", _PLAIN)])])
        dict_off = f.tell()
        f.write(hdr + comp)
        total_u += len(hdr) + len(dict_body)
        total_c += len(hdr) + len(comp)
        encs = [_PLAIN, _RLE, _RLE_DICTIONARY]
        per_row = max(1, bw) / 8
    else:
        per_row = c.width
    rows_per_page = max(8, int(page_bytes // max(per_row, 1e-9)) // 8 * 8)
    data_off = f.tell()
    dpos = 0                     # position in the dense values
    for p0 in range(0, max(n, 1), rows_per_page):
        p1 = min(n, p0 + rows_per_page)
        pm = None if mask is None else mask[p0:p1]
        nv = (p1 - p0) if pm is None else int(pm.sum())
        if c.dictionary:
            values = bytes([bw]) + encode_bitpacked(idx[dpos:dpos + nv], bw)
            enc = _RLE_DICTIONARY
        else:
            values = dense[dpos:dpos + nv].tobytes()
            enc = _PLAIN
        dpos += nv
        levels = b"" if pm is None else _levels(pm)
        if v2:
            body_c = compress(values)
            body = levels + body_c
            uncompressed = len(levels) + len(values)
            hdr = _thrift([(1, "i32", _PAGE_DATA_V2),
                           (2, "i32", uncompressed),
                           (3, "i32", len(body)),
                           (8, "struct", [
                               (1, "i32", p1 - p0),
                               (2, "i32", (p1 - p0) - nv),
                               (3, "i32", p1 - p0),
                               (4, "i32", enc),
                               (5, "i32", len(levels)),
                               (6, "i32", 0),
                               (7, "bool", codec != 0)])])
        else:
            raw = (b"" if pm is None
                   else struct.pack("<I", len(levels)) + levels) + values
            body = compress(raw)
            uncompressed = len(raw)
            hdr = _thrift([(1, "i32", _PAGE_DATA),
                           (2, "i32", uncompressed),
                           (3, "i32", len(body)),
                           (5, "struct", [(1, "i32", p1 - p0),
                                          (2, "i32", enc),
                                          (3, "i32", _RLE),
                                          (4, "i32", _RLE)])])
        f.write(hdr + body)
        total_u += len(hdr) + uncompressed
        total_c += len(hdr) + len(body)
        if n == 0:
            break
    if c.labels is not None:
        lo_b, hi_b = _stat_bytes(uniq, c.is_str)
    else:
        lo_b, hi_b = _stat_bytes(dense, c.is_str)
    stats = [(3, "i64", 0 if mask is None else int((~mask).sum())),
             (5, "bin", hi_b), (6, "bin", lo_b)]
    meta = [(1, "i32", c.ptype),
            (2, ("list", "i32"), encs),
            (3, ("list", "bin"), [c.name.encode()]),
            (4, "i32", codec),
            (5, "i64", n),
            (6, "i64", total_u),
            (7, "i64", total_c),
            (9, "i64", data_off),
            (11, "i64", dict_off),
            (12, "struct", stats)]
    return [(2, "i64", start), (3, "struct", meta)], total_u
