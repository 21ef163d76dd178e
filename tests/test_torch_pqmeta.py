"""The port's Parquet footer reader (nvme_strom_tpu_torch/sql/pqmeta.py)
held against ``pyarrow.parquet.read_metadata`` field by field, over every
file shape the JAX package's SQL tests write: v1 and v2 pages, nulls,
dictionary fallback mid-chunk, BYTE_STREAM_SPLIT, several row groups,
each codec, strings, 8-byte types, nested and repeated columns, page
indexes, and no statistics.  Also the Thrift compact corners: a list
whose size nibble is 15, booleans in the type nibble, long field-id
deltas, unknown fields skipped, truncation."""

import numpy as np
import pytest

from nvme_strom_tpu_torch.sql import pqmeta

SCHEMA_FIELDS = ("name", "path", "physical_type", "max_definition_level",
                 "max_repetition_level", "converted_type", "logical_type")
CHUNK_FIELDS = ("physical_type", "compression", "encodings",
                "path_in_schema", "num_values", "data_page_offset",
                "dictionary_page_offset", "total_compressed_size",
                "total_uncompressed_size", "file_offset")
STAT_FIELDS = ("has_min_max", "min", "max", "null_count")


def _table(n=6000, seed=0):
    import pyarrow as pa
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal(n).astype(np.float32)
    return pa.table({
        "i32": pa.array(rng.integers(-100, 100, n, dtype=np.int32)),
        "i64": pa.array(rng.integers(-2**40, 2**40, n)),
        "f": pa.array(vals),
        "d": pa.array(vals.astype(np.float64)),
        "s": pa.array(np.array(["a", "bb", "ccc"])[rng.integers(0, 3, n)]),
        "o": pa.array([None if i % 7 == 0 else float(i) for i in range(n)],
                      pa.float32()),
        "b": pa.array(rng.random(n) > 0.5),
        "u": pa.array(rng.integers(0, 2**31, n, dtype=np.uint32)),
        "l": pa.array([[1, 2]] * n),
        "st": pa.array([{"x": 1, "y": float(i)} for i in range(n)]),
    })


SHAPES = {
    "default": dict(),
    "v2_gzip": dict(compression="gzip", data_page_version="2.0"),
    "bss": dict(compression="none", use_dictionary=False,
                column_encoding={"f": "BYTE_STREAM_SPLIT",
                                 "d": "BYTE_STREAM_SPLIT"}),
    "zstd_row_groups_page_index": dict(compression="zstd",
                                       row_group_size=1000,
                                       write_page_index=True),
    "no_stats": dict(write_statistics=False),
    "dict_fallback": dict(dictionary_pagesize_limit=256,
                          data_page_size=512),
    "brotli_lz4": dict(compression={"i32": "brotli", "f": "lz4"}),
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_footer_matches_pyarrow(shape, tmp_path):
    import pyarrow.parquet as pq
    path = tmp_path / f"{shape}.parquet"
    pq.write_table(_table(), path, **SHAPES[shape])
    a = pq.read_metadata(path)
    b = pqmeta.read_metadata(path)
    assert (a.num_rows, a.num_row_groups, a.num_columns) == \
        (b.num_rows, b.num_row_groups, b.num_columns)
    assert a.created_by == b.created_by
    for i in range(a.num_columns):
        x, y = a.schema.column(i), b.schema.column(i)
        for f in SCHEMA_FIELDS:
            assert str(getattr(x, f)) == str(getattr(y, f)), (i, f)
    for rg in range(a.num_row_groups):
        assert a.row_group(rg).num_rows == b.row_group(rg).num_rows
        assert a.row_group(rg).total_byte_size == \
            b.row_group(rg).total_byte_size
        for ci in range(a.num_columns):
            x, y = a.row_group(rg).column(ci), b.row_group(rg).column(ci)
            for f in CHUNK_FIELDS:
                assert getattr(x, f) == getattr(y, f), (rg, ci, f)
            sx, sy = x.statistics, y.statistics
            assert (sx is None) == (sy is None), (rg, ci)
            if sx is not None:
                for f in STAT_FIELDS:
                    assert getattr(sx, f) == getattr(sy, f), (rg, ci, f)


def _compact(*fields) -> bytes:
    """A struct of (id, type, raw bytes) in the compact protocol."""
    out, last = bytearray(), 0
    for fid, t, raw in fields:
        d = fid - last
        if 0 < d <= 15:
            out.append((d << 4) | t)
        else:
            out.append(t)
            z = (fid << 1) ^ (fid >> 63)
            out += _varint(z)
        out += raw
        last = fid
    out.append(0)
    return bytes(out)


def _varint(n):
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def test_compact_corners():
    zz = lambda v: _varint((v << 1) ^ (v >> 63))  # noqa: E731
    # a list of 20 i32 (size nibble 15, varint size), a true and a false
    # bool in the type nibble, a field id 40 past the last (a long
    # delta), an unknown nested struct, a double
    lst = bytes([0xF5]) + _varint(20) + b"".join(zz(i) for i in range(20))
    inner = _compact((1, 5, zz(7)), (3, 8, _varint(2) + b"hi"))
    buf = _compact((1, 9, lst), (2, 1, b""), (3, 2, b""),
                   (43, 6, zz(-2**40)), (44, 12, inner),
                   (45, 7, np.float64(2.5).tobytes()))
    d = pqmeta.Compact(buf).struct()
    assert d[1] == list(range(20))
    assert d[2] is True and d[3] is False
    assert d[43] == -2**40
    assert d[44] == {1: 7, 3: b"hi"}
    assert d[45] == 2.5
    with pytest.raises(pqmeta.ThriftError):
        pqmeta.Compact(buf[:len(buf) // 2]).struct()


def test_not_parquet_raises(tmp_path):
    p = tmp_path / "x.parquet"
    p.write_bytes(b"PAR1" + bytes(100) + b"nope")
    with pytest.raises(ValueError, match="magic"):
        pqmeta.read_metadata(p)
