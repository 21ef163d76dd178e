"""The port's direct Parquet decode (nvme_strom_tpu_torch/sql/pq_direct.py)
and its host path (sql/parquet.py) held against the JAX package and
pyarrow on the CPU, over the file shapes of tests/test_pq_direct.py whose
codec the port has (none, SNAPPY, GZIP): page headers, plans (spans, bit
widths, masks) equal to the JAX planner's, decoded columns equal to
pyarrow's bitwise on both paths, nulls under ``nulls="mask"``.  ZSTD,
BROTLI, DELTA encodings and nested fields: the reason equals the JAX
``eligible_chunk``'s and the host path raises ``NotImplementedError``
naming the column."""

import os

import numpy as np
import pytest
import torch

from nvme_strom_tpu.sql import pq_direct as jpq
from nvme_strom_tpu.sql.parquet import ParquetScanner as JaxScanner
from nvme_strom_tpu_torch.sql import pq_direct
from nvme_strom_tpu_torch.sql.parquet import ParquetScanner

from _torch_sql_util import engine_pair

CPU = "cpu"


@pytest.fixture(scope="module")
def engines():
    e, je = engine_pair(chunk_bytes=64 << 10, pool_bytes=4 << 20)
    with e, je:
        yield e, je


def _table(rows=5000, seed=0, nulls=False):
    import pyarrow as pa
    rng = np.random.default_rng(seed)
    cols = {
        "i32": pa.array(rng.integers(-2**31, 2**31 - 1, rows,
                                     dtype=np.int64).astype(np.int32)),
        "i64": pa.array(rng.integers(-2**62, 2**62, rows, dtype=np.int64)),
        "f32": pa.array(rng.standard_normal(rows).astype(np.float32)),
        "f64": pa.array(rng.standard_normal(rows)),
        "d32": pa.array(rng.integers(0, 40, rows).astype(np.int32)),
    }
    if nulls:
        v = rng.integers(0, 1000, rows)
        cols["n32"] = pa.array([None if (i % 11 == 0 or 200 <= i < 300)
                                else int(x) for i, x in enumerate(v)],
                               pa.int32())
    return pa.table(cols)


SHAPES = {
    "plain": dict(compression="none", use_dictionary=False),
    "plain_v2": dict(compression="none", use_dictionary=False,
                     data_page_version="2.0"),
    "dict": dict(compression="none", use_dictionary=True),
    "dict_fallback": dict(compression="none", use_dictionary=True,
                          dictionary_pagesize_limit=512,
                          data_page_size=2048),
    "bss": dict(compression="none", use_dictionary=False,
                column_encoding={"f32": "BYTE_STREAM_SPLIT",
                                 "f64": "BYTE_STREAM_SPLIT"}),
    "snappy": dict(compression="snappy", use_dictionary=False),
    "snappy_v2_dict": dict(compression="snappy", use_dictionary=True,
                           data_page_version="2.0"),
    "gzip_dict": dict(compression="gzip", use_dictionary=True),
    "gzip_v2": dict(compression="gzip", use_dictionary=False,
                    data_page_version="2.0"),
    "row_groups_small_pages": dict(compression="none",
                                   use_dictionary=False,
                                   row_group_size=700, data_page_size=1024),
    "big_pages": dict(compression="none", use_dictionary=False,
                      data_page_size=1 << 20),
}
COLS = ["i32", "i64", "f32", "f64", "d32"]


def _plan_key(plan):
    return ([(p.kind, p.span, p.num_values, p.bit_width, p.codec,
              p.uncompressed_len, p.inline_levels, p.max_def, p.n_valid,
              None if p.mask is None else np.asarray(p.mask).tolist())
             for p in plan.parts],
            plan.num_values, plan.physical_type, plan.dict_span,
            plan.dict_count, plan.dict_codec, plan.dict_uncompressed_len)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_decode_matches_pyarrow_and_jax_plans(shape, tmp_path, engines):
    import pyarrow.parquet as pq
    e, je = engines
    tbl = _table(rows=6000, seed=len(shape))
    path = tmp_path / f"{shape}.parquet"
    pq.write_table(tbl, path, **SHAPES[shape])
    sc = ParquetScanner(path, e)
    plans = pq_direct.plan_columns(sc, COLS)
    jsc = JaxScanner(path, je)
    # the JAX planner refuses 8-byte types without x64: compare the rest
    jplans = jpq.plan_columns(jsc, ["i32", "f32", "d32"])
    for c in jplans:
        assert [_plan_key(p) for p in plans[c]] == \
            [_plan_key(p) for p in jplans[c]], c
    for direct in ("always", "never"):
        got = sc.read_columns_to_device(COLS, device=CPU, direct=direct)
        for c in COLS:
            want = tbl.column(c).to_numpy()
            assert got[c].dtype == torch.from_numpy(want).dtype
            assert np.array_equal(got[c].numpy(), want), (c, direct)
    jgot = jsc.read_columns_to_device(["i32", "f32", "d32"])
    for c in jgot:
        assert np.array_equal(np.asarray(jgot[c]), got[c].numpy())


@pytest.mark.parametrize("comp", ["none", "snappy"])
@pytest.mark.parametrize("ver", ["1.0", "2.0"])
@pytest.mark.parametrize("use_dict", [False, True])
def test_null_mask_matches_pyarrow_and_jax(comp, ver, use_dict, tmp_path,
                                           engines):
    import pyarrow.parquet as pq
    e, je = engines
    tbl = _table(rows=3000, nulls=True)
    path = tmp_path / "n.parquet"
    pq.write_table(tbl, path, compression=comp, data_page_version=ver,
                   use_dictionary=use_dict, data_page_size=2048)
    ref = tbl.column("n32").to_numpy(zero_copy_only=False)
    valid = ~np.isnan(ref)
    sc = ParquetScanner(path, e)
    jv, jm = JaxScanner(path, je).read_columns_to_device(
        ["n32"], nulls="mask")["n32"]
    for direct in ("always", "never"):
        v, m = sc.read_columns_to_device(["n32"], device=CPU, nulls="mask",
                                         direct=direct)["n32"]
        assert np.array_equal(m.numpy(), valid), direct
        assert np.array_equal(v.numpy()[valid], ref[valid]), direct
        assert not v.numpy()[~valid].any(), direct
        assert np.array_equal(m.numpy(), np.asarray(jm))
        assert np.array_equal(v.numpy(), np.asarray(jv))
    with pytest.raises(ValueError, match="nulls"):
        sc.read_columns_to_device(["n32"], device=CPU, direct="never")


@pytest.mark.parametrize("shape,column,why", [
    ("zstd", "i32", "compression ZSTD"),
    ("brotli", "f32", "compression BROTLI"),
    ("delta", "i32", "encodings"),
])
def test_refusals_name_the_reason(shape, column, why, tmp_path, engines):
    import pyarrow.parquet as pq
    e, je = engines
    kw = {"zstd": dict(compression="zstd"),
          "brotli": dict(compression="brotli"),
          "delta": dict(compression="none", use_dictionary=False,
                        column_encoding={"i32": "DELTA_BINARY_PACKED"})}
    path = tmp_path / f"{shape}.parquet"
    pq.write_table(_table(rows=2000), path, **kw[shape])
    sc = ParquetScanner(path, e)
    ours = sc.direct_reasons([column])[column]
    theirs = JaxScanner(path, je).direct_reasons([column])[column]
    assert why in ours
    # the JAX package decodes ZSTD and BROTLI pages through pyarrow's
    # codecs; the port carries no such codec and says so
    assert ours == theirs or (theirs is None and "compression" in why)
    with pytest.raises(ValueError, match="not direct-eligible"):
        sc.read_columns_to_device([column], device=CPU, direct="always")
    with pytest.raises(NotImplementedError, match=column):
        sc.read_columns_to_device([column], device=CPU)


def test_nested_refused(tmp_path, engines):
    import pyarrow as pa
    import pyarrow.parquet as pq
    e, je = engines
    path = tmp_path / "l.parquet"
    pq.write_table(pa.table({"l": pa.array([[1, 2], [3]] * 50,
                                           pa.list_(pa.int32()))}), path)
    sc = ParquetScanner(path, e)
    ours = sc.direct_reasons(["element"])
    assert ours == JaxScanner(path, je).direct_reasons(["element"])
    assert "repeated" in ours["element"]
    with pytest.raises(NotImplementedError, match="element"):
        sc.read_columns_to_device(["element"], device=CPU)


def test_page_headers_match_jax(tmp_path):
    import pyarrow.parquet as pq
    path = tmp_path / "h.parquet"
    pq.write_table(_table(rows=4000), path, compression="snappy",
                   use_dictionary=True, data_page_version="2.0",
                   data_page_size=1024)
    meta = ParquetScanner.__new__(ParquetScanner)
    from nvme_strom_tpu_torch.sql import pqmeta
    md = pqmeta.read_metadata(path)
    with open(path, "rb") as f:
        def rd(off, ln):
            return os.pread(f.fileno(), ln, off)
        n = 0
        for ci in range(md.num_columns):
            col = md.row_group(0).column(ci)
            for pos, ph in pq_direct._walk_pages(col, rd):
                jph = jpq.parse_page_header(rd(pos, 1024))
                assert ph == pq_direct.PageHeader(*[getattr(jph, f) for f in
                                                    jph.__dataclass_fields__])
                n += 1
    assert n > 10
    del meta


def test_rle_hybrid_host_decoder_matches_jax():
    rng = np.random.default_rng(5)
    for bw in (1, 3, 7, 8, 13, 20, 31):
        vals = rng.integers(0, 1 << min(bw, 31), 777)
        from nvme_strom_tpu_torch.sql.pqwrite import encode_bitpacked
        # an RLE run of 12 copies of 5, then the packed values
        buf = bytes([0x18]) + (5).to_bytes((bw + 7) // 8, "little") + \
            encode_bitpacked(vals, bw)
        ours = pq_direct.decode_rle_hybrid(buf, bw, len(vals) + 12)
        theirs = jpq.decode_rle_hybrid(buf, bw, len(ours))
        assert np.array_equal(ours, theirs), bw


def test_dict_code_scan_matches_jax(tmp_path, engines):
    import pyarrow as pa
    import pyarrow.parquet as pq
    e, je = engines
    rng = np.random.default_rng(2)
    labels = np.array(["north", "south", "east", "west", "up"])
    tbl = pa.table({"s": pa.array(labels[rng.integers(0, 5, 9000)]),
                    "v": pa.array(rng.standard_normal(9000)
                                  .astype(np.float32))})
    path = tmp_path / "s.parquet"
    pq.write_table(tbl, path, row_group_size=2500, use_dictionary=["s"],
                   compression="snappy")
    ours, it = pq_direct.read_dict_key_column(ParquetScanner(path, e), "s",
                                              device=CPU)
    theirs, jit = jpq.read_dict_key_column(JaxScanner(path, je), "s")
    assert ours == theirs
    assert np.array_equal(torch.cat(list(it())).numpy(),
                          np.concatenate([np.asarray(x) for x in jit()]))
    plain = tmp_path / "p.parquet"
    pq.write_table(tbl, plain, use_dictionary=False)
    with pytest.raises(ValueError, match="dict-code"):
        pq_direct.read_dict_key_column(ParquetScanner(plain, e), "s",
                                       device=CPU)


def test_empty_table(tmp_path, engines):
    import pyarrow as pa
    import pyarrow.parquet as pq
    e, _ = engines
    path = tmp_path / "e.parquet"
    pq.write_table(pa.table({"a": pa.array([], pa.int32()),
                             "b": pa.array([], pa.float64())}), path)
    got = ParquetScanner(path, e).read_columns_to_device(["a", "b"],
                                                         device=CPU)
    assert got["a"].shape == (0,) and got["a"].dtype == torch.int32
    assert got["b"].shape == (0,) and got["b"].dtype == torch.float64


def test_pipelined_iter_windows_and_pruning(tmp_path, engines):
    import pyarrow as pa
    import pyarrow.parquet as pq
    e, je = engines
    rng = np.random.default_rng(9)
    data = {"a": np.arange(30_000, dtype=np.int32),
            "b": rng.standard_normal(30_000).astype(np.float32)}
    path = tmp_path / "w.parquet"
    pq.write_table(pa.table(data), path, row_group_size=4096,
                   use_dictionary=False, compression="none")
    sc = ParquetScanner(path, e)
    groups = [1, 3, 4, 6]
    got = list(pq_direct.iter_plain_row_groups_to_device(
        sc, ["a", "b"], device=CPU, row_groups=groups))
    assert len(got) == len(groups)
    for rg, cols in zip(groups, got):
        lo = rg * 4096
        assert np.array_equal(cols["a"].numpy(),
                              data["a"][lo:lo + 4096])
    win = list(pq_direct.iter_plain_row_groups_to_device(
        sc, ["a", "b"], device=CPU, window_bytes=100_000))
    jwin = list(jpq.iter_plain_row_groups_to_device(
        JaxScanner(path, je), ["a", "b"], window_bytes=100_000))
    assert [w["a"].shape[0] for w in win] == \
        [int(w["a"].shape[0]) for w in jwin]
    assert np.array_equal(torch.cat([w["b"] for w in win]).numpy(),
                          data["b"])
