"""The port's Parquet writer (nvme_strom_tpu_torch/sql/pqwrite.py) held
against pyarrow and the JAX package's scanner on the CPU: its files read
by ``pyarrow.parquet`` and by the JAX direct path equal the numpy arrays
written (v1 and v2 pages, UNCOMPRESSED and GZIP, PLAIN and
RLE_DICTIONARY of numbers and strings, optional columns, statistics that
prune); and ``python -m nvme_strom_tpu_torch.sql_query`` run in process
on the CPU prints the groups ``examples/sql_query.py`` prints on the same
seed (tests/test_example.py's case)."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from nvme_strom_tpu import sql as J
from nvme_strom_tpu_torch import sql as T
from nvme_strom_tpu_torch.sql.pqwrite import encode_bitpacked, write_parquet

from _torch_sql_util import engine_pair

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CITIES = np.array(["tokyo", "osaka", "kyoto", "nagoya", "sapporo"])


@pytest.fixture(scope="module")
def engines():
    e, je = engine_pair()
    with e, je:
        yield e, je


def _cols(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, 9, n).astype(np.int32),
            "v": rng.standard_normal(n).astype(np.float32),
            "t": np.arange(n, dtype=np.int64),
            "d": rng.standard_normal(n),
            "dv": rng.integers(0, 5, n).astype(np.float32),
            "one": np.full(n, 7, np.int32),
            "city": CITIES[rng.integers(0, 5, n)],
            "cc": (CITIES, rng.integers(0, 5, n))}


@pytest.mark.parametrize("ver", ["1.0", "2.0"])
@pytest.mark.parametrize("comp", ["none", "gzip"])
def test_written_files_read_back(ver, comp, tmp_path, engines):
    import pyarrow.parquet as pq
    e, je = engines
    n = 30_000
    cols = _cols(n)
    valid = np.random.default_rng(1).random(n) > 0.1
    path = tmp_path / "w.parquet"
    write_parquet(path, cols, row_group_size=7000, page_bytes=8192,
                  data_page_version=ver, compression=comp,
                  dictionary=["city", "cc", "dv", "one"],
                  nulls={"d": valid})
    tbl = pq.read_table(path)
    for c in ("k", "v", "t", "dv", "one"):
        assert np.array_equal(tbl[c].to_numpy(), cols[c]), c
    assert tbl["city"].to_pylist() == list(cols["city"])
    assert tbl["cc"].to_pylist() == list(CITIES[cols["cc"][1]])
    d = tbl["d"].to_numpy(zero_copy_only=False)
    assert np.array_equal(np.isnan(d), ~valid)
    assert np.array_equal(d[valid], cols["d"][valid])
    md = pq.read_metadata(path)
    st = md.row_group(1).column(0).statistics
    assert (st.min, st.max) == (cols["k"][7000:14000].min(),
                                cols["k"][7000:14000].max())
    assert md.row_group(0).column(3).statistics.null_count == \
        int((~valid[:7000]).sum())
    # the JAX package's direct path and the port's read it alike
    jsc = J.ParquetScanner(path, je)
    assert jsc.direct_reasons(["k", "v", "dv"]) == \
        {"k": None, "v": None, "dv": None}
    jcols = jsc.read_columns_to_device(["k", "v", "dv"], direct="always")
    got = T.ParquetScanner(path, e).read_columns_to_device(
        ["k", "v", "t", "dv", "one"], device=CPU, direct="always")
    for c in ("k", "v", "dv"):
        assert np.array_equal(np.asarray(jcols[c]), cols[c]), c
    for c in got:
        assert np.array_equal(got[c].numpy(), cols[c]), c
    a = J.sql_groupby_str(jsc, "city", "v")
    b = T.sql_groupby_str(T.ParquetScanner(path, e), "city", "v",
                          device=CPU)
    assert a["labels"] == b["labels"]
    np.testing.assert_allclose(np.asarray(a["sum"]), b["sum"].numpy(),
                               rtol=1e-5, atol=1e-4)


def test_pruning_statistics_and_refusals(tmp_path, engines):
    e, _ = engines
    path = tmp_path / "p.parquet"
    write_parquet(path, {"t": np.arange(10_000, dtype=np.int64)},
                  row_group_size=1000)
    sc = T.ParquetScanner(path, e)
    assert sc.prune_row_groups([("t", 2500, 4100)]) == [2, 3, 4]
    with pytest.raises(ValueError, match="dictionary"):
        write_parquet(tmp_path / "s.parquet",
                      {"s": np.array(["a", "b"])})
    with pytest.raises(ValueError, match="compression"):
        write_parquet(tmp_path / "z.parquet", {"a": np.arange(3)},
                      compression="zstd")
    with pytest.raises(ValueError, match="unequal"):
        write_parquet(tmp_path / "u.parquet",
                      {"a": np.arange(3), "b": np.arange(4)})


def test_bitpacked_encoding_decodes():
    from nvme_strom_tpu.sql.pq_direct import decode_rle_hybrid
    rng = np.random.default_rng(2)
    for bw in (0, 1, 3, 8, 13, 24):
        vals = rng.integers(0, 1 << bw, 1001) if bw else np.zeros(1001)
        got = decode_rle_hybrid(encode_bitpacked(vals, bw), bw, 1001)
        assert np.array_equal(got, vals.astype(np.int32)), bw


def _groups(text: str) -> list:
    """The lines that carry query results (the timings differ)."""
    keep = []
    for line in text.splitlines():
        if line.startswith(("synthesized", "  [")):
            continue
        keep.append(re.sub(r"np\.int32\((\d+)\)", r"\1", line))
    return keep


def test_entry_point_prints_the_example_groups(capsys):
    from nvme_strom_tpu_torch import sql_query
    argv = ["--rows", "50000", "--where", "w", "100", "5000"]
    assert sql_query.main(argv + ["--device", "cpu"]) == 0
    ours = capsys.readouterr().out
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable,
                        os.path.join(REPO, "examples", "sql_query.py"),
                        *argv], capture_output=True, text=True,
                       timeout=240, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "GROUP BY k" in ours and "top-3 by count" in ours
    assert _groups(ours) == _groups(r.stdout)
    with pytest.raises(SystemExit):
        sql_query.main(["--rows", "100", "--compression", "zstd",
                        "--device", "cpu"])


def test_entry_point_sql_string(capsys):
    from nvme_strom_tpu_torch import sql_query
    assert sql_query.main(["--rows", "20000", "--device", "cpu", "--sql",
                           "SELECT k, COUNT(*) AS n FROM t GROUP BY k "
                           "ORDER BY n DESC LIMIT 3"]) == 0
    out = capsys.readouterr().out
    assert "  n: [" in out and "  k: [" in out
