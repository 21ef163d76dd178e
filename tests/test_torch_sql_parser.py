"""The port's SQL text front end (nvme_strom_tpu_torch/sql/parser.py) held
against the JAX package's: every query of tests/test_sql_parser.py runs
through both ``sql_query``s on the same Parquet files (written with
pyarrow, as the JAX tests write them), on the CPU, and the outputs must
agree — names in order, integer columns and labels exactly, float
columns within 1e-5 relative or 1e-4 absolute (both fold in f32, in
different orders).
The refusals raise ``SQLSyntaxError`` with the same hint in both.  The
JOIN queries run in tests/test_torch_sql.py, the fold's ``scatter``
method there too (one file takes at most 30 s alone)."""

import numpy as np
import pytest

from nvme_strom_tpu.io import StromEngine as JaxEngine
from nvme_strom_tpu.sql import ParquetScanner as JaxScanner
from nvme_strom_tpu.sql.parser import SQLSyntaxError as JaxSyntaxError
from nvme_strom_tpu.sql.parser import sql_query as jax_sql_query
from nvme_strom_tpu_torch.io.engine import StromEngine
from nvme_strom_tpu_torch.sql import ParquetScanner
from nvme_strom_tpu_torch.sql.parser import (SQLSyntaxError, parse_select,
                                             sql_query)
from nvme_strom_tpu_torch.utils.config import EngineConfig

from _torch_sql_util import same as _same


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    import pyarrow as pa
    import pyarrow.parquet as pq
    d = tmp_path_factory.mktemp("sqlp")
    rng = np.random.default_rng(7)
    n = 30_000
    data = {
        "k": rng.integers(0, 23, n).astype(np.int32),
        "v": rng.standard_normal(n).astype(np.float32),
        "w": rng.uniform(0, 1, n).astype(np.float32),
        "city": rng.choice(np.array(["tokyo", "osaka", "kyoto", "naha"]),
                           n),
    }
    pq.write_table(pa.table(data), d / "t.parquet", row_group_size=4096)
    rng = np.random.default_rng(8)
    nf, nd = 20_000, 50
    dim_key = rng.permutation(1000)[:nd].astype(np.int64)
    attr = rng.integers(0, 6, nd).astype(np.int32)
    fact = {"fk": rng.choice(dim_key, nf).astype(np.int64),
            "amount": rng.standard_normal(nf).astype(np.float32)}
    pq.write_table(pa.table(fact), d / "f.parquet", row_group_size=4096)
    pq.write_table(pa.table({"dk": dim_key, "attr": attr}),
                   d / "d.parquet")
    return d


@pytest.fixture(scope="module")
def both(files):
    cfg = EngineConfig(chunk_bytes=1 << 20, queue_depth=8,
                       buffer_pool_bytes=8 << 20)
    from nvme_strom_tpu.utils.config import EngineConfig as JaxConfig
    jcfg = JaxConfig(chunk_bytes=1 << 20, queue_depth=8,
                     buffer_pool_bytes=8 << 20)
    with StromEngine(cfg) as e, JaxEngine(jcfg) as je:
        ours = {n: ParquetScanner(files / f"{n}.parquet", e)
                for n in ("t", "f", "d")}
        theirs = {n: JaxScanner(files / f"{n}.parquet", je)
                  for n in ("t", "f", "d")}
        yield ours, theirs, e, je


QUERIES = [
    "SELECT k, COUNT(*), SUM(v), AVG(v) FROM t GROUP BY k",
    "SELECT k, SUM(v) FROM t WHERE 0.2 <= w AND w < 0.6 GROUP BY k",
    "SELECT city, COUNT(v) AS n, MEAN(v) FROM t GROUP BY city "
    "ORDER BY n DESC LIMIT 2",
    "SELECT k, SUM(v), SUM(w), MEAN(v) FROM t GROUP BY k",
    "SELECT v, k FROM t ORDER BY v DESC LIMIT 7",
    "SELECT v FROM t WHERE w > 0.5 ORDER BY v ASC LIMIT 3",
    "SELECT k, v FROM t WHERE 0.9 <= w LIMIT 10",
    "SELECT w FROM t",
    "SELECT k, COUNT(*) AS n FROM t GROUP BY k ORDER BY n DESC LIMIT 100",
    "SELECT v AS x FROM t ORDER BY x DESC LIMIT 3",
    "SELECT k, SUM(v) AS s FROM t GROUP BY k HAVING s > 0",
    "SELECT city, COUNT(v) AS n FROM t GROUP BY city HAVING n > 7000 "
    "ORDER BY n DESC LIMIT 3",
    "SELECT COUNT(*), SUM(v), AVG(v), MIN(v), MAX(v) FROM t",
    "SELECT COUNT(*) AS n, SUM(v) AS s FROM t WHERE w > 0.5",
    "SELECT SUM(v), SUM(w) FROM t",
    "SELECT COUNT(*) FROM t",
    "SELECT k, VAR(v), STDDEV(v) FROM t GROUP BY k",
    "SELECT STD(v) AS s FROM t WHERE w > 0.5",
    "SELECT k, COUNT(*), SUM(v) AS total FROM t WHERE 0.25 <= w AND "
    "w < 0.75 AND k BETWEEN 2 AND 20 GROUP BY k ORDER BY total DESC "
    "LIMIT 5",
]

@pytest.mark.parametrize("sql", QUERIES)
def test_query_matches_jax(sql, both):
    ours, theirs, _, _ = both
    a = sql_query(sql, ours, device="cpu")
    b = jax_sql_query(sql, theirs)
    _same(a, b, sql)


REFUSALS = [
    ("SELECT * FROM t", "name them"),
    ("SELECT k FROM t WHERE a = 1 OR b = 2", "OR is not"),
    ("SELECT k FROM t WHERE city = 'tokyo'", "string predicates"),
    ("SELECT k FROM t WHERE k != 3", "!="),
    ("SELECT SUM(*) FROM t", "COUNT"),
    ("SELECT k FROM t ORDER BY k", "LIMIT"),
    ("SELECT k, v FROM", "end of query"),
    ("SELECT k FROM t GROUP BY k", "aggregate"),
    ("SELECT v FROM t GROUP BY k", "group key"),
    ("SELECT k, SUM(v) FROM t GROUP BY k HAVING max(v) > 0", "HAVING"),
    ("SELECT city, COUNT(v) AS n FROM t GROUP BY city HAVING city > 5",
     "string columns"),
    ("SELECT k, SUM(v) FROM t", "bare column"),
    ("SELECT SUM(v) FROM t ORDER BY v DESC LIMIT 3", "ORDER BY"),
]


@pytest.mark.parametrize("sql,hint", REFUSALS)
def test_refusals_match_jax(sql, hint, both):
    import re
    ours, theirs, _, _ = both
    with pytest.raises(SQLSyntaxError, match=re.escape(hint)):
        sql_query(sql, ours["t"], device="cpu")
    with pytest.raises(JaxSyntaxError, match=re.escape(hint)):
        jax_sql_query(sql, theirs["t"])


@pytest.mark.parametrize("sql,kw", [
    ("SELECT d.attr, SUM(f.amount) FROM f JOIN d ON f.fk = d.dk "
     "GROUP BY d.attr", {"nulls": "skip"}),
    ("SELECT v FROM t", {"nulls": "skip"}),
    ("SELECT COUNT(*) FROM t", {"nulls": "skip"}),
    ("SELECT k, COUNT(*) FROM t GROUP BY k", {"nulls": "skip"}),
])
def test_nulls_skip_refusals_match_jax(sql, kw, both):
    ours, theirs, _, _ = both
    with pytest.raises(SQLSyntaxError):
        sql_query(sql, ours, device="cpu", **kw)
    with pytest.raises(JaxSyntaxError):
        jax_sql_query(sql, theirs, **kw)


def test_parse_full_query_and_limit():
    q = parse_select(
        "SELECT k, COUNT(*), SUM(v) AS total FROM t "
        "WHERE 0.25 <= w AND w < 0.75 AND k BETWEEN 2 AND 20 "
        "GROUP BY k ORDER BY total DESC LIMIT 5")
    assert [i.name for i in q.select] == ["k", "count(*)", "total"]
    assert ("w", ">=", 0.25) in q.where and ("w", "<", 0.75) in q.where
    assert q.group_by == "k" and q.order_by == ("total", True)
    assert q.limit == 5
    with pytest.raises(SQLSyntaxError):
        parse_select("SELECT v FROM t LIMIT 2.5")
    with pytest.raises(SQLSyntaxError):
        parse_select("SELECT v FROM t HAVING v > 1")


def test_bare_count_star_reads_no_payload(both):
    ours, _, e, _ = both
    e.sync_stats()
    before = e.stats.snapshot()
    out = sql_query("SELECT COUNT(*) FROM t", ours["t"], device="cpu")
    e.sync_stats()
    after = e.stats.snapshot()
    assert int(out["count(*)"]) == 30_000
    assert after["bytes_direct"] + after["bytes_fallback"] == \
        before["bytes_direct"] + before["bytes_fallback"]


def test_tables_by_path_and_engine(files, both):
    _, _, e, je = both
    a = sql_query("SELECT k, SUM(v) FROM u GROUP BY k",
                  {"u": str(files / "t.parquet")}, engine=e, device="cpu")
    b = jax_sql_query("SELECT k, SUM(v) FROM u GROUP BY k",
                      {"u": str(files / "t.parquet")}, engine=je)
    _same(a, b, "by path")
    with pytest.raises(ValueError, match="engine="):
        sql_query("SELECT k, SUM(v) FROM u GROUP BY k",
                  {"u": str(files / "t.parquet")}, device="cpu")
    with pytest.raises(KeyError):
        sql_query("SELECT a, SUM(b) FROM nope GROUP BY a",
                  {"u": str(files / "t.parquet")}, engine=e, device="cpu")
