"""The port's top-k, star join and device cache (nvme_strom_tpu_torch/sql/)
held against the JAX package's executors on the same Parquet files, on
the CPU: the cases of tests/test_topk.py, test_join.py,
test_device_cache.py and the JOIN queries of test_sql_parser.py.  Row
ids and integers must be equal, float aggregates within 1e-5 relative or
1e-4 absolute (both fold in f32, in different orders).  Every entry
point runs on ``cuda:0`` unless given ``device="cpu"``."""

import numpy as np
import pytest
import torch

from nvme_strom_tpu import sql as J
from nvme_strom_tpu_torch import sql as T

from _torch_sql_util import engine_pair, same, scanner_pairs, write_tables

CPU = "cpu"
AGGS = ("count", "sum", "mean", "min", "max", "var", "std")
JOIN_QUERIES = [       # tests/test_sql_parser.py's JOIN queries
    "SELECT d.attr, COUNT(*), SUM(f.amount) FROM f JOIN d ON f.fk = d.dk "
    "GROUP BY d.attr",
    "SELECT d.attr, SUM(f.amount) AS s FROM f JOIN d ON f.fk = d.dk "
    "WHERE f.amount > 0 GROUP BY d.attr ORDER BY s DESC LIMIT 2",
    "SELECT d.attr, COUNT(*) AS n FROM f JOIN d ON f.fk = d.dk "
    "GROUP BY d.attr HAVING n > 999999 ORDER BY n DESC LIMIT 3",
    "SELECT d.attr, VAR(f.amount) FROM f JOIN d ON f.fk = d.dk "
    "GROUP BY d.attr",
]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_tables(tmp_path_factory.mktemp("sqlj"))


@pytest.fixture(scope="module")
def sc(files):
    e, je = engine_pair()
    with e, je:
        yield scanner_pairs(files, e, je)


@pytest.mark.parametrize("kw", [
    dict(by="v", columns=["k", "w"]),
    dict(by="v", descending=False, k=5),
    dict(by="w", columns=["v"], where_ranges=[("ts", 20_000, 30_000)]),
    dict(by="ts", k=4),
    dict(by="v", where=lambda c: c["w"] > 500, where_columns=("w",)),
])
def test_sql_topk_matches_jax(kw, sc):
    ours, theirs, _, _ = sc
    a = T.sql_topk(ours["t"], device=CPU, **kw)
    b = J.sql_topk(theirs["t"], **kw)
    same(a, b, str(kw), keys_in_order=False)


def test_topk_nulls_skip_matches_jax(sc):
    ours, theirs, _, _ = sc
    a = T.sql_topk(ours["n"], "x", columns=["k"], k=9, nulls="skip",
                   device=CPU)
    b = J.sql_topk(theirs["n"], "x", columns=["k"], k=9, nulls="skip")
    same(a, b, "topk skip", keys_in_order=False)


@pytest.mark.parametrize("method", ["matmul", "scatter"])
def test_star_join_matches_jax(method, sc):
    ours, theirs, _, _ = sc
    a = T.star_join_groupby(ours["f"], "fk", "amount", ours["d"], "dk",
                            "attr", 6, aggs=AGGS, method=method,
                            device=CPU)
    b = J.star_join_groupby(theirs["f"], "fk", "amount", theirs["d"], "dk",
                            "attr", 6, aggs=AGGS, method=method)
    same(a, b, method, keys_in_order=False)


@pytest.mark.parametrize("sql", JOIN_QUERIES)
def test_join_queries_match_jax(sql, sc):
    ours, theirs, _, _ = sc
    a = T.sql_query(sql, ours, device=CPU)
    b = J.sql_query(sql, theirs)
    same(a, b, sql)


def test_join_refusals():
    from nvme_strom_tpu_torch.sql.join import check_unique, lookup_unique
    with pytest.raises(ValueError, match="duplicate"):
        check_unique(torch.tensor([1, 2, 2]))
    with pytest.raises(ValueError, match="empty"):
        check_unique(torch.tensor([], dtype=torch.int64))
    idx, found = lookup_unique(torch.tensor([30, 10, 20]),
                               torch.tensor([20, 5, 30, 10]))
    assert found.tolist() == [True, False, True, True]
    assert idx[found].tolist() == [2, 0, 1]


def test_device_table_matches_jax(sc):
    ours, theirs, e, je = sc
    a_t = T.DeviceTable(ours["t"], ["k", "v", "w", "ts"], device=CPU)
    b_t = J.DeviceTable(theirs["t"], ["k", "v", "w", "ts"])
    same(a_t.groupby("k", "v", 37, aggs=AGGS),
         b_t.groupby("k", "v", 37, aggs=AGGS), "cache groupby",
         keys_in_order=False)
    same(a_t.scalar_agg("v", where_ranges=[("w", 0, 300)]),
         b_t.scalar_agg("v", where_ranges=[("w", 0, 300)]), "cache scalar",
         keys_in_order=False)
    for desc in (True, False):
        same(a_t.topk("v", columns=["v", "k"], k=6, descending=desc),
             b_t.topk("v", columns=["v", "k"], k=6, descending=desc),
             f"cache topk {desc}", keys_in_order=False)
    f_t = T.DeviceTable(ours["f"], ["fk", "amount"], device=CPU)
    d_t = T.DeviceTable(ours["d"], ["dk", "attr"], device=CPU)
    jf = J.DeviceTable(theirs["f"], ["fk", "amount"])
    jd = J.DeviceTable(theirs["d"], ["dk", "attr"])
    same(f_t.star_join_groupby("fk", "amount", d_t, "dk", "attr", 6),
         jf.star_join_groupby("fk", "amount", jd, "dk", "attr", 6),
         "cache join", keys_in_order=False)
    e.sync_stats()
    before = e.stats.snapshot()
    a_t.groupby("k", "v", 37)
    e.sync_stats()
    after = e.stats.snapshot()
    assert after["bytes_direct"] + after["bytes_fallback"] == \
        before["bytes_direct"] + before["bytes_fallback"]
    with pytest.raises(ValueError, match="budget"):
        T.DeviceTable(ours["t"], ["k", "v"], device=CPU, budget_bytes=1024)


@pytest.mark.parametrize("method", ["matmul", "scatter"])
def test_count_exact_past_f32_integers(method):
    """A cached table folds whole: a group of 2^24 + 3 rows keeps an
    exact COUNT (an f32 count stops at 2^24), in GROUP BY and in the
    scalar COUNT."""
    n = (1 << 24) + 5
    keys = torch.zeros(n, dtype=torch.int32)
    keys[:2] = 1
    t = T.DeviceTable.__new__(T.DeviceTable)     # the columns as cached
    t.device, t.num_rows = torch.device(CPU), n
    t.columns = {"k": keys, "v": torch.ones(n, dtype=torch.float32)}
    r = t.groupby("k", "v", 2, aggs=("count", "sum"), method=method)
    assert r["count"].dtype == torch.int32
    assert r["count"].tolist() == [n - 2, 2]
    assert int(t.scalar_agg("v", aggs=("count",))["count"]) == n


def test_entry_points_default_to_cuda(sc, files):
    """With no device named, every entry point takes cuda:0: on a
    machine without one it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from nvme_strom_tpu_torch.formats.arrow import (ArrowFileReader,
                                                    write_arrow_file)
    ours, _, e, _ = sc
    p = files / "a.arrow"
    write_arrow_file(p, {"a": np.arange(10, dtype=np.int32)})
    calls = [
        lambda: ours["t"].read_columns_to_device(["k"]),
        lambda: T.sql_query("SELECT k, COUNT(*) FROM t GROUP BY k", ours),
        lambda: T.sql_groupby(ours["t"], "k", "v", 37),
        lambda: T.sql_groupby_str(ours["t"], "city", "v"),
        lambda: T.sql_topk(ours["t"], "v"),
        lambda: T.star_join_groupby(ours["f"], "fk", "amount", ours["d"],
                                    "dk", "attr", 6),
        lambda: T.DeviceTable(ours["t"], ["k"]),
        lambda: T.multi_groupby([ours["t"]], "k", "v", 37),
        lambda: T.dist_groupby([ours["t"]], "k", "v", 37),
        lambda: ArrowFileReader(p).read_columns_to_device(e),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
