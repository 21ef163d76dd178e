"""The port's GROUP BY (nvme_strom_tpu_torch/sql/groupby.py, scan_plan.py)
held against the JAX package's executors on the same Parquet files
(written with pyarrow, as the JAX tests write them) and the same arrays,
on the CPU: the cases of tests/test_sql.py and test_sql_scan.py.
Integers and labels must be equal, float aggregates within 1e-5
relative or 1e-4 absolute (both fold in f32, in different orders).
Keys outside [0, num_groups) are dropped, as the JAX fold drops them.
Top-k, the star join and the device cache: tests/test_torch_sql_join.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nvme_strom_tpu import sql as J
from nvme_strom_tpu.sql import groupby as jgb
from nvme_strom_tpu_torch import sql as T
from nvme_strom_tpu_torch.sql import groupby as tgb

from _torch_sql_util import (engine_pair, host, same, scanner_pairs,
                             write_tables)

CPU = "cpu"
AGGS = ("count", "sum", "mean", "min", "max", "var", "std")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_tables(tmp_path_factory.mktemp("sqlx"))


@pytest.fixture(scope="module")
def sc(files):
    e, je = engine_pair()
    with e, je:
        yield scanner_pairs(files, e, je)


# -- the fold ---------------------------------------------------------------

@pytest.mark.parametrize("method", ["matmul", "scatter"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cols", [1, 3])
def test_groupby_aggregate_matches_jax(method, masked, cols):
    rng = np.random.default_rng(3)
    n, g = 5000, 13
    keys = rng.integers(0, g - 2, n).astype(np.int32)   # 2 empty groups
    vals = rng.standard_normal((n, cols) if cols > 1 else n) \
        .astype(np.float32)
    mask = rng.random(n) > 0.3 if masked else None
    a = tgb.groupby_aggregate(torch.from_numpy(keys),
                              torch.from_numpy(vals), g, aggs=AGGS,
                              method=method,
                              mask=None if mask is None
                              else torch.from_numpy(mask))
    b = jgb.groupby_aggregate(jnp.asarray(keys), jnp.asarray(vals), g,
                              aggs=AGGS, method=method,
                              mask=None if mask is None
                              else jnp.asarray(mask))
    same(a, b, f"{method} masked={masked}", keys_in_order=False)


@pytest.mark.parametrize("method", ["matmul", "scatter"])
def test_keys_out_of_range_are_dropped(method):
    """A negative key and keys at and past num_groups drop out, as JAX's
    one_hot / segment ops drop them (torch's index_add_ would assert on
    the card)."""
    keys = np.array([0, 1, -1, 4, 2, 5, 4, 1, -7, 3], np.int32)
    vals = np.arange(10, dtype=np.float32) + 0.5
    a = tgb.groupby_aggregate(torch.from_numpy(keys), torch.from_numpy(vals),
                              4, aggs=AGGS, method=method)
    b = jgb.groupby_aggregate(jnp.asarray(keys), jnp.asarray(vals), 4,
                              aggs=AGGS, method=method)
    same(a, b, method, keys_in_order=False)
    assert host(a["count"]).tolist() == [1, 2, 1, 1]
    assert host(a["sum"]).tolist() == [0.5, 1.5 + 7.5, 4.5, 9.5]


def test_full_fp32_during_the_fold():
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with tgb.full_fp32():
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def test_top_k_groups_matches_jax():
    rng = np.random.default_rng(4)
    res = {"sum": rng.standard_normal(20).astype(np.float32),
           "count": rng.integers(0, 5, 20).astype(np.int32)}
    res["sum"][3] = np.nan
    for desc in (True, False):
        a = tgb.top_k_groups({k: torch.from_numpy(v) for k, v in
                              res.items()}, "count", 7, descending=desc)
        b = jgb.top_k_groups({k: jnp.asarray(v) for k, v in res.items()},
                             "count", 7, descending=desc)
        same(a, b, f"desc={desc}")


# -- scans ------------------------------------------------------------------

GROUPBY_CASES = [
    dict(),
    dict(method="scatter"),
    dict(aggs=AGGS),
    dict(where_ranges=[("w", 100, 600)]),
    dict(where_ranges=[("ts", 10_000, 22_000)], aggs=("count", "sum")),
    dict(value_column=["v", "w"], aggs=("sum", "mean", "max")),
    dict(where=lambda c: c["v"] > 0, where_columns=("v",)),
]


@pytest.mark.parametrize("case", range(len(GROUPBY_CASES)))
def test_sql_groupby_matches_jax(case, sc):
    ours, theirs, e, je = sc
    kw = dict(GROUPBY_CASES[case])
    value = kw.pop("value_column", "v")
    a = T.sql_groupby(ours["t"], "k", value, 37, device=CPU, **kw)
    b = J.sql_groupby(theirs["t"], "k", value, 37, **kw)
    same(a, b, str(case), keys_in_order=False)


@pytest.mark.parametrize("env", [{"STROM_SQL_WORKERS": "1",
                                  "STROM_SQL_PUSHDOWN": "0"},
                                 {"STROM_SQL_WORKERS": "3"},
                                 {"STROM_SQL_WINDOW_BYTES": "0"}])
def test_scan_routes_agree(env, sc, monkeypatch):
    """The serial stack, the partition-parallel pool and one window a
    row group give the JAX answer, with the same zone-map counters."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ours, theirs, e, je = sc
    e.sync_stats()
    je.sync_stats()
    s0, j0 = e.stats.snapshot(), je.stats.snapshot()
    a = T.sql_groupby(ours["t"], "k", "v", 37, device=CPU,
                      where_ranges=[("ts", 9000, 30_000)])
    b = J.sql_groupby(theirs["t"], "k", "v", 37,
                      where_ranges=[("ts", 9000, 30_000)])
    same(a, b, str(env), keys_in_order=False)
    e.sync_stats()
    je.sync_stats()
    s1, j1 = e.stats.snapshot(), je.stats.snapshot()
    for c in ("sql_scans", "sql_rowgroups_scanned", "sql_rowgroups_skipped",
              "sql_bytes_skipped", "sql_pages_skipped"):
        assert s1[c] - s0[c] == j1[c] - j0[c], c


def test_groupby_str_and_scalar_match_jax(sc):
    ours, theirs, _, _ = sc
    a = T.sql_groupby_str(ours["t"], "city", "v", aggs=AGGS, device=CPU)
    b = J.sql_groupby_str(theirs["t"], "city", "v", aggs=AGGS)
    same(a, b, "str", keys_in_order=False)
    a = T.sql_groupby_str(ours["t"], "city", ["v", "w"],
                          where_ranges=[("w", 10, 500)], device=CPU)
    b = J.sql_groupby_str(theirs["t"], "city", ["v", "w"],
                          where_ranges=[("w", 10, 500)])
    same(a, b, "str ranged", keys_in_order=False)
    a = T.sql_scalar_agg(ours["t"], "v", aggs=AGGS, device=CPU,
                         where_ranges=[("w", 0, 499)])
    b = J.sql_scalar_agg(theirs["t"], "v", aggs=AGGS,
                         where_ranges=[("w", 0, 499)])
    same(a, b, "scalar", keys_in_order=False)


def test_nulls_skip_match_jax(sc):
    ours, theirs, _, _ = sc
    a = T.sql_groupby(ours["n"], "k", "x", 9, aggs=AGGS, nulls="skip",
                      device=CPU)
    b = J.sql_groupby(theirs["n"], "k", "x", 9, aggs=AGGS, nulls="skip")
    same(a, b, "groupby skip", keys_in_order=False)
    a = T.sql_scalar_agg(ours["n"], "x", aggs=("count", "sum"),
                         nulls="skip", device=CPU)
    b = J.sql_scalar_agg(theirs["n"], "x", aggs=("count", "sum"),
                         nulls="skip")
    same(a, b, "scalar skip", keys_in_order=False)
    with pytest.raises(ValueError, match="nulls"):
        T.sql_groupby(ours["n"], "k", "x", 9, device=CPU)


