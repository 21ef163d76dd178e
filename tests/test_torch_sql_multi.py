"""The port's multi-file and multi-process Direct SQL
(nvme_strom_tpu_torch/sql/multi.py, dist.py) held against the JAX
package on the CPU: ``open_dataset``, ``multi_groupby``,
``multi_scalar_agg`` and ``multi_topk`` over a directory of Parquet files
(the cases of tests/test_sql_multi.py), and ``dist_groupby`` /
``dist_scalar_agg`` over 2 and 3 gloo ranks (tests/_torch_dist.py, one
process a rank, each scanning its share of the files, the partials folded
over ``torch.distributed``): every rank must hold the JAX union's
answer, integers exactly and floats within 1e-5 relative or 1e-4
absolute (the JAX ``dist_groupby`` case of tests/test_multiprocess.py).
The ranks are started like tests/_torch_dist.py's, with their job in
tests/_torch_sql_util.py."""

import numpy as np
import pytest

import _torch_dist
from nvme_strom_tpu import sql as J
from nvme_strom_tpu_torch import sql as T

from _torch_sql_util import engine_pair, same, start_ranks

CPU = "cpu"
AGGS = ("count", "sum", "mean", "min", "max", "std")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    import pyarrow as pa
    import pyarrow.parquet as pq
    d = tmp_path_factory.mktemp("multi")
    rng = np.random.default_rng(12)
    for i in range(4):
        n = 6000 + 1000 * i
        pq.write_table(pa.table({
            "k": rng.integers(0, 11, n).astype(np.int32),
            "v": rng.standard_normal(n).astype(np.float32),
            "ts": np.arange(i * 10_000, i * 10_000 + n, dtype=np.int64)}),
            d / f"part{i}.parquet", row_group_size=2048)
    (d / "notes.txt").write_text("not a table")
    return d


@pytest.fixture(scope="module")
def spawned(dataset, tmp_path_factory):
    """The ranks start with the module's first test and run beside the
    in-process cases; :func:`dist_runs` waits for them."""
    paths = sorted(str(p) for p in dataset.glob("*.parquet"))
    payload = {"paths": paths, "groups": 11,
               "where_ranges": [("ts", 3000, 34_000)]}
    handles = {w: start_ranks(
        "sql_dist", w, tmp_path_factory.mktemp(f"sqldist{w}"), payload,
        timeout=120) for w in (2,)}
    cache = {}
    yield handles, cache
    for w, h in handles.items():
        if w not in cache:
            _torch_dist.collect(h)


@pytest.fixture()
def dist_runs(spawned):
    handles, cache = spawned
    for w, h in handles.items():
        if w not in cache:
            cache[w] = _torch_dist.collect(h)
    return cache


@pytest.fixture(scope="module")
def both(dataset, spawned):
    e, je = engine_pair()
    with e, je:
        yield T.open_dataset(dataset, e), J.open_dataset(dataset, je)


def test_open_dataset_lists_parquet_files(both):
    ours, theirs = both
    assert [s.path for s in ours] == [s.path for s in theirs]
    assert len(ours) == 4


@pytest.mark.parametrize("kw", [
    dict(),
    dict(where_ranges=[("ts", 3000, 34_000)]),
    dict(where_ranges=[("ts", 100_000, 200_000)]),
    dict(method="scatter", where=lambda c: c["v"] > 0,
         where_columns=("v",)),
])
def test_multi_groupby_and_scalar_match_jax(kw, both):
    ours, theirs = both
    a = T.multi_groupby(ours, "k", "v", 11, aggs=AGGS, device=CPU, **kw)
    b = J.multi_groupby(theirs, "k", "v", 11, aggs=AGGS, **kw)
    same(a, b, str(kw), keys_in_order=False)
    a = T.multi_scalar_agg(ours, "v", aggs=AGGS, device=CPU, **kw)
    b = J.multi_scalar_agg(theirs, "v", aggs=AGGS, **kw)
    same(a, b, str(kw), keys_in_order=False)


@pytest.mark.parametrize("desc", [True, False])
def test_multi_topk_matches_jax(desc, both):
    ours, theirs = both
    a = T.multi_topk(ours, "v", columns=["k", "ts"], k=9, descending=desc,
                     device=CPU)
    b = J.multi_topk(theirs, "v", columns=["k", "ts"], k=9,
                     descending=desc)
    same(a, b, f"desc={desc}", keys_in_order=False)


def test_dataset_sql_query_matches_jax(dataset, both):
    ours, theirs = both
    for q in ("SELECT k, COUNT(*), SUM(v) FROM t GROUP BY k",
              "SELECT v, ts FROM t ORDER BY v DESC LIMIT 5",
              "SELECT COUNT(*), MAX(v) FROM t WHERE ts < 25000"):
        same(T.sql_query(q, {"t": ours}, device=CPU),
             J.sql_query(q, {"t": theirs}), q)


def test_schema_mismatch_refused(tmp_path, both):
    import pyarrow as pa
    import pyarrow.parquet as pq
    ours, _ = both
    p = tmp_path / "odd.parquet"
    pq.write_table(pa.table({"k": np.arange(5, dtype=np.int64),
                             "v": np.ones(5, np.float32)}), p)
    odd = T.ParquetScanner(p, ours[0].engine)
    with pytest.raises(ValueError, match="schema mismatch"):
        T.multi_groupby(ours + [odd], "k", "v", 11, device=CPU)


@pytest.mark.parametrize("world", [2])
def test_dist_groupby_every_rank_holds_the_union(world, dist_runs, both):
    ours, theirs = both
    want = J.multi_groupby(theirs, "k", "v", 11, aggs=AGGS,
                           where_ranges=[("ts", 3000, 34_000)])
    want_s = J.multi_scalar_agg(theirs, "v", aggs=("count", "sum", "max"))
    reps = dist_runs[world]
    assert sum(r["files"] for r in reps) == 4
    for r in reps:
        same({k: np.asarray(v) for k, v in r["groupby"].items()}, want,
             f"rank of {world}", keys_in_order=False)
        same({k: np.asarray(v) for k, v in r["scalar"].items()},
             {k: np.asarray(v) for k, v in want_s.items()},
             f"scalar rank of {world}", keys_in_order=False)
    # every rank holds the identical answer
    for r in reps[1:]:
        assert r["groupby"] == reps[0]["groupby"]
