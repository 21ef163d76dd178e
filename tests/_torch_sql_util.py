"""Helpers of the port's Direct SQL parity tests (tests/test_torch_sql*.py,
tests/test_torch_pq*.py): result comparison, the engine pairs, the
tables, and the ranks of the two-rank ``dist_groupby`` case."""

from __future__ import annotations

import numpy as np

#: float results of the port against the JAX package's: both fold in f32,
#: in different orders, so a SUM near 0 of ~1000 values of |v| ~ 1 may
#: differ by a few f32 roundings of the running sum (~1e-5 each)
RTOL = 1e-5
ATOL = 1e-4


def host(x):
    """A torch tensor, JAX array, list or scalar → numpy."""
    try:
        import torch
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
    except ImportError:      # pragma: no cover
        pass
    return np.asarray(x)


def same(a, b, what="", rtol=RTOL, atol=ATOL, keys_in_order=True):
    """Two result dicts agree: the same keys (in order), integer and
    boolean columns and label lists exactly, float columns within
    ``rtol`` relative or ``atol`` absolute (NaN equal)."""
    if keys_in_order:
        assert list(a) == list(b), (what, list(a), list(b))
    else:
        assert sorted(a) == sorted(b), (what, sorted(a), sorted(b))
    for k in b:
        x, y = a[k], b[k]
        if isinstance(y, list):
            assert list(x) == y, (what, k)
            continue
        if isinstance(y, (int, np.integer)) and not hasattr(x, "shape"):
            assert x == y, (what, k, x, y)
            continue
        x, y = host(x), host(y)
        assert x.shape == y.shape, (what, k, x.shape, y.shape)
        if y.dtype.kind in "iub":
            assert np.array_equal(x, y), (what, k, x, y)
        else:
            np.testing.assert_allclose(x.astype(np.float64),
                                       y.astype(np.float64), rtol=rtol,
                                       atol=atol, equal_nan=True,
                                       err_msg=f"{what} {k}")


def engine_pair(chunk_bytes=1 << 20, pool_bytes=8 << 20):
    """(port engine, JAX engine) of one small configuration."""
    from nvme_strom_tpu.io import StromEngine as JaxEngine
    from nvme_strom_tpu.utils.config import EngineConfig as JaxConfig
    from nvme_strom_tpu.utils.stats import StromStats as JaxStats
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.utils.config import EngineConfig
    cfg = dict(chunk_bytes=chunk_bytes, queue_depth=8,
               buffer_pool_bytes=pool_bytes)
    return (StromEngine(EngineConfig(**cfg)),
            JaxEngine(JaxConfig(**cfg), stats=JaxStats()))


def write_tables(d):
    """The SQL tests' tables under ``d`` (pyarrow, as the JAX tests write
    them): t (k, v, w, ts, city: 50,000 rows in row groups of 4096), n
    (nullable x), f / d (a star schema)."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    rng = np.random.default_rng(0)
    n = 50_000
    pq.write_table(pa.table({
        "k": rng.integers(0, 37, n).astype(np.int32),
        "v": rng.standard_normal(n).astype(np.float32),
        "w": rng.integers(0, 1000, n).astype(np.int64),
        "ts": np.arange(n, dtype=np.int64),
        "city": rng.choice(np.array(["tokyo", "osaka", "kyoto", "naha"]),
                           n)}),
        d / "t.parquet", row_group_size=4096, use_dictionary=["city"])
    vals = rng.standard_normal(20_000).astype(np.float32)
    keys = rng.integers(0, 9, 20_000).astype(np.int32)
    nul = [None if i % 9 == 0 else float(x) for i, x in enumerate(vals)]
    pq.write_table(pa.table({"k": pa.array(keys),
                             "x": pa.array(nul, pa.float32()),
                             "y": pa.array(vals)}),
                   d / "n.parquet", row_group_size=3000)
    rng = np.random.default_rng(8)
    nd = 50
    dim_key = rng.permutation(1000)[:nd].astype(np.int64)
    attr = rng.integers(0, 6, nd).astype(np.int32)
    pq.write_table(pa.table({
        "fk": rng.choice(dim_key, 20_000).astype(np.int64),
        "amount": rng.standard_normal(20_000).astype(np.float32)}),
        d / "f.parquet", row_group_size=4096)
    pq.write_table(pa.table({"dk": dim_key, "attr": attr}), d / "d.parquet")
    return d


def scanner_pairs(d, e, je):
    """({name: port scanner}, {name: JAX scanner}, e, je) over ``d``."""
    from nvme_strom_tpu import sql as J
    from nvme_strom_tpu_torch import sql as T
    names = ("t", "n", "f", "d")
    return ({n: T.ParquetScanner(d / f"{n}.parquet", e) for n in names},
            {n: J.ParquetScanner(d / f"{n}.parquet", je) for n in names},
            e, je)


# -- the two-rank dist_groupby spawn (tests/test_torch_sql_multi.py) --------

def start_ranks(job: str, world: int, tmp, payload=None,
                timeout: float = 120.0) -> tuple:
    """``_torch_dist.start`` for a job of this module: the same child, a
    gloo rank a process, importing this module for its job; wait with
    ``_torch_dist.collect``."""
    import os
    import pickle
    import subprocess
    import sys
    import time
    import _torch_dist
    child = _torch_dist._CHILD.replace("import _torch_dist as jobs",
                                       "import _torch_sql_util as jobs")
    tmp = str(tmp)
    inp = os.path.join(tmp, f"{job}.{world}.in.pkl")
    with open(inp, "wb") as f:
        pickle.dump(payload, f)
    store = os.path.join(tmp, f"{job}.{world}.store")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([_torch_dist.REPO,
                                           _torch_dist.HERE]))
    procs, outs, logs = [], [], []
    for r in range(world):
        out = os.path.join(tmp, f"{job}.{world}.{r}.out.pkl")
        log = os.path.join(tmp, f"{job}.{world}.{r}.log")
        outs.append(out)
        logs.append(log)
        with open(log, "w") as lf:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", child, job, str(r), str(world),
                 store, inp, out], env=env, stdout=lf,
                stderr=subprocess.STDOUT, cwd=tmp))
    return job, procs, outs, logs, time.monotonic() + timeout, timeout


def sql_dist(rank: int, world: int, p: dict) -> dict:
    """``dist_groupby`` and ``dist_scalar_agg`` with rank r scanning
    ``p["paths"][r::world]`` (an empty share on some ranks when there are
    fewer files than ranks)."""
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.sql import (ParquetScanner, dist_groupby,
                                          dist_scalar_agg)
    from nvme_strom_tpu_torch.utils.config import EngineConfig
    mine = p["paths"][rank::world]
    eng = StromEngine(EngineConfig(chunk_bytes=64 << 10, queue_depth=8,
                                   buffer_pool_bytes=2 << 20))
    try:
        scs = [ParquetScanner(x, eng) for x in mine]
        g = dist_groupby(scs, "k", "v", p["groups"],
                         aggs=("count", "sum", "mean", "min", "max", "std"),
                         where_ranges=p.get("where_ranges", ()),
                         device="cpu")
        s = dist_scalar_agg(scs, "v", aggs=("count", "sum", "max"),
                            device="cpu")
        return {"groupby": {k: v.tolist() for k, v in g.items()},
                "scalar": {k: float(v) for k, v in s.items()},
                "files": len(mine)}
    finally:
        eng.close_all()
