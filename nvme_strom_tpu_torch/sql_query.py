"""Direct-SQL demo CLI: scans decoded and aggregated on the card, end to
end (counterpart of examples/sql_query.py).

    SELECT k, COUNT(v), SUM(v), MEAN(v) FROM t [WHERE lo<=w<=hi] GROUP BY k
    SELECT city, AGG(v)  FROM t GROUP BY city          (string keys)
    SELECT v, k FROM t ORDER BY v DESC LIMIT n      (stats-eliminated scan)

Points at an existing Parquet file (--table) or synthesizes one (--rows)
with the port's own writer (sql/pqwrite.py; seed 0, the same values the
JAX example draws).  Column payloads ride the O_DIRECT engine and decode
on the device (sql/pq_direct.py); the aggregate runs there; the engine's
counters print after each query.

    python -m nvme_strom_tpu_torch.sql_query --rows 2000000
    python -m nvme_strom_tpu_torch.sql_query --table t.parquet --key k
    python -m nvme_strom_tpu_torch.sql_query --rows 50000 --device cpu \\
        --sql "SELECT k, COUNT(*) FROM t GROUP BY k"
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

_CITIES = ("tokyo", "osaka", "kyoto", "nagoya", "sapporo", "fukuoka",
           "sendai", "kobe")


def synthesize(path: str, rows: int, groups: int, compression: str) -> None:
    """The demo table: ``k`` int32 in [0, groups), ``v`` float32 normal,
    ``w`` int32 in [0, 10000), ``city`` one of eight labels
    (RLE_DICTIONARY), in 16 row groups of at least 4096 rows."""
    import numpy as np
    from nvme_strom_tpu_torch.sql.pqwrite import write_parquet
    rng = np.random.default_rng(0)
    cities = np.array(_CITIES)
    cols = {
        "k": rng.integers(0, groups, rows, dtype=np.int32),
        "v": rng.standard_normal(rows, dtype=np.float32),
        "w": rng.integers(0, 10_000, rows, dtype=np.int32),
        "city": (cities, rng.integers(0, len(cities), rows)),
    }
    write_parquet(path, cols, row_group_size=max(4096, rows // 16),
                  compression=compression, dictionary=["city"])
    print(f"synthesized {rows} rows -> {path} "
          f"({os.path.getsize(path) >> 20} MiB, {compression})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--table", default=None,
                    help="existing Parquet file (else synthesized)")
    ap.add_argument("--sql", default=None, metavar="QUERY",
                    help="run this SQL string (table name 't') instead "
                         "of the demo queries")
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--groups", type=int, default=64)
    ap.add_argument("--compression", default="none",
                    choices=("none", "zstd", "snappy", "gzip"))
    ap.add_argument("--key", default="k")
    ap.add_argument("--value", default="v")
    ap.add_argument("--top", type=int, default=5,
                    help="LIMIT for the ORDER BY demo query")
    ap.add_argument("--where", nargs=3, metavar=("COL", "LO", "HI"),
                    default=None,
                    help="range predicate; row groups the footer stats "
                         "exclude never leave the SSD")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0; 'cpu' runs the "
                         "plain versions)")
    args = ap.parse_args(argv)
    if args.table is None and args.compression in ("zstd", "snappy"):
        ap.error(f"--compression {args.compression}: the port writes "
                 "none or gzip (it carries no compressor for "
                 f"{args.compression}); it reads snappy files")

    from nvme_strom_tpu_torch.device import resolve_device
    from nvme_strom_tpu_torch.io.faults import build_engine
    from nvme_strom_tpu_torch.sql import (ParquetScanner, sql_groupby,
                                          sql_groupby_str, sql_topk,
                                          top_k_groups)
    device = resolve_device(args.device)

    path = args.table
    if path is None:
        import atexit
        import shutil
        tmp = tempfile.mkdtemp(prefix="strom_sql_")
        atexit.register(shutil.rmtree, tmp, ignore_errors=True)
        path = os.path.join(tmp, "t.parquet")
        synthesize(path, args.rows, args.groups, args.compression)

    eng = build_engine()
    try:
        sc = ParquetScanner(path, eng)
        print(f"table: {sc.num_rows} rows, "
              f"{sc.num_row_groups} row groups; direct eligibility: "
              f"{sc.direct_reasons([args.key, args.value])}")

        def counters(label: str, t0: float) -> None:
            if device.type == "cuda":
                import torch
                torch.cuda.synchronize(device)
            eng.sync_stats()
            s = eng.stats.snapshot()
            print(f"  [{label}: {time.monotonic() - t0:.3f}s  "
                  f"direct={s['bytes_direct'] >> 20}MiB "
                  f"bounce={s['bounce_bytes'] >> 20}MiB]")

        if args.sql:
            from nvme_strom_tpu_torch.sql import sql_query as run_sql
            t0 = time.monotonic()
            out = run_sql(args.sql, {"t": sc}, engine=eng, device=device)
            for name, col in out.items():
                if not hasattr(col, "__len__"):
                    print(f"  {name}: {col}")
                    continue

                def _fmt(x):
                    try:
                        return round(float(x), 4)
                    except (TypeError, ValueError):
                        return x
                head = [_fmt(x) for x in list(col[:8])]
                print(f"  {name}: {head}"
                      + (" ..." if len(col) > 8 else ""))
            counters("sql", t0)
            return 0

        where_ranges = []
        if args.where:
            col, lo, hi = args.where
            where_ranges = [(col, float(lo), float(hi))]

        t0 = time.monotonic()
        out = sql_groupby(sc, args.key, args.value, args.groups,
                          aggs=("count", "sum", "mean"),
                          where_ranges=where_ranges, device=device)
        head = {a: [round(float(x), 3) for x in out[a][:5].tolist()]
                for a in out}
        print(f"GROUP BY {args.key} (first 5 groups): {head}")
        counters("groupby", t0)

        t0 = time.monotonic()
        tk = sql_topk(sc, args.value, columns=[args.key], k=args.top,
                      where_ranges=where_ranges, device=device)
        print(f"ORDER BY {args.value} DESC LIMIT {args.top}: "
              f"{[round(float(x), 4) for x in tk[args.value]]} "
              f"(rows {[int(r) for r in tk['_row']]}, "
              f"{tk['_skipped_row_groups']} row groups eliminated)")
        counters("order by / limit", t0)

        if args.table is None:       # the synthesized string column
            t0 = time.monotonic()
            s_out = sql_groupby_str(sc, "city", args.value,
                                    aggs=("count", "mean"), device=device)
            top = top_k_groups(
                {k: v for k, v in s_out.items() if k != "labels"},
                "count", 3)
            print("GROUP BY city, top-3 by count:")
            for i in range(3):
                lab = s_out["labels"][int(top["group"][i])]
                lab = lab.decode() if isinstance(lab, bytes) else lab
                print(f"  {lab:<10} count={int(top['count'][i])} "
                      f"mean={float(top['mean'][i]):+.4f}")
            counters("string groupby", t0)
    finally:
        eng.close_all()
    return 0


if __name__ == "__main__":
    sys.exit(main())
