"""Multi-file datasets: a directory of Parquet files as ONE table
(counterpart of nvme_strom_tpu/sql/multi.py).

PG-Strom's arrow_fdw scans many files behind one foreign table; here
each file keeps its own
scanner — footer statistics, direct-path eligibility and row-group
pruning all stay per-file — and unions at the AGGREGATE level:

- grouped / scalar aggregates: each file produces RAW foldable
  partials (count/sum/sum2/min/max with segment identities, the same
  `_fold_scan(finalize=False)` body the single-file executors use) and
  one final finalize runs over the cross-file fold — numerically the
  single-table answer, never a concatenated table in memory.
- ORDER BY/LIMIT: per-file `sql_topk` (each with its own
  statistics-driven LIMIT elimination), then a host-side merge of the
  tiny per-file top-k candidate sets.

String-keyed GROUP BY is refused for now: per-file dictionaries would
need a global label-union remap; numeric keys don't have the problem.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

__all__ = ["multi_groupby", "multi_scalar_agg", "multi_topk",
           "open_dataset"]


def open_dataset(paths, engine) -> List:
    """Paths (list, or a directory of .parquet files) → scanners."""
    import os
    from nvme_strom_tpu_torch.sql.parquet import ParquetScanner
    if isinstance(paths, (str, bytes, os.PathLike)):
        d = os.fspath(paths)
        paths = sorted(os.path.join(d, f) for f in os.listdir(d)
                       if f.endswith(".parquet"))
        if not paths:
            raise ValueError(f"no .parquet files under {d}")
    return [ParquetScanner(p, engine) for p in paths]


def _check_schemas(scanners, columns) -> None:
    """The referenced columns must exist with one type in every file."""
    ref = None
    for sc in scanners:
        md = sc.metadata
        types = {md.schema.column(i).name:
                 str(md.schema.column(i).physical_type)
                 for i in range(md.num_columns)}
        got = {}
        for c in columns:
            if c not in types:
                raise KeyError(f"column {c!r} missing from {sc.path}")
            got[c] = types[c]
        if ref is None:
            ref = got
        elif got != ref:
            raise ValueError(
                f"schema mismatch across dataset files: {sc.path} has "
                f"{got}, first file has {ref}")


def _union_fold(scanners, key_column, vcols, single, num_groups, aggs,
                method, device, where, where_columns, where_ranges,
                nulls):
    """THE per-scanner fold loop (raw partials, fully-pruned members
    skipped) shared by the multi-file union and the distributed
    executor.  Each member's scan rides `_fold_scan`, so pushdown
    planning, partition-parallel workers, and late materialization
    (sql/scan_plan.py) apply per file with no code here.  Returns the
    folded partials, or None when no member produced any row group."""
    from nvme_strom_tpu_torch.sql.groupby import _fold, _fold_scan
    folds = None
    for sc in scanners:
        try:
            part = _fold_scan(sc, key_column, vcols, single, num_groups,
                              aggs, method, device, where, where_columns,
                              where_ranges, nulls, finalize=False)
        except ValueError as e:
            if "empty table" in str(e):   # a zero-row-group member
                continue                  # must not kill the union
            raise
        folds = part if folds is None else _fold(folds, part)
    return folds


def multi_groupby(scanners: Sequence, key_column: str, value_column,
                  num_groups: int,
                  aggs: Sequence[str] = ("count", "sum", "mean"),
                  method: str = "matmul", device=None,
                  where=None, where_columns: Sequence[str] = (),
                  where_ranges: Sequence[tuple] = (),
                  nulls: str = "forbid") -> Dict[str, object]:
    """`sql_groupby` over a file union — one fold, one finalize."""
    from nvme_strom_tpu_torch.sql.groupby import (_validate_nulls,
                                            _validate_query, _value_cols,
                                            finalize_folds)
    _validate_query(aggs, method)
    where_ranges = list(where_ranges)   # a generator must not exhaust
    vcols, single = _value_cols(value_column)   # after file 0
    _validate_nulls(nulls, single)
    _check_schemas(scanners, [key_column, *vcols])
    folds = _union_fold(scanners, key_column, vcols, single, num_groups,
                        aggs, method, device, where, where_columns,
                        where_ranges, nulls)
    if folds is None:
        raise ValueError("empty dataset (no rows in any file)")
    return finalize_folds(folds, aggs)


def multi_scalar_agg(scanners: Sequence, value_column,
                     aggs: Sequence[str] = ("count", "sum", "mean"),
                     method: str = "matmul", device=None,
                     where=None, where_columns: Sequence[str] = (),
                     where_ranges: Sequence[tuple] = (),
                     nulls: str = "forbid") -> Dict[str, object]:
    """`sql_scalar_agg` over a file union."""
    from nvme_strom_tpu_torch.sql.groupby import (_validate_nulls,
                                            _validate_query, _value_cols,
                                            finalize_folds)
    _validate_query(aggs, method)
    where_ranges = list(where_ranges)   # a generator must not exhaust
    vcols, single = _value_cols(value_column)   # after file 0
    _validate_nulls(nulls, single)
    _check_schemas(scanners, vcols)
    folds = _union_fold(scanners, None, vcols, single, 1, aggs, method,
                        device, where, where_columns, where_ranges,
                        nulls)
    if folds is None:
        raise ValueError("empty dataset (no rows in any file)")
    res = finalize_folds(folds, aggs)
    return {a: res[a][0] for a in res}


def multi_topk(scanners: Sequence, by: str,
               columns: Sequence[str] = (), k: int = 10,
               descending: bool = True, device=None,
               where=None, where_columns: Sequence[str] = (),
               where_ranges: Sequence[tuple] = (),
               nulls: str = "forbid") -> Dict[str, np.ndarray]:
    """`sql_topk` over a file union: per-file top-k (each with its own
    LIMIT scan-elimination), merged host-side.  ``_file`` joins
    ``_row`` in the provenance columns; ``_skipped_row_groups`` sums.

    Tie order: rows with equal keys rank by (_file, _row) ascending in
    both sort directions — deterministic where single-file ``sql_topk``
    leaves ties unspecified (its streamed merge carries no provenance
    to break them with)."""
    from nvme_strom_tpu_torch.sql.topk import sql_topk
    where_ranges = list(where_ranges)   # a generator must not exhaust
    _check_schemas(scanners, [by, *columns])   # after file 0
    parts = []
    skipped = 0
    for fi, sc in enumerate(scanners):
        try:
            r = sql_topk(sc, by, columns=columns, k=k,
                         descending=descending, device=device,
                         where=where, where_columns=where_columns,
                         where_ranges=where_ranges, nulls=nulls)
        except ValueError as e:
            if "empty table" in str(e):   # member fully pruned: the
                continue                  # union answers from the rest
            raise
        skipped += int(r.pop("_skipped_row_groups"))
        r["_file"] = np.full(len(r["_row"]), fi, np.int32)
        parts.append(r)
    if not parts:
        raise ValueError("empty dataset (every file pruned away)")
    names = [by, *[c for c in columns if c != by], "_row", "_file"]
    merged = {n: np.concatenate([p[n] for p in parts]) for n in names}
    # Explicit tie-break on (_file, _row) ascending in BOTH directions
    # (a reversed stable sort would return descending ties in reverse
    # file/row order).  The KEY column is never negated —
    # that would wrap unsigned dtypes and INT64_MIN (the per-file merge
    # kernel avoids negation the same way) — but the provenance columns
    # are non-negative ordinals, so negating them to pre-reverse the
    # tie order is safe.
    if descending:
        order = np.lexsort((-merged["_row"], -merged["_file"],
                            merged[by]))[::-1]
    else:
        order = np.lexsort((merged["_row"], merged["_file"], merged[by]))
    order = order[:k]
    out = {n: merged[n][order] for n in names}
    out["_skipped_row_groups"] = skipped
    return out
