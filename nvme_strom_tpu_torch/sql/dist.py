"""Distributed SQL: scan locally, fold globally (counterpart of
nvme_strom_tpu/sql/dist.py).

Every process scans only its own Parquet files (direct decode, footer
pruning, WHERE pushdown) and ships only the raw foldable partials
(count / sum / sum2 / min / max with their identities) across processes:
an all-gather over ``torch.distributed`` (parallel/collectives.py's
``all_gather`` on the world group), each partial reduced with its own op
(sum, or elementwise min / max), then ONE finalize everywhere, so every
process holds the identical global answer.  Table bytes never cross the
network: the collective moves O(num_groups) floats an aggregate.  A
process with no local rows joins with the zero fold (collectives must
match on every process or the program hangs).  One process degenerates
to the multi-file union.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

__all__ = ["dist_groupby", "dist_scalar_agg"]

#: cross-process reduction per raw-partial kind
_REDUCE = {"count": "sum", "sum": "sum", "sum2": "sum",
           "min": "min", "max": "max"}


def _global_fold(folds: Dict[str, torch.Tensor],
                 had_rows: bool) -> Dict[str, torch.Tensor]:
    """All-gather each partial across processes and reduce it with its
    own op.  ``had_rows`` travels with the partials (a 0/1 leaf, summed):
    "no process scanned a row group" raises, "rows streamed but the
    WHERE matched none" is a legal zero-count / NaN result."""
    from nvme_strom_tpu_torch.parallel.collectives import (all_gather,
                                                           world_group)
    dev = next(iter(folds.values())).device
    parts = dict(folds)
    parts["_had_rows"] = torch.tensor([1 if had_rows else 0],
                                      dtype=torch.int32, device=dev)
    group = world_group()
    if group is not None:
        out = {}
        for k in sorted(parts):
            stacked = torch.stack(all_gather(parts[k].contiguous(), group))
            op = _REDUCE.get(k, "sum")
            out[k] = (stacked.amin(0) if op == "min"
                      else stacked.amax(0) if op == "max"
                      else stacked.sum(0, dtype=stacked.dtype))
        parts = out
    if int(parts.pop("_had_rows")[0]) == 0:
        raise ValueError("empty dataset (no rows on any process)")
    return parts


def _local_fold(local_scanners, key_column, vcols, single, num_groups,
                aggs, method, device, where, where_columns,
                where_ranges, nulls):
    """This process's fold, or the zero fold → (folds, had_rows)."""
    from nvme_strom_tpu_torch.device import resolve_device
    from nvme_strom_tpu_torch.sql.groupby import _zero_folds
    from nvme_strom_tpu_torch.sql.multi import _union_fold
    folds = _union_fold(local_scanners, key_column, vcols, single,
                        num_groups, aggs, method, device, where,
                        where_columns, where_ranges, nulls)
    if folds is None:
        return _zero_folds(num_groups, aggs,
                           0 if single else len(vcols),
                           resolve_device(device)), False
    return folds, True


def dist_groupby(local_scanners: Sequence, key_column: str, value_column,
                 num_groups: int,
                 aggs: Sequence[str] = ("count", "sum", "mean"),
                 method: str = "matmul", device=None,
                 where=None, where_columns: Sequence[str] = (),
                 where_ranges: Sequence[tuple] = (),
                 nulls: str = "forbid") -> Dict[str, np.ndarray]:
    """``sql_groupby`` over a dataset partitioned across processes:
    ``local_scanners`` are THIS process's files (lists may differ in
    length, or be empty); ``num_groups`` is the GLOBAL group count.  Every
    process returns the identical finalized result (host arrays)."""
    from nvme_strom_tpu_torch.sql.groupby import (_validate_nulls,
                                                  _validate_query,
                                                  _value_cols,
                                                  finalize_folds)
    from nvme_strom_tpu_torch.sql.multi import _check_schemas
    _validate_query(aggs, method)
    where_ranges = list(where_ranges)
    vcols, single = _value_cols(value_column)
    _validate_nulls(nulls, single)
    if local_scanners:
        _check_schemas(local_scanners, [key_column, *vcols])
    folds, had = _local_fold(local_scanners, key_column, vcols, single,
                             num_groups, aggs, method, device, where,
                             where_columns, where_ranges, nulls)
    out = finalize_folds(_global_fold(folds, had), aggs)
    return {k: v.cpu().numpy() for k, v in out.items()}


def dist_scalar_agg(local_scanners: Sequence, value_column,
                    aggs: Sequence[str] = ("count", "sum", "mean"),
                    method: str = "matmul", device=None,
                    where=None, where_columns: Sequence[str] = (),
                    where_ranges: Sequence[tuple] = (),
                    nulls: str = "forbid") -> Dict[str, object]:
    """``sql_scalar_agg`` over a dataset partitioned across processes."""
    from nvme_strom_tpu_torch.sql.groupby import (_validate_nulls,
                                                  _validate_query,
                                                  _value_cols,
                                                  finalize_folds)
    from nvme_strom_tpu_torch.sql.multi import _check_schemas
    _validate_query(aggs, method)
    where_ranges = list(where_ranges)
    vcols, single = _value_cols(value_column)
    _validate_nulls(nulls, single)
    if local_scanners:
        _check_schemas(local_scanners, vcols)
    folds, had = _local_fold(local_scanners, None, vcols, single, 1,
                             aggs, method, device, where, where_columns,
                             where_ranges, nulls)
    res = finalize_folds(_global_fold(folds, had), aggs)
    return {a: res[a].cpu().numpy()[0] for a in res}
