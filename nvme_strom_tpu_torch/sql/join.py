"""On-device star-schema join: fact rows → dimension attributes
(counterpart of nvme_strom_tpu/sql/join.py).

The warehouse shape: a large fact table joined to a dimension table on
the dimension's UNIQUE key, grouped by a dimension attribute::

    SELECT d.attr, AGG(f.value)
    FROM fact f JOIN dim d ON f.key = d.key
    GROUP BY d.attr

With a unique build side the join is a sort and a binary search: sort
the dimension keys once, ``torch.searchsorted`` every fact key into
them, gather the attribute.  Unmatched fact rows carry ``found=False``
and flow into the GROUP BY mask, so inner-join semantics cost nothing
more.  Fact row groups stream through the engine; only the small
dimension table stays on the device.  M:N joins (duplicate build keys)
are refused.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def lookup_unique(build_keys: torch.Tensor, probe_keys: torch.Tensor):
    """For each probe key, the index of the matching build row:
    build_keys (M,) UNIQUE integers, probe_keys (N,) →
    (idx (N,) int32 into build rows, found (N,) bool).  Rows with
    ``found=False`` carry an arbitrary (clipped) idx."""
    order = torch.argsort(build_keys, stable=True)
    skeys = build_keys[order].contiguous()
    pos = torch.searchsorted(skeys, probe_keys.to(skeys.dtype).contiguous())
    pos = torch.clamp(pos, 0, skeys.shape[0] - 1)
    found = skeys[pos] == probe_keys.to(skeys.dtype)
    return order[pos].to(torch.int32), found


def check_unique(keys) -> None:
    """Raise if the build-side keys are empty or not unique."""
    k = keys.cpu().numpy() if isinstance(keys, torch.Tensor) \
        else np.asarray(keys)
    if k.shape[0] == 0:
        raise ValueError("join build side (dimension table) is empty")
    if len(np.unique(k)) != k.shape[0]:
        raise ValueError(
            "join build side has duplicate keys — M:N joins are not "
            "supported on the device path")


def star_join_groupby(fact_scanner, fact_key: str, fact_value: str,
                      dim_scanner, dim_key: str, dim_attr: str,
                      num_groups: int,
                      aggs: Sequence[str] = ("count", "sum", "mean"),
                      method: str = "matmul", device=None,
                      where=None, where_columns: Sequence[str] = ()
                      ) -> Dict[str, torch.Tensor]:
    """The star query above, end to end on the device.  ``dim_attr`` must
    be an integer column in [0, num_groups); ``where`` receives the fact
    columns and returns a row mask, ANDed with the join's found-mask.
    Returns {agg: (num_groups,)} like ``sql_groupby``."""
    from nvme_strom_tpu_torch.device import resolve_device
    from nvme_strom_tpu_torch.sql.groupby import (
        _fold, _is_int, _norm_aggs, finalize_folds, iter_device_columns,
        sql_window_bytes)

    dev = resolve_device(device)
    dcols = dim_scanner.read_columns_to_device([dim_key, dim_attr],
                                               device=dev)
    for c in (dim_key, dim_attr):
        if not _is_int(dcols[c]):
            raise TypeError(f"dimension column {c} must be integer, "
                            f"got {dcols[c].dtype}")
    check_unique(dcols[dim_key])
    dkeys = dcols[dim_key].to(torch.int64)
    dattr = dcols[dim_attr].to(torch.int32)

    part_aggs = _norm_aggs(aggs)
    cols_needed = list(dict.fromkeys(
        [fact_key, fact_value, *where_columns]))
    folds = None
    for cols in iter_device_columns(fact_scanner, cols_needed, dev,
                                    require_int=(fact_key,),
                                    window_bytes=sql_window_bytes()):
        mask = where(cols) if where is not None else None
        part = _join_part(dkeys, dattr, cols[fact_key],
                          cols[fact_value], mask,
                          num_groups=num_groups, aggs=part_aggs,
                          method=method)
        folds = part if folds is None else _fold(folds, part)
    if folds is None:
        raise ValueError("empty fact table")
    return finalize_folds(folds, aggs)


def _join_part(dkeys, dattr, fkeys, fvals, mask, *, num_groups, aggs,
               method):
    """One fact window: join → masked partial aggregates."""
    from nvme_strom_tpu_torch.sql.groupby import groupby_aggregate
    idx, found = lookup_unique(dkeys, fkeys.to(dkeys.dtype))
    groups = dattr[idx.to(torch.int64)]
    m = found if mask is None else (found & mask)
    return groupby_aggregate(groups, fvals, num_groups, aggs=aggs,
                             method=method, mask=m, empty_as_nan=False)
