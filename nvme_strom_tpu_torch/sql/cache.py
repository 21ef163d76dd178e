"""Device-resident table cache: scan once, query from device memory
(counterpart of nvme_strom_tpu/sql/cache.py).

:class:`DeviceTable` reads selected Parquet columns onto the device
through the same windowed direct scan the one-shot queries use, then
serves GROUP BY, scalar aggregates, top-k and star joins as device
programs: no engine read and no host↔device payload per query.
Construction refuses a table beyond a byte budget
(``STROM_DEVICE_CACHE_BYTES``, default 4 GiB) rather than run out of
device memory mid-stream.  Columns are cached null-free.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import torch


def device_cache_budget() -> int:
    """Most bytes a DeviceTable may pin (``STROM_DEVICE_CACHE_BYTES``;
    0 = unlimited)."""
    v = os.environ.get("STROM_DEVICE_CACHE_BYTES")
    return int(v) if v is not None else 4 << 30


class DeviceTable:
    """Selected columns of one Parquet table, resident on the device
    (``cuda:0`` unless ``device`` names another)."""

    def __init__(self, scanner, columns: Sequence[str], device=None,
                 budget_bytes: Optional[int] = None):
        from nvme_strom_tpu_torch.device import resolve_device
        from nvme_strom_tpu_torch.sql.groupby import (iter_device_columns,
                                                      sql_window_bytes)
        columns = list(dict.fromkeys(columns))
        if not columns:
            raise ValueError("DeviceTable needs at least one column")
        self.device = resolve_device(device)
        self.path = getattr(scanner, "path", None)
        budget = (device_cache_budget() if budget_bytes is None
                  else budget_bytes)
        est = _estimate_bytes(scanner, columns)
        if budget and est > budget:
            raise ValueError(
                f"table needs ~{est >> 20} MiB resident for "
                f"{columns}, over the {budget >> 20} MiB device-cache "
                f"budget (STROM_DEVICE_CACHE_BYTES) — use the "
                f"streaming scan instead")
        parts: Dict[str, list] = {c: [] for c in columns}
        for cols in iter_device_columns(scanner, columns, self.device,
                                        window_bytes=sql_window_bytes()):
            for c in columns:
                parts[c].append(cols[c])
        # one column at a time: the transient over-residency is one
        # column's payload, not the table's
        self.columns: Dict[str, torch.Tensor] = {}
        for c in columns:
            frags = parts.pop(c)
            self.columns[c] = (frags[0] if len(frags) == 1
                               else torch.cat(frags))
            frags.clear()
        n = {int(v.shape[0]) for v in self.columns.values()}
        if len(n) != 1:
            raise AssertionError(f"ragged cached columns: {n}")
        self.num_rows = n.pop()

    def nbytes(self) -> int:
        return sum(v.numel() * v.element_size()
                   for v in self.columns.values())

    def column(self, name: str) -> torch.Tensor:
        try:
            return self.columns[name]
        except KeyError:
            raise KeyError(
                f"column {name!r} not cached (have "
                f"{sorted(self.columns)}) — list it at construction")

    def _mask(self, where, where_ranges):
        from nvme_strom_tpu_torch.sql.groupby import _range_mask
        if not where_ranges and where is None:
            return None
        where_ranges = list(where_ranges)
        for c, _, _ in where_ranges:
            self.column(c)
        return _range_mask(self.columns, where_ranges, where)

    def groupby(self, key_column: str, value_column, num_groups: int,
                aggs: Sequence[str] = ("count", "sum", "mean"),
                method: str = "matmul", where=None,
                where_ranges: Sequence[tuple] = ()
                ) -> Dict[str, torch.Tensor]:
        """``SELECT key, AGG(value) ... GROUP BY key`` over the cached
        columns: one fold, no I/O."""
        from nvme_strom_tpu_torch.sql.groupby import (_is_int, _norm_aggs,
                                                      _stack_values,
                                                      _value_cols,
                                                      finalize_folds,
                                                      groupby_aggregate)
        keys = self.column(key_column)
        if not _is_int(keys):
            raise TypeError(f"key column {key_column} must be integer")
        vcols, single = _value_cols(value_column)
        values = _stack_values(self.columns, vcols, single)
        part = groupby_aggregate(
            keys.to(torch.int32), values, num_groups,
            aggs=_norm_aggs(aggs), method=method,
            mask=self._mask(where, where_ranges), empty_as_nan=False)
        return finalize_folds(part, aggs)

    def scalar_agg(self, value_column,
                   aggs: Sequence[str] = ("count", "sum", "mean"),
                   where=None, where_ranges: Sequence[tuple] = ()
                   ) -> Dict[str, object]:
        """``SELECT AGG(v), ...`` (no GROUP BY): one global group."""
        from nvme_strom_tpu_torch.sql.groupby import (_norm_aggs,
                                                      _stack_values,
                                                      _value_cols,
                                                      finalize_folds,
                                                      groupby_aggregate)
        vcols, single = _value_cols(value_column)
        values = _stack_values(self.columns, vcols, single)
        part = groupby_aggregate(
            torch.zeros((self.num_rows,), dtype=torch.int32,
                        device=self.device), values, 1,
            aggs=_norm_aggs(aggs),
            mask=self._mask(where, where_ranges), empty_as_nan=False)
        res = finalize_folds(part, aggs)
        return {a: res[a][0] for a in res}

    def topk(self, by: str, columns: Sequence[str] = (), k: int = 10,
             descending: bool = True) -> Dict[str, object]:
        """``SELECT ... ORDER BY by LIMIT k`` over the cached table.  Ties
        rank by ascending row in both directions; NaN keys never
        surface.  Returns host arrays with ``_row`` as global row ids."""
        from nvme_strom_tpu_torch.sql.topk import lexsort
        if not 0 < k:
            raise ValueError("k must be positive")
        key = self.column(by)
        rows = torch.arange(self.num_rows, dtype=torch.int32,
                            device=self.device)
        if key.dtype.is_floating_point:
            valid = ~torch.isnan(key)
            kf = torch.where(valid, key, torch.full_like(
                key, float("-inf") if descending else float("inf")))
        else:
            valid = torch.ones((self.num_rows,), dtype=torch.bool,
                               device=self.device)
            kf = key
        if descending:
            order = lexsort((-rows, valid, kf)).flip(0)
        else:
            order = lexsort((rows, ~valid, kf))
        order = order[:k]
        nv = int(valid[order].sum())
        order = order[:nv]
        out: Dict[str, object] = {
            c: self.column(c)[order].cpu().numpy()
            for c in (columns or [by])}
        out["_row"] = rows[order].cpu().numpy()
        return out

    def star_join_groupby(self, fact_key: str, fact_value: str,
                          dim_table: "DeviceTable", dim_key: str,
                          dim_attr: str, num_groups: int,
                          aggs: Sequence[str] = ("count", "sum",
                                                 "mean"),
                          method: str = "matmul", where=None
                          ) -> Dict[str, torch.Tensor]:
        """The star join with BOTH sides cached: no I/O on either side."""
        from nvme_strom_tpu_torch.sql.groupby import (_is_int, _norm_aggs,
                                                      finalize_folds)
        from nvme_strom_tpu_torch.sql.join import _join_part, check_unique
        fkeys = self.column(fact_key)
        dkeys = dim_table.column(dim_key)
        dattr = dim_table.column(dim_attr)
        for name, arr in ((fact_key, fkeys), (dim_key, dkeys),
                          (dim_attr, dattr)):
            if not _is_int(arr):
                raise TypeError(f"join column {name} must be integer, "
                                f"got {arr.dtype}")
        check_unique(dkeys)
        mask = where(self.columns) if where is not None else None
        part = _join_part(dkeys.to(torch.int64), dattr.to(torch.int32),
                          fkeys, self.column(fact_value), mask,
                          num_groups=num_groups,
                          aggs=_norm_aggs(aggs), method=method)
        return finalize_folds(part, aggs)


def _estimate_bytes(scanner, columns: Sequence[str]) -> int:
    """Resident estimate from the footer's uncompressed sizes."""
    md = scanner.metadata
    names = {md.schema.column(i).name: i for i in range(md.num_columns)}
    total = 0
    for c in columns:
        if c not in names:
            raise KeyError(f"column {c!r} not in the table schema")
        for rg in range(md.num_row_groups):
            total += md.row_group(rg).column(
                names[c]).total_uncompressed_size
    return total


__all__ = ["DeviceTable", "device_cache_budget"]
