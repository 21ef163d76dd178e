"""ORDER BY <col> [DESC|ASC] LIMIT k over a streamed Parquet scan, on the
device (counterpart of nvme_strom_tpu/sql/topk.py).

A streaming top-k merge: each row group's columns land on the device
through the direct path, and a merge keeps the best k rows there — the
carried k candidates joined with the group's rows, a stable lexsort on
(key, validity) in the key's own dtype (no float rank for integer
keys), the first k kept.  Only the final k rows cross back to the host.

LIMIT pushdown with scan elimination: row groups are visited in the
order of their footer bound (max for DESC, min for ASC; groups without
statistics first, never skipped), and once k valid rows are held, a
group whose bound cannot beat the k-th row is skipped with every later
one: its payload never leaves the SSD.

Ties beyond position k are unspecified (as in SQL); NaN keys and, with
``nulls="skip"``, NULL rows never surface.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from nvme_strom_tpu_torch.sql.groupby import _range_mask, iter_device_columns


def _sentinel(dtype: torch.dtype, descending: bool):
    """The key an invalid row is given so that it always loses."""
    if dtype.is_floating_point:
        return float("-inf") if descending else float("inf")
    info = torch.iinfo(dtype)
    return info.min if descending else info.max


def lexsort(keys) -> torch.Tensor:
    """``np.lexsort`` on tensors: the LAST key is the primary one; stable
    sorts from the least significant key up."""
    n = keys[0].shape[0]
    idx = torch.arange(n, device=keys[0].device)
    for k in keys:
        if k.dtype == torch.bool:
            k = k.to(torch.uint8)
        idx = idx[torch.sort(k[idx], stable=True).indices]
    return idx


def _merge_topk(key, vals, row, valid, k: int, descending: bool):
    """Best k rows of (key, vals, row, valid) by key; validity is the
    secondary sort key, so a valid row whose key equals the sentinel
    still beats the invalid ones."""
    if key.dtype.is_floating_point:
        valid = valid & ~torch.isnan(key)
    skey = torch.where(valid, key,
                       torch.full_like(key, _sentinel(key.dtype,
                                                      descending)))
    if descending:
        idx = lexsort((valid, skey)).flip(0)[:k]
    else:
        idx = lexsort((~valid, skey))[:k]
    return (key[idx], {c: v[idx] for c, v in vals.items()},
            row[idx], valid[idx])


def _rg_bound(scanner, rg: int, ci: int, descending: bool):
    st = scanner.metadata.row_group(rg).column(ci).statistics
    if st is None or st.min is None or st.max is None:
        return None
    return st.max if descending else st.min


def _beats(bound, worst, descending: bool) -> bool:
    """Could a row at ``bound`` displace the k-th row ``worst``?  A tie
    cannot improve the top-k multiset."""
    return bound > worst if descending else bound < worst


def sql_topk(scanner, by: str, columns: Sequence[str] = (),
             k: int = 10, descending: bool = True, device=None,
             where=None, where_columns: Sequence[str] = (),
             where_ranges: Sequence[tuple] = (),
             nulls: str = "forbid") -> Dict[str, np.ndarray]:
    """``SELECT by, columns... FROM parquet [WHERE ...] ORDER BY by [DESC]
    LIMIT k`` — streamed, merged on the device, statistics-skipped.

    Returns {name: (m,) numpy} for ``by`` and every ``columns`` name, plus
    ``"_row"`` (int32 global row index) and ``"_skipped_row_groups"``,
    with m ≤ k, in result order."""
    from nvme_strom_tpu_torch.device import resolve_device
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if nulls not in ("forbid", "skip"):
        raise ValueError(f"bad nulls={nulls!r}")
    where_ranges = list(where_ranges)
    dev = resolve_device(device)
    out_cols = list(dict.fromkeys([by, *columns]))
    range_cols = [c for c, _, _ in where_ranges]
    cols_needed = list(dict.fromkeys(
        [*out_cols, *where_columns, *range_cols]))
    full_where = ((lambda cols: _range_mask(cols, where_ranges, where))
                  if (where_ranges or where is not None) else None)

    rgs = (scanner.prune_row_groups(where_ranges) if where_ranges
           else list(range(scanner.num_row_groups)))
    name_to_ci = {scanner.metadata.schema.column(i).name: i
                  for i in range(scanner.metadata.num_columns)}
    if by not in name_to_ci:
        raise KeyError(f"column {by!r} not in schema")
    ci = name_to_ci[by]
    bounds = {rg: _rg_bound(scanner, rg, ci, descending) for rg in rgs}
    unbounded = [rg for rg in rgs if bounds[rg] is None]
    bounded = sorted((rg for rg in rgs if bounds[rg] is not None),
                     key=lambda rg: bounds[rg], reverse=descending)
    rgs = unbounded + bounded
    row_base, acc = {}, 0
    for rg in range(scanner.num_row_groups):
        row_base[rg] = acc
        acc += scanner.metadata.row_group(rg).num_rows

    carry = None
    skipped_rgs = 0

    def fold(rg_index: int, cols, base_mask):
        nonlocal carry
        key = cols[by]
        n = key.shape[0]
        row = (torch.arange(n, dtype=torch.int32, device=key.device)
               + int(row_base[rg_index]))
        valid = torch.ones((n,), dtype=torch.bool, device=key.device)
        if full_where is not None:
            valid = valid & full_where(cols)
        if base_mask is not None:
            valid = valid & base_mask
        vals = {c: cols[c] for c in out_cols}
        if carry is not None:
            ckey, cvals, crow, cvalid = carry
            key = torch.cat([ckey, key])
            row = torch.cat([crow, row])
            valid = torch.cat([cvalid, valid])
            vals = {c: torch.cat([cvals[c], vals[c]]) for c in out_cols}
        kk = min(k, int(key.shape[0]))
        carry = _merge_topk(key, vals, row, valid, kk, descending)

    from nvme_strom_tpu_torch.sql import pq_direct
    plans = pq_direct.try_plan(scanner, cols_needed,
                               allow_nulls=nulls == "skip")

    def group_stream(batch):
        if nulls == "skip":
            for cols, masks in iter_device_columns(
                    scanner, cols_needed, dev, row_groups=batch,
                    nulls="mask", plans=plans):
                base = None
                for c in cols_needed:
                    base = masks[c] if base is None else base & masks[c]
                yield cols, base
        else:
            for cols in iter_device_columns(scanner, cols_needed, dev,
                                            row_groups=batch,
                                            plans=plans):
                yield cols, None

    # windows of 1, 2, 4, 8, 8, ... groups; the elimination check runs
    # once a window before its reads are submitted
    pos = 0
    window = 1
    while pos < len(rgs):
        if carry is not None and carry[0].shape[0] == k:
            if bool(carry[3].all()):
                worst = carry[0][-1].item()
                b = bounds[rgs[pos]]
                if b is not None and not _beats(b, worst, descending):
                    skipped_rgs = len(rgs) - pos
                    break
        batch = rgs[pos:pos + window]
        for rg, (cols, base) in zip(batch, group_stream(batch)):
            fold(rg, cols, base)
        pos += len(batch)
        window = min(window * 2, 8)

    if carry is None:
        raise ValueError("empty table (no row groups survive pruning)")
    key, vals, row, valid = carry
    m = int(valid.sum())
    out = {c: vals[c][:m].cpu().numpy() for c in out_cols}
    out["_row"] = row[:m].cpu().numpy()
    out["_skipped_row_groups"] = skipped_rgs
    return out
