"""GROUP BY aggregation on the device (counterpart of
nvme_strom_tpu/sql/groupby.py).

The compute half of the Direct SQL scan: the filtered, projected columns
live on the device, the aggregate runs there, and only the per-group
results return to the host.  Two formulations, both over a static
``num_groups``:

- ``method="matmul"``: the segment sum as ``one_hot(keys).T @ values``,
  a (G × N)·(N × C) product in FULL fp32 — TF32 would round the values,
  so the fold turns it off and asserts it is off.
- ``method="scatter"``: ``index_add_`` for the sums, ``bincount`` for
  the counts.

Both take the minimum and maximum with ``scatter_reduce`` ("amin" /
"amax", ``include_self=False``) over ±inf identities.

Keys outside [0, num_groups), and rows a mask drops, go to a spill group
``num_groups`` that is sliced off the result: the JAX fold drops such
keys without a word (``one_hot`` gives them a zero row and the segment
operations drop out-of-range ids), while torch's ``index_add_`` and
``scatter_reduce`` would assert on the device.

Aggregates: count, sum, mean, min, max, var, std (sample statistics, n-1,
from the one-pass sum of squares).  PRECISION POLICY, kept for parity:
every float aggregate computes in f32 (an f64 column is cast at the
fold); a SUM over n values carries a relative error of ~n·2⁻²⁴ of Σ|v|;
COUNT is exact at any n: integer counts (the matmul's ones column summed
in f32 over at most 2^24 rows a block, each block's count then added as
an integer; ``bincount`` for scatter), returned as int32.

The fold runs as a chain of torch operations, as the JAX package's
jitted program does (it reaches no Pallas kernel).
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Sequence

import numpy as np
import torch

_AGGS = ("count", "sum", "mean", "min", "max", "var", "std")

#: folds run (one per groupby_aggregate call), by method
FOLDS = {"matmul": 0, "scatter": 0}

#: most bytes of one-hot rows the matmul fold builds at once
ONEHOT_BLOCK_BYTES = 256 << 20
#: most rows a matmul block sums: its f32 count column stays exact
ONEHOT_BLOCK_ROWS = 1 << 24


def _is_int(t: torch.Tensor) -> bool:
    return not t.dtype.is_floating_point and not t.dtype.is_complex \
        and t.dtype != torch.bool


@contextlib.contextmanager
def full_fp32():
    """fp32 products with no TF32 rounding for the duration."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        assert not torch.backends.cuda.matmul.allow_tf32, \
            "TF32 would round the one-hot product's values"
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def groupby_aggregate(keys: torch.Tensor, values: torch.Tensor,
                      num_groups: int,
                      aggs: Sequence[str] = ("count", "sum", "mean"),
                      method: str = "matmul",
                      mask: torch.Tensor = None,
                      empty_as_nan: bool = True) -> Dict[str, torch.Tensor]:
    """Aggregate ``values`` (N,) or (N, C) by integer ``keys`` (N,) in
    [0, num_groups).  Returns {agg: (num_groups,) or (num_groups, C)}.

    ``mask`` (N,) bool: rows where False are excluded (the WHERE
    pushdown).  Empty groups: mean / min / max are NaN;
    ``empty_as_nan=False`` keeps the raw ±inf identities so partial
    results fold across row groups."""
    for a in aggs:
        if a not in _AGGS and a != "sum2":   # sum2: internal foldable
            raise ValueError(f"unknown aggregate {a!r}")
    if method not in ("matmul", "scatter"):
        raise ValueError(f"unknown method {method!r}")
    FOLDS[method] += 1
    squeeze = values.dim() == 1
    vals = values[:, None] if squeeze else values
    vals_f = vals.to(torch.float32)
    dev = vals_f.device
    G = num_groups + 1                       # + the spill group
    k = keys.to(torch.int64)
    drop = (k < 0) | (k >= num_groups)
    if mask is not None:
        drop = drop | ~mask.to(torch.bool)
    k = torch.where(drop, torch.full_like(k, num_groups), k)
    n = k.shape[0]
    want2 = bool({"sum2", "var", "std"} & set(aggs))

    if method == "matmul":
        cols = [vals_f, torch.ones((n, 1), dtype=torch.float32, device=dev)]
        if want2:
            cols.append(vals_f * vals_f)
        rhs = torch.cat(cols, dim=1)
        # the one-hot block stays under ONEHOT_BLOCK_BYTES and
        # ONEHOT_BLOCK_ROWS: rows in blocks, their (G, C) products summed,
        # each block's count (exact in f32 below 2^24) added as an integer
        step = max(1, min(ONEHOT_BLOCK_BYTES // (4 * G), ONEHOT_BLOCK_ROWS))
        c = vals_f.shape[1]
        prod = count = None
        with full_fp32():
            for lo in range(0, max(n, 1), step):
                kb = k[lo:lo + step]
                onehot = torch.zeros((kb.shape[0], G), dtype=torch.float32,
                                     device=dev)
                onehot.scatter_(1, kb[:, None], 1.0)
                part = onehot.t() @ rhs[lo:lo + step]
                cnt = part[:, c].to(torch.int64)
                prod = part if prod is None else prod + part
                count = cnt if count is None else count + cnt
        summed = prod[:, :c]
        sum2 = prod[:, c + 1:] if want2 else None
    else:
        summed = torch.zeros((G, vals_f.shape[1]), dtype=torch.float32,
                             device=dev).index_add_(0, k, vals_f)
        count = torch.bincount(k, minlength=G)
        sum2 = (torch.zeros_like(summed).index_add_(0, k, vals_f * vals_f)
                if want2 else None)
    summed = summed[:num_groups]
    count = count[:num_groups]
    if sum2 is not None:
        sum2 = sum2[:num_groups]

    def sq(x):
        return x[:, 0] if squeeze else x

    out: Dict[str, torch.Tensor] = {}
    if "count" in aggs:
        out["count"] = count.to(torch.int32)
    if "sum2" in aggs:
        out["sum2"] = sq(sum2)
    if {"var", "std"} & set(aggs):
        var = _sample_var(count, summed, sum2)
        if "var" in aggs:
            out["var"] = sq(var)
        if "std" in aggs:
            out["std"] = sq(torch.sqrt(var))
    if "sum" in aggs:
        out["sum"] = sq(summed)
    if "mean" in aggs:
        cf = count.to(torch.float32)
        mean = summed / torch.clamp(cf, min=1.0)[:, None]
        mean = torch.where(count[:, None] > 0, mean,
                           torch.full_like(mean, float("nan")))
        out["mean"] = sq(mean)
    empty = count == 0
    for agg, red, ident in (("min", "amin", float("inf")),
                            ("max", "amax", float("-inf"))):
        if agg in aggs:
            m = torch.full((G, vals_f.shape[1]), ident, dtype=torch.float32,
                           device=dev)
            m.scatter_reduce_(0, k[:, None].expand(-1, vals_f.shape[1]),
                              vals_f, red, include_self=False)
            m = m[:num_groups]
            if empty_as_nan:
                m = torch.where(empty[:, None],
                                torch.full_like(m, float("nan")), m)
            out[agg] = sq(m)
    return out


def _range_mask(cols, where_ranges, where):
    """AND of the exact range predicates and the user's ``where``, on the
    device."""
    m = None
    for c, lo, hi in where_ranges:
        x = cols[c]
        mm = torch.ones(x.shape, dtype=torch.bool, device=x.device)
        if lo is not None:
            mm = mm & (x >= lo)
        if hi is not None:
            mm = mm & (x <= hi)
        m = mm if m is None else m & mm
    if where is not None:
        w = where(cols)
        m = w if m is None else m & w
    return m


def _sample_var(count, summed, sum2):
    """(G,) count + (G, C) sum / sum2 → sample variance (n-1), NaN for
    n < 2, clamped at 0 against one-pass cancellation."""
    n = count.to(torch.float32)[:, None]
    var = (sum2 - summed * summed / torch.clamp(n, min=1.0)) \
        / torch.clamp(n - 1.0, min=1.0)
    var = torch.clamp(var, min=0.0)
    return torch.where(n >= 2, var, torch.full_like(var, float("nan")))


def _norm_aggs(aggs) -> tuple:
    """The foldable-aggregate set behind any requested aggs."""
    want = set(aggs)
    folds = (want | {"count", "sum"}) - {"mean", "var", "std"}
    if want & {"var", "std"}:
        folds.add("sum2")
    return tuple(sorted(folds))


def _validate_query(aggs, method) -> None:
    for a in aggs:
        if a not in _AGGS:
            raise ValueError(f"unknown aggregate {a!r}")
    if method not in ("matmul", "scatter"):
        raise ValueError(f"unknown method {method!r}")


def _zero_folds(num_groups: int, aggs, n_value_cols: int = 0,
                device="cpu") -> Dict[str, torch.Tensor]:
    """Foldable identities for a scan with no surviving row group."""
    aggs_norm = _norm_aggs(aggs)
    vshape = ((num_groups,) if n_value_cols == 0
              else (num_groups, n_value_cols))
    f: Dict[str, torch.Tensor] = {
        "count": torch.zeros((num_groups,), dtype=torch.int32,
                             device=device),
        "sum": torch.zeros(vshape, dtype=torch.float32, device=device)}
    if "sum2" in aggs_norm:
        f["sum2"] = torch.zeros(vshape, dtype=torch.float32, device=device)
    if "min" in aggs_norm:
        f["min"] = torch.full(vshape, float("inf"), device=device)
    if "max" in aggs_norm:
        f["max"] = torch.full(vshape, float("-inf"), device=device)
    return f


def _validate_nulls(nulls: str, single: bool) -> None:
    if nulls not in ("forbid", "skip"):
        raise ValueError(f"bad nulls={nulls!r}")
    if nulls == "skip" and not single:
        raise ValueError(
            "nulls='skip' supports a single value column (per-column "
            "NULL patterns would need per-column counts); aggregate "
            "one nullable column at a time")


def _value_cols(value_column):
    """value_column str | list | tuple → (names, single flag); only
    ordered containers (results are positional)."""
    if isinstance(value_column, str):
        return [value_column], True
    if not isinstance(value_column, (list, tuple)):
        raise TypeError(
            f"value_column must be a str, list or tuple (ordered — "
            f"results are positional), got {type(value_column).__name__}")
    vcols = list(value_column)
    if not vcols:
        raise ValueError("value_column list must not be empty")
    return vcols, False


def _stack_values(cols, vcols, single):
    if single:
        return cols[vcols[0]]
    return torch.stack([cols[c].to(torch.float32) for c in vcols], dim=1)


def sql_window_bytes() -> int:
    """Row-group coalescing target of the fold scans (bytes a yielded
    batch on the all-PLAIN direct path): each batch costs a fixed set of
    device calls (join, view, fold), so bigger batches amortize them.
    ``STROM_SQL_WINDOW_BYTES`` overrides, 0 gives one batch a row
    group.  The default, 64 MiB, is the faster of 0 and 64 MiB on an H100
    where row groups are smaller than the window (2^25 rows in 8 MiB row
    groups: 4 folds against 32, 1.29x; PERF.md, Direct SQL); on row
    groups of a window or more the two fold alike."""
    v = os.environ.get("STROM_SQL_WINDOW_BYTES")
    return int(v) if v is not None else DEFAULT_WINDOW_BYTES


#: the scan's default window (see :func:`sql_window_bytes`)
DEFAULT_WINDOW_BYTES = 64 << 20


def iter_device_columns(scanner, columns: Sequence[str], dev,
                        require_int: Sequence[str] = (),
                        narrow_int32: Sequence[str] = (),
                        row_groups=None, nulls: str = "forbid",
                        plans=None, window_bytes=None):
    """Stream a scanner's row groups as {name: device tensor} dicts: the
    pq_direct path when every column plans, else the host path with its
    counted handoff copy.  ``require_int`` names must be integer
    columns; ``narrow_int32`` names arrive as int32 (narrowed on the host
    on the host path).  ``nulls="mask"`` yields (values, masks) pairs.
    ``window_bytes``: row-group coalescing for fold consumers."""
    from nvme_strom_tpu_torch.ops.bridge import to_device
    from nvme_strom_tpu_torch.sql import pq_direct

    if nulls not in ("forbid", "mask"):
        raise ValueError(f"bad nulls={nulls!r}")
    masked = nulls == "mask"
    require_int = tuple(dict.fromkeys([*require_int, *narrow_int32]))

    def check_dev(cols):
        for c in require_int:
            if not _is_int(cols[c]):
                raise TypeError(f"key column {c} must be integer")
        for c in narrow_int32:
            cols[c] = cols[c].to(torch.int32)

    def check_host(cols):
        for c in require_int:
            if not np.issubdtype(cols[c].dtype, np.integer):
                raise TypeError(f"key column {c} must be integer")
        for c in narrow_int32:
            cols[c] = cols[c].astype(np.int32)

    if plans is None:
        plans = pq_direct.try_plan(scanner, columns, allow_nulls=masked)
    if plans is not None:
        for cols in pq_direct.iter_plain_row_groups_to_device(
                scanner, columns, device=dev, plans=plans,
                row_groups=row_groups, nulls=nulls,
                window_bytes=window_bytes):
            if masked:
                vals = {c: v for c, (v, _) in cols.items()}
                masks = {c: m for c, (_, m) in cols.items()}
                check_dev(vals)
                yield vals, masks
            else:
                check_dev(cols)
                yield cols
        return
    for item in scanner.iter_row_groups(list(columns),
                                        row_groups=row_groups,
                                        nulls=nulls):
        host, hmask = item if masked else (item, None)
        for c in columns:
            if host[c].dtype == object:
                raise TypeError(f"column {c} holds strings: group a string "
                                "key with sql_groupby_str")
        check_host(host)
        vals = {c: to_device(scanner.engine, host[c], dev) for c in columns}
        if masked:
            yield vals, {c: to_device(scanner.engine, hmask[c], dev)
                         for c in columns}
        else:
            yield vals


def finalize_folds(folds: Dict[str, torch.Tensor],
                   aggs: Sequence[str]) -> Dict[str, torch.Tensor]:
    """Foldable partials → the requested aggregates, NaN for empty
    groups."""
    out: Dict[str, torch.Tensor] = {}
    count = folds["count"]

    def up(x, like):
        return x[:, None] if like.dim() == 2 else x

    if "count" in aggs:
        out["count"] = count
    if "sum" in aggs:
        out["sum"] = folds["sum"]
    if "mean" in aggs:
        cf = count.to(torch.float32)
        mean = folds["sum"] / torch.clamp(up(cf, folds["sum"]), min=1.0)
        out["mean"] = torch.where(up(cf, mean) > 0, mean,
                                  torch.full_like(mean, float("nan")))
    if {"var", "std"} & set(aggs):
        sum_ = folds["sum"]
        sum2 = folds["sum2"]
        s1 = sum_ if sum_.dim() == 2 else sum_[:, None]
        s2 = sum2 if sum2.dim() == 2 else sum2[:, None]
        var = _sample_var(count, s1, s2)
        var = var if sum_.dim() == 2 else var[:, 0]
        if "var" in aggs:
            out["var"] = var
        if "std" in aggs:
            out["std"] = torch.sqrt(var)
    empty = count == 0
    for a in ("min", "max"):
        if a in aggs:
            f = folds[a]
            out[a] = torch.where(up(empty, f),
                                 torch.full_like(f, float("nan")), f)
    return out


def top_k_groups(result: Dict[str, torch.Tensor], by: str, k: int,
                 descending: bool = True) -> Dict[str, torch.Tensor]:
    """ORDER BY <agg> [DESC] LIMIT k over a groupby / join result, on the
    device: a stable sort of the ``by`` aggregate ranks the groups
    (equal values in group order), every column is gathered in that
    order, and the group ids come back as ``"group"``.  NaN groups sort
    last."""
    if by not in result:
        raise KeyError(f"{by!r} not in result columns {sorted(result)}")
    n = result[by].shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"k={k} not in [1, {n}]")
    key = result[by].to(torch.float32)
    key = torch.where(torch.isnan(key),
                      torch.full_like(key, float("-inf") if descending
                                      else float("inf")), key)
    idx = torch.sort(key, descending=descending, stable=True).indices[:k]
    out = {c: v[idx] for c, v in result.items()}
    out["group"] = idx.to(torch.int32)
    return dict(sorted(out.items()))    # the JAX result's key order


def sql_groupby(scanner, key_column: str, value_column,
                num_groups: int, aggs: Sequence[str] = ("count", "sum",
                                                        "mean"),
                method: str = "matmul", device=None,
                where=None, where_columns: Sequence[str] = (),
                where_ranges: Sequence[tuple] = (),
                nulls: str = "forbid") -> Dict[str, torch.Tensor]:
    """``SELECT key, AGG(value) FROM parquet [WHERE ...] GROUP BY key``.

    Row groups stream through the engine and fold on the device, so
    device memory holds one row group (or window) of columns at a time.
    ``where``: ``fn(cols) -> (N,) bool`` over {name: device column} for
    key, value and every ``where_columns`` name.  ``where_ranges``:
    (column, lo, hi) ranges that also prune row groups by the footer
    statistics before any payload read.  ``value_column`` may be a list
    (each value aggregate is then (num_groups, n_columns)).
    ``nulls="skip"``: SQL NULL semantics for a single value column."""
    _validate_query(aggs, method)
    where_ranges = list(where_ranges)
    vcols, single = _value_cols(value_column)
    _validate_nulls(nulls, single)
    return _fold_scan(scanner, key_column, vcols, single, num_groups,
                      aggs, method, device, where, where_columns,
                      where_ranges, nulls)


def _fold_scan(scanner, key_column, vcols, single, num_groups, aggs,
               method, device, where, where_columns, where_ranges,
               nulls, finalize: bool = True) -> Dict[str, torch.Tensor]:
    """The one scan→fold body behind sql_groupby and sql_scalar_agg
    (``key_column=None`` folds into one global group).  ``finalize=False``
    returns the raw foldable partials (multi-file and distributed
    unions keep folding)."""
    from nvme_strom_tpu_torch.device import resolve_device
    from nvme_strom_tpu_torch.sql import scan_plan
    dev = resolve_device(device)
    range_cols = [c for c, _, _ in where_ranges]
    key_cols = [key_column] if key_column is not None else []
    cols_needed = list(dict.fromkeys(
        [*key_cols, *vcols, *where_columns, *range_cols]))
    if where_ranges:
        if scan_plan.pushdown_enabled():
            rgs = list(scan_plan.plan_scan(
                scanner, cols_needed, where_ranges).row_groups)
        else:
            rgs = scanner.prune_row_groups(where_ranges)
    else:
        rgs = None
    full_where = ((lambda cols: _range_mask(cols, where_ranges, where))
                  if (where_ranges or where is not None) else None)
    if rgs is not None and not rgs:
        zero = _zero_folds(num_groups, aggs, 0 if single else len(vcols),
                           dev)
        return finalize_folds(zero, aggs) if finalize else zero

    def keys_of(cols):
        if key_column is not None:
            return cols[key_column]
        v = cols[vcols[0]]
        return torch.zeros(v.shape[0], dtype=torch.int32, device=v.device)

    def stream():
        if nulls == "skip":
            for cols, masks in iter_device_columns(
                    scanner, cols_needed, dev,
                    narrow_int32=tuple(key_cols), row_groups=rgs,
                    nulls="mask"):
                base = None
                for c in cols_needed:
                    base = masks[c] if base is None else base & masks[c]
                yield (keys_of(cols),
                       _stack_values(cols, vcols, single), cols, base)
        else:
            for cols in scan_plan.iter_scan_columns(
                    scanner, cols_needed, dev,
                    narrow_int32=tuple(key_cols), row_groups=rgs,
                    where_ranges=where_ranges,
                    window_bytes=sql_window_bytes()):
                yield (keys_of(cols),
                       _stack_values(cols, vcols, single), cols, None)

    return _stream_fold(stream(), num_groups, aggs, method, full_where,
                        finalize=finalize)


def _stream_fold(stream, num_groups: int, aggs: Sequence[str],
                 method: str, where,
                 finalize: bool = True) -> Dict[str, torch.Tensor]:
    """Fold per-row-group partial aggregates; ``stream`` yields (keys,
    values, cols for where, base mask | None)."""
    folds = None
    for keys, values, cols, base in stream:
        mask = where(cols) if where is not None else None
        if base is not None:
            mask = base if mask is None else (mask & base)
        part = groupby_aggregate(keys, values, num_groups,
                                 aggs=_norm_aggs(aggs), method=method,
                                 mask=mask, empty_as_nan=False)
        folds = part if folds is None else _fold(folds, part)
    if folds is None:
        raise ValueError("empty table")
    return finalize_folds(folds, aggs) if finalize else folds


def sql_scalar_agg(scanner, value_column,
                   aggs: Sequence[str] = ("count", "sum", "mean"),
                   method: str = "matmul", device=None,
                   where=None, where_columns: Sequence[str] = (),
                   where_ranges: Sequence[tuple] = (),
                   nulls: str = "forbid") -> Dict[str, object]:
    """``SELECT AGG(v), ... FROM parquet [WHERE ...]`` — one global
    group through the same fold.  Returns {agg: 0-d tensor} (or
    (n_columns,) for a list)."""
    _validate_query(aggs, method)
    where_ranges = list(where_ranges)
    vcols, single = _value_cols(value_column)
    _validate_nulls(nulls, single)
    res = _fold_scan(scanner, None, vcols, single, 1, aggs, method,
                     device, where, where_columns, where_ranges, nulls)
    return {a: res[a][0] for a in res}


def sql_groupby_str(scanner, key_column: str, value_column,
                    aggs: Sequence[str] = ("count", "sum", "mean"),
                    method: str = "matmul", device=None,
                    where=None, where_columns: Sequence[str] = (),
                    where_ranges: Sequence[tuple] = ()
                    ) -> Dict[str, object]:
    """GROUP BY a dictionary-encoded STRING key, the strings never on the
    device: the device groups by the int32 dictionary code and the host
    maps group ids back to labels.  The result carries ``"labels"``
    (``labels[g]``, bytes, names group ``g``)."""
    from nvme_strom_tpu_torch.device import resolve_device
    from nvme_strom_tpu_torch.sql import pq_direct
    _validate_query(aggs, method)
    where_ranges = list(where_ranges)
    if any(c == key_column for c, _, _ in where_ranges):
        raise ValueError(
            f"range predicate on string key {key_column!r} would "
            "compare dictionary codes, not labels — filter labels "
            "host-side or use a numeric column")
    dev = resolve_device(device)
    vcols, single = _value_cols(value_column)
    if where_ranges:
        from nvme_strom_tpu_torch.sql import scan_plan
        if scan_plan.pushdown_enabled():
            proj = list(dict.fromkeys(
                [key_column, *vcols, *where_columns,
                 *(c for c, _, _ in where_ranges)]))
            rgs = list(scan_plan.plan_scan(
                scanner, proj, where_ranges).row_groups)
        else:
            rgs = scanner.prune_row_groups(where_ranges)
    else:
        rgs = None
    labels, iter_codes = pq_direct.read_dict_key_column(
        scanner, key_column, device=dev, row_groups=rgs)
    num_groups = len(labels)
    if num_groups == 0:
        raise ValueError("empty dictionary (no rows?)")
    range_cols = [c for c, _, _ in where_ranges if c != key_column]
    cols_needed = [c for c in dict.fromkeys([*vcols, *where_columns,
                                             *range_cols])
                   if c != key_column]
    full_where = ((lambda cols: _range_mask(cols, where_ranges, where))
                  if (where_ranges or where is not None) else None)
    if rgs is not None and not rgs:
        out0: Dict[str, object] = dict(
            finalize_folds(_zero_folds(num_groups, aggs,
                                       0 if single else len(vcols), dev),
                           aggs))
        out0["labels"] = labels
        return out0

    def stream():
        for cols, codes in zip(
                iter_device_columns(scanner, cols_needed, dev,
                                    row_groups=rgs),
                iter_codes()):
            cols[key_column] = codes
            yield codes, _stack_values(cols, vcols, single), cols, None

    out: Dict[str, object] = dict(_stream_fold(stream(), num_groups,
                                               aggs, method, full_where))
    out["labels"] = labels
    return out


def _fold(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]):
    out = {}
    for k in a:
        if k in ("count", "sum", "sum2"):
            out[k] = a[k] + b[k]
        elif k == "min":
            out[k] = torch.minimum(a[k], b[k])
        elif k == "max":
            out[k] = torch.maximum(a[k], b[k])
        else:
            out[k] = a[k]
    return out
