"""SQL text front-end: parse a SELECT string, run it on the device
(counterpart of nvme_strom_tpu/sql/parser.py).

PG-Strom's user surface is SQL — its scan/agg/join acceleration hides
behind PostgreSQL's planner.  The executors in this package
(`sql_groupby`, `sql_groupby_str`, `star_join_groupby`, `sql_topk`) are
that acceleration, each a Python call; this module gives them the same
front door — a SQL string in, device-aggregated results out:

    sql_query("SELECT k, COUNT(*), SUM(v) FROM t "
              "WHERE 0.2 <= w AND w <= 0.8 GROUP BY k", {"t": scanner})

Supported dialect (one SELECT, no subqueries/OR — the shapes the device
executors accelerate; anything else raises ``SQLSyntaxError`` rather
than silently falling back):

    SELECT item [, item ...] FROM t
        [JOIN d ON t.col = d.col]
        [WHERE conj [AND conj ...]]
        [GROUP BY col]
        [HAVING hconj [AND hconj ...]]
        [ORDER BY col|agg [ASC|DESC]]
        [LIMIT n]
    item := col | COUNT(*) | {COUNT|SUM|MEAN|AVG|MIN|MAX|VAR|STD|STDDEV}(col) [AS name]
    conj := col {=|<|<=|>|>=} number | number {=|<|<=|>|>=} col
          | col BETWEEN number AND number
    hconj := agg|alias {=|<|<=|>|>=} number      (post-aggregation)

Planning rules (each maps to one streaming executor — the query never
materializes the table):

- aggregates without GROUP BY       → ``sql_scalar_agg`` (one global
  group, same WHERE pushdown / stats pruning)
- GROUP BY over an integer key      → ``sql_groupby``   (num_groups
  derived from footer statistics when possible)
- GROUP BY over a string key        → ``sql_groupby_str`` (dictionary
  codes on device, labels on host)
- JOIN ... GROUP BY                 → ``star_join_groupby``
- ORDER BY + LIMIT, no GROUP BY     → ``sql_topk`` (statistics-
  eliminated scan)
- ORDER BY + LIMIT after GROUP BY   → ``top_k_groups`` on the folded
  aggregates (only k rows reach the host)
- bare projection [+ WHERE, LIMIT]  → streamed scan, predicate ON
  DEVICE, rows gathered host-side (projection output is host-bound
  by definition)

Inclusive predicates (=, <=, >=, BETWEEN) both prune row groups via
footer statistics AND filter exactly on device; strict (<, >) prune
with the inclusive superset and keep exactness in the device mask.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["SQLSyntaxError", "parse_select", "sql_query", "Query"]

_AGG_FNS = ("count", "sum", "mean", "avg", "min", "max", "var",
            "std", "stddev")
_AGG_ALIAS = {"avg": "mean", "stddev": "std"}
_KEYWORDS = {"select", "from", "join", "on", "where", "and", "between",
             "group", "by", "having", "order", "asc", "desc", "limit",
             "as", "or", "not"}

_TOKEN = re.compile(r"""\s*(?:
      (?P<num>-?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)
    | (?P<str>'(?:[^']|'')*')
    | (?P<id>[A-Za-z_][A-Za-z0-9_.]*)
    | (?P<op><=|>=|!=|<>|[<>=(),*])
    )""", re.VERBOSE)


class SQLSyntaxError(ValueError):
    """Query text outside the supported dialect (position + hint)."""


@dataclass
class SelectItem:
    agg: Optional[str]        # None = bare column; "count" may pair
    column: Optional[str]     # None only for COUNT(*)
    alias: Optional[str] = None

    @property
    def name(self) -> str:
        if self.alias:
            return self.alias
        if self.agg is None:
            return self.column
        return f"{self.agg}({self.column or '*'})"


@dataclass
class Query:
    select: List[SelectItem]
    table: str
    join: Optional[Tuple[str, str, str]] = None  # (tbl2, lcol, rcol) qualified
    where: List[Tuple[str, str, float]] = field(default_factory=list)
    group_by: Optional[str] = None
    having: List[Tuple[str, str, float]] = field(default_factory=list)
    order_by: Optional[Tuple[str, bool]] = None        # (name, descending)
    limit: Optional[int] = None


class _Tokens:
    def __init__(self, sql: str):
        self.sql = sql
        self.toks: List[Tuple[str, str, int]] = []
        pos = 0
        while pos < len(sql):
            m = _TOKEN.match(sql, pos)
            if m is None:
                if sql[pos:].strip() == "":
                    break
                raise SQLSyntaxError(
                    f"unrecognized token at position {pos}: "
                    f"{sql[pos:pos + 20]!r}")
            pos = m.end()
            for kind in ("num", "str", "id", "op"):
                v = m.group(kind)
                if v is not None:
                    if kind == "id" and v.lower() in _KEYWORDS:
                        kind = "kw"
                        v = v.lower()
                    self.toks.append((kind, v, m.start()))
                    break
        self.i = 0

    def peek(self, kind=None, value=None):
        if self.i >= len(self.toks):
            return None
        k, v, _ = self.toks[self.i]
        if kind is not None and k != kind:
            return None
        if value is not None and v.lower() != value:
            return None
        return v

    def next(self):
        if self.i >= len(self.toks):
            raise SQLSyntaxError("unexpected end of query")
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, kind, value=None):
        k, v, pos = self.next()
        if k != kind or (value is not None and v.lower() != value):
            want = value or kind
            raise SQLSyntaxError(
                f"expected {want!r} at position {pos}, got {v!r}")
        return v

    def accept(self, kind, value=None) -> Optional[str]:
        if self.peek(kind, value) is not None:
            return self.next()[1]
        return None

    def done(self) -> bool:
        return self.i >= len(self.toks)


def parse_select(sql: str) -> Query:
    """Parse the supported SELECT dialect into a :class:`Query`."""
    t = _Tokens(sql)
    t.expect("kw", "select")

    select: List[SelectItem] = []
    while True:
        select.append(_parse_item(t))
        if not t.accept("op", ","):
            break
    if not select:
        raise SQLSyntaxError("empty select list")

    t.expect("kw", "from")
    table = t.expect("id")

    join = None
    if t.accept("kw", "join"):
        tbl2 = t.expect("id")
        t.expect("kw", "on")
        lcol = t.expect("id")
        t.expect("op", "=")
        rcol = t.expect("id")
        join = (tbl2, lcol, rcol)

    where: List[Tuple[str, str, float]] = []
    if t.accept("kw", "where"):
        while True:
            where.extend(_parse_conjunct(t))
            if not t.accept("kw", "and"):
                break
        if t.peek("kw", "or"):
            raise SQLSyntaxError(
                "OR is not supported (conjunctive predicates only — "
                "they push down to the device scan)")

    group_by = None
    if t.accept("kw", "group"):
        t.expect("kw", "by")
        group_by = t.expect("id")

    having: List[Tuple[str, str, float]] = []
    if t.accept("kw", "having"):
        if group_by is None:
            raise SQLSyntaxError("HAVING requires GROUP BY")
        while True:
            name = _parse_order_target(t, clause="HAVING")
            op = t.expect("op")
            if op not in ("<", "<=", ">", ">=", "="):
                raise SQLSyntaxError(
                    f"bad HAVING comparison operator {op!r}")
            having.append((name, op, float(t.expect("num"))))
            if not t.accept("kw", "and"):
                break

    order_by = None
    if t.accept("kw", "order"):
        t.expect("kw", "by")
        name = _parse_order_target(t)
        desc = bool(t.accept("kw", "desc"))
        if not desc:
            t.accept("kw", "asc")   # SQL default; explicit ASC is a no-op
        order_by = (name, desc)

    limit = None
    if t.accept("kw", "limit"):
        raw = t.expect("num")
        try:
            limit = int(raw)
        except ValueError:
            raise SQLSyntaxError(f"LIMIT must be an integer, got {raw!r}")
        if limit < 1:
            raise SQLSyntaxError(f"LIMIT must be >= 1, got {limit}")

    if not t.done():
        k, v, pos = t.next()
        raise SQLSyntaxError(f"unexpected {v!r} at position {pos}")
    return Query(select=select, table=table, join=join, where=where,
                 group_by=group_by, having=having, order_by=order_by,
                 limit=limit)


def _parse_item(t: _Tokens) -> SelectItem:
    kind, v, pos = t.next()
    if kind == "id" and v.lower() in _AGG_FNS and t.peek("op", "("):
        fn = _AGG_ALIAS.get(v.lower(), v.lower())
        t.expect("op", "(")
        if t.accept("op", "*"):
            if fn != "count":
                raise SQLSyntaxError(f"{fn.upper()}(*) is not SQL; "
                                     "only COUNT(*) takes *")
            col = None
        else:
            col = t.expect("id")
        t.expect("op", ")")
        item = SelectItem(agg=fn, column=col)
    elif kind == "id":
        item = SelectItem(agg=None, column=v)
    elif kind == "op" and v == "*":
        raise SQLSyntaxError(
            "SELECT * is not supported: the direct path streams only "
            "the referenced columns — name them")
    else:
        raise SQLSyntaxError(f"bad select item at position {pos}: {v!r}")
    if t.accept("kw", "as"):
        item.alias = t.expect("id")
    return item


def _parse_order_target(t: _Tokens, clause: str = "ORDER BY") -> str:
    """ORDER BY / HAVING target: a column, or an aggregate spelled like
    the select list spells it (``ORDER BY COUNT(v)`` ≡ the item named
    ``count(v)``)."""
    kind, v, pos = t.next()
    if kind != "id":
        raise SQLSyntaxError(f"bad {clause} target at {pos}: {v!r}")
    if v.lower() in _AGG_FNS and t.peek("op", "("):
        fn = _AGG_ALIAS.get(v.lower(), v.lower())
        t.expect("op", "(")
        col = None if t.accept("op", "*") else t.expect("id")
        t.expect("op", ")")
        return f"{fn}({col or '*'})"
    return v


def _parse_conjunct(t: _Tokens) -> List[Tuple[str, str, float]]:
    """One predicate → [(col, op, value)] with op in <,<=,>,>=,=.
    Literal-first comparisons are flipped onto the column."""
    kind, v, pos = t.next()
    if kind == "id":
        col = v
        if t.accept("kw", "between"):
            lo = float(t.expect("num"))
            t.expect("kw", "and")
            hi = float(t.expect("num"))
            return [(col, ">=", lo), (col, "<=", hi)]
        op = t.expect("op")
        k2, v2, p2 = t.next()
        if k2 == "str":
            raise SQLSyntaxError(
                "string predicates are not supported on the direct "
                "path (dictionary codes, not labels, live on device) — "
                "filter string-keyed results host-side")
        if k2 != "num":
            raise SQLSyntaxError(f"expected a number at {p2}, got {v2!r}")
        val = float(v2)
    elif kind == "num":
        val = float(v)
        op = t.expect("op")
        col = t.expect("id")
        flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "="}
        if op not in flip:
            raise SQLSyntaxError(f"bad comparison operator {op!r}")
        op = flip[op]
    else:
        raise SQLSyntaxError(f"bad predicate at position {pos}: {v!r}")
    if op in ("!=", "<>"):
        raise SQLSyntaxError("!= cannot prune row groups and is not "
                             "supported; use ranges")
    if op not in ("<", "<=", ">", ">=", "="):
        raise SQLSyntaxError(f"bad comparison operator {op!r}")
    return [(col, op, val)]


# --------------------------- planning/executing ---------------------------

def _split_where(conjs):
    """(col, op, val) conjuncts → (where_ranges, strict) where
    ``where_ranges`` are inclusive [lo, hi] bounds (statistics pruning +
    exact device mask) and ``strict`` are the <,> comparisons that the
    inclusive bounds over-approximate — applied exactly in the device
    predicate on top."""
    ranges: Dict[str, List[Optional[float]]] = {}
    strict: List[Tuple[str, str, float]] = []

    def bound(col, lo=None, hi=None):
        r = ranges.setdefault(col, [None, None])
        if lo is not None:
            r[0] = lo if r[0] is None else max(r[0], lo)
        if hi is not None:
            r[1] = hi if r[1] is None else min(r[1], hi)

    for col, op, val in conjs:
        if op == "=":
            bound(col, lo=val, hi=val)
        elif op == ">=":
            bound(col, lo=val)
        elif op == "<=":
            bound(col, hi=val)
        elif op == ">":
            bound(col, lo=val)      # inclusive superset for pruning
            strict.append((col, op, val))
        elif op == "<":
            bound(col, hi=val)
            strict.append((col, op, val))
    where_ranges = [(c, lo, hi) for c, (lo, hi) in ranges.items()]
    return where_ranges, strict


def _strict_predicate(strict):
    if not strict:
        return None, ()

    def fn(cols):
        m = None
        for col, op, val in strict:
            c = cols[col]
            part = (c > val) if op == ">" else (c < val)
            m = part if m is None else (m & part)
        return m

    return fn, tuple(dict.fromkeys(c for c, _, _ in strict))


def _resolve(tables, name, engine):
    """A table entry may be a scanner, a path, a LIST of either, or a
    directory path ending in '/' — lists/directories resolve to a
    multi-file dataset (executed via sql/multi.py)."""
    from nvme_strom_tpu_torch.sql.parquet import ParquetScanner
    if hasattr(tables, "num_row_groups"):     # a scanner: single table
        return tables
    if isinstance(tables, (list, tuple)):     # a dataset AS the table
        if engine is None and any(isinstance(x, (str, bytes))
                                  for x in tables):
            raise ValueError("dataset has paths; pass engine= to open "
                             "them")
        return [x if hasattr(x, "num_row_groups")
                else ParquetScanner(x, engine) for x in tables]
    try:
        t = tables[name]
    except (KeyError, TypeError):
        raise KeyError(f"table {name!r} not in tables "
                       f"{sorted(tables) if hasattr(tables, 'keys') else tables!r}")
    if isinstance(t, (list, tuple)):
        if engine is None and any(isinstance(x, (str, bytes))
                                  for x in t):
            raise ValueError(f"table {name!r} has paths; pass engine=")
        return [x if hasattr(x, "num_row_groups")
                else ParquetScanner(x, engine) for x in t]
    if isinstance(t, (str, bytes)):
        import os
        if engine is None:
            raise ValueError(f"table {name!r} is a path; pass engine= "
                             "to open it")
        if os.path.isdir(t):
            from nvme_strom_tpu_torch.sql.multi import open_dataset
            return open_dataset(t, engine)
        return ParquetScanner(t, engine)
    return t


def _is_string_col(scanner, col: str) -> bool:
    md = scanner.metadata
    for i in range(md.num_columns):
        c = md.schema.column(i)
        if c.name == col:
            return str(c.physical_type) == "BYTE_ARRAY"
    raise KeyError(f"column {col!r} not in schema")


def _derive_num_groups(scanner, col: str) -> Optional[int]:
    """max(col)+1 from footer statistics — the dense group-id domain —
    or None when any row group lacks stats (caller must then pass
    num_groups explicitly)."""
    md = scanner.metadata
    ci = None
    for i in range(md.num_columns):
        if md.schema.column(i).name == col:
            ci = i
            break
    if ci is None:
        raise KeyError(f"column {col!r} not in schema")
    mx = None
    for rg in range(md.num_row_groups):
        st = md.row_group(rg).column(ci).statistics
        if st is None or not st.has_min_max:
            return None
        if not isinstance(st.max, int):
            raise TypeError(f"GROUP BY {col!r}: integer key required, "
                            f"stats say {type(st.max).__name__}")
        mx = st.max if mx is None else max(mx, st.max)
    return None if mx is None else int(mx) + 1


def _unqual(name: str, table: str, alt: str = None) -> str:
    """Strip a 't.' qualifier (validated against the known tables)."""
    if "." in name:
        tbl, col = name.split(".", 1)
        if tbl not in (table, alt):
            raise SQLSyntaxError(f"unknown table qualifier {tbl!r} "
                                 f"in {name!r}")
        return col
    return name


def sql_query(sql: str, tables, *, num_groups: Optional[int] = None,
              device=None, engine=None, method: str = "matmul",
              nulls: str = "forbid") -> Dict[str, object]:
    """Parse ``sql`` and execute it against ``tables``.

    ``tables``: a ParquetScanner (single-table queries), or a dict
    name → ParquetScanner | path (paths are opened through ``engine``).
    ``num_groups``: group-id domain for integer GROUP BY keys; derived
    from footer statistics when omitted.  Returns {name: array} keyed
    by select-item names (aliases win); grouped queries add the group
    key column (``arange`` ids for integer keys, ``labels`` bytes for
    string keys), top-k queries add ``_row`` provenance.
    """
    from nvme_strom_tpu_torch.device import resolve_device
    q = parse_select(sql)
    device = resolve_device(device)
    if q.join is not None:
        if nulls != "forbid":
            raise SQLSyntaxError("nulls='skip' is not supported for "
                                 "JOIN queries")
        return _run_join(q, tables, num_groups=num_groups, device=device,
                         engine=engine, method=method)
    sc = _resolve(tables, q.table, engine)
    for it in q.select:
        if it.column:
            it.column = _unqual(it.column, q.table)
    q.where = [(_unqual(c, q.table), op, v) for c, op, v in q.where]
    if q.group_by:
        q.group_by = _unqual(q.group_by, q.table)
        return _run_groupby(q, sc, num_groups=num_groups, device=device,
                            method=method, nulls=nulls)
    if any(it.agg is not None for it in q.select) and not q.order_by:
        return _run_scalar_agg(q, sc, device=device, method=method,
                               nulls=nulls)
    if q.order_by:
        return _run_topk(q, sc, device=device, nulls=nulls)
    if nulls != "forbid":
        raise SQLSyntaxError("nulls='skip' is not supported for bare "
                             "projections")
    return _run_projection(q, sc, device=device)


def _agg_items(q: Query):
    aggs = [it for it in q.select if it.agg is not None]
    bare = [it for it in q.select if it.agg is None]
    return aggs, bare


def _run_groupby(q: Query, sc, *, num_groups, device, method, nulls):
    import numpy as np
    from nvme_strom_tpu_torch.sql.groupby import (sql_groupby, sql_groupby_str,
                                            top_k_groups)
    agg_items, bare = _agg_items(q)
    for it in bare:
        if it.column != q.group_by:
            raise SQLSyntaxError(
                f"bare column {it.column!r} in a GROUP BY query must be "
                f"the group key {q.group_by!r} (or aggregated)")
    if not agg_items:
        raise SQLSyntaxError("GROUP BY needs at least one aggregate")
    # same contract as the scalar path: COUNT(*) counts ROWS, but the
    # null-skipping stream drops NULL rows before the fold — the grouped
    # counts would silently undercount
    if nulls == "skip" and any(it.agg == "count" and it.column is None
                               for it in agg_items):
        raise SQLSyntaxError(
            "COUNT(*) counts rows, but nulls='skip' drops NULL rows "
            "from the stream and would undercount — count a named "
            "column instead")
    vcols = list(dict.fromkeys(it.column for it in agg_items
                               if it.column is not None))
    aggs = tuple(dict.fromkeys(it.agg for it in agg_items))
    where_ranges, strict = _split_where(q.where)
    where_fn, strict_cols = _strict_predicate(strict)

    dataset = isinstance(sc, list)
    str_key = _is_string_col(sc[0] if dataset else sc, q.group_by)
    if str_key:
        if dataset:
            raise SQLSyntaxError(
                "string-keyed GROUP BY over a multi-file dataset is "
                "not supported (per-file dictionaries would need a "
                "global label union) — query files individually")
        if not vcols:
            raise SQLSyntaxError(
                "COUNT(*) alone over a string key needs a numeric "
                "column to stream — count a named column instead")
        if nulls != "forbid":
            # sql_groupby_str has no null-mask plumbing: accepting the
            # flag here would zero-fill NULLs into the aggregates while
            # every other unsupported combination raises — fail loudly
            # like the rest
            raise SQLSyntaxError(
                f"nulls={nulls!r} is not supported for a string-keyed "
                "GROUP BY — the dictionary fold has no null mask; use "
                "an integer key or nulls='forbid'")
        res = sql_groupby_str(sc, q.group_by, vcols if len(vcols) > 1
                              else vcols[0], aggs=aggs, method=method,
                              device=device, where=where_fn,
                              where_columns=strict_cols,
                              where_ranges=where_ranges)
        key_out = {q.group_by: list(res.pop("labels"))}
    else:
        if num_groups:
            ng = num_groups
        else:
            derived = [_derive_num_groups(s, q.group_by)
                       for s in (sc if dataset else [sc])]
            ng = (None if any(d is None for d in derived)
                  else max(derived))
        if ng is None:
            raise ValueError(
                f"GROUP BY {q.group_by}: footer statistics are absent; "
                "pass num_groups= explicitly")
        value_column = (vcols if len(vcols) > 1 else
                        (vcols[0] if vcols else q.group_by))
        if dataset:
            from nvme_strom_tpu_torch.sql.multi import multi_groupby
            res = multi_groupby(sc, q.group_by, value_column, ng,
                                aggs=aggs, method=method, device=device,
                                where=where_fn,
                                where_columns=strict_cols,
                                where_ranges=where_ranges, nulls=nulls)
        else:
            res = sql_groupby(sc, q.group_by, value_column, ng,
                              aggs=aggs, method=method, device=device,
                              where=where_fn, where_columns=strict_cols,
                              where_ranges=where_ranges, nulls=nulls)
        key_out = {q.group_by: np.arange(
            res[aggs[0]].shape[0], dtype=np.int64)}

    out = dict(key_out)
    col_pos = {c: i for i, c in enumerate(vcols)}
    for it in agg_items:
        v = _host(res[it.agg])
        if getattr(v, "ndim", 1) == 2:
            v = (v[:, col_pos[it.column]] if it.column is not None
                 else v[:, 0])
        out[it.name] = v

    out = _apply_having(q, out, q.group_by)

    if q.order_by is not None:
        if q.limit is None:
            raise SQLSyntaxError("ORDER BY without LIMIT is unbounded; "
                                 "add LIMIT")
        by, desc = q.order_by
        by = _order_key(q, by)
        ranked_in = {k: _as_device(v, device) for k, v in out.items()
                     if not (str_key and k == q.group_by)}
        # SQL: LIMIT larger than the result is the whole result (and a
        # HAVING that filtered everything is a legal empty result)
        k_eff = min(q.limit, int(ranked_in[by].shape[0]))
        if k_eff == 0:
            return {k: (v if isinstance(v, list) else np.asarray(v))
                    for k, v in out.items()}
        ranked = top_k_groups(ranked_in, by, k_eff, descending=desc)
        res_out = {k: _host(v) for k, v in ranked.items()
                   if k != "group"}
        if str_key:
            labels = out[q.group_by]
            res_out[q.group_by] = [labels[g]
                                   for g in _host(ranked["group"])]
        return res_out
    if q.limit is not None:
        out = {k: v[:q.limit] for k, v in out.items()}
    return {k: (v if isinstance(v, list) else np.asarray(v))
            for k, v in out.items()}


def _order_key(q: Query, by: str, clause: str = "ORDER BY") -> str:
    """ORDER BY / HAVING target → output column name (alias-aware)."""
    for it in q.select:
        if it.name == by or (it.agg and
                             f"{it.agg}({it.column or '*'})" == by):
            return it.name
    raise SQLSyntaxError(f"{clause} {by!r} is not in the select list")


def _apply_having(q: Query, out: dict, group_col: str) -> dict:
    """Filter the grouped result rows by the HAVING conjuncts.

    Runs host-side on the already-folded aggregates — HAVING touches
    (num_groups,) arrays, not the scan, so there is nothing left to
    push down.  A string group key (label list) filters by index; other
    columns by boolean mask."""
    import numpy as np
    if not q.having:
        return out
    mask = None
    for name, op, val in q.having:
        col = out[_order_key(q, name, clause="HAVING")]
        if isinstance(col, list):       # the string group-key labels
            raise SQLSyntaxError(
                f"HAVING {name!r}: string columns cannot compare to "
                "numbers — HAVING takes the aggregates (or the integer "
                "group key)")
        arr = np.asarray(col)
        part = {"<": arr < val, "<=": arr <= val, ">": arr > val,
                ">=": arr >= val, "=": arr == val}[op]
        mask = part if mask is None else (mask & part)
    idx = np.nonzero(mask)[0]
    return {k: ([v[i] for i in idx] if isinstance(v, list)
                else np.asarray(v)[idx])
            for k, v in out.items()}


def _as_device(v, device):
    import torch
    return torch.as_tensor(_host(v)).to(device)


def _host(v):
    """A tensor (on any device), array or scalar → numpy on the host."""
    import numpy as np
    import torch
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _run_scalar_agg(q: Query, sc, *, device, method, nulls):
    """SELECT AGG(col), ... FROM t [WHERE ...] — one global group."""
    import numpy as np
    from nvme_strom_tpu_torch.sql.groupby import sql_scalar_agg
    agg_items, bare = _agg_items(q)
    if bare:
        raise SQLSyntaxError(
            f"bare column {bare[0].column!r} without GROUP BY — "
            "aggregate it or add GROUP BY")
    if q.order_by or q.having:
        raise SQLSyntaxError("ORDER BY/HAVING need GROUP BY (a scalar "
                             "aggregate is one row)")
    has_count_star = any(it.agg == "count" and it.column is None
                         for it in agg_items)
    if has_count_star and nulls == "skip":
        raise SQLSyntaxError(
            "COUNT(*) counts rows, but nulls='skip' drops NULL rows "
            "from the stream and would undercount — count a named "
            "column instead")
    dataset = isinstance(sc, list)
    if (not q.where
            and all(it.agg == "count" and it.column is None
                    for it in agg_items)):
        # bare COUNT(*): the footer already knows — zero payload I/O
        n = (sum(s.num_rows for s in sc) if dataset else sc.num_rows)
        return {it.name: np.int64(n) for it in agg_items}
    vcols = list(dict.fromkeys(it.column for it in agg_items
                               if it.column is not None))
    if not vcols:       # COUNT(*) alone still needs a column to stream
        md = (sc[0] if dataset else sc).metadata
        numeric = [md.schema.column(i).name
                   for i in range(md.num_columns)
                   if str(md.schema.column(i).physical_type)
                   != "BYTE_ARRAY"]
        if not numeric:
            raise SQLSyntaxError("COUNT(*) needs at least one numeric "
                                 "column in the table to stream")
        vcols = [numeric[0]]
    aggs = tuple(dict.fromkeys(it.agg for it in agg_items))
    where_ranges, strict = _split_where(q.where)
    where_fn, strict_cols = _strict_predicate(strict)
    value_column = vcols if len(vcols) > 1 else vcols[0]
    if dataset:
        from nvme_strom_tpu_torch.sql.multi import multi_scalar_agg
        res = multi_scalar_agg(sc, value_column, aggs=aggs,
                               method=method, device=device,
                               where=where_fn,
                               where_columns=strict_cols,
                               where_ranges=where_ranges, nulls=nulls)
    else:
        res = sql_scalar_agg(sc, value_column, aggs=aggs, method=method,
                             device=device, where=where_fn,
                             where_columns=strict_cols,
                             where_ranges=where_ranges, nulls=nulls)
    out = {}
    col_pos = {c: i for i, c in enumerate(vcols)}
    for it in agg_items:
        v = _host(res[it.agg])
        if getattr(v, "ndim", 0) >= 1:
            v = (v[col_pos[it.column]] if it.column is not None
                 else v[0])
        out[it.name] = np.asarray(v)[()]
    return out


def _run_topk(q: Query, sc, *, device, nulls):
    import numpy as np
    from nvme_strom_tpu_torch.sql.topk import sql_topk
    agg_items, bare = _agg_items(q)
    if agg_items:
        raise SQLSyntaxError("aggregates without GROUP BY are not "
                             "supported with ORDER BY (add GROUP BY)")
    if q.limit is None:
        raise SQLSyntaxError("ORDER BY without LIMIT is unbounded; "
                             "add LIMIT")
    by, desc = q.order_by
    by = _unqual(by, q.table)
    for it in bare:            # ORDER BY may name a select alias
        if it.alias == by:
            by = it.column
            break
    cols = [it.column for it in bare if it.column != by]
    where_ranges, strict = _split_where(q.where)
    where_fn, strict_cols = _strict_predicate(strict)
    if isinstance(sc, list):
        from nvme_strom_tpu_torch.sql.multi import multi_topk
        res = multi_topk(sc, by, columns=cols, k=q.limit,
                         descending=desc, device=device, where=where_fn,
                         where_columns=strict_cols,
                         where_ranges=where_ranges, nulls=nulls)
    else:
        res = sql_topk(sc, by, columns=cols, k=q.limit,
                       descending=desc, device=device, where=where_fn,
                       where_columns=strict_cols,
                       where_ranges=where_ranges, nulls=nulls)
    out = {}
    for it in bare:       # select order, aliases applied
        out[it.name] = np.asarray(res[it.column])
    out["_row"] = res["_row"]
    if "_file" in res:
        out["_file"] = res["_file"]
    out["_skipped_row_groups"] = res["_skipped_row_groups"]
    return out


def _run_projection(q: Query, sc, *, device):
    import numpy as np
    from nvme_strom_tpu_torch.sql.groupby import (_range_mask,
                                            iter_device_columns)
    if isinstance(sc, list):   # dataset: per-file scans, concatenated
        parts = [_run_projection(q, s, device=device) for s in sc]
        # drop fully-pruned members: their typeless np.empty((0,))
        # placeholders would promote int columns to float64 in concat
        nonempty = [p for p in parts
                    if len(next(iter(p.values()))) > 0]
        parts = nonempty or parts[:1]
        out = {n: np.concatenate([p[n] for p in parts])
               for n in parts[0]}
        if q.limit is not None:
            out = {n: v[:q.limit] for n, v in out.items()}
        return out
    agg_items, bare = _agg_items(q)
    if agg_items:
        raise SQLSyntaxError("aggregates without GROUP BY are not "
                             "supported (add GROUP BY)")
    dev = device
    out_cols = [it.column for it in bare]
    where_ranges, strict = _split_where(q.where)
    where_fn, strict_cols = _strict_predicate(strict)
    rgs = (sc.prune_row_groups(where_ranges) if where_ranges else None)
    cols_needed = list(dict.fromkeys(
        [*out_cols, *strict_cols, *(c for c, _, _ in where_ranges)]))
    parts = {it.name: [] for it in bare}
    got = 0
    for cols in iter_device_columns(sc, cols_needed, dev,
                                    row_groups=rgs):
        if where_ranges or where_fn is not None:
            m = _host(_range_mask(cols, where_ranges, where_fn))
            idx = np.nonzero(m)[0]
        else:
            idx = None
        for it in bare:
            a = _host(cols[it.column])
            parts[it.name].append(a if idx is None else a[idx])
        got += (len(idx) if idx is not None
                else int(cols[out_cols[0]].shape[0]))
        if q.limit is not None and got >= q.limit:
            break
    out = {n: (np.concatenate(p) if p else np.empty((0,)))
           for n, p in parts.items()}
    if q.limit is not None:
        out = {n: v[:q.limit] for n, v in out.items()}
    return out


def _run_join(q: Query, tables, *, num_groups, device, engine, method):
    import numpy as np
    from nvme_strom_tpu_torch.sql.join import star_join_groupby
    if q.group_by is None:
        raise SQLSyntaxError("JOIN requires GROUP BY (star aggregation "
                             "is the supported join shape)")
    fact_sc = _resolve(tables, q.table, engine)
    dim_sc = _resolve(tables, q.join[0], engine)
    if isinstance(fact_sc, list) or isinstance(dim_sc, list):
        raise SQLSyntaxError("JOIN over a multi-file dataset is not "
                             "supported — query per file")
    if fact_sc is dim_sc and q.table != q.join[0]:
        raise SQLSyntaxError("self-joins are not supported")
    dim_name = q.join[0]

    def side(name):
        if "." not in name:
            raise SQLSyntaxError(
                f"JOIN queries need table-qualified columns; {name!r} "
                f"is ambiguous between {q.table!r} and {dim_name!r}")
        tbl, col = name.split(".", 1)
        if tbl == q.table:
            return "fact", col
        if tbl == dim_name:
            return "dim", col
        raise SQLSyntaxError(f"unknown table qualifier in {name!r}")

    s1, on_l = side(q.join[1])
    s2, on_r = side(q.join[2])
    if {s1, s2} != {"fact", "dim"}:
        raise SQLSyntaxError("ON must equate a fact column with a "
                             "dimension column")
    fact_key = on_l if s1 == "fact" else on_r
    dim_key = on_r if s2 == "dim" else on_l

    gside, dim_attr = side(q.group_by)
    if gside != "dim":
        raise SQLSyntaxError("GROUP BY must name a dimension column "
                             "(the star shape)")
    agg_items, bare = _agg_items(q)
    for it in q.select:       # keep the user's qualified spelling in
        it.alias = it.alias or it.name    # the output column names
    for it in bare:
        if side(it.column) != ("dim", dim_attr):
            raise SQLSyntaxError(
                f"bare column {it.column!r} must be the GROUP BY key")
        it.column = dim_attr
    vcols = []
    for it in agg_items:
        if it.column is None:
            continue
        s, col = side(it.column)
        if s != "fact":
            raise SQLSyntaxError(f"aggregates must target fact "
                                 f"columns, got {it.column!r}")
        it.column = col
        vcols.append(col)
    vcols = list(dict.fromkeys(vcols))
    if len(vcols) > 1:
        raise SQLSyntaxError("JOIN aggregates support one fact value "
                             "column per query")
    fact_value = vcols[0] if vcols else fact_key
    aggs = tuple(dict.fromkeys(it.agg for it in agg_items))

    conjs = []
    for c, op, v in q.where:
        s, col = side(c)
        if s != "fact":
            raise SQLSyntaxError("WHERE predicates must target fact "
                                 "columns in a JOIN query")
        conjs.append((col, op, v))
    # star_join_groupby has no range-pruning path; all predicates apply
    # exactly in the device mask
    where_fn = None
    where_cols = tuple(dict.fromkeys(c for c, _, _ in conjs))
    if conjs:
        def where_fn(cols):
            m = None
            for col, op, v in conjs:
                c = cols[col]
                part = {"<": c < v, "<=": c <= v, ">": c > v,
                        ">=": c >= v, "=": c == v}[op]
                m = part if m is None else (m & part)
            return m

    ng = num_groups or _derive_num_groups(dim_sc, dim_attr)
    if ng is None:
        raise ValueError(f"GROUP BY {q.group_by}: dimension statistics "
                         "absent; pass num_groups=")
    res = star_join_groupby(fact_sc, fact_key, fact_value, dim_sc,
                            dim_key, dim_attr, ng, aggs=aggs,
                            method=method, device=device,
                            where=where_fn, where_columns=where_cols)
    out = {q.group_by: np.arange(ng, dtype=np.int64)}
    for it in agg_items:
        out[it.name] = _host(res[it.agg])
    out = _apply_having(q, out, q.group_by)

    if q.order_by is not None:
        from nvme_strom_tpu_torch.sql.groupby import top_k_groups
        if q.limit is None:
            raise SQLSyntaxError("ORDER BY without LIMIT is unbounded; "
                                 "add LIMIT")
        by, desc = q.order_by
        by = _order_key(q, by)
        k_eff = min(q.limit, len(out[q.group_by]))
        if k_eff == 0:
            return {k: np.asarray(v) for k, v in out.items()}
        ranked = top_k_groups({k: _as_device(v, device)
                               for k, v in out.items()},
                              by, k_eff, descending=desc)
        return {k: _host(v) for k, v in ranked.items()
                if k != "group"}
    if q.limit is not None:
        out = {k: v[:q.limit] for k, v in out.items()}
    return {k: np.asarray(v) for k, v in out.items()}
