"""Pushdown-planned, partition-parallel Direct SQL scans (counterpart of
nvme_strom_tpu/sql/scan_plan.py).

Three moves on top of the pq_direct page walk:

1. **Pushdown planning** (:func:`plan_scan`): WHERE range predicates are
   held against the row groups' zone maps (column min / max statistics)
   and the projection before any NVMe command is issued; a provably
   excluded row group's chunks are never read, and the skipped bytes are
   counted (``sql_rowgroups_skipped`` / ``sql_bytes_skipped``).  Absent
   statistics, or NaN min / max, keep the group: pruning is always a
   superset of the exact answer, like ``ParquetScanner.prune_row_groups``.

2. **Partition-parallel execution** (:func:`iter_scan_columns`): the
   surviving row groups are windowed by the serial scan's rule
   (``pq_direct._split_windows``) and fanned across a thread pool
   (``STROM_SQL_WORKERS``; 0 = ``max(1, min(4, cpu_count // 2))``).
   Each worker owns a ``DeviceStream`` at the ``scan`` QoS class and runs
   under a copy of the caller's ``contextvars`` (its tenant).  Windows
   are yielded in index order through a bounded hand-off, so the merged
   stream is bit-identical to the serial scan.

3. **Late materialization** (the ``where_ranges`` path): the filter
   columns decode first, the predicate mask is computed on the device and
   read back (one bool a row: control data), and payload columns then
   fetch only the pages whose rows contain a survivor; skipped pages are
   zero-filled on the device (``sql_pages_skipped``).  The fold's spill
   group keeps masked rows out of every aggregate, so results are
   bit-identical to the full fetch.  Private to the fold consumers.

``STROM_SQL_PUSHDOWN=0`` turns planning and late materialization off;
with ``STROM_SQL_WORKERS=1`` as well, the scan is the plain serial
stack.
"""

from __future__ import annotations

import contextvars
import os
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch


__all__ = ["ScanPlan", "plan_scan", "pushdown_enabled", "sql_workers",
           "iter_scan_columns"]

#: max assembled-but-unyielded windows beyond the pool width: bounds
#: device residency of the ordered merge while letting fast workers run
#: ahead of the consumer by a little
_PACING_SLACK = 2


def pushdown_enabled() -> bool:
    """STROM_SQL_PUSHDOWN (default on): zone-map row-group skipping +
    late materialization.  0 restores statistics pruning to the exact
    pre-pushdown ``prune_row_groups`` path."""
    return os.environ.get("STROM_SQL_PUSHDOWN", "1") != "0"


def sql_workers() -> int:
    """Partition-parallel scan width.  STROM_SQL_WORKERS: explicit
    N >= 1 pins the pool; 0 (default) takes a CPU-derived width,
    ``max(1, min(4, cpu_count // 2))``.  1 = the serial scan."""
    v = int(os.environ.get("STROM_SQL_WORKERS", "0") or "0")
    if v < 0:
        raise ValueError(f"STROM_SQL_WORKERS ({v}) must be >= 0")
    if v:
        return v
    return max(1, min(4, (os.cpu_count() or 2) // 2))


@dataclass(frozen=True)
class ScanPlan:
    """A pushdown-planned scan: which row groups survive the zone maps,
    and what the skips saved (projection-aware — ``bytes_skipped``
    counts only the SELECTED columns' compressed chunk bytes, the bytes
    the scan would otherwise have read)."""
    row_groups: Tuple[int, ...]        # surviving, ascending
    skipped: Tuple[int, ...]           # provably excluded, ascending
    bytes_skipped: int                 # selected columns, skipped groups
    bytes_selected: int                # selected columns, kept groups

    @property
    def selectivity(self) -> float:
        total = len(self.row_groups) + len(self.skipped)
        return len(self.row_groups) / total if total else 1.0


def plan_scan(scanner, columns: Sequence[str],
              where_ranges: Sequence[tuple]) -> ScanPlan:
    """Evaluate ``where_ranges`` (column, lo, hi) against the row-group
    zone maps and the projection ``columns`` — before any NVMe command.

    Exclusion requires PROOF: statistics must exist and ``[min, max]``
    must be disjoint from ``[lo, hi]``.  Absent statistics keep the
    group; so do NaN min/max (any comparison with NaN is False), which
    float columns containing NaNs produce — a NaN row would otherwise
    be wrongly skipped.  Survivor selection is intentionally identical
    to ``ParquetScanner.prune_row_groups``; this planner adds the
    projection-aware byte accounting and the ``sql_*`` counters."""
    where_ranges = list(where_ranges)
    md = scanner.metadata
    name_to_ci = {md.schema.column(i).name: i
                  for i in range(md.num_columns)}
    for col, _, _ in where_ranges:
        if col not in name_to_ci:
            raise KeyError(f"column {col!r} not in schema")
    proj_ci = [name_to_ci[c] for c in columns]
    keep: List[int] = []
    skipped: List[int] = []
    b_skip = b_keep = 0
    for rg in range(md.num_row_groups):
        g = md.row_group(rg)
        alive = True
        for col, lo, hi in where_ranges:
            st = g.column(name_to_ci[col]).statistics
            if st is None or st.min is None or st.max is None:
                continue          # no stats → cannot exclude
            if ((lo is not None and st.max < lo)
                    or (hi is not None and st.min > hi)):
                alive = False
                break
        nbytes = sum(g.column(ci).total_compressed_size
                     for ci in proj_ci)
        if alive:
            keep.append(rg)
            b_keep += nbytes
        else:
            skipped.append(rg)
            b_skip += nbytes
    stats = getattr(scanner.engine, "stats", None)
    if stats is not None:
        stats.add(sql_scans=1, sql_rowgroups_scanned=len(keep),
                  sql_rowgroups_skipped=len(skipped),
                  sql_bytes_skipped=b_skip)
    return ScanPlan(tuple(keep), tuple(skipped), b_skip, b_keep)


def _check_and_narrow(cols: dict, narrow_int32: Sequence[str]) -> dict:
    """The iter_device_columns key contract, replicated for the scan
    paths that bypass it: narrowed names must be integer (a float key
    would truncate into a silently wrong query) and are delivered
    int32."""
    from nvme_strom_tpu_torch.sql.groupby import _is_int
    for c in narrow_int32:
        if not _is_int(cols[c]):
            raise TypeError(f"key column {c} must be integer")
        cols[c] = cols[c].to(torch.int32)
    return cols


def _cached_plans(scanner, columns: Sequence[str]):
    """Plan-once, scan-many: the direct page walk (one thrift parse +
    pread per page header) is a pure function of the scanner's footer
    snapshot and the column list, so repeated queries over the same
    scanner reuse it instead of re-walking every data page.  The cache
    lives on the scanner instance and dies with it — a new scanner
    (new footer snapshot) always re-plans."""
    from nvme_strom_tpu_torch.sql import pq_direct
    cache = getattr(scanner, "_scan_plan_cache", None)
    if cache is None:
        cache = {}
        try:
            scanner._scan_plan_cache = cache
        except AttributeError:       # slotted/frozen scanner: no cache
            return pq_direct.try_plan(scanner, columns,
                                      allow_nulls=False)
    key = tuple(columns)
    if key not in cache:
        cache[key] = pq_direct.try_plan(scanner, columns,
                                        allow_nulls=False)
    return cache[key]


def iter_scan_columns(scanner, columns: Sequence[str], dev,
                      narrow_int32: Sequence[str] = (),
                      row_groups=None,
                      where_ranges: Sequence[tuple] = (),
                      window_bytes: Optional[int] = None):
    """Stream ``columns`` as {name: device array} dicts for the FOLD
    consumers (sql_groupby / sql_scalar_agg / multi-file unions) —
    the partition-parallel, late-materializing front of the scan.

    Route selection, most capable first:

    - **late materialization** when pushdown is on, range predicates
      exist, and every selected chunk is raw-PLAIN: filter columns
      decode first, payload pages with no surviving rows are never
      fetched (zero-filled; only valid under the fold's spill-group
      masking — positional consumers must not use this iterator).
      Runs partition-parallel when the pool width allows.
    - **partition-parallel scan** when the pool width is > 1 and the
      chunks are raw-PLAIN: windows fan across workers, each submitting
      at the ``scan`` QoS class under the caller's tenant context;
      yields are merged in window order, bit-identical to serial.
    - **serial scan** otherwise — the exact
      ``groupby.iter_device_columns`` path (with STROM_SQL_WORKERS=1
      and STROM_SQL_PUSHDOWN=0 this is bit-for-bit the pre-pushdown
      stack).
    """
    from nvme_strom_tpu_torch.sql import pq_direct
    from nvme_strom_tpu_torch.sql.groupby import iter_device_columns

    plans = _cached_plans(scanner, columns)
    groups = list(range(scanner.metadata.num_row_groups)
                  if row_groups is None else row_groups)
    plain = plans is not None and all(
        plans[c] and pq_direct._plain_only([plans[c][rg]])
        for rg in groups for c in columns)
    workers = sql_workers()
    range_cols = [c for c, _, _ in dict.fromkeys(
        (c, lo, hi) for c, lo, hi in where_ranges)]
    range_cols = list(dict.fromkeys(range_cols))
    payload_cols = [c for c in columns if c not in range_cols]
    late = (pushdown_enabled() and plain and groups and where_ranges
            and payload_cols and all(c in columns for c in range_cols))
    if late:
        yield from _iter_late(scanner, columns, plans, groups, dev,
                              range_cols, payload_cols,
                              list(where_ranges), window_bytes,
                              tuple(narrow_int32), workers)
        return
    if plain and workers > 1 and len(groups) > 1:
        windows = pq_direct._split_windows(columns, plans, groups,
                                           window_bytes)
        if len(windows) > 1:
            for cols in _iter_windows_parallel(
                    scanner, columns, plans, windows, dev,
                    _pool_workers(scanner.engine, workers,
                                  len(windows))):
                yield _check_and_narrow(cols, narrow_int32)
            return
    yield from iter_device_columns(scanner, columns, dev,
                                   narrow_int32=narrow_int32,
                                   row_groups=row_groups,
                                   plans=plans,
                                   window_bytes=window_bytes)


def _pool_workers(engine, workers: int, n_windows: int) -> int:
    """Pool width, capped so the scan can never exhaust the engine's
    staging buffers.  A worker parked on the pacing gate holds up to
    ``3 × depth`` staging buffers (ops/bridge.py ``stream_ranges``: reads
    submitted plus copies in flight), released only when it is next
    pulled; if parked workers could hold the whole pool, the owner of
    the next window to yield would wait for staging that never frees.
    So the width times the least holding (3 buffers at depth 1) must
    leave two spare."""
    return max(1, min(workers, n_windows, (engine.n_buffers - 2) // 3))


def _worker_stream(scanner, dev, workers: int = 1):
    """One worker's DeviceStream at the scan class: the stream's default
    depth, divided across the pool so the workers' worst-case holdings
    (3 × depth each, see :func:`_pool_workers`) leave spare buffers."""
    from nvme_strom_tpu_torch.ops.bridge import DeviceStream
    from nvme_strom_tpu_torch.sql.pq_direct import SCAN_CLASS
    ds = DeviceStream(scanner.engine, device=dev, klass=SCAN_CLASS)
    if workers > 1:
        ds = DeviceStream(scanner.engine, device=dev, klass=SCAN_CLASS,
                          depth=max(1, min(ds.depth, (
                              scanner.engine.n_buffers - 2)
                              // (3 * workers))))
    return ds


def _iter_windows_parallel(scanner, columns, plans, windows, dev,
                           workers: int):
    """Fan ``windows`` across ``workers`` threads; yield each window's
    assembled {column: device array} dict IN WINDOW ORDER.

    Worker k owns windows k, k+W, ... and streams ALL of its windows'
    ranges as one pipelined ``stream_ranges`` sequence on its own
    DeviceStream — within a worker the engine queue never drains at a
    window boundary, and across workers the engine's submission path is
    designed for concurrent submitters (the QoS scheduler's grant round
    adds ordering, never serialization).  Pacing: a worker may not
    ASSEMBLE window ``wi`` until ``wi < yielded + workers +
    _PACING_SLACK`` — since the consumer yields in window order, the
    window it waits on is always allowed to assemble, so the bound can
    never deadlock; it just caps device residency.

    Each worker runs under a copy of the caller's contextvars context,
    so ``tenant_context`` and trace identity reach
    the per-batch capture in the scheduler exactly as on the serial
    path."""
    from nvme_strom_tpu_torch.sql import pq_direct

    cond = threading.Condition(threading.Lock())
    state = {"yielded": 0, "stop": False}
    results: Dict[int, tuple] = {}     # wi -> ("ok", cols) | ("err", e)
    bound = workers + _PACING_SLACK
    fh = scanner.engine.open(scanner.path)

    def run_worker(k: int):
        wi = k          # first owned window: where an early error lands
        it = None
        try:
            ds = _worker_stream(scanner, dev, workers)
            my = list(range(k, len(windows), workers))
            flat, counts = [], []
            for wi in my:
                f, cn = pq_direct._plan_window_ranges(
                    scanner, columns, plans, windows[wi])
                flat.extend(f)
                counts.extend(cn)
            it = ds.stream_ranges(fh, flat)
            ci = iter(counts)
            for wi in my:
                with cond:
                    while (not state["stop"]
                           and wi >= state["yielded"] + bound):
                        cond.wait(timeout=1.0)
                    if state["stop"]:
                        return
                out = pq_direct._assemble_window(columns, plans,
                                                 windows[wi], ci, it)
                with cond:
                    results[wi] = ("ok", out)
                    cond.notify_all()
        except BaseException as e:        # noqa: BLE001 — relayed
            with cond:
                results.setdefault(wi, ("err", e))
                cond.notify_all()
        finally:
            if it is not None:
                it.close()

    threads = []
    try:
        for k in range(workers):
            ctx = contextvars.copy_context()
            t = threading.Thread(target=ctx.run, args=(run_worker, k),
                                 name=f"strom-sql-scan-{k}",
                                 daemon=True)
            t.start()
            threads.append(t)
        stats = getattr(scanner.engine, "stats", None)
        if stats is not None:
            stats.add(sql_parallel_scans=1)
        for wi in range(len(windows)):
            with cond:
                while wi not in results:
                    cond.wait(timeout=1.0)
                    if wi not in results and not any(
                            t.is_alive() for t in threads):
                        raise RuntimeError(
                            "scan worker pool died without a result "
                            f"for window {wi}")
                kind, val = results.pop(wi)
            if kind == "err":
                raise val
            yield val
            with cond:
                state["yielded"] += 1
                cond.notify_all()
    finally:
        with cond:
            state["stop"] = True
            cond.notify_all()
        for t in threads:
            t.join()
        scanner.engine.close(fh)


def _page_rows(plan) -> List[Tuple[int, int]]:
    """Per page: (row_start, n_rows) in chunk row order."""
    out, pos = [], 0
    for p in plan.parts:
        out.append((pos, p.num_values))
        pos += p.num_values
    return out


def _iter_late(scanner, columns, plans, groups, dev, range_cols,
               payload_cols, where_ranges, window_bytes, narrow_int32,
               workers: int):
    """Late materialization, optionally partition-parallel.

    Per window: (A) the filter columns stream and assemble exactly as
    a normal scan of ``range_cols``; (B) the range-predicate mask is
    computed on device and read back (one bool per row — control data,
    never payload bounce); (C) each payload column fetches only the
    pages overlapping a surviving row, in exact per-page spans
    (no header coalescing — the skip decision is per page), and skipped
    pages zero-fill ON DEVICE.  Zero-filled rows are always masked
    rows, and the fold's spill-group masking keeps masked values out of
    every aggregate — so final results are bit-identical to the full
    fetch.  The WHERE lambda (if any) plays no part in the skip
    decision: the final mask is ``range_mask & where``, a subset of the
    range mask, so a page with no range-surviving rows is dead under
    any ``where``."""
    from nvme_strom_tpu_torch.sql import pq_direct

    windows = pq_direct._split_windows(columns, plans, groups,
                                       window_bytes)
    rows_of = {rg: plans[columns[0]][rg].num_values for rg in groups}

    def assemble_late(w, ds, fh):
        from nvme_strom_tpu_torch.ops.bridge import split_ranges
        chunk_bytes = scanner.engine.config.chunk_bytes
        # (A) filter columns: the normal window scan, filter cols only
        flat, counts = pq_direct._plan_window_ranges(scanner,
                                                     range_cols, plans,
                                                     w)
        it = ds.stream_ranges(fh, flat)
        try:
            fcols = pq_direct._assemble_window(range_cols, plans, w,
                                               iter(counts), it)
        finally:
            it.close()
        # (B) the range mask, on device, then the tiny readback
        m = None
        for c, lo, hi in where_ranges:
            x = fcols[c]
            mm = torch.ones(x.shape, dtype=torch.bool, device=x.device)
            if lo is not None:
                mm = mm & (x >= lo)
            if hi is not None:
                mm = mm & (x <= hi)
            m = mm if m is None else m & mm
        mask = m.cpu().numpy()
        # (C) payload pages: fetch survivors, zero-fill the rest.
        # Consecutive kept pages collapse into one coalesced read (the
        # page headers degap on device, exactly as the full-window
        # scan does) and consecutive dead pages into one zero piece —
        # a contiguous predicate band costs O(1) reads and O(1)
        # device ops per column chunk, not O(pages).
        fetch = []          # every sub-range, submission order
        layout = []         # (c, [("zero", nbytes) | ("fetch", n, spec)])
        pages_skipped = bytes_skipped = 0
        base = 0
        for rg in w:
            n_rows = rows_of[rg]
            rg_mask = mask[base:base + n_rows]
            for c in payload_cols:
                plan = plans[c][rg]
                width = pq_direct._WIDTHS[plan.physical_type]
                pieces: list = []
                run: list = []      # spans of consecutive kept pages

                def flush_run(pieces=pieces, run=run):
                    if not run:
                        return
                    merged = (pq_direct._coalesce_spans(run)
                              if 1 < len(run) <=
                              pq_direct._COALESCE_MAX_SLICES else None)
                    if merged is not None:
                        ranges, _ = split_ranges([merged], chunk_bytes)
                        spec = tuple((off - merged[0], ln)
                                     for off, ln in run if ln)
                    else:
                        ranges, _ = split_ranges(list(run), chunk_bytes)
                        spec = None
                    fetch.extend(ranges)
                    pieces.append(("fetch", len(ranges), spec))
                    run.clear()

                for part, (r0, nr) in zip(plan.parts,
                                          _page_rows(plan)):
                    if rg_mask[r0:r0 + nr].any():
                        run.append(part.span)
                    else:
                        flush_run()
                        pages_skipped += 1
                        bytes_skipped += part.span[1]
                        if pieces and pieces[-1][0] == "zero":
                            pieces[-1] = ("zero",
                                          pieces[-1][1] + nr * width)
                        else:
                            pieces.append(("zero", nr * width))
                flush_run()
                layout.append((c, pieces))
            base += n_rows
        stats = getattr(scanner.engine, "stats", None)
        if stats is not None and pages_skipped:
            stats.add(sql_pages_skipped=pages_skipped,
                      sql_bytes_skipped=bytes_skipped)
        it = ds.stream_ranges(fh, fetch)
        try:
            bufs: Dict[str, list] = {c: [] for c in payload_cols}
            for c, pieces in layout:     # one buffer per (rg, column)
                bufs[c].append(_assemble_column(pieces, it, ds.device))
        finally:
            it.close()
        out = dict(fcols)
        for c in payload_cols:
            pt = plans[c][w[0]].physical_type
            ps = [p for p in bufs[c] if int(p.shape[0])]
            if not ps:
                out[c] = pq_direct._empty(pt, ds.device)
                continue
            out[c] = pq_direct._cat(ps).view(pq_direct._TORCH_DTYPES[pt])
        return {c: out[c] for c in columns}

    def _assemble_column(pieces, it, dev):
        """One column-window's output buffer from its piece list.
        A contiguous predicate band leaves at most one fetched run
        between two zero runs — that common shape builds with a
        single ``F.pad`` (one memset+copy pass) instead of
        materializing zero arrays and concatenating (which writes
        the output bytes twice)."""
        parts = []       # ("z", nbytes) | ("b", device buffer)
        for piece in pieces:
            if piece[0] == "zero":
                parts.append(("z", piece[1]))
                continue
            _, n, spec = piece
            got = [next(it) for _ in range(n)]
            buf = pq_direct._cat(got)
            if spec is not None:
                buf = pq_direct._degap(spec, buf)
            parts.append(("b", buf))
        if not parts:
            return torch.zeros((0,), dtype=torch.uint8, device=dev)
        kinds = "".join(k for k, _ in parts)
        if kinds in ("b", "zb", "bz", "zbz"):
            lead = parts[0][1] if kinds[0] == "z" else 0
            tail = parts[-1][1] if kinds[-1] == "z" else 0
            buf = next(p for k, p in parts if k == "b")
            if lead or tail:
                buf = torch.nn.functional.pad(buf, (lead, tail))
            return buf
        return torch.cat(
            [p if k == "b" else torch.zeros((p,), dtype=torch.uint8,
                                            device=dev)
             for k, p in parts])

    workers = _pool_workers(scanner.engine, workers, len(windows))
    if workers > 1 and len(windows) > 1:
        yield from _iter_late_parallel(scanner, windows, dev, workers,
                                       assemble_late, narrow_int32)
        return
    fh = scanner.engine.open(scanner.path)
    try:
        ds = _worker_stream(scanner, dev)
        for w in windows:
            yield _check_and_narrow(assemble_late(w, ds, fh),
                                    list(narrow_int32))
    finally:
        scanner.engine.close(fh)


def _iter_late_parallel(scanner, windows, dev, workers, assemble_late,
                        narrow_int32):
    """The parallel harness of :func:`_iter_late`: same ordered-merge /
    pacing discipline as :func:`_iter_windows_parallel`, but each
    window assembles through ``assemble_late`` (two stream_ranges
    passes per window — the mask readback is a genuine barrier between
    filter and payload, so the cross-window pipelining comes from the
    pool, not from one long range sequence)."""
    cond = threading.Condition(threading.Lock())
    state = {"yielded": 0, "stop": False}
    results: Dict[int, tuple] = {}
    bound = workers + _PACING_SLACK
    fh = scanner.engine.open(scanner.path)

    def run_worker(k: int):
        wi = k
        try:
            ds = _worker_stream(scanner, dev, workers)
            for wi in range(k, len(windows), workers):
                with cond:
                    while (not state["stop"]
                           and wi >= state["yielded"] + bound):
                        cond.wait(timeout=1.0)
                    if state["stop"]:
                        return
                out = assemble_late(windows[wi], ds, fh)
                with cond:
                    results[wi] = ("ok", out)
                    cond.notify_all()
        except BaseException as e:        # noqa: BLE001 — relayed
            with cond:
                results.setdefault(wi, ("err", e))
                cond.notify_all()

    threads = []
    try:
        for k in range(workers):
            ctx = contextvars.copy_context()
            t = threading.Thread(target=ctx.run, args=(run_worker, k),
                                 name=f"strom-sql-late-{k}",
                                 daemon=True)
            t.start()
            threads.append(t)
        stats = getattr(scanner.engine, "stats", None)
        if stats is not None:
            stats.add(sql_parallel_scans=1)
        for wi in range(len(windows)):
            with cond:
                while wi not in results:
                    cond.wait(timeout=1.0)
                    if wi not in results and not any(
                            t.is_alive() for t in threads):
                        raise RuntimeError(
                            "scan worker pool died without a result "
                            f"for window {wi}")
                kind, val = results.pop(wi)
            if kind == "err":
                raise val
            yield _check_and_narrow(val, list(narrow_int32))
            with cond:
                state["yielded"] += 1
                cond.notify_all()
    finally:
        with cond:
            state["stop"] = True
            cond.notify_all()
        for t in threads:
            t.join()
        scanner.engine.close(fh)
