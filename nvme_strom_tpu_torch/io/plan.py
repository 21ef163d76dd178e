"""Extent-coalescing read planner (counterpart of
nvme_strom_tpu/io/plan.py).

* coalesce — extents on the same file that are adjacent, overlapping or
  at most one 4 KiB block apart merge into one
  read; each extent gets a zero-copy sub-view of the merged span;
* split — an extent larger than ``chunk_bytes`` breaks into pieces;
* batch — the spans enter the engine as one ``submit_readv``.

The pinned host-cache tier and the QoS classes of the JAX planner are
not part of this port yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

#: one O_DIRECT logical block: reading it through beats a second read
COALESCE_GAP = 4096


def split_spans(spans, chunk: int):
    """(offset, length) spans → (flat sub-ranges ≤ ``chunk``, per-span
    sub-range counts); zero-length spans keep a 0 count entry."""
    flat, counts = [], []
    for off, ln in spans:
        before = len(flat)
        while ln > 0:
            take = min(chunk, ln)
            flat.append((off, take))
            off += take
            ln -= take
        counts.append(len(flat) - before)
    return flat, counts


@dataclass(frozen=True)
class ExtentPlan:
    """``spans``: (fh, offset, length) engine reads in submission order.
    ``placements``: per input extent, its ordered (span_index, lo, hi)
    pieces relative to that span's view.  ``spans_coalesced``: extents
    that merged into a span opened by an earlier one."""

    spans: List[Tuple[int, int, int]]
    placements: List[List[Tuple[int, int, int]]]
    spans_coalesced: int


def plan_extents(extents: Sequence[Tuple[int, int, int]], *,
                 chunk_bytes: int) -> ExtentPlan:
    """Sort + coalesce + split ``(fh, offset, length)`` extents with the
    JAX planner's rule (its default gap, no record unit)."""
    if chunk_bytes <= 0:
        raise ValueError(f"chunk_bytes must be >= 1, got {chunk_bytes}")
    split, gap = chunk_bytes, COALESCE_GAP
    n = len(extents)
    for i in range(n):
        if extents[i][2] < 0:
            raise ValueError(f"extent {i}: negative length {extents[i][2]}")
    placements: List[List[Tuple[int, int, int]]] = [[] for _ in range(n)]
    spans: List[Tuple[int, int, int]] = []
    coalesced = 0
    order = sorted((i for i in range(n) if extents[i][2] > 0),
                   key=lambda i: (extents[i][0], extents[i][1],
                                  extents[i][2]))

    def emit(group: list) -> None:
        nonlocal coalesced
        fh = extents[group[0]][0]
        start = extents[group[0]][1]
        length = max(extents[i][1] + extents[i][2] for i in group) - start
        if length <= split:
            si = len(spans)
            spans.append((fh, start, length))
            for i in group:
                off, ln = extents[i][1], extents[i][2]
                placements[i].append((si, off - start, off - start + ln))
            coalesced += len(group) - 1
            return
        # a lone oversized extent: chunk-sized pieces
        (i,) = group
        pos = 0
        while pos < length:
            take = min(split, length - pos)
            placements[i].append((len(spans), 0, take))
            spans.append((fh, start + pos, take))
            pos += take

    group: list = []
    g_fh = g_start = g_end = 0
    for i in order:
        fh, off, ln = extents[i]
        if group and fh == g_fh and off <= g_end + gap \
                and max(g_end, off + ln) - g_start <= split:
            group.append(i)
            g_end = max(g_end, off + ln)
            continue
        if group:
            emit(group)
        group = [i]
        g_fh, g_start, g_end = fh, off, off + ln
    if group:
        emit(group)
    return ExtentPlan(spans=spans, placements=placements,
                      spans_coalesced=coalesced)


class _SharedSpan:
    """One submitted span read; its request releases with the LAST of
    the views cut from it."""

    __slots__ = ("pending", "_refs")

    def __init__(self, pending, refs: int):
        self.pending = pending
        self._refs = refs

    def release_one(self) -> None:
        self._refs -= 1
        if self._refs <= 0:
            self.pending.release()


class SpanView:
    """PendingRead-shaped zero-copy piece ``[lo, hi)`` of a span read."""

    __slots__ = ("_span", "_lo", "_hi", "fh", "offset", "_released")

    def __init__(self, span: _SharedSpan, lo: int, hi: int, fh: int,
                 offset: int):
        self._span = span
        self._lo = lo
        self._hi = hi
        self.fh = fh
        self.offset = offset
        self._released = False

    @property
    def length(self) -> int:
        return self._hi - self._lo

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        view = self._span.pending.wait(timeout)
        return view[min(self._lo, view.nbytes):min(self._hi, view.nbytes)]

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._span.release_one()


class JoinedPieces:
    """Pending-shaped join of one extent's several pieces: ``wait()``
    assembles them into one host buffer (a host copy, counted as
    ``bounce_bytes``); ``release()`` releases every piece."""

    __slots__ = ("_pieces", "_stats", "_buf", "fh", "offset", "length")

    def __init__(self, pieces, stats=None):
        self._pieces = list(pieces)
        self._stats = stats
        self._buf: Optional[np.ndarray] = None
        self.fh = self._pieces[0].fh
        self.offset = self._pieces[0].offset
        self.length = sum(p.length for p in self._pieces)

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        if self._buf is None:
            self._buf = np.concatenate(
                [p.wait(timeout).reshape(-1).view(np.uint8)
                 for p in self._pieces])
            if self._stats is not None:
                self._stats.add(bounce_bytes=self._buf.nbytes)
        return self._buf

    def release(self) -> None:
        for p in self._pieces:
            p.release()


def join_pieces(pieces, stats=None):
    """The single piece itself (zero-copy), or a :class:`JoinedPieces`."""
    if len(pieces) == 1:
        return pieces[0]
    return JoinedPieces(pieces, stats)


def plan_and_submit(engine, extents: Sequence[Tuple[int, int, int]]
                    ) -> List[List[SpanView]]:
    """Plan ``(fh, offset, length)`` extents in pieces of at most one
    staging buffer, submit the spans as ONE batch, and return each
    extent's ordered :class:`SpanView` pieces (empty for a zero-length
    extent)."""
    plan = plan_extents(extents, chunk_bytes=engine.config.chunk_bytes)
    pendings = engine.submit_readv(plan.spans)
    refs = [0] * len(pendings)
    for pieces in plan.placements:
        for si, _, _ in pieces:
            refs[si] += 1
    shared = [_SharedSpan(p, max(1, r)) for p, r in zip(pendings, refs)]
    out = []
    for (fh, off, _ln), pieces in zip(extents, plan.placements):
        views, pos = [], 0
        for si, lo, hi in pieces:
            views.append(SpanView(shared[si], lo, hi, fh, off + pos))
            pos += hi - lo
        out.append(views)
    return out
