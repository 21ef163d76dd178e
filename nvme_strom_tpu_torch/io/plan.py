"""Extent-coalescing read planner (counterpart of
nvme_strom_tpu/io/plan.py).

* coalesce — extents on the same file that are adjacent, overlapping or
  at most ``gap`` bytes apart (one 4 KiB block by default) merge into
  one read; each extent gets a zero-copy sub-view of the merged span;
* split — an extent larger than ``chunk_bytes`` (the engine's by
  default) breaks into pieces, on multiples of ``split_unit`` from the
  extent's start;
* batch — the spans enter the engine as one ``submit_readv``, tagged
  with the batch's latency class (``klass``) for the QoS scheduler of a
  multi-ring engine (io/sched.py).

With the host-DRAM tier on (``STROM_HOSTCACHE_MB``, io/hostcache.py),
``plan_and_submit`` first splits each extent into hit spans, served as
zero-copy views of resident lines without the engine, and miss spans,
which are planned and submitted as above and fill admitted lines when
their reads complete.  ``submit_spans_tiered`` does the same for whole
spans (``DeviceStream.stream_ranges``).  ``hot=True`` admits a batch's
missed lines on first touch and pins them under the class's residency
quota.  With the tier off and one ring the planner submits exactly what
it submitted before either existed.

While the engine's supervisor (io/health.py) has the device degraded,
``submit_spans`` serves every batch as buffered preads past the engine
and its wrappers, and each submit is a time-gated supervision tick.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import inspect

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
                 chunk_bytes: int, gap: Optional[int] = None,
                 split_unit: int = 1) -> ExtentPlan:
    """Sort + coalesce + split ``(fh, offset, length)`` extents with the
    JAX planner's rule.  ``gap``: the most dead bytes read through to
    merge (None: one 4 KiB block).  ``split_unit``: a split extent's
    pieces are multiples of it from the extent's start."""
    if chunk_bytes <= 0:
        raise ValueError(f"chunk_bytes must be >= 1, got {chunk_bytes}")
    if split_unit <= 0:
        raise ValueError(f"split_unit must be >= 1, got {split_unit}")
    gap = COALESCE_GAP if gap is None else max(0, gap)
    split = (chunk_bytes // split_unit) * split_unit
    if split <= 0:
        raise ValueError(f"split_unit ({split_unit}) exceeds chunk_bytes "
                         f"({chunk_bytes})")
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

    def is_ready(self) -> bool:
        return self._span.pending.is_ready()

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


_READV_KLASS: dict = {}


def _readv_accepts_klass(engine) -> bool:
    """Whether the engine's ``submit_readv`` takes ``klass`` (an engine
    wrapper that predates it gets the batch untagged), cached per
    type."""
    t = type(engine)
    ok = _READV_KLASS.get(t)
    if ok is None:
        try:
            params = inspect.signature(engine.submit_readv).parameters
            ok = "klass" in params or any(
                p.kind is inspect.Parameter.VAR_KEYWORD
                for p in params.values())
        except (TypeError, ValueError):
            ok = False
        _READV_KLASS[t] = ok
    return ok


def submit_spans(engine, spans: Sequence[Tuple[int, int, int]],
                 klass: Optional[str] = None) -> list:
    """Submit planned spans as one vectored batch tagged ``klass``;
    returns the pending reads aligned with ``spans``.  None rides the
    scheduler's default class.

    While the engine's supervisor (io/health.py) has the device
    degraded, the spans are served as synchronous buffered preads
    (``DegradedRead``) past the engine, the scheduler and any wrapper,
    as host-tier hits are; one probe every ``probe_s`` rides the real path,
    and its success sends this very batch down it."""
    sup = getattr(engine, "supervisor", None)
    if sup is not None:
        sup.tick()
        if sup.degraded():
            out = sup.serve_degraded(engine, list(spans))
            if out is not None:
                return out      # still degraded (None: the probe healed)
    if klass is not None and _readv_accepts_klass(engine):
        return engine.submit_readv(spans, klass=klass)
    return engine.submit_readv(spans)


def _share_spans(pendings, placements) -> list:
    """Refcount each submitted span by the pieces cut from it: its
    request is released with the last of them."""
    refs = [0] * len(pendings)
    for pieces in placements:
        for si, _, _ in pieces:
            refs[si] += 1
    return [_SharedSpan(p, max(1, r)) for p, r in zip(pendings, refs)]


def _views_for(shared, pieces, fh: int, start_off: int) -> list:
    """One placement's ordered pieces as SpanViews."""
    views, pos = [], 0
    for si, lo, hi in pieces:
        views.append(SpanView(shared[si], lo, hi, fh, start_off + pos))
        pos += hi - lo
    return views


def plan_and_submit(engine, extents: Sequence[Tuple[int, int, int]], *,
                    gap: Optional[int] = None, split_unit: int = 1,
                    chunk_bytes: Optional[int] = None,
                    klass: Optional[str] = None, hot: bool = False
                    ) -> List[list]:
    """Plan ``(fh, offset, length)`` extents in pieces of at most
    ``chunk_bytes`` (the engine's staging buffer by default), submit the
    spans as ONE batch of class ``klass``, and return each extent's
    ordered pieces (empty for a zero-length extent).

    With the host tier on, each extent is split into hit pieces
    (:class:`CacheHitRead` over resident lines) and miss pieces; a
    record-unit plan (``split_unit > 1``) bypasses the tier, whose line
    boundaries cannot keep pieces on records.  ``hot`` admits missed
    lines on first touch and pins them under the class's quota."""
    if chunk_bytes is None:
        chunk_bytes = engine.config.chunk_bytes
    if split_unit == 1:
        from nvme_strom_tpu_torch.io import hostcache
        cache = hostcache.get_cache(engine)
        if cache is not None:
            return _plan_and_submit_tiered(cache, engine, extents, gap=gap,
                                           chunk_bytes=chunk_bytes,
                                           klass=klass, hot=hot)
    plan = plan_extents(extents, chunk_bytes=chunk_bytes, gap=gap,
                        split_unit=split_unit)
    shared = _share_spans(submit_spans(engine, plan.spans, klass=klass),
                          plan.placements)
    return [_views_for(shared, pieces, fh, off)
            for (fh, off, _ln), pieces in zip(extents, plan.placements)]


def _fill_keys_for_span(cache, fkey, admitted: dict, s_off: int,
                        s_ln: int) -> dict:
    """The admitted line keys (→ admission epoch) whose line starts this
    span covers from their beginning."""
    lb = cache.line_bytes
    start = s_off if s_off % lb == 0 else s_off - s_off % lb + lb
    return {(fkey, lo): admitted[(fkey, lo)]
            for lo in range(start, s_off + s_ln, lb)
            if (fkey, lo) in admitted}


def _plan_and_submit_tiered(cache, engine, extents, *, gap, chunk_bytes,
                            klass, hot: bool = False) -> List[list]:
    """The tier's path of :func:`plan_and_submit`: probe each extent,
    serve hits as pinned line views, plan and submit only the misses,
    whose reads fill the admitted lines when waited."""
    from nvme_strom_tpu_torch.io.hostcache import (CacheHitRead,
                                                   _FillOnWait, file_key_of)
    stats = getattr(engine, "stats", None)
    for i, (_fh, _off, ln) in enumerate(extents):
        if ln < 0:   # before probing: probes pin lines
            raise ValueError(f"extent {i}: negative length {ln}")
    fkeys: dict = {}
    segs_all: List[list] = []
    miss_exts: List[Tuple[int, int, int]] = []
    admitted: dict = {}      # line key → admission-time epoch
    for fh, off, ln in extents:
        if ln == 0:
            segs_all.append([])
            continue
        if fh not in fkeys:
            fkeys[fh] = file_key_of(engine, fh)
        fkey = fkeys[fh]
        if fkey is None:
            segs = [("miss", off, ln)]
        else:
            segs, adm = cache.probe_range(fkey, off, ln, klass, stats,
                                          hot=hot)
            admitted.update(adm)
        segs_all.append(segs)
        miss_exts.extend((fh, sg[1], sg[2]) for sg in segs
                         if sg[0] == "miss")
    try:
        plan = plan_extents(miss_exts, chunk_bytes=chunk_bytes, gap=gap)
        pendings = submit_spans(engine, plan.spans, klass=klass)
    except BaseException:
        for segs in segs_all:          # pinned hits must not leak
            for sg in segs:
                if sg[0] == "hit":
                    cache.unpin(sg[3])
        raise
    wrapped = []
    for (fh, s_off, s_ln), p in zip(plan.spans, pendings):
        fkey = fkeys.get(fh)
        keys = (_fill_keys_for_span(cache, fkey, admitted, s_off, s_ln)
                if fkey is not None and admitted else {})
        wrapped.append(_FillOnWait(p, cache, fkey, s_off, keys, klass,
                                   stats, sticky=hot) if keys else p)
    shared = _share_spans(wrapped, plan.placements)
    out: List[list] = []
    mi = 0
    for (fh, _off, _ln), segs in zip(extents, segs_all):
        pieces: list = []
        for sg in segs:
            if sg[0] == "hit":
                _, a, sl, line = sg
                rel = a - line.key[1]
                pieces.append(CacheHitRead(cache, line, rel, rel + sl, fh,
                                           a))
            else:
                pieces.extend(_views_for(shared, plan.placements[mi], fh,
                                         sg[1]))
                mi += 1
        out.append(pieces)
    return out


def submit_spans_tiered(engine, spans: Sequence[Tuple[int, int, int]],
                        klass: Optional[str] = None) -> list:
    """:func:`submit_spans` with the host tier in front: a span inside
    one resident line's valid bytes comes back as a ready
    :class:`CacheHitRead`; the rest submit as one batch and fill their
    admitted lines when waited.  With the tier off it is
    :func:`submit_spans`."""
    from nvme_strom_tpu_torch.io import hostcache
    cache = hostcache.get_cache(engine)
    if cache is None:
        return submit_spans(engine, spans, klass=klass)
    from nvme_strom_tpu_torch.io.hostcache import (CacheHitRead,
                                                   _FillOnWait, file_key_of)
    stats = getattr(engine, "stats", None)
    spans = list(spans)
    out: list = [None] * len(spans)
    miss: list = []
    meta: list = []    # (out index, fkey, admitted keys)
    fkeys: dict = {}
    for i, (fh, off, ln) in enumerate(spans):
        if fh not in fkeys:
            fkeys[fh] = file_key_of(engine, fh)
        fkey = fkeys[fh]
        line, adm = None, {}
        if fkey is not None and ln > 0:
            line, adm = cache.probe_span(fkey, off, ln, klass, stats)
        if line is not None:
            rel = off - line.key[1]
            out[i] = CacheHitRead(cache, line, rel, rel + ln, fh, off)
        else:
            miss.append((fh, off, ln))
            meta.append((i, fkey, adm))
    try:
        pendings = submit_spans(engine, miss, klass=klass)
    except BaseException:
        for p in out:
            if p is not None:
                p.release()
        raise
    for (i, fkey, adm), p in zip(meta, pendings):
        _fh, off, ln = spans[i]
        keys = (_fill_keys_for_span(cache, fkey, adm, off, ln)
                if fkey is not None and adm else {})
        out[i] = (_FillOnWait(p, cache, fkey, off, keys, klass, stats)
                  if keys else p)
    return out
