"""Chrome-trace span recorder with request-scoped causal context
(counterpart of nvme_strom_tpu/utils/trace.py).

``Tracer`` records completed spans (``add_span``, or the ``span``
context manager) and counter samples (``add_counter``) and exports
them as a Chrome ``traceEvents`` JSON file that ``chrome://tracing``
and Perfetto load, beside a ``torch.profiler`` trace: both stamp
CLOCK_MONOTONIC.  The engine's read and write spans carry the C
engine's own submit and completion nanoseconds.

A :class:`TraceContext` (a trace id and a span id) made at a request's
boundary is current on its thread through a ``contextvars.ContextVar``
(``use_context``) and attached explicitly to work that completes on
another thread (``attach_context``).  Every span emitted under a
context carries ``args.trace`` / ``args.span`` / ``args.parent``, so
one load shows the request's tree; outside any context spans are flat.
``connected_tree`` checks that a trace's spans form one tree.

Activation: ``STROM_TRACE=/path/out.trace.json`` enables the process's
``global_tracer`` (every engine records into it by default), written
atomically by ``export()`` and at exit; or a ``Tracer(path)`` handed to
an engine.  Disabled, a call site costs one attribute test
(``tracer.enabled``).  Span sinks (``add_sink``) receive every span
without an export path: the attribution collector (obs/attrib.py,
``STROM_ATTRIB=1``) is one."""

from __future__ import annotations

import atexit
import contextlib
import contextvars
import itertools
import json
import os
import threading
import time
from typing import Optional

from nvme_strom_tpu_torch.utils.lockwitness import make_lock


#: Default in-memory span cap; override per-tracer or with
#: $STROM_TRACE_MAX_EVENTS.  When full, new spans are DROPPED and counted
#: (``Tracer.dropped`` → the ``trace_spans_dropped`` StromStats counter
#: and the exported file's metadata) — an unbounded event list on a
#: multi-hour run would otherwise grow to OOM.
DEFAULT_MAX_EVENTS = 1_000_000

#: process-wide id stream shared by trace and span ids: unique within a
#: process, which is the correlation domain (the export stamps pid)
_ids = itertools.count(1)

#: the current request's TraceContext on THIS thread/task (None = no
#: request scope: spans stay flat, exactly the pre-causal behavior)
_ctx_var: contextvars.ContextVar[Optional["TraceContext"]] = \
    contextvars.ContextVar("strom_trace_ctx", default=None)


class TraceContext:
    """One node of a request's causal tree: ``trace_id`` names the
    request, ``span_id`` this node, ``parent_id`` its parent (None at
    the root).  Immutable; ``child()`` allocates the next node.

    Two attachment conventions, used consistently across io/ and
    models/:

    - ``Tracer.add_span(..., ctx=c)`` — ``c`` IS the span's identity
      (the caller already allocated it with ``.child()``).
    - ``Tracer.add_span(...)`` with a context CURRENT on the thread —
      the span auto-becomes a fresh child of the current context.
    """

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id: int, span_id: int,
                 parent_id: Optional[int] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id

    @classmethod
    def new(cls) -> "TraceContext":
        """A fresh root context (one per request)."""
        return cls(next(_ids), next(_ids), None)

    def child(self) -> "TraceContext":
        """A child node: same trace, new span id, parent = this span."""
        return TraceContext(self.trace_id, next(_ids), self.span_id)

    def args(self) -> dict:
        """The correlation args stamped onto an exported span."""
        out = {"trace": f"{self.trace_id:x}", "span": self.span_id}
        if self.parent_id is not None:
            out["parent"] = self.parent_id
        return out

    def __repr__(self) -> str:
        return (f"TraceContext(trace={self.trace_id:x}, "
                f"span={self.span_id}, parent={self.parent_id})")


#: explicit "no causal scope" sentinel for cross-thread emit sites.
#: ``add_span(ctx=None)`` means "auto-attach from the CURRENT thread's
#: context" — but a span whose submit point had no scope must not
#: inherit whatever unrelated request happens to be current on the
#: thread that completes it.  ``attach_context()`` returns this instead
#: of None so captured contexts always round-trip unambiguously.
NO_CONTEXT = TraceContext(0, 0, None)


def current_context() -> Optional[TraceContext]:
    """The TraceContext current on this thread/task (None outside any
    request scope)."""
    return _ctx_var.get()


@contextlib.contextmanager
def use_context(ctx: Optional[TraceContext]):
    """Make ``ctx`` current for the enclosed block (None = explicitly
    no scope, shadowing an outer one)."""
    token = _ctx_var.set(ctx)
    try:
        yield ctx
    finally:
        _ctx_var.reset(token)


def attach_context() -> TraceContext:
    """The explicit-attachment helper for work that completes on another
    thread (planned batches, pending reads): a child of the current
    context, or :data:`NO_CONTEXT` outside any request scope — so the
    later emit can never mis-inherit the COMPLETING thread's context.
    The returned context is the future span's identity — pass it to
    ``add_span(..., ctx=...)``."""
    cur = _ctx_var.get()
    return cur.child() if cur is not None else NO_CONTEXT


class Tracer:
    """Thread-safe span recorder with chrome://tracing export."""

    def __init__(self, path: Optional[str] = None,
                 max_events: Optional[int] = None, stats=None):
        self._lock = make_lock("trace.Tracer._lock")
        self._events: list[dict] = []
        self._path = path
        self.enabled = path is not None
        self.max_events = max_events if max_events is not None else int(
            os.environ.get("STROM_TRACE_MAX_EVENTS", DEFAULT_MAX_EVENTS))
        self.dropped = 0
        #: StromStats block charged ``trace_spans_dropped`` on drops
        #: (None: the first engine built on this tracer sets its own;
        #: until then drops are only counted in ``dropped``)
        self.stats = stats
        #: span SINKS (obs/attrib.py): callables handed
        #: every completed span event dict.  A sink-only tracer (no
        #: export path) records nothing in memory: spans flow to the
        #: sinks and are gone, so always-on attribution never grows the
        #: event list toward the cap.  Sinks must be cheap and never
        #: raise.
        self._sinks: list = []
        self._atexit_registered = False
        if self.enabled:
            self._register_atexit()

    def _register_atexit(self) -> None:
        if not self._atexit_registered:
            atexit.register(self.export)
            self._atexit_registered = True

    def enable(self, path: str) -> None:
        self._path = path
        self.enabled = True
        self._register_atexit()

    def disable(self) -> None:
        """Stop recording AND exporting (the atexit hook becomes a
        no-op) — for throwaway tracers in bench/test passes.  A tracer
        with attached sinks stays enabled for sink delivery only."""
        self._path = None
        self.enabled = bool(self._sinks)

    def add_sink(self, sink) -> None:
        """Attach a span sink (``sink(event_dict)`` per completed span —
        the obs/attrib.py collector).  Enables the tracer for sink
        delivery even with no export path; idempotent per callable."""
        with self._lock:
            if sink not in self._sinks:
                self._sinks.append(sink)
        self.enabled = True

    def remove_sink(self, sink) -> None:
        with self._lock:
            try:
                self._sinks.remove(sink)
            except ValueError:
                pass
            has = bool(self._sinks)
        if not has and self._path is None:
            self.enabled = False

    def add_span(self, name: str, begin_ns: int, end_ns: int,
                 category: str = "strom",
                 ctx: Optional[TraceContext] = None, **args) -> None:
        """Record a completed span [begin_ns, end_ns) (CLOCK_MONOTONIC).

        ``ctx``: the span's causal identity (see :class:`TraceContext`);
        None auto-attaches a fresh child of the thread's current context
        (nothing when no context is current); :data:`NO_CONTEXT` attaches
        nothing regardless — the captured-at-submit "there was no scope"
        verdict, immune to whatever is current on THIS thread."""
        if not self.enabled:
            return
        if ctx is None:
            cur = _ctx_var.get()
            if cur is not None:
                ctx = cur.child()
        elif ctx is NO_CONTEXT:
            ctx = None
        if ctx is not None:
            args = {**ctx.args(), **args}
        ev = {
            "name": name,
            "cat": category,
            "ph": "X",
            "ts": begin_ns / 1000.0,                  # chrome wants µs
            "dur": max(end_ns - begin_ns, 0) / 1000.0,
            "pid": os.getpid(),
            "tid": threading.get_ident() & 0xFFFFFFFF,
        }
        if args:
            ev["args"] = args
        for sink in self._sinks:
            try:
                sink(ev)
            except Exception:
                pass   # a broken sink must never fail the traced I/O
        if self._path is None and self._sinks:
            # sink-only tracer (always-on attribution): nothing to
            # export, so keep no in-memory copy — a multi-day run must
            # not creep toward the event cap for spans nobody reads
            return
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                if self.stats is not None:
                    self.stats.add(trace_spans_dropped=1)
                return
            self._events.append(ev)

    @property
    def exports(self) -> bool:
        """True when spans/counters land in a trace FILE — the gate for
        counter-track emission sites, which do real work (depth walks,
        dict builds) a sink-only attribution tracer would discard."""
        return self.enabled and self._path is not None

    def add_counter(self, name: str, values: dict,
                    t_ns: Optional[int] = None) -> None:
        """Record one Perfetto COUNTER-track sample (``ph: "C"``): the
        numeric series in ``values`` land on one stacked counter track
        named ``name``, on the same timeline as the spans, so traces and
        metrics read off one Perfetto load.  Counter samples are not
        delivered to span sinks and only recorded when an export path
        is set."""
        if not self.enabled or self._path is None or not values:
            return
        ev = {
            "name": name,
            "ph": "C",
            "ts": (time.monotonic_ns() if t_ns is None else t_ns)
            / 1000.0,
            "pid": os.getpid(),
            "args": {str(k): float(v) for k, v in values.items()},
        }
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(ev)

    def span(self, name: str, category: str = "strom",
             ctx: Optional[TraceContext] = None, **args):
        """Context manager measuring a Python-side span with the same
        clock the engine stamps I/O with (CLOCK_MONOTONIC).  While the
        block runs, the span's OWN context is current on the thread, so
        spans emitted inside become its children — the nesting that
        builds the causal tree without threading ctx through every
        call."""
        return _SpanCtx(self, name, category, ctx, args)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def events(self) -> list:
        """A snapshot copy of the recorded events (tests, tooling)."""
        with self._lock:
            return list(self._events)

    def export(self, path: Optional[str] = None) -> Optional[str]:
        """Atomically write the trace file; returns the path (None if the
        tracer is disabled / has nowhere to write)."""
        path = path or self._path
        if path is None:
            return None
        with self._lock:
            doc = {"traceEvents": list(self._events),
                   "displayTimeUnit": "ms"}
            if self.dropped:
                doc["metadata"] = {"strom_dropped_events": self.dropped}
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path

    def clear(self) -> None:
        with self._lock:
            self._events.clear()


class _SpanCtx:
    def __init__(self, tracer: Tracer, name: str, category: str,
                 ctx: Optional[TraceContext], args: dict):
        self._tracer = tracer
        self._name = name
        self._cat = category
        self._args = args
        self._t0 = 0
        self._ctx = ctx
        self._token = None

    def __enter__(self):
        self._t0 = time.monotonic_ns()
        if self._tracer.enabled:
            if self._ctx is None:
                cur = _ctx_var.get()
                if cur is not None:
                    self._ctx = cur.child()
            if self._ctx is not None and self._ctx is not NO_CONTEXT:
                self._token = _ctx_var.set(self._ctx)
        return self

    def __exit__(self, *exc):
        if self._token is not None:
            _ctx_var.reset(self._token)
            self._token = None
        self._tracer.add_span(self._name, self._t0, time.monotonic_ns(),
                              category=self._cat, ctx=self._ctx,
                              **self._args)
        return False


def live_tracer(engine) -> Optional[Tracer]:
    """``engine``'s tracer while it is on, else None: one attribute test
    a call site with tracing off."""
    tracer = getattr(engine, "tracer", None)
    return tracer if tracer is not None and tracer.enabled else None


def connected_tree(events, trace_id: Optional[str] = None) -> bool:
    """True when every causally-tagged event of ``trace_id`` (default:
    the first tagged event's trace) forms ONE connected tree: every
    span's parent is either absent (an emitted root), another tagged
    span's id, or the SINGLE implicit root node every parentless chain
    shares (a request whose root span has not been emitted yet still
    forms one tree).  The acceptance check behind the e2e propagation
    tests (and handy for ad-hoc triage)."""
    tagged = [e.get("args", {}) for e in events
              if e.get("args", {}).get("trace") is not None]
    if trace_id is None:
        if not tagged:
            return False
        trace_id = tagged[0]["trace"]
    mine = [a for a in tagged if a["trace"] == trace_id]
    if not mine:
        return False
    ids = {a["span"] for a in mine}
    unresolved = {a["parent"] for a in mine
                  if a.get("parent") is not None
                  and a["parent"] not in ids}
    roots = [a for a in mine if a.get("parent") is None]
    # one tree: at most one root — emitted (parent None, all unresolved
    # edges would then be a disconnect) or implicit (all unresolved
    # parents name the SAME never-emitted node)
    if roots:
        return len(roots) == 1 and not unresolved
    return len(unresolved) == 1


global_tracer = Tracer(os.environ.get("STROM_TRACE") or None)
