"""QoS scheduler: latency classes over the multi-ring engine
(counterpart of nvme_strom_tpu/io/sched.py).

A multi-ring engine (``io/engine.py``, ``EngineConfig.n_rings``) has N
submission rings over one staging pool.  This module decides which
planned batch goes to which ring, and when:

  classes     every batch carries a class, ``decode`` > ``restore`` >
              ``prefetch`` > ``scan`` > ``scrub`` in priority order;
              consumers tag it at ``io/plan.py`` (``plan_and_submit(...,
              klass=...)``), and an untagged batch rides ``prefetch``.
  fair-share  each dispatch round credits every backlogged class its
              weight in batches (deficit round-robin, at most one round
              of banking), then serves the classes in priority order.
  aging       a batch queued for ``aging_rounds`` rounds is granted
              ahead of every weight and priority: even a class of
              weight 0 completes within K rounds.
  admission   a ring takes a bulk batch while its in-flight I/O
              (submitted minus completed, lock-free C counters) is under
              the per-ring budget; bulk classes leave one slot free and
              stay off ring 0, the urgent ring, unless it is idle.  The
              top class is never admission-queued.

Grant and execute are split: the lock covers only the decision, and
the owner thread submits its own batch outside it.  ``submit()`` blocks
until its batch is granted, and the blocked thread runs grant rounds
itself, so another thread's higher-class batch is granted first.
``close()`` wakes every blocked submitter with ECANCELED.

Inside one class the fair share is hierarchical: each batch carries the
tenant of the scope that queued it (io/tenants.py, taken at enqueue),
and among one class's queued batches the tenant with the least service
banked (a grant costs 1/effective weight) goes next, so tenants split a
class's grants by weight ratio.  The aging pass runs before that pick,
so the starvation bound does not depend on weights; until a batch with
a tenant is queued the pick is the queue's head, exact FIFO.

The engine's ``ring_free`` callback is masked by its supervisor
(io/health.py): a ring whose breaker is open reports no headroom, so
batches are granted to the healthy rings, and each poll of it is a
time-gated supervision round.  A granted batch's pending reads carry
its class (``op_klass``) for the flight recorder.

With the tracer on, each grant is a ``strom.sched.queue`` span from
enqueue to grant under the requester's causal context (taken at
enqueue: the grant may run on another thread), the ``sched_queue``
component of obs/attrib.py; with a trace file, every dispatch round
also samples each class's queue depth as the
``strom.sched.queue_depth`` counter track (at most every 20 ms).
"""

from __future__ import annotations

import errno
import time
from collections import deque
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Sequence

from nvme_strom_tpu_torch.io.tenants import current_tenant
from nvme_strom_tpu_torch.utils.lockwitness import make_condition, make_lock
from nvme_strom_tpu_torch.utils.trace import NO_CONTEXT, attach_context

#: priority order, highest first
CLASS_ORDER = ("decode", "restore", "prefetch", "scan", "scrub")

#: the class of every untagged batch
DEFAULT_CLASS = "prefetch"


@dataclass(frozen=True)
class ClassPolicy:
    """One class's scheduling policy: ``weight`` is its fair-share
    credit in batches a round.  ``hedge_budget`` and ``max_retries``
    are the class's recovery budgets, read by io/resilient.py's
    ``ResilientEngine``: its concurrent hedges, and (when set) its
    retries in place of ``ResilientConfig.max_retries``."""

    name: str
    priority: int          # position in CLASS_ORDER; lower serves first
    weight: float = 1.0
    hedge_budget: int = 4
    max_retries: Optional[int] = None

    def __post_init__(self):
        if self.weight < 0:
            raise ValueError(f"weight ({self.weight}) must be >= 0")
        if self.hedge_budget < 0:
            raise ValueError("hedge_budget must be >= 0")


def default_policies(weights: str = "") -> Dict[str, ClassPolicy]:
    """The five stock policies; ``weights`` ("decode=8,scrub=1")
    overrides weights per class (``SchedConfig.class_weights``)."""
    pol = {
        "decode": ClassPolicy("decode", 0, weight=8.0, hedge_budget=8),
        "restore": ClassPolicy("restore", 1, weight=4.0, hedge_budget=4),
        "prefetch": ClassPolicy("prefetch", 2, weight=2.0, hedge_budget=2),
        "scan": ClassPolicy("scan", 3, weight=2.0, hedge_budget=2),
        "scrub": ClassPolicy("scrub", 4, weight=1.0, hedge_budget=1),
    }
    for part in filter(None, (s.strip() for s in weights.split(","))):
        name, eq, val = part.partition("=")
        name = name.strip()
        if not eq or name not in pol:
            raise ValueError(
                f"STROM_CLASS_WEIGHTS entry {part!r}: expected "
                f"<class>=<weight> with class in {CLASS_ORDER}")
        pol[name] = replace(pol[name], weight=float(val))
    return pol


class _Batch:
    """One planned batch queued for a grant."""

    __slots__ = ("spans", "klass", "rounds", "granted", "ring",
                 "promoted", "t_enq", "t_enq_ns", "ctx", "tenant")

    def __init__(self, spans, klass: str, ctx=None):
        self.spans = spans
        self.klass = klass
        self.rounds = 0          # dispatch rounds survived ungranted
        self.granted = False
        self.ring: Optional[int] = None
        self.promoted = False    # granted by the aging bound
        self.t_enq = time.monotonic()
        self.t_enq_ns = time.monotonic_ns()
        #: the requester's TraceContext, taken at enqueue
        self.ctx = ctx
        #: the queuing scope's Tenant (None outside any tenant scope)
        self.tenant = current_tenant()


class QoSScheduler:
    """Weighted fair-share and aging over N rings.

    ``submit_ring(spans, ring) -> pendings`` does the engine submission;
    ``ring_free() -> [free slots per ring]`` reports admission headroom.
    Both are injectable, so tests drive ``step()`` against fakes."""

    #: poll slice while waiting for ring capacity: completions free it
    #: without a signal
    _POLL_S = 0.002

    def __init__(self, submit_ring: Callable[[Sequence, int], list],
                 ring_free: Callable[[], List[int]],
                 policies: Optional[Dict[str, ClassPolicy]] = None,
                 aging_rounds: int = 16, stats=None,
                 ring_cap: Optional[int] = None, tracer=None):
        if aging_rounds < 1:
            raise ValueError("aging_rounds must be >= 1")
        self._submit_ring = submit_ring
        self._ring_free = ring_free
        self.policies = policies or default_policies()
        self.aging_rounds = aging_rounds
        self.stats = stats
        #: where the queue spans and the depth track go (utils/trace.py)
        self.tracer = tracer
        self._next_counter_t = 0.0
        #: what a fully idle ring reports free: tells "ring 0 is idle"
        #: from "every ring is equally busy"
        self.ring_cap = ring_cap
        self._order = sorted(self.policies,
                             key=lambda k: self.policies[k].priority)
        self._queues: Dict[str, deque] = {k: deque() for k in self._order}
        self._deficit: Dict[str, float] = {k: 0.0 for k in self._order}
        # the tenant level: per class, each tenant's banked grant cost;
        # empty, and the pick the queue's head, until a batch with a
        # tenant is queued
        self._tenant_credit: Dict[str, Dict] = {}
        self._tenant_seen = False
        #: ring → spans granted and not yet submitted to the engine
        self._granted_out: Dict[int, int] = {}
        self._closed = False
        self._lock = make_lock("sched.QoSScheduler._lock")
        self._cv = make_condition("sched.QoSScheduler._cv", self._lock)
        self.dispatches = 0
        self.promotions = 0
        self.enqueued = 0

    # -- public API --------------------------------------------------------

    def enqueue(self, spans: Sequence, klass: Optional[str] = None
                ) -> _Batch:
        """Queue one batch without waiting (tests drive ``step()``
        against this; ``submit()`` is the blocking path)."""
        if klass not in self.policies:
            klass = DEFAULT_CLASS
        # NO_CONTEXT, not None, out of scope: the grant may run on
        # another request's thread, whose context must not be adopted
        ctx = NO_CONTEXT
        if self.tracer is not None and self.tracer.enabled:
            ctx = attach_context()
        b = _Batch(list(spans), klass, ctx=ctx)
        with self._cv:
            if self._closed:
                raise OSError(errno.ECANCELED,
                              "engine closing: scheduler shut down")
            self._queues[klass].append(b)
            if b.tenant is not None:
                self._tenant_seen = True
            self.enqueued += 1
            if self.stats is not None:
                self.stats.add(sched_enqueued=1)
        return b

    def submit(self, spans: Sequence, klass: Optional[str] = None) -> list:
        """Queue one batch under ``klass``, block until it is granted a
        ring (running grant rounds meanwhile), then submit it outside
        the lock.  Returns the engine's pendings aligned with ``spans``;
        raises what the submission raised."""
        b = self.enqueue(spans, klass)
        with self._cv:
            while not b.granted:
                if self._closed:
                    try:
                        self._queues[b.klass].remove(b)
                    except ValueError:
                        pass
                    raise OSError(errno.ECANCELED,
                                  "engine closing: batch never granted")
                self._drain_locked()
                if b.granted:
                    break
                self._cv.wait(timeout=self._POLL_S)
        try:
            out = self._submit_ring(b.spans, b.ring)
            for p in out:
                try:
                    p.op_klass = b.klass   # the flight recorder's class
                except AttributeError:
                    break   # a test double without a __dict__
            return out
        finally:
            self.ack_submitted(b)

    def ack_submitted(self, b: _Batch) -> None:
        """Hand a granted batch's charge over to the engine's in-flight
        counters (``submit()`` calls it; tests driving ``step()`` call
        it themselves)."""
        with self._cv:
            if b.ring is not None:
                self._granted_out[b.ring] = \
                    self._granted_out.get(b.ring, 0) - max(1, len(b.spans))
            self._cv.notify_all()

    def close(self) -> None:
        """Refuse further batches and wake every blocked submitter with
        ECANCELED (``StromEngine.close_all`` calls this first)."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def step(self) -> bool:
        """Run one dispatch round; True if a batch was granted."""
        with self._cv:
            return self._dispatch_round_locked()

    def queued(self) -> Dict[str, int]:
        """Queued batches per class."""
        with self._lock:
            return {k: len(q) for k, q in self._queues.items()}

    def backlog(self) -> Dict[str, Dict[str, float]]:
        """Per backlogged class: batches, spans and the oldest wait."""
        now = time.monotonic()
        out: Dict[str, Dict[str, float]] = {}
        with self._lock:
            for k, q in self._queues.items():
                if q:
                    out[k] = {"batches": len(q),
                              "spans": sum(len(b.spans) for b in q),
                              "oldest_wait_s": round(now - q[0].t_enq, 6)}
        return out

    def set_weight(self, klass: str, weight: float) -> None:
        """Change one class's weight at run time; priorities and the
        aging bound are untouched."""
        with self._lock:
            p = self.policies.get(klass)
            if p is None:
                raise KeyError(f"unknown class {klass!r} "
                               f"(have {sorted(self.policies)})")
            self.policies[klass] = replace(p, weight=float(weight))

    # -- dispatch core -----------------------------------------------------

    def _pick_index_locked(self, klass: str, q: deque) -> int:
        """The tenant level: among one class's queued batches, the index
        of the oldest batch of the tenant with the least banked cost
        (ties go to the older batch; batches outside any tenant scope
        share one pseudo-tenant of weight 1).  0 until a tenant is seen:
        exact FIFO.  The aging pass never calls it."""
        if not self._tenant_seen or len(q) <= 1:
            return 0
        credits = self._tenant_credit.setdefault(klass, {})
        first: Dict = {}           # tenant id → its oldest batch's index
        for i, b in enumerate(q):
            tid = b.tenant.id if b.tenant is not None else None
            if tid not in first:
                first[tid] = i
        for tid in list(credits):
            if tid not in first:   # gone: a returning tenant starts even
                del credits[tid]
        pick = min(first,
                   key=lambda tid: (credits.get(tid, 0.0), first[tid]))
        return first[pick]

    def _charge_tenant_locked(self, b: _Batch) -> None:
        """Bank one grant's cost against the batch's tenant (every grant,
        aged ones too), floored so the banks measure relative debt."""
        if not self._tenant_seen:
            return
        credits = self._tenant_credit.setdefault(b.klass, {})
        tid = b.tenant.id if b.tenant is not None else None
        w = b.tenant.effective_weight if b.tenant is not None else 1.0
        credits[tid] = credits.get(tid, 0.0) + 1.0 / max(w, 1e-9)
        if len(credits) > 1:
            base = min(credits.values())
            if base > 0:
                for t in credits:
                    credits[t] -= base

    def _drain_locked(self) -> None:
        while any(self._queues.values()):
            if not self._dispatch_round_locked():
                break

    def _dispatch_round_locked(self) -> bool:
        """One round: the top class, then aging promotions, then
        fair-share in priority order, against the rings' headroom.  A
        round with headroom ages every batch it leaves queued; one
        without does not (a device stall must not burn the bound)."""
        try:
            slots = list(self._ring_free())
        except OSError:
            slots = []
        if not slots:
            return False
        for r, g in self._granted_out.items():
            if 0 <= r < len(slots):
                slots[r] -= g
        progress = False
        # 0) the top class is never admission-queued: the urgent ring
        #    while it has room, else the least-loaded ring
        top_q = self._queues[self._order[0]]
        while top_q:
            i = self._pick_index_locked(self._order[0], top_q)
            b = top_q[i]
            r = 0 if slots[0] > 0 else max(range(len(slots)),
                                           key=lambda j: slots[j])
            slots[r] -= max(1, len(b.spans))
            del top_q[i]
            self._dispatch_one(b, r)
            progress = True
        if not any(s > 0 for s in slots):
            return progress

        cap = self.ring_cap if self.ring_cap is not None else max(slots)
        # with one slot a ring, a reserve of 1 would leave bulk only the
        # aging path: the scheduler stays work-conserving at any cap
        bulk_reserve = 1 if cap > 1 else 0

        def pick_ring(n_spans: int, reserve: int = 0) -> Optional[int]:
            # the least-loaded eligible ring takes the whole batch (one
            # doorbell).  A bulk class leaves ``reserve`` slots free and
            # takes ring 0 only when no other ring has room and ring 0
            # is completely idle
            lo = 0 if (reserve == 0 or len(slots) == 1) else 1
            r = max(range(lo, len(slots)), key=lambda i: slots[i])
            if slots[r] <= reserve:
                if lo == 1 and slots[0] >= cap and cap > reserve:
                    r = 0
                else:
                    return None
            slots[r] -= max(1, n_spans)
            return r

        # 1) aging: past the bound, before weights, priority and reserve
        for klass in self._order:
            q = self._queues[klass]
            while q and q[0].rounds >= self.aging_rounds:
                r = pick_ring(len(q[0].spans))
                if r is None:
                    break
                self._dispatch_one(q.popleft(), r, promoted=True)
                progress = True
        # 2) weighted fair-share: one round of banking at most
        for klass in self._order:
            if self._queues[klass]:
                w = self.policies[klass].weight
                self._deficit[klass] = min(self._deficit[klass] + w, 2 * w)
        top = self._order[0]
        for klass in self._order:
            q = self._queues[klass]
            reserve = 0 if klass == top else bulk_reserve
            while q and self._deficit[klass] >= 1.0:
                i = self._pick_index_locked(klass, q)
                b = q[i]
                r = pick_ring(len(b.spans), reserve)
                if r is None:
                    break
                del q[i]
                self._dispatch_one(b, r)
                self._deficit[klass] -= 1.0
                progress = True
            if not q:
                self._deficit[klass] = 0.0   # no banking while idle
        # 3) age the survivors of a round that had capacity
        for q in self._queues.values():
            for b in q:
                b.rounds += 1
        if self.tracer is not None and self.tracer.exports:
            now = time.monotonic()
            if now >= self._next_counter_t:
                self._next_counter_t = now + 0.02
                self.tracer.add_counter(
                    "strom.sched.queue_depth",
                    {k: len(q) for k, q in self._queues.items()})
        return progress

    def _dispatch_one(self, b: _Batch, ring: int,
                      promoted: bool = False) -> None:
        """Grant ``b`` its ring; the owner thread submits it."""
        b.ring = ring
        b.promoted = promoted
        b.granted = True
        self._charge_tenant_locked(b)
        self._granted_out[ring] = (self._granted_out.get(ring, 0)
                                   + max(1, len(b.spans)))
        self.dispatches += 1
        if promoted:
            self.promotions += 1
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.add_span(
                "strom.sched.queue", b.t_enq_ns, time.monotonic_ns(),
                category="strom.sched", ctx=b.ctx, klass=b.klass,
                ring=ring, spans=len(b.spans), promoted=promoted)
        if self.stats is not None:
            extra = {"promotions": 1} if promoted else {}
            self.stats.add(sched_dispatches=1,
                           **({"sched_promotions": 1} if promoted else {}))
            self.stats.add_class_stat(b.klass, dispatches=1,
                                      spans=len(b.spans), **extra)
            self.stats.class_stat_gauges(
                b.klass, queue_wait_s=time.monotonic() - b.t_enq)
            if b.tenant is not None:
                self.stats.add_tenant_stat(b.tenant.id, dispatches=1,
                                           spans=len(b.spans), **extra)
        self._cv.notify_all()
