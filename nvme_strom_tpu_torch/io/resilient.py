"""ResilientEngine: every detected I/O failure turned into a recovery
(counterpart of nvme_strom_tpu/io/resilient.py).

``ResilientEngine`` wraps any engine-shaped object (a StromEngine, or a
FaultyEngine for chaos runs) and gives its reads three mechanisms
(knobs: ``ResilientConfig`` in utils/config.py):

  retry    a read that completes with an error, or with fewer bytes than
           the file holds, is released and resubmitted whole after an
           exponential backoff with seeded jitter, up to ``max_retries``
           times; the last failure raises ReadError with the history of
           every attempt.
  hedge    a read still in flight past a threshold (``hedge_after_s``,
           or the engine's own latency histogram: p<hedge_percentile> ×
           hedge_multiplier) gets one duplicate; the first to complete
           wins, and the loser is parked and released once it lands.
  cancel   a read in flight after ``stuck_timeout_s`` is presumed
           wedged: it is parked and resubmitted, against the retry
           budget.

Writes get the mirror through ``submit_write`` → :class:`ResilientWrite`:
a failed write is resubmitted after backoff, a short one resubmits
exactly the rest (``data[n:]`` at ``offset + n``), and exhaustion raises
WriteError with the history.  Writes are never hedged: two writes of
one range in flight could land out of order.

The view a recovered read returns is always the winning attempt's own
staging view, never a copy: a consumer that copies it to the device
(``ops/bridge.py`` ``h2d_copy``) reads registered memory as it does for
a clean read, so ``bounce_bytes`` stays 0.  No attempt whose view may be
handed out is released before the caller releases the read.

Policy is per latency class (the scheduler's, io/sched.py): a read
tagged ``klass`` runs under that class's ``ResilientConfig``
(``class_configs``; a stock ``ClassPolicy.max_retries`` sets it) and
takes a token of the class's concurrent-hedge budget (``hedge_budgets``,
by default each ``ClassPolicy.hedge_budget``); a class out of tokens is
denied hedges (``hedges_denied``) while other classes keep theirs.
``set_hedge_budget`` is the SLO governor's lever on it
(models/kv_offload.py).  Untagged reads keep the engine-wide config and
hedge without a budget (still one hedge an attempt).

Every action is counted (``resilient_retries``, ``hedges_issued``,
``hedges_won``, ``hedges_denied``, ``stuck_cancelled``,
``write_retries``, per class in ``class_stats``), charged to the waste
ledger (obs/ledger.py: ``hedge_loss``, ``retry_reread``) and traced
(``strom.resilient.*`` spans).

The base engine's failure-domain supervisor (io/health.py) hears every
failed attempt of a read or write (``note_error``, attributed to the
attempt's ring; a cancellation is a requeue and the C engine's own
failures are counted once), and the wait loop runs its time-gated
``tick`` while a read straggles: the stall detector and the hot restart
run on the threads stuck on the wedged ring; so does a blocking release
or ``close(fh)`` that waits out an attempt still in flight (a hedge's
losing twin parked on a stalled ring would otherwise hold it forever).
Once the device breaker
is open, a read's next retry browns out onto a degraded buffered pread
(``degraded_pending``, an attempt marked ``degraded`` in the trace)
instead of spending its retries on the sick device.

The wrapper keeps the engine contract: ``wait(timeout=...)`` raises
TimeoutError with the read still live; ``release()`` frees every
attempt; everything else (``config``, ``stats``, ``scheduler``,
``cuda_mappings``, ``file_key``, ``n_buffers``, ...) is the wrapped
engine's.
"""

from __future__ import annotations

import random
import time
from dataclasses import replace
from typing import Optional

import numpy as np

from nvme_strom_tpu_torch.io.tenants import current_tenant
from nvme_strom_tpu_torch.obs.ledger import charge_waste
from nvme_strom_tpu_torch.utils.config import ResilientConfig
from nvme_strom_tpu_torch.utils.lockwitness import make_lock
from nvme_strom_tpu_torch.utils.trace import NO_CONTEXT, current_context

#: granularity of the hedged/stuck wait loop: long enough to stay off
#: the hot path (one wake per slice only while a read is *already* a
#: straggler), short enough to notice a hedge winning promptly
_POLL_S = 0.02


class ReadError(OSError):
    """A read that stayed failed after the full retry budget.

    ``attempts`` is the per-attempt fault history: a list of
    ``{"error": str, "kind": str, "elapsed_s": float}`` dicts, oldest
    first — the loud, fully-accounted failure the error budget demands.
    """

    def __init__(self, msg: str, attempts):
        super().__init__(msg)
        self.attempts = list(attempts)


class WriteError(OSError):
    """A write that stayed failed after the full retry budget —
    ReadError's mirror, same ``attempts`` fault-history shape."""

    def __init__(self, msg: str, attempts):
        super().__init__(msg)
        self.attempts = list(attempts)


def _release_supervised(pending, sup) -> None:
    """``pending.release()``, which waits out a request still in flight;
    with a supervisor the wait for the engine's own request (under any
    fault wrapper, whose injected delay a release does not wait out) is
    taken in ``_POLL_S`` slices, each returning as soon as the request
    completes, with a supervision heartbeat between them, so a request
    parked on a wedged ring is cancelled by the ring's restart instead
    of holding the caller forever."""
    if sup is not None:
        inner = pending
        while getattr(inner, "_inner", None) is not None:
            inner = inner._inner
        while not inner.is_ready():
            try:
                inner.wait(timeout=_POLL_S)
            except TimeoutError:
                sup.tick()
            except OSError:
                break     # completed with an error: nothing to wait for
    pending.release()


class _Attempt:
    """One submission of the logical read (original, retry, or hedge)."""

    def __init__(self, pending, t0: float):
        self.pending = pending
        self.t0 = t0


class ResilientRead:
    """The recoverable counterpart of ``PendingRead``.

    Holds (fh, offset, length) so a failed attempt can be resubmitted;
    the underlying PendingRead is replaced across retries, invisibly to
    the caller.
    """

    def __init__(self, engine: "ResilientEngine", fh: int, offset: int,
                 length: int, pending, expected: int,
                 klass: Optional[str] = None):
        self._engine = engine
        self._fh = fh
        self._offset = offset
        self._length = length
        self._expected = expected    # bytes the file actually holds here
        #: latency class: selects this read's ResilientConfig (per-class
        #: retry/backoff/hedge policy) and charges its hedge budget
        self._klass = klass
        self._cfg = engine.config_for(klass)
        #: causal identity for recovery spans (hedge/retry may fire from
        #: a wait() on another thread/context — capture at submit)
        self._ctx = None
        if engine.tracer.enabled:
            self._ctx = current_context()
        self._primary = _Attempt(pending, time.monotonic())
        self._hedge: Optional[_Attempt] = None
        self._hedge_token = False    # class hedge-budget token held
        self._hedge_denied = False   # denial counted for this primary
        self._attempts: list = []    # fault history of failed attempts
        self._retries = 0
        self._hedges = 0             # hedges issued for the CURRENT
        # primary: capped at one — a fast-failing hedge must not turn
        # into a resubmission storm against an unhealthy device
        self._view: Optional[np.ndarray] = None
        self._winner = None          # the attempt whose view we returned
        self._released = False
        self.was_fallback = False

    @property
    def length(self) -> int:
        """Bytes requested at submit (PendingRead.length parity)."""
        return self._length

    @property
    def fh(self) -> int:
        return self._fh

    @property
    def offset(self) -> int:
        return self._offset

    # -- the recovery loop -------------------------------------------------

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        """Blocking wait with retry/hedge/cancel recovery.

        ``timeout`` bounds THIS call (the engine contract): TimeoutError
        means the logical read is still live — recovery continues on the
        next wait; release() aborts it.
        """
        if self._view is not None:
            return self._view
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        cfg = self._cfg
        while True:
            try:
                view = self._wait_attempts(deadline)
            except TimeoutError:
                raise            # caller's bound, read still live
            except OSError as e:
                self._note_failure(e)
                if self._retries >= cfg.max_retries:
                    self._release_attempts()
                    self._released = True
                    raise ReadError(
                        f"read fh={self._fh} off={self._offset} "
                        f"len={self._length} failed after "
                        f"{self._retries + 1} attempts: {e} "
                        f"(history: {self._attempts})",
                        self._attempts) from e
                self._retry(deadline)
                continue
            short = self._expected - view.nbytes
            if short > 0:
                # the short attempt's delivered bytes are discarded and
                # re-read whole by the resubmission — retry-reread waste
                charge_waste(self._engine.stats, "retry_reread",
                             int(view.nbytes))
                self._note_failure(OSError(
                    f"short read: {view.nbytes} of {self._expected} "
                    f"bytes"), kind="short")
                if self._retries >= cfg.max_retries:
                    self._release_attempts()
                    self._released = True
                    raise ReadError(
                        f"read fh={self._fh} off={self._offset} "
                        f"len={self._length} still short after "
                        f"{self._retries + 1} attempts "
                        f"(history: {self._attempts})", self._attempts)
                self._retry(deadline)
                continue
            self._view = view
            return view

    def _wait_attempts(self, deadline) -> np.ndarray:
        """Wait for the primary (or a hedge) to produce a view; raises
        OSError on a completed-with-error attempt, TimeoutError only at
        the caller's deadline."""
        eng = self._engine
        cfg = self._cfg
        hedge_after = eng._hedge_after(self._klass)
        while True:
            # primary probe FIRST: a read whose payload already landed
            # must return its view even at timeout=0 (PendingRead.wait
            # parity — engine.is_ready builds on exactly that)
            slice_s = _POLL_S
            if deadline is not None:
                slice_s = min(slice_s,
                              max(0.0, deadline - time.monotonic()))
            try:
                view = self._primary.pending.wait(timeout=slice_s)
            except TimeoutError:
                pass
            else:
                if self._hedge is not None:
                    # primary won the race: the losing hedge hands its
                    # staging buffer back as soon as it lands (deferred
                    # — it may still be in flight, and release() would
                    # block).  Its bytes are the hedge's bandwidth
                    # price — the ledger's hedge-loss waste class.
                    charge_waste(eng.stats, "hedge_loss", self._length)
                    eng._defer_release(self._fh, self._hedge.pending)
                    self._drop_hedge()
                self._winner = self._primary
                self.was_fallback = bool(getattr(
                    self._primary.pending, "was_fallback", False))
                return view
            now = time.monotonic()
            if deadline is not None and now >= deadline:
                raise TimeoutError(
                    f"read fh={self._fh} off={self._offset} still in "
                    f"flight (recovery continues on the next wait)")
            # supervision heartbeat on the thread waiting on a straggler
            # (time-gated inside)
            sup = eng._supervisor
            if sup is not None:
                sup.tick()
            elapsed = now - self._primary.t0
            # hedge: the primary is a straggler — race ONE duplicate
            if (self._hedge is None and self._hedges == 0
                    and hedge_after is not None
                    and elapsed >= hedge_after):
                self._hedge = self._submit_hedge()
            # stuck: cancel-then-retry (counts against the retry budget)
            if elapsed >= cfg.stuck_timeout_s:
                raise _Stuck(f"request still in flight after "
                             f"{elapsed:.3f}s (stuck_timeout_s="
                             f"{cfg.stuck_timeout_s})")
            if self._hedge is not None and self._hedge.pending.is_ready():
                try:
                    view = self._hedge.pending.wait(timeout=0.0)
                except TimeoutError:
                    pass
                except OSError:
                    # a failed hedge never fails the read — drop it and
                    # keep waiting on the primary (wait() released it)
                    self._drop_hedge()
                else:
                    eng.stats.add(hedges_won=1)
                    # the parked primary's bytes are the losing side of
                    # this race — same hedge-loss waste class
                    charge_waste(eng.stats, "hedge_loss", self._length)
                    if self._klass:
                        eng.stats.add_class_stat(self._klass,
                                                 hedges_won=1)
                    eng._trace("strom.resilient.hedge_won",
                               int(self._hedge.t0 * 1e9),
                               ctx=self._ctx, fh=self._fh,
                               offset=self._offset)
                    # the straggler primary may run for a while yet:
                    # release() would BLOCK until its I/O lands, erasing
                    # the hedge's entire latency win — park it instead
                    eng._defer_release(self._fh, self._primary.pending)
                    self._primary = self._hedge
                    self._drop_hedge()
                    self._winner = self._primary
                    self.was_fallback = bool(getattr(
                        self._primary.pending, "was_fallback", False))
                    return view

    def _submit_hedge(self) -> Optional[_Attempt]:
        """Issue the duplicate read IF the class's concurrent-hedge
        budget has a token; None (counted hedges_denied, once per
        primary) when the budget is exhausted — this is the isolation
        that keeps a scrub storm from eating the decode class's hedge
        quota."""
        eng = self._engine
        if not eng._acquire_hedge(self._klass):
            if not self._hedge_denied:
                self._hedge_denied = True
                eng.stats.add(hedges_denied=1)
                if self._klass:
                    eng.stats.add_class_stat(self._klass, hedges_denied=1)
            return None
        try:
            pending = eng._engine.submit_read(self._fh, self._offset,
                                              self._length,
                                              klass=self._klass)
        except OSError:
            # a hedge that cannot even submit (pool teardown, routing
            # refusal) must neither fail the read nor strand its class's
            # token: hand the token straight back
            eng._release_hedge(self._klass)
            return None
        self._hedge_token = True
        self._hedges += 1
        eng.stats.add(hedges_issued=1)
        if self._klass:
            eng.stats.add_class_stat(self._klass, hedges_issued=1)
        tenant = current_tenant()
        if tenant is not None:
            # hedges are real duplicate I/O on the shared device: the
            # per-tenant ledger shows WHO is spending the budget
            eng.stats.add_tenant_stat(tenant.id, hedges_issued=1)
        eng._trace("strom.resilient.hedge", time.monotonic_ns(),
                   ctx=self._ctx, fh=self._fh, offset=self._offset,
                   length=self._length)
        return _Attempt(pending, time.monotonic())

    def _drop_hedge(self) -> None:
        """Clear the hedge slot and hand its budget token back (every
        transition out of 'hedge outstanding' funnels here exactly
        once)."""
        if self._hedge_token:
            self._engine._release_hedge(self._klass)
            self._hedge_token = False
        self._hedge = None

    def _note_failure(self, e: OSError, kind: Optional[str] = None):
        self._attempts.append({
            "error": str(e),
            "kind": kind or ("stuck" if isinstance(e, _Stuck) else "io"),
            "elapsed_s": round(time.monotonic() - self._primary.t0, 4),
        })
        # a Python fault plan never moves the C ring counters, yet must
        # reach the same breakers
        sup = self._engine._supervisor
        if sup is not None:
            sup.note_error(getattr(self._primary.pending, "ring", -1),
                           err=getattr(e, "errno", None),
                           engine_counted=getattr(e, "engine_counted",
                                                  False))

    def _retry(self, deadline) -> None:
        """Release the failed/stuck attempt, back off, resubmit."""
        eng = self._engine
        cfg = self._cfg
        stuck = self._attempts[-1]["kind"] == "stuck"
        t0 = time.monotonic_ns()
        self._release_attempts()
        if stuck:
            eng.stats.add(stuck_cancelled=1)
            # a cancelled stuck read typically completes into the void
            # after the resubmission: its whole range is re-read
            charge_waste(eng.stats, "retry_reread", self._length)
        eng.stats.add(resilient_retries=1)
        if self._klass:
            eng.stats.add_class_stat(self._klass, retries=1)
        delay = min(cfg.backoff_max_s,
                    cfg.backoff_base_s * (2 ** self._retries))
        delay *= 1.0 + cfg.jitter * (2 * eng._rng.random() - 1)
        if deadline is not None:
            delay = min(delay, max(0.0, deadline - time.monotonic()))
        if delay > 0:
            time.sleep(delay)
        self._retries += 1
        self._hedges = 0     # a fresh primary earns a fresh hedge budget
        self._hedge_denied = False
        sup = eng._supervisor
        if sup is not None and sup.degraded():
            # the device breaker opened while this read recovered: its
            # next attempt browns out instead of spending its retries
            # on a device already condemned
            self._primary = _Attempt(
                sup.degraded_pending(self._fh, self._offset, self._length,
                                     eng.stats, probe_engine=eng._engine),
                time.monotonic())
            eng._trace("strom.resilient.retry", t0, ctx=self._ctx,
                       fh=self._fh, offset=self._offset,
                       attempt=self._retries, stuck=stuck, degraded=True,
                       error=self._attempts[-1]["error"])
            return
        try:
            pending = eng._engine.submit_read(self._fh, self._offset,
                                              self._length,
                                              klass=self._klass)
        except OSError as e:
            # the resubmission itself failed (engine teardown, pool
            # refusal): every prior attempt is already released or
            # parked, so raise the history-carrying ReadError, whose
            # released state consumers treat as final
            self._note_failure(e, kind="resubmit")
            self._released = True
            raise ReadError(
                f"read fh={self._fh} off={self._offset} "
                f"len={self._length} could not be resubmitted after "
                f"{self._retries} retries: {e} "
                f"(history: {self._attempts})", self._attempts) from e
        self._primary = _Attempt(pending, time.monotonic())
        eng._trace("strom.resilient.retry", t0, ctx=self._ctx,
                   fh=self._fh, offset=self._offset,
                   attempt=self._retries, stuck=stuck,
                   error=self._attempts[-1]["error"])

    def _release_attempts(self) -> None:
        """Hand every outstanding attempt back — DEFERRED for attempts
        still in flight: a synchronous release() blocks until the I/O
        lands, which on a genuinely wedged request means the stuck
        recovery would never get to resubmit.  Internal-recovery use
        only; the caller-facing :meth:`release` blocks, preserving the
        engine's release-before-close invariant."""
        self._engine._defer_release(self._fh, self._primary.pending)
        if self._hedge is not None:
            self._engine._defer_release(self._fh, self._hedge.pending)
        self._drop_hedge()

    # -- PendingRead-compatible surface ------------------------------------

    def is_ready(self) -> bool:
        """Non-blocking probe; True once wait() would not block on I/O
        (recovery work — backoff, resubmit — may still run inside it)."""
        if self._view is not None or self._released:
            return True
        if self._primary.pending.is_ready():
            return True
        return self._hedge is not None and self._hedge.pending.is_ready()

    def release(self) -> None:
        """Caller-facing abort/free: BLOCKS until every attempt is out
        of flight (the PendingRead contract drain paths rely on — the
        caller may close the fh right after)."""
        if self._released:
            return
        self._released = True
        self._view = None
        sup = self._engine._supervisor
        _release_supervised(self._primary.pending, sup)
        if self._hedge is not None:
            _release_supervised(self._hedge.pending, sup)
        self._drop_hedge()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


class _Stuck(OSError):
    """Internal: a wait that exceeded stuck_timeout_s (cancel + retry)."""


class ResilientWrite:
    """The recoverable counterpart of ``PendingWrite`` — the write-path
    mirror of :class:`ResilientRead`.

    Holds (fh, offset, source bytes) so a failed attempt can be
    resubmitted whole and a SHORT write can resubmit exactly the
    remaining span (``data[n:]`` at ``offset + n``) instead of
    rewriting committed bytes.  Hedging does not apply: two in-flight
    writes of one range could land out of order and interleave torn
    content — retry/backoff is the whole recovery vocabulary here.
    The source buffer stays referenced until the logical write
    completes (the engine works from a raw pointer).
    """

    def __init__(self, engine: "ResilientEngine", fh: int, offset: int,
                 data: np.ndarray, pending):
        self._engine = engine
        self._fh = fh
        self._offset = offset
        self._data = data            # contiguous uint8; keepalive
        self._pending = pending
        self._done_total: Optional[int] = None
        self._written = 0            # bytes committed by prior attempts
        self._attempt_off = offset   # submit offset of the CURRENT attempt
        self._attempts: list = []
        self._retries = 0
        self._t0 = time.monotonic()
        self._released = False

    @property
    def fh(self) -> int:
        return self._fh

    @property
    def offset(self) -> int:
        return self._offset

    @property
    def length(self) -> int:
        return self._data.nbytes

    def wait(self, timeout: Optional[float] = None) -> int:
        """Block until every byte is committed (retrying failed and
        short attempts under the engine's retry budget); returns the
        total byte count, PendingWrite.wait parity.  ``timeout`` bounds
        THIS call: TimeoutError means the logical write is still live
        and recovery continues on the next wait."""
        if self._done_total is not None:
            return self._done_total
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        cfg = self._engine.rconfig
        while True:
            slice_t = None
            if deadline is not None:
                slice_t = max(0.0, deadline - time.monotonic())
            try:
                n = self._pending.wait(timeout=slice_t)
            except TimeoutError:
                raise            # caller's bound, write still live
            except OSError as e:
                self._note(e, kind="io")
                # retry exactly the failed attempt's span (bytes before
                # self._written were committed by earlier short attempts)
                self._retry_or_raise(cfg, deadline,
                                     resubmit_from=self._written)
                continue
            expected = self._data.nbytes - self._written
            if n < expected:
                self._note(OSError(
                    f"short write: {n} of {expected} bytes at "
                    f"offset {self._attempt_off}"), kind="short")
                # bytes [0, n) of this attempt ARE committed: resubmit
                # only the remainder
                self._written += n
                self._retry_or_raise(cfg, deadline,
                                     resubmit_from=self._written)
                continue
            self._done_total = self._written + n
            self._released = True
            return self._done_total

    def _note(self, e: OSError, kind: str) -> None:
        self._attempts.append({
            "error": str(e), "kind": kind,
            "elapsed_s": round(time.monotonic() - self._t0, 4)})
        sup = self._engine._supervisor
        if sup is not None:   # write failures feed the same breakers
            sup.note_error(getattr(self._pending, "ring", -1),
                           err=getattr(e, "errno", None),
                           engine_counted=getattr(e, "engine_counted",
                                                  False))

    def _retry_or_raise(self, cfg, deadline, resubmit_from: int) -> None:
        eng = self._engine
        if self._retries >= cfg.max_retries:
            self._released = True
            raise WriteError(
                f"write fh={self._fh} off={self._offset} "
                f"len={self._data.nbytes} failed after "
                f"{self._retries + 1} attempts "
                f"(history: {self._attempts})", self._attempts)
        delay = min(cfg.backoff_max_s,
                    cfg.backoff_base_s * (2 ** self._retries))
        delay *= 1.0 + cfg.jitter * (2 * eng._rng.random() - 1)
        if deadline is not None:
            delay = min(delay, max(0.0, deadline - time.monotonic()))
        if delay > 0:
            time.sleep(delay)
        self._retries += 1
        eng.stats.add(write_retries=1)
        self._attempt_off = self._offset + resubmit_from
        remaining = self._data[resubmit_from:]
        self._pending = eng._engine.submit_write(
            self._fh, self._attempt_off, remaining)
        eng._trace("strom.resilient.write_retry", time.monotonic_ns(),
                   fh=self._fh, offset=self._attempt_off,
                   attempt=self._retries,
                   error=self._attempts[-1]["error"])

    def release(self) -> None:
        """Abort/free: blocks until the current attempt is out of
        flight (the PendingWrite contract), then drops the keepalive."""
        if self._released:
            return
        self._released = True
        self._pending.release()


class ResilientEngine:
    """Engine wrapper adding retry / hedging / stuck-cancel to reads,
    and retry / short-write-resubmit to writes.

    Drop-in for StromEngine everywhere I/O happens (ShardedLoader,
    CheckpointManager, PagedKVCache, PrefixStore, parallel/weights,
    DeviceStream): ``submit_read`` returns a ResilientRead,
    ``submit_write`` a ResilientWrite; all other attributes delegate to
    the wrapped engine.  Write recovery is safe under the checkpoint's
    atomic save: every consumer writes into a staged temp file or a
    slot it owns, so rewriting the same bytes at the same offset is
    idempotent, and the commit (manifest, rename) lands only after the
    waits succeed.
    """

    def __init__(self, engine, config: Optional[ResilientConfig] = None,
                 class_configs: Optional[dict] = None,
                 hedge_budgets: Optional[dict] = None):
        self._engine = engine
        self.rconfig = config or ResilientConfig()
        #: per-latency-class ResilientConfig overrides ({class: config})
        #: — recovery policy is no longer process-global: tests and
        #: serving deployments vary a class's retry/backoff/hedging
        #: without touching env vars or the other classes
        self.class_configs = dict(class_configs or {})
        # concurrent-hedge budget per class (tokens; {class: int}).
        # Default from the scheduler's stock policies so the two layers
        # agree on class names and relative generosity; explicit
        # ``hedge_budgets`` wins.  Reads with NO class share the
        # unlimited legacy pool (hedging capped at 1 per primary as
        # before), so un-tagged callers keep exact pre-PR behavior.
        from nvme_strom_tpu_torch.io.sched import default_policies
        policies = default_policies()
        if hedge_budgets is None:
            hedge_budgets = {name: p.hedge_budget
                             for name, p in policies.items()}
        self.hedge_budgets = dict(hedge_budgets)
        # a stock policy's max_retries, where it sets one, is its
        # class's retry budget unless class_configs names the class
        for name, p in policies.items():
            if p.max_retries is not None and name not in self.class_configs:
                self.class_configs[name] = replace(
                    self.rconfig, max_retries=p.max_retries)
        #: the base engine's failure-domain supervisor (reached through
        #: the wrappers' delegation), read on every poll slice
        self._supervisor = getattr(engine, "supervisor", None)
        self._hedge_out: dict = {}           # class -> outstanding hedges
        self._hedge_lock = make_lock("resilient.ResilientEngine._hedge_lock")
        self._rng = random.Random(self.rconfig.seed)
        # abandoned attempts (lost hedges, cancelled stuck reads) whose
        # I/O may still be in flight: released opportunistically once
        # complete — a synchronous release would block on the very
        # straggler/wedge being recovered from.  Bounded: at most
        # 1 + max_retries outstanding attempts exist per logical read.
        self._zombies: list = []
        self._zombie_lock = make_lock("resilient.ResilientEngine._zombie_lock")
        # derived hedge threshold, refreshed at most once a second PER
        # CLASS: the percentile walk over the C histogram is cheap but
        # runs per wait — uncached it becomes measurable on tens of
        # thousands of small reads per second
        self._hedge_cache: dict = {}   # class -> (computed_at, value)

    def config_for(self, klass: Optional[str]) -> ResilientConfig:
        """The ResilientConfig governing reads of ``klass`` (the
        engine-wide config unless a per-class override is registered)."""
        if klass is not None:
            cfg = self.class_configs.get(klass)
            if cfg is not None:
                return cfg
        return self.rconfig

    # -- per-class hedge budget (token accounting) -------------------------

    def _acquire_hedge(self, klass: Optional[str]) -> bool:
        """Take one concurrent-hedge token for ``klass``; False when the
        class's budget is exhausted.  Class-less reads always succeed
        (legacy behavior: their only cap is one hedge per primary)."""
        if klass is None:
            return True
        budget = self.hedge_budgets.get(klass)
        if budget is None:
            return True
        with self._hedge_lock:
            if self._hedge_out.get(klass, 0) >= budget:
                return False
            self._hedge_out[klass] = self._hedge_out.get(klass, 0) + 1
            return True

    def _release_hedge(self, klass: Optional[str]) -> None:
        if klass is None or klass not in self.hedge_budgets:
            return
        with self._hedge_lock:
            n = self._hedge_out.get(klass, 0)
            if n > 0:
                self._hedge_out[klass] = n - 1

    def hedges_outstanding(self, klass: str) -> int:
        with self._hedge_lock:
            return self._hedge_out.get(klass, 0)

    def set_hedge_budget(self, klass: str, budget: int) -> None:
        """Adjust one class's concurrent-hedge token budget at runtime —
        the SLO governor's resilience lever (models/kv_offload.py
        ``SloGovernor``): a decode-path p99 violation buys the decode
        class more concurrent hedges, and the governor decays the budget
        back once the target is met.  Outstanding tokens are untouched: a shrink simply
        denies NEW hedges until enough in-flight ones release."""
        if budget < 0:
            raise ValueError(f"budget must be >= 0, got {budget}")
        with self._hedge_lock:
            self.hedge_budgets[klass] = int(budget)

    # -- delegation --------------------------------------------------------

    def open(self, path, **kw) -> int:
        return self._engine.open(path, **kw)

    def close(self, fh: int) -> None:
        # lost hedges / cancelled stuck reads on this file must be out
        # of flight before the fd goes away (a recycled fd number would
        # hand their late completion someone else's file)
        self._reap_zombies(fh=fh, block=True)
        self._engine.close(fh)

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def __enter__(self):
        return self

    def close_all(self) -> None:
        # completed zombies release cleanly; a genuinely wedged one is
        # left to the engine's own teardown drain (which must wait for
        # the kernel anyway before unmapping the pool)
        self._reap_zombies()
        self._engine.close_all()

    def __exit__(self, *exc):
        self.close_all()

    # -- reads -------------------------------------------------------------

    def _defer_release(self, fh: int, pending) -> None:
        """Release ``pending`` without ever blocking: immediately when
        its I/O already landed, else parked (tagged with its fh) for the
        next reap — ``close(fh)`` force-releases its stragglers so the
        fd never closes under an in-flight read."""
        if pending.is_ready():
            pending.release()
        else:
            with self._zombie_lock:
                self._zombies.append((fh, pending))

    def _reap_zombies(self, fh: Optional[int] = None,
                      block: bool = False) -> None:
        """Release parked attempts that have landed; ``fh``+``block``
        restricts to that file's zombies and waits for them (the
        close-time invariant: no read may be in flight on a closing fd)."""
        with self._zombie_lock:
            zombies, self._zombies = self._zombies, []
        survivors = []
        for zfh, p in zombies:
            if block and (fh is None or zfh == fh):
                # waits if still in flight (a lost hedge's twin may be
                # parked on a wedged ring: the wait ticks the supervisor)
                _release_supervised(p, self._supervisor)
            elif p.is_ready():
                p.release()
            else:
                survivors.append((zfh, p))
        if survivors:
            with self._zombie_lock:
                self._zombies.extend(survivors)

    def submit_read(self, fh: int, offset: int, length: int,
                    klass: Optional[str] = None) -> ResilientRead:
        self._reap_zombies()   # lost hedges hand buffers back here
        pending = self._engine.submit_read(fh, offset, length,
                                           klass=klass)
        # size AFTER submit: the C engine re-fstats the file at every
        # submit, so this reflects writes since open() (a size cached at
        # open time would make short-read detection silently inert on
        # grow-after-open files like the offload stores' backing files)
        try:
            size = self._engine.file_size(fh)
        except OSError:
            size = 0
        expected = min(length, max(0, size - offset))
        return ResilientRead(self, fh, offset, length, pending, expected,
                             klass=klass)

    def submit_readv(self, reads, klass: Optional[str] = None) -> list:
        """Batch-aware vectored submission: the whole batch goes down
        in ONE wrapped-engine call (keeping the syscall amortization),
        but every extent comes back as its OWN ResilientRead — a
        failed/short/stuck span retries, hedges, and cancels alone;
        the rest of the batch is never resubmitted.  ``klass`` flows
        down to the scheduler AND selects the per-class retry/hedge
        budgets each ResilientRead runs under."""
        from nvme_strom_tpu_torch.io.plan import submit_spans
        self._reap_zombies()   # lost hedges hand buffers back here
        reads = list(reads)
        pendings = submit_spans(self._engine, reads, klass=klass)
        sizes: dict = {}
        out = []
        for (fh, offset, length), pending in zip(reads, pendings):
            size = sizes.get(fh)
            if size is None:
                try:
                    size = self._engine.file_size(fh)
                except OSError:
                    size = 0
                sizes[fh] = size
            expected = min(length, max(0, size - offset))
            out.append(ResilientRead(self, fh, offset, length, pending,
                                     expected, klass=klass))
        return out

    def read(self, fh: int, offset: int, length: int) -> np.ndarray:
        """Synchronous owning-array read through the recovery path."""
        with self.submit_read(fh, offset, length) as p:
            out = p.wait().copy()
        self.stats.add(bounce_bytes=int(out.nbytes))
        return out

    # -- writes ------------------------------------------------------------

    def submit_write(self, fh: int, offset: int, data) -> ResilientWrite:
        """Recoverable write: failed attempts resubmit with backoff,
        short writes resubmit the remaining span, and exhaustion raises
        WriteError with the per-attempt history — the write mirror of
        submit_read's retry half (hedging deliberately excluded: racing
        duplicate writes of one range can interleave torn content)."""
        arr = np.ascontiguousarray(np.asarray(data)) \
            .view(np.uint8).reshape(-1)
        pending = self._engine.submit_write(fh, offset, arr)
        return ResilientWrite(self, fh, offset, arr, pending)

    # -- policy helpers ----------------------------------------------------

    def _hedge_after(self, klass: Optional[str] = None) -> Optional[float]:
        """Seconds after which an in-flight read of ``klass`` earns a
        hedge; None disables hedging (per-class config, or the
        histogram is still cold)."""
        cfg = self.config_for(klass)
        if not cfg.hedging:
            return None
        if cfg.hedge_after_s > 0:
            return cfg.hedge_after_s
        now = time.monotonic()
        computed_at, cached = self._hedge_cache.get(klass, (-1.0, None))
        if now - computed_at < 1.0:
            return cached
        try:
            pct = self._engine.latency_percentiles(
                "read", ps=(cfg.hedge_percentile,))
        except (OSError, AttributeError):
            return None
        ns = pct.get(cfg.hedge_percentile, 0)
        # None while no read has completed — nothing to derive from
        val = (max(cfg.hedge_min_s, ns / 1e9 * cfg.hedge_multiplier)
               if ns else None)
        self._hedge_cache[klass] = (now, val)
        return val

    def _trace(self, name: str, t0_ns: int, ctx=None, **args) -> None:
        tracer = self.tracer
        if not tracer.enabled:
            return
        if ctx is not None and ctx is not NO_CONTEXT:
            ctx = ctx.child()   # ctx is the PARENT here (the submit-
            #                     time context the read captured)
        elif ctx is None:
            # a recovery span may fire from a wait() on another
            # request's thread: never auto-adopt that thread's context
            ctx = NO_CONTEXT
        tracer.add_span(name, int(t0_ns), time.monotonic_ns(),
                        category="strom.resilient", ctx=ctx, **args)
