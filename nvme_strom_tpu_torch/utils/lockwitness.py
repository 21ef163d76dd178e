"""Runtime lock-order witness: a small lockdep for the Python control
plane (counterpart of nvme_strom_tpu/utils/lockwitness.py).  The static
half is analysis/locks.py; both enforce analysis/lock_order.conf.

Every concurrent module of the port creates its locks through
:func:`make_lock` / :func:`make_rlock` / :func:`make_condition`, passing
the lock's manifest id (``"sched.QoSScheduler._lock"``).  Disarmed (the
default), these return plain ``threading`` primitives: no overhead, the
behaviour of a plain lock.  Armed (``STROM_LOCK_WITNESS=1``, or
:func:`arm` / :func:`armed_scope` as the port's chaos-class tests do),
every blocking acquisition records the edge ``held -> acquired`` into
one process-wide acquisition graph.  An edge that closes a cycle is an
order inversion that deadlocks under the right interleaving, even when
this run got away with it: it is recorded as a violation and dumped
through the flight recorder (io/flightrec.py,
``reason="lock_order_cycle"``).  ``STROM_LOCK_WITNESS=strict`` raises
:class:`LockOrderError` at the acquisition site instead.

The witness records the order relation, not the deadlock: one clean run
of each of two call paths proves the inversion without the fatal
interleaving.  Re-acquiring a held non-reentrant witnessed lock is
reported at once, before the thread hangs.

Scope: try-acquires (``blocking=False``) and bounded acquires never
record, since they cannot deadlock; RLock re-entry records nothing for
the re-entered lock; ``Condition.wait`` releases through the proxy, so
the held set stays truthful across waits.

Arming is sampled at construction: a lock built while disarmed is a
plain primitive for good.  Module-level locks created at import (the
library bind lock ``_build._lock``, ``stats._writer_lock``, the
singletons' locks) are witnessed only when ``STROM_LOCK_WITNESS`` is
set in the environment when the process starts.  :func:`armed_scope`
covers every lock constructed during the scope; the import-time locks
are covered by the static pass either way."""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Dict, List, Optional, Set, Tuple

__all__ = ["make_lock", "make_rlock", "make_condition", "witness",
           "LockOrderError", "arm", "disarm", "armed", "armed_scope"]


class LockOrderError(RuntimeError):
    """An acquisition closed a cycle in the lock-order graph (strict
    mode), or re-acquired a held non-reentrant lock."""


class _Witness:
    """Process-wide acquisition graph + per-thread held stacks."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        #: directed edges: held-id -> {acquired-ids}
        self.edges: Dict[str, Set[str]] = {}
        #: first-observation site of each edge, for reports
        self.edge_sites: Dict[Tuple[str, str], str] = {}
        self.violations: List[dict] = []
        self._tls = threading.local()
        self._dumped = 0
        #: ONE recorder for the witness's lifetime: dump filenames
        #: increment (a second cycle never overwrites the first's
        #: post-mortem) and the recorder's rate limit actually holds
        self._recorder = None

    # -- held tracking -----------------------------------------------------
    def _held(self) -> List[str]:
        h = getattr(self._tls, "held", None)
        if h is None:
            h = []
            self._tls.held = h
        return h

    # -- graph -------------------------------------------------------------
    def _reaches(self, src: str, dst: str) -> bool:
        seen: Set[str] = set()
        stack = [src]
        while stack:
            n = stack.pop()
            if n == dst:
                return True
            if n in seen:
                continue
            seen.add(n)
            stack.extend(self.edges.get(n, ()))
        return False

    def suppressed(self) -> bool:
        """True while the witness itself is dumping — witnessed locks
        taken by the reporting machinery (the flight recorder's own
        dump lock) must not re-enter the witness."""
        return getattr(self._tls, "suppress", False)

    def note_acquire(self, lock_id: str, reentrant_depth: int,
                     site: str) -> None:
        held = self._held()
        if reentrant_depth > 0:        # RLock re-entry: no new ordering
            held.append(lock_id)
            return
        strict = _mode() == "strict"
        cycle: Optional[dict] = None
        with self._mu:
            for h in held:
                if h == lock_id:
                    continue           # multi-acquire of the same id
                if self._reaches(lock_id, h):
                    if cycle is None:
                        cycle = {"kind": "cycle",
                                 "edge": (h, lock_id),
                                 "held": list(held),
                                 "site": site,
                                 "closes": self._cycle_path(lock_id, h)}
                        self.violations.append(cycle)
                    # do NOT install the inverted edge: it would make
                    # every LATER correct-order acquisition of the
                    # pair "close a cycle" too — one real inversion
                    # must not cascade into strict-mode raises and
                    # dump spam for innocent code
                    continue
                self.edges.setdefault(h, set()).add(lock_id)
                self.edge_sites.setdefault((h, lock_id), site)
        if cycle is not None:
            self._dump(cycle)          # NOT under _mu: the dump takes
            #                            witnessed locks of its own
            if strict:
                raise LockOrderError(
                    f"lock-order cycle: acquiring {lock_id} while "
                    f"holding {cycle['edge'][0]} at {site}, but the "
                    f"graph already orders {lock_id} before "
                    f"{cycle['edge'][0]} (path {cycle['closes']}) — "
                    f"this interleaving deadlocks")
        held.append(lock_id)

    def note_self_deadlock(self, lock_id: str, site: str) -> None:
        v = {"kind": "self-deadlock", "edge": (lock_id, lock_id),
             "held": list(self._held()), "site": site, "closes": []}
        with self._mu:
            self.violations.append(v)
        self._dump(v)
        raise LockOrderError(
            f"self-deadlock: {lock_id} acquired while already held by "
            f"this thread at {site} and it is not an RLock — without "
            f"the witness this thread would hang here forever")

    def _cycle_path(self, src: str, dst: str) -> List[str]:
        # one witnessing path src ->* dst for the report
        seen: Set[str] = set()

        def _dfs(n: str, path: List[str]) -> Optional[List[str]]:
            if n == dst:
                return path + [n]
            if n in seen:
                return None
            seen.add(n)
            for m in self.edges.get(n, ()):
                got = _dfs(m, path + [n])
                if got:
                    return got
            return None
        return _dfs(src, []) or [src, "...", dst]

    def note_release(self, lock_id: str) -> None:
        held = self._held()
        # out-of-order release is legal for locks; remove last instance
        for i in range(len(held) - 1, -1, -1):
            if held[i] == lock_id:
                del held[i]
                return

    # -- reporting ---------------------------------------------------------
    def _dump(self, violation: dict) -> None:
        """Route through the flight recorder (rate-limited there);
        never let observability crash the observed program.  Recording
        is suppressed for the duration — the recorder's own witnessed
        locks must not feed back into the graph."""
        self._tls.suppress = True
        try:
            # recorder creation under _mu: two threads closing cycles
            # concurrently must share ONE recorder, or their dumps
            # would both be numbered _1 and the second os.replace
            # silently overwrites the first post-mortem (and each
            # instance's private rate limiter defeats
            # STROM_FLIGHT_MIN_S).  The dump itself stays outside _mu.
            with self._mu:
                if self._recorder is None:
                    from nvme_strom_tpu_torch.io.flightrec import FlightRecorder
                    self._recorder = FlightRecorder()
                recorder = self._recorder
                edges = {k: sorted(v) for k, v in self.edges.items()}
            recorder.dump("lock_order_cycle", extra={
                "violation": {k: list(v) if isinstance(v, tuple) else v
                              for k, v in violation.items()},
                "edges": edges,
            })
            self._dumped += 1
        except Exception:
            pass
        finally:
            self._tls.suppress = False

    def snapshot_edges(self) -> Dict[str, List[str]]:
        with self._mu:
            return {k: sorted(v) for k, v in self.edges.items()}

    def reset(self) -> None:
        with self._mu:
            self.edges.clear()
            self.edge_sites.clear()
            self.violations.clear()
            # drop the cached recorder too: the next armed scope
            # re-reads FlightConfig (tests repoint STROM_FLIGHT_DIR)
            self._recorder = None


_witness = _Witness()
_armed_override: Optional[bool] = None


def witness() -> _Witness:
    return _witness


def _mode() -> str:
    return os.environ.get("STROM_LOCK_WITNESS", "0").strip().lower()


def armed() -> bool:
    if _armed_override is not None:
        return _armed_override
    return _mode() not in ("", "0", "no", "false", "off")


def arm(reset: bool = True) -> _Witness:
    """Programmatic arming (a test fixture);
    returns the witness for assertions."""
    global _armed_override
    _armed_override = True
    if reset:
        _witness.reset()
    return _witness


def disarm() -> None:
    global _armed_override
    _armed_override = False


@contextlib.contextmanager
def armed_scope(reset: bool = True):
    """Arm for a scope, restoring the PRIOR override on exit — unlike a
    bare ``arm()``/``disarm()`` pair, an operator's
    ``STROM_LOCK_WITNESS=1``/``strict`` environment setting survives
    the scope (a test fixture: the first armed test's teardown must
    not silently disarm the rest of the run)."""
    global _armed_override
    prev = _armed_override
    w = arm(reset)
    try:
        yield w
    finally:
        _armed_override = prev


def _site() -> str:
    import inspect
    f = inspect.currentframe()
    # first frame OUTSIDE this module: `with lock:` adds an __enter__
    # frame and a direct lock.acquire() does not, so a fixed-depth walk
    # would blame the caller's caller in one of the two shapes
    here = __file__
    while f is not None and f.f_code.co_filename == here:
        f = f.f_back
    if f is None:
        return "?"
    return f"{f.f_code.co_filename}:{f.f_lineno}"


class _WitnessedLock:
    """Proxy over Lock/RLock.  Supports the full context-manager and
    acquire/release protocol (enough for ``threading.Condition`` to
    wrap it via its documented fallbacks)."""

    def __init__(self, name: str, reentrant: bool):
        self.name = name
        self.reentrant = reentrant
        self._inner = (threading.RLock() if reentrant
                       else threading.Lock())
        self._tls = threading.local()

    def _depth(self) -> int:
        return getattr(self._tls, "depth", 0)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        # disarmed mid-process (armed_scope exit): a surviving proxy in
        # a long-lived singleton must stop recording — plain
        # passthrough, no frame walks, no graph mutation
        if not armed() or _witness.suppressed():
            got = (self._inner.acquire(blocking, timeout)
                   if timeout >= 0 else self._inner.acquire(blocking))
            if got:
                self._tls.depth = self._depth() + 1
            return got
        if not blocking or timeout >= 0:
            # bounded/try acquires cannot deadlock; do not record order
            got = (self._inner.acquire(blocking, timeout) if blocking
                   else self._inner.acquire(False))
            if got:
                self._tls.depth = self._depth() + 1
                _witness._held().append(self.name)
            return got
        depth = self._depth()
        if depth > 0 and not self.reentrant:
            _witness.note_self_deadlock(self.name, _site())
        _witness.note_acquire(self.name, depth if self.reentrant else 0,
                              _site())
        self._inner.acquire()
        self._tls.depth = depth + 1
        return True

    def release(self) -> None:
        self._inner.release()
        self._tls.depth = max(0, self._depth() - 1)
        if not _witness.suppressed():
            _witness.note_release(self.name)

    def locked(self) -> bool:
        inner = self._inner
        if hasattr(inner, "locked"):     # Lock always; RLock only 3.14+
            return inner.locked()
        if self._depth() > 0:            # held by this thread
            return True
        # ownership probe, straight to the inner lock: a witness-side
        # try-acquire would record a phantom held entry
        if inner.acquire(False):
            inner.release()
            return False
        return True

    # -- threading.Condition integration ------------------------------------
    # Condition probes ownership via _is_owned when the lock provides
    # it; its try-acquire fallback reports False for the OWNER of a
    # reentrant lock (the owner CAN re-acquire), so every
    # wait()/notify() on a Condition over a witnessed RLock would
    # raise 'cannot wait/notify on un-acquired lock'.  The proxy
    # already tracks per-thread depth — answer from it.
    def _is_owned(self) -> bool:
        return self._depth() > 0

    def _release_save(self):
        # Condition.wait must release ALL re-entrant levels (RLock
        # semantics); going through the proxy keeps the witness's held
        # stack truthful across the wait
        depth = self._depth()
        for _ in range(depth):
            self.release()
        return depth

    def _acquire_restore(self, depth) -> None:
        for _ in range(depth):
            self.acquire()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<WitnessedLock {self.name} {self._inner!r}>"


def make_lock(name: str):
    """A ``threading.Lock`` — witness-wrapped when armed.  ``name`` is
    the lock's manifest id (analysis/lock_order.conf)."""
    if armed():
        return _WitnessedLock(name, reentrant=False)
    return threading.Lock()


def make_rlock(name: str):
    if armed():
        return _WitnessedLock(name, reentrant=True)
    return threading.RLock()


def make_condition(name: str, lock=None):
    """A ``threading.Condition`` over ``lock`` (which should itself come
    from :func:`make_lock`/:func:`make_rlock`, so the condition's
    acquisitions are witnessed through the shared underlying lock).
    With no ``lock``, one is created under ``name`` — never a plain
    internal RLock, which would silently escape the witness.

    NOTE: when ``lock`` is given, every runtime edge records under THAT
    lock's manifest id — ``name`` is call-site documentation only.  Put
    the LOCK's id in analysis/lock_order.conf; a rule written against
    the condition's name would never match an edge."""
    return threading.Condition(lock if lock is not None
                               else make_rlock(name))
