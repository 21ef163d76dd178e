"""Fault injection at the submit/wait boundary (counterpart of
nvme_strom_tpu/io/faults.py): every failure mode of the chain NVMe →
staging buffer → device, reproducible on demand, so the recovery paths
(``io/resilient.py``, the loader's shard quarantine, the checkpoint
restore's step-back) are testable without flaky hardware:

    plan   = FaultPlan.parse("eio:p=0.05, delay:every=100:delay_s=0.2")
    engine = FaultyEngine(StromEngine(), plan)

``FaultyEngine`` wraps any engine-shaped object and grafts faults onto
the pending reads and writes it hands out.  Read kinds:

    eio      the read failed                          → OSError(EIO)
    short    fewer bytes than asked                   → truncated view
    delay    a latency straggler                      → wait blocks longer
    stuck    a wedged request                         → waits time out
    bitflip  one byte flipped in flight               → in the staging view
    estorm   the next max_count matching reads all fail, then clean

and write kinds (checkpoint saves, KV eviction):

    weio     the write failed                         → OSError(EIO)
    wenospc  the namespace filled up                  → OSError(ENOSPC)
    wshort   fewer bytes committed than submitted     → short wait() count
    wdelay   a write-completion straggler             → wait blocks longer

A faulted read still hands back the engine's own staging view (a
``short`` fault a prefix of it, a ``bitflip`` flips a byte inside it),
never a copy, so a recovered read reaches ``h2d_copy`` from registered
memory as a clean one does.  ``crash_point(name)`` marks the checkpoint
save's crash windows; ``STROM_CRASH_POINT=<name>`` ends the process
there (``os._exit(137)``).

Plans are deterministic: decisions come from ``random.Random(seed)`` in
submit order, the same decisions in the same order as the JAX package's
plan for the same text and seed.  Below Python, the C engine honours
``STROM_FAULT_READ_EIO_EVERY`` / ``_SHORT_EVERY`` / ``_DELAY_MS`` and
``STROM_FAULT_WRITE_EIO_EVERY`` / ``_ENOSPC_EVERY`` / ``_SHORT_EVERY`` /
``_DELAY_MS`` at engine creation (csrc/strom_io.cc), and
``STROM_FAULT_RING_STALL_RING`` / ``_AFTER`` wedge one ring after its
first N dispatches; :func:`set_ring_stall` arms or disarms that stall on
a live engine.  An ``estorm`` drives the supervisor's device breaker
(io/health.py) through the resilient engine's failed attempts.  Every
injected fault is counted
(``StromStats.faults_injected``), tallied per kind on the plan and
traced as a ``strom.fault.<kind>`` span.
"""

from __future__ import annotations

import errno
import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

READ_FAULT_KINDS = ("eio", "short", "delay", "stuck", "bitflip",
                    "estorm")
WRITE_FAULT_KINDS = ("weio", "wenospc", "wshort", "wdelay")
FAULT_KINDS = READ_FAULT_KINDS + WRITE_FAULT_KINDS


def set_ring_stall(engine, ring: int, on: bool = True) -> None:
    """Arm or disarm the C engine's stall injection on ``ring`` of a live
    engine, under any FaultyEngine or ResilientEngine wrappers (the stall
    lives below them all: the ring's requests park at dispatch and never
    complete).  The env twins ``STROM_FAULT_RING_STALL_RING`` /
    ``STROM_FAULT_RING_STALL_AFTER`` arm it at engine creation."""
    base = engine
    while getattr(base, "_engine", None) is not None \
            and not hasattr(base, "set_ring_stall"):
        base = base._engine
    base.set_ring_stall(ring, on)


def crash_point(name: str) -> None:
    """Deterministic crash injection: when ``$STROM_CRASH_POINT`` equals
    ``name``, the process dies HERE (``os._exit`` — no atexit, no
    flushes, exactly what a power loss or OOM-kill leaves behind).
    Instrumented at the checkpoint commit sequence's crash windows
    (checkpoint/manager.py): ``ckpt.tiles``, ``ckpt.marker`` (a
    multi-process ``save_async``'s done marker durable, the commit
    pending), ``ckpt.meta``, ``ckpt.rename``.  One environment read when
    the variable is unset."""
    want = os.environ.get("STROM_CRASH_POINT")
    if want and want == name:
        os._exit(137)


@dataclass(frozen=True)
class FaultSpec:
    """One fault class plus its trigger rule.

    Triggering: ``every`` (deterministic: the Nth, 2Nth, ... matching
    read) wins over ``p`` (per-read probability from the plan's seeded
    rng).  ``max_count`` bounds total injections from this spec
    (0 = unlimited).  ``path_substr`` restricts injection to reads of
    files whose path contains the substring ("" = all files).
    """

    kind: str
    p: float = 1.0
    every: int = 0
    max_count: int = 0
    #: delay/stuck duration (seconds).  Negative (the default) resolves
    #: per kind in __post_init__: 0.05 for a latency spike, 300 for
    #: 'stuck': far past any reasonable stuck_timeout, so
    #: cancel-and-retry always fires first, yet finite, so an abandoned
    #: stuck read cannot hang teardown forever
    delay_s: float = -1.0
    #: errno raised by 'eio' faults
    err: int = errno.EIO
    #: fraction of the payload kept by 'short' faults
    frac: float = 0.5
    path_substr: str = ""

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; one of {FAULT_KINDS}")
        if not 0 <= self.p <= 1:
            raise ValueError(f"p ({self.p}) must be in [0, 1]")
        if self.every < 0 or self.max_count < 0:
            raise ValueError("every/max_count must be >= 0")
        if self.delay_s < 0:   # auto: same default however constructed
            object.__setattr__(
                self, "delay_s", 300.0 if self.kind == "stuck" else 0.05)
        if not 0 <= self.frac < 1:
            raise ValueError(f"frac ({self.frac}) must be in [0, 1)")
        if self.kind == "wenospc" and self.err == errno.EIO:
            # the kind IS the errno: 'wenospc' without an explicit err=
            # models the namespace filling up
            object.__setattr__(self, "err", errno.ENOSPC)
        if self.kind == "estorm" and self.max_count == 0:
            # a storm is bounded: max_count consecutive failures, then
            # clean (every/p are ignored)
            object.__setattr__(self, "max_count", 16)

    @property
    def is_write(self) -> bool:
        return self.kind in WRITE_FAULT_KINDS


_SPEC_FLOAT = {"p", "delay_s", "frac"}
_SPEC_INT = {"every", "max_count", "err"}


class FaultPlan:
    """A seeded, ordered list of FaultSpecs; decides per submitted
    request (reads and writes draw from separate taxonomy halves of
    the same plan — see ``decide``'s ``op``).

    The first spec whose trigger matches wins, so ordering encodes
    priority.  ``injected`` tallies injections per kind; the engine's
    ``StromStats.faults_injected`` counts them all.  Decisions are taken
    under a lock, so readers on several threads never push a spec past
    its ``max_count``.
    """

    def __init__(self, specs, seed: int = 0):
        self.specs: List[FaultSpec] = list(specs)
        self.seed = seed
        self._rng = random.Random(seed)
        self._reads = 0
        self._matches: Dict[int, int] = {}   # spec index → matching reads
        self._fired: Dict[int, int] = {}     # spec index → injections
        self.injected: Dict[str, int] = {}   # kind → injections
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, text: str, seed: int = 0) -> "FaultPlan":
        """``"eio:p=0.1, delay:every=3:delay_s=0.2"`` → FaultPlan.

        Comma-separated specs; each is ``kind[:key=value]...``.  Keys are
        the FaultSpec fields (p, every, max_count, delay_s, err, frac,
        path).  'stuck' without an explicit delay_s defaults to 300 s.
        """
        specs = []
        for part in filter(None, (s.strip() for s in text.split(","))):
            kind, _, rest = part.partition(":")
            kw: dict = {}
            for item in filter(None, (s.strip() for s in rest.split(":"))):
                key, eq, val = item.partition("=")
                if not eq:
                    raise ValueError(
                        f"fault spec {part!r}: expected key=value, "
                        f"got {item!r}")
                if key == "path":
                    kw["path_substr"] = val
                elif key in _SPEC_FLOAT:
                    kw[key] = float(val)
                elif key in _SPEC_INT:
                    kw[key] = int(val)
                else:
                    raise ValueError(
                        f"fault spec {part!r}: unknown key {key!r}")
            specs.append(FaultSpec(kind=kind, **kw))
        return cls(specs, seed=seed)

    @classmethod
    def from_env(cls) -> Optional["FaultPlan"]:
        """Plan from ``$STROM_FAULTS`` (+ ``$STROM_FAULTS_SEED``); None
        when unset — the zero-cost production default."""
        text = os.environ.get("STROM_FAULTS")
        if not text:
            return None
        return cls.parse(text, seed=int(os.environ.get(
            "STROM_FAULTS_SEED", "0")))

    def decide(self, path: str = "", op: str = "read"
               ) -> Optional[FaultSpec]:
        """Fault for the next submitted request (None = runs clean).
        ``op`` selects the taxonomy half: read specs never fire on
        writes and vice versa, so one plan can chaos both directions
        of the chain with independent triggers."""
        with self._lock:
            return self._decide(path, op)

    def _decide(self, path: str, op: str) -> Optional[FaultSpec]:
        self._reads += 1
        want_write = op == "write"
        for i, spec in enumerate(self.specs):
            if spec.is_write != want_write:
                continue
            if spec.path_substr and spec.path_substr not in path:
                continue
            if spec.max_count and self._fired.get(i, 0) >= spec.max_count:
                continue
            n = self._matches[i] = self._matches.get(i, 0) + 1
            if spec.kind == "estorm":
                hit = True      # consecutive until max_count exhausts
            elif spec.every:
                hit = n % spec.every == 0
            else:
                hit = self._rng.random() < spec.p
            if hit:
                self._fired[i] = self._fired.get(i, 0) + 1
                self.injected[spec.kind] = \
                    self.injected.get(spec.kind, 0) + 1
                return spec
        return None

    def corrupt_byte(self, length: int) -> tuple[int, int]:
        """(index, xor mask) for a bitflip — from the plan's own rng so
        corruption position replays with the seed."""
        with self._lock:
            return (self._rng.randrange(max(1, length)),
                    1 << self._rng.randrange(8))


class FaultyRead:
    """A PendingRead with a fault grafted onto its wait/release path.

    Honors the engine contract exactly: ``wait(timeout=...)`` raises
    TimeoutError with the request STILL LIVE; errors release the staging
    buffer before raising (mirroring PendingRead.wait); ``is_ready`` is a
    non-throwing probe; ``release`` is idempotent.
    """

    def __init__(self, inner, spec: FaultSpec, plan: FaultPlan):
        self._inner = inner
        self._spec = spec
        self._plan = plan
        self._t0 = time.monotonic()
        self._view: Optional[np.ndarray] = None
        self._error: Optional[OSError] = None
        self._released = False

    @property
    def was_fallback(self) -> bool:
        return self._inner.was_fallback

    @property
    def length(self) -> int:
        """Bytes requested at submit — NOT shrunk by a 'short' fault:
        consumers compare the completed view against this to detect
        exactly that truncation."""
        return self._inner.length

    @property
    def fh(self) -> int:
        return getattr(self._inner, "fh", -1)

    @property
    def offset(self) -> int:
        return getattr(self._inner, "offset", -1)

    @property
    def ring(self) -> int:
        """Failure-domain attribution rides through the fault layer."""
        return getattr(self._inner, "ring", -1)

    def _remaining_delay(self) -> float:
        if self._spec.kind not in ("delay", "stuck"):
            return 0.0
        return self._spec.delay_s - (time.monotonic() - self._t0)

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        if self._view is not None:
            return self._view
        if self._error is not None:
            raise self._error
        remain = self._remaining_delay()
        if remain > 0:
            # latency spike / wedged request: the underlying read may be
            # long done, but this request refuses to complete yet
            if timeout is not None and timeout < remain:
                time.sleep(timeout)
                raise TimeoutError(
                    f"read still in flight after {timeout}s "
                    f"(injected {self._spec.kind})")
            time.sleep(remain)
            if timeout is not None:
                timeout = max(0.0, timeout - remain)
        if self._spec.kind in ("eio", "estorm"):
            self._error = OSError(self._spec.err,
                                  os.strerror(self._spec.err)
                                  + " (injected)")
            self._inner.release()
            raise self._error
        view = self._inner.wait(
            timeout=None if timeout is None else max(0.0, timeout))
        if self._spec.kind == "short" and view.nbytes > 0:
            view = view[:int(view.nbytes * self._spec.frac)]
        elif self._spec.kind == "bitflip" and view.nbytes > 0:
            idx, mask = self._plan.corrupt_byte(view.nbytes)
            # flip in the staging view itself — exactly what in-flight
            # corruption looks like to every downstream consumer
            view[idx] ^= mask
        self._view = view
        return view

    def is_ready(self) -> bool:
        if self._view is not None or self._error is not None \
                or self._released:
            return True
        if self._remaining_delay() > 0:
            return False
        # eio included: completed-with-error counts as ready (wait() will
        # raise) — mirrors PendingRead.is_ready caching semantics
        return self._inner.is_ready()

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        self._view = None
        self._inner.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


class FaultyWrite:
    """A PendingWrite with a write fault grafted onto its wait path.

    Honors the write contract exactly: ``wait()`` returns the byte
    count actually committed (a ``wshort`` fault shrinks it — the
    signal the resilient write mirror resubmits on); error kinds
    release the request before raising (PendingWrite.wait parity);
    ``release`` is idempotent.
    """

    def __init__(self, inner, spec: FaultSpec):
        self._inner = inner
        self._spec = spec
        self._t0 = time.monotonic()
        self._released = False

    @property
    def fh(self) -> int:
        return getattr(self._inner, "fh", -1)

    @property
    def offset(self) -> int:
        return getattr(self._inner, "offset", -1)

    @property
    def length(self) -> int:
        return getattr(self._inner, "length", 0)

    @property
    def ring(self) -> int:
        return getattr(self._inner, "ring", -1)

    def wait(self, timeout: Optional[float] = None) -> int:
        if self._spec.kind == "wdelay":
            remain = self._spec.delay_s - (time.monotonic() - self._t0)
            if remain > 0:
                if timeout is not None and timeout < remain:
                    time.sleep(timeout)
                    raise TimeoutError(
                        f"write still in flight after {timeout}s "
                        f"(injected wdelay)")
                time.sleep(remain)
                if timeout is not None:
                    timeout = max(0.0, timeout - remain)
        n = self._inner.wait(timeout)
        self._released = True
        if self._spec.kind in ("weio", "wenospc"):
            raise OSError(self._spec.err,
                          os.strerror(self._spec.err) + " (injected)")
        if self._spec.kind == "wshort" and n > 1:
            return int(n * self._spec.frac)
        return n

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        self._inner.release()


def build_engine(config=None, stats=None, tracer=None):
    """The engine every consumer builds by default (weights, loader,
    checkpoints, trainer, servers, ``generate``): a StromEngine, wrapped
    per the environment so any run becomes a chaos and/or self-healing
    run without code changes:

    - ``STROM_FAULTS`` set   → FaultyEngine with the environment's plan
      (``STROM_FAULTS_SEED`` seeds it)
    - ``STROM_RESILIENT=1``  → ResilientEngine on top (retry, hedge and
      stuck cancel per the ``STROM_RETRY_*`` / ``STROM_HEDGE_*`` /
      ``STROM_STUCK_*`` knobs of ResilientConfig)

    Both unset (the default): the bare engine, no added indirection.
    """
    from nvme_strom_tpu_torch.io.engine import StromEngine

    eng = StromEngine(config, stats=stats, tracer=tracer)
    plan = FaultPlan.from_env()
    if plan is not None:
        eng = FaultyEngine(eng, plan)
    if os.environ.get("STROM_RESILIENT", "0") == "1":
        from nvme_strom_tpu_torch.io.resilient import ResilientEngine
        eng = ResilientEngine(eng)
    return eng


class FaultyEngine:
    """Engine wrapper injecting a FaultPlan at the submit boundary.

    Transparent to consumers (ShardedLoader, CheckpointManager,
    ResilientEngine): everything but ``open``/``close`` and the three
    submit paths (``submit_read``/``submit_readv``/``submit_write``)
    delegates to the wrapped engine.  Stack under ResilientEngine —
    ``ResilientEngine(FaultyEngine(StromEngine(), plan))`` — so
    recoveries (read AND write) are exercised against the injected
    faults.
    """

    def __init__(self, engine, plan: Optional[FaultPlan] = None):
        self._engine = engine
        self.plan = plan if plan is not None else FaultPlan.from_env()
        if self.plan is None:
            self.plan = FaultPlan([])
        self._paths: Dict[int, str] = {}

    def open(self, path, **kw) -> int:
        fh = self._engine.open(path, **kw)
        self._paths[fh] = str(path)
        return fh

    def close(self, fh: int) -> None:
        self._paths.pop(fh, None)
        self._engine.close(fh)

    def _maybe_fault(self, pending, fh: int, offset: int, length: int,
                     op: str = "read"):
        """Per-request injection decision + accounting, shared by the
        scalar, vectored, and write submit paths."""
        spec = self.plan.decide(self._paths.get(fh, ""), op=op)
        if spec is None:
            return pending
        self.stats.add(faults_injected=1)
        tracer = self.tracer
        if tracer.enabled:
            now = time.monotonic_ns()
            tracer.add_span(f"strom.fault.{spec.kind}", now, now,
                            category="strom.fault", fh=fh, offset=offset,
                            length=length)
        if op == "write":
            return FaultyWrite(pending, spec)
        return FaultyRead(pending, spec, self.plan)

    def submit_read(self, fh: int, offset: int, length: int,
                    klass: Optional[str] = None):
        # scalar routing stays class-blind (engine contract); the tag
        # rides through for flight-recorder attribution only
        pending = self._engine.submit_read(fh, offset, length,
                                           klass=klass)
        return self._maybe_fault(pending, fh, offset, length)

    def submit_readv(self, reads, klass: Optional[str] = None) -> list:
        """Vectored path: ONE batched submission through the wrapped
        engine (``klass`` rides along to the QoS scheduler below), then
        a PER-EXTENT injection decision — a chaos plan hits individual
        spans of a batch exactly as a real device fails individual
        commands of a multi-command submission."""
        from nvme_strom_tpu_torch.io.plan import submit_spans
        reads = list(reads)
        pendings = submit_spans(self._engine, reads, klass=klass)
        return [self._maybe_fault(p, fh, offset, length)
                for (fh, offset, length), p in zip(reads, pendings)]

    def submit_write(self, fh: int, offset: int, data):
        """Write-path injection: the wrapped engine's write goes down
        unchanged; the handed-back PendingWrite carries the fault
        (weio/wenospc/wshort/wdelay) into its ``wait``."""
        pending = self._engine.submit_write(fh, offset, data)
        return self._maybe_fault(pending, fh, offset,
                                 getattr(pending, "length", 0),
                                 op="write")

    def read(self, fh: int, offset: int, length: int) -> np.ndarray:
        with self.submit_read(fh, offset, length) as p:
            out = p.wait().copy()
        self.stats.add(bounce_bytes=int(out.nbytes))
        return out

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._engine.close_all()
