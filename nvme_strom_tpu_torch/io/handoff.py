"""Drain and warm handoff: a retiring replica hands its live sessions and
warm state to its replacement (counterpart of nvme_strom_tpu/io/handoff.py,
with plain ``threading`` locks).

An integrator builds a :class:`DrainCoordinator` beside the server, and
under ``STROM_HANDOFF=1`` (``HandoffConfig.enabled``) retirement walks a
forward-only phase machine:

    serving ──drain requested──▶ draining ──in-flight done /
                                           │ deadline hit
                              bundle built ▼
              retired ◀──published── handing_off

* ``draining``: the server's admission gate is closed: new prefills
  defer (they stay queued, nothing fails) while in-flight sessions decode
  on for up to ``HandoffConfig.deadline_s``.  A drain that outlives its
  deadline with sessions still decoding dumps ``handoff_stall`` to the
  flight recorder, with the phase and the scheduler's backlog a class.
* ``handing_off``: the warm state ships in one atomic
  ``<base>.handoff.json`` bundle (temp file and rename): fresh
  ``.warmhints.json`` snapshots of the host tier, the prefix store's
  proven-drained flush and clean manifest, the cold-start claim table's
  residue (the tensors the old replica demand-faulted: its measured hot
  set), per-tenant SLO state and ledger, and the sessions still queued
  or decoding, exported as their prompt, the tokens already delivered
  and their prefix-store page keys.
* ``retired``: the bundle is published; the process may exit.

:func:`consume_bundle` replays a bundle in the replacement at boot:
exported sessions are re-admitted first, their prompt pages restored
from the prefix store instead of prefilled again; the hot set is
pre-faulted at ``restore`` class ahead of the bulk lane; the warm hints
replay at ``prefetch`` class through the cold-start coordinator's warming
phase.  A missing, torn or stale bundle counts one ``handoff_brownouts``
and the boot goes on as a plain cold start, with no error.  A
re-admitted session's delivered tokens are prefilled in one block step
where the retiring replica decoded them one at a time, so its
continuation is bitwise the undisturbed run's only in float32: in bf16
the other summation order can turn a greedy token.

The phase is the ``drain_phase`` gauge (and ``drain_phase_code``), and
a consumed bundle sets ``handoff_source``.  With the gate off a
coordinator never leaves ``serving``: ``begin_drain``, ``drain``,
``publish_bundle`` and :func:`install_drain_signals` do nothing, and
:func:`consume_bundle` returns None without a brown-out, so no counter
or gauge of this module moves.
Engine work (serving steps, the store's flush, hint collection, flight
dumps) runs outside the coordinator's lock.

The exit hook (:meth:`DrainCoordinator.final_snapshot`) flushes what a
TERM would lose: a last export of the stats block
(``StromStats.maybe_export``: the JSON snapshot at
``$STROM_STATS_EXPORT`` that ``tools/strom_stat.py`` reads, and the
OpenMetrics text at ``$STROM_METRICS_FILE``) and a forced flight dump
of the last operations.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

from nvme_strom_tpu_torch.utils.config import HandoffConfig
from nvme_strom_tpu_torch.utils.stats import atomic_write_text

#: drain phases in order; the index is the ``drain_phase_code`` gauge
DRAIN_PHASES = ("serving", "draining", "handing_off", "retired")

#: the bundle's suffix beside its anchor; checkpoint/manager.py sweeps
#: orphans of it with ``.kvman.json`` and ``.warmhints.json``
HANDOFF_SUFFIX = ".handoff.json"

_VERSION = 1


def bundle_path(base: str) -> str:
    """``<base>.handoff.json``: the bundle anchored to ``base`` (normally
    the prefix store's page file), whose stat validates it."""
    return base + HANDOFF_SUFFIX


def _stat_block(path: str) -> Optional[dict]:
    try:
        st = os.stat(path)
    except OSError:
        return None
    return {"size": st.st_size, "mtime_ns": st.st_mtime_ns}


def write_handoff_bundle(base: str, doc: dict) -> Optional[str]:
    """Publish ``doc`` as ``base``'s bundle atomically (temp file and
    rename: a reader sees the old bundle or the new one), stamped with
    the anchor's size and mtime_ns.  The bundle's path, or None when the
    anchor is gone."""
    anchor = _stat_block(base)
    if anchor is None:
        return None
    out = bundle_path(base)
    doc = dict(doc)
    doc["version"] = _VERSION
    doc["base"] = anchor
    atomic_write_text(out, json.dumps(doc, sort_keys=True))
    return out


def load_handoff_bundle(base: str) -> Optional[dict]:
    """``base``'s bundle, checked against the anchor as it is now; None
    for a missing, corrupt, other-version or stale bundle (the anchor
    rewritten since), one whose checkpoint changed since, or one with a
    malformed session."""
    try:
        with open(bundle_path(base), "r") as f:
            doc = json.load(f)
        st = os.stat(base)
    except (OSError, ValueError):
        return None
    if (not isinstance(doc, dict)
            or doc.get("version") != _VERSION
            or not isinstance(doc.get("base"), dict)
            or doc["base"].get("size") != st.st_size
            or doc["base"].get("mtime_ns") != st.st_mtime_ns):
        return None
    ck = doc.get("checkpoint")
    if ck is not None:
        # sessions and hot tensors of another checkpoint generation would
        # restore another model's state
        if (not isinstance(ck, dict)
                or _stat_block(str(ck.get("path", ""))) !=
                {"size": ck.get("size"), "mtime_ns": ck.get("mtime_ns")}):
            return None
    sessions = doc.get("sessions", [])
    if not isinstance(sessions, list):
        return None
    for s in sessions:
        try:
            if (not s["prompt"] or int(s["max_new"]) < 1
                    or not all(isinstance(t, int) for t in s["prompt"])
                    or not all(isinstance(t, int)
                               for t in s.get("emitted", []))):
                return None
        except (TypeError, KeyError, ValueError):
            return None
    return doc


class DrainCoordinator:
    """One replica's retirement: the drain phase machine, the server's
    closed admission gate, the stall dump and the bundle.  Thread-safe;
    construction changes nothing until :meth:`begin_drain` (or a signal
    handler of :func:`install_drain_signals`) fires, and with
    ``cfg.enabled`` off nothing does."""

    def __init__(self, engine=None, server=None,
                 cfg: Optional[HandoffConfig] = None,
                 checkpoint: Optional[str] = None,
                 hint_paths: Optional[Sequence[str]] = None,
                 bundle: Optional[str] = None) -> None:
        self.cfg = cfg or HandoffConfig()
        self.engine = engine
        self.server = server
        self.checkpoint = checkpoint
        self.hint_paths = list(hint_paths or [])
        self._bundle = bundle
        self._lock = threading.Lock()
        self._phase = "serving"
        self._t0 = time.monotonic()
        self._t_phase: Dict[str, float] = {"serving": 0.0}

    # -- the phase machine --------------------------------------------------

    @property
    def phase(self) -> str:
        with self._lock:
            return self._phase

    def phase_times(self) -> Dict[str, float]:
        """Seconds from construction at which each phase was entered."""
        with self._lock:
            return dict(self._t_phase)

    @property
    def bundle(self) -> Optional[str]:
        """Where the bundle goes: the given path, else beside the
        server's prefix store's page file; None with neither."""
        if self._bundle is not None:
            return self._bundle
        path = getattr(getattr(self.server, "kv_store", None), "path", None)
        return bundle_path(path) if path else None

    def _advance(self, new: str) -> bool:
        """Forward only: a late request never rewinds the machine.  True
        on a real transition."""
        with self._lock:
            if DRAIN_PHASES.index(new) <= DRAIN_PHASES.index(self._phase):
                return False
            self._phase = new
            self._t_phase[new] = round(time.monotonic() - self._t0, 6)
        stats = self._stats()
        if stats is not None:
            stats.set_gauges(drain_phase=new,
                             drain_phase_code=DRAIN_PHASES.index(new))
        return True

    def _stats(self):
        return getattr(self.engine, "stats", None)

    # -- the protocol -------------------------------------------------------

    def begin_drain(self) -> bool:
        """Enter ``draining`` and close the server's admission gate.
        Idempotent; True on the real transition, never with the gate
        off."""
        if not self.cfg.enabled or not self._advance("draining"):
            return False
        stats = self._stats()
        if stats is not None:
            stats.add(handoff_drains=1)
        if self.server is not None and hasattr(self.server, "begin_drain"):
            self.server.begin_drain()
        return True

    def drain(self, lookahead: int = 4,
              deadline_s: Optional[float] = None) -> Dict[str, object]:
        """The whole retirement: step the server until its in-flight
        sessions finish or ``deadline_s`` (default the config's) passes,
        then publish the bundle and retire.  Returns ``{"results": {rid:
        tokens}, "bundle": path}``: ``results`` are the sessions finished
        here; every other one rides the bundle, none is dropped.  With
        the gate off the server is left as it is and nothing is
        published."""
        if not self.cfg.enabled:
            return {"results": {}, "bundle": None}
        self.begin_drain()
        deadline = (self.cfg.deadline_s if deadline_s is None
                    else float(deadline_s))
        srv = self.server
        results: Dict[object, List[int]] = {}
        stalled = False
        t0 = time.monotonic()
        while srv is not None and not srv.idle:
            if time.monotonic() - t0 >= deadline:
                stalled = True
                break
            if all(s is None for s in srv.slots):
                # only deferred queue entries are left, and they export:
                # another step would spin on the closed gate
                break
            results.update(srv.step_many(lookahead))
        if stalled:
            self._stall_dump(time.monotonic() - t0, deadline)
        path = self.publish_bundle()
        self._advance("retired")
        return {"results": results, "bundle": path}

    def publish_bundle(self) -> Optional[str]:
        """Enter ``handing_off``, build the bundle and publish it.  Each
        part is best effort: one that cannot be collected ships empty,
        and the replacement's validation decides what it can use.  The
        bundle's path, or None with nothing to anchor it or the gate
        off."""
        if not self.cfg.enabled:
            return None
        self._advance("handing_off")
        out = self.bundle
        if out is None:
            return None
        base = out[:-len(HANDOFF_SUFFIX)]
        srv = self.server
        store = getattr(srv, "kv_store", None)
        stats = self._stats()

        # 1) sessions still queued or decoding, taken off the server so
        # that it ends idle
        sessions: List[dict] = []
        if srv is not None and hasattr(srv, "export_sessions"):
            sessions = srv.export_sessions(self.cfg.max_sessions, pop=True)

        # 2) the store's proven-drained flush: a session ships only the
        # page keys whose write was proven complete
        if store is not None:
            try:
                ready = set(store.flush_for_handoff())
            except Exception:   # noqa: BLE001 — the bundle ships without
                ready = set()   # pages; sessions then prefill again
            for s in sessions:
                s["kv_keys"] = [k for k in s.get("kv_keys", [])
                                if k in ready]

        # 3) fresh host-tier hint snapshots of every file served hot
        from nvme_strom_tpu_torch.io.warmup import refresh_hints
        paths = list(self.hint_paths)
        if store is not None and getattr(store, "path", None):
            paths.append(store.path)
        hints = refresh_hints(self.engine, paths)

        # 4) the claim table's residue: what requests could not wait for
        hot: List[str] = []
        names = getattr(getattr(srv, "_param_source", None), "fault_names",
                        None)
        if callable(names):
            try:
                hot = list(names())
            except Exception:   # noqa: BLE001 — best effort
                hot = []

        doc = {
            "checkpoint": (dict(_stat_block(self.checkpoint) or {},
                                path=self.checkpoint)
                           if self.checkpoint else None),
            "kv_manifest": (store.manifest_path
                            if store is not None else None),
            "warm_hints": hints,
            "hot_tensors": hot,
            "tenants": self._tenant_state(stats),
            "sessions": sessions,
        }
        path = write_handoff_bundle(base, doc)
        if path is not None and stats is not None:
            stats.add(handoff_bundles=1,
                      handoff_bundle_bytes=os.path.getsize(path),
                      handoff_sessions_exported=len(sessions))
        return path

    def _tenant_state(self, stats) -> Dict[str, dict]:
        """Each tenant's SLO boost and its counter ledger."""
        try:
            from nvme_strom_tpu_torch.io.tenants import get_registry
            out = get_registry().export_state()
        except Exception:   # noqa: BLE001 — best effort
            out = {}
        ledger = stats.tenant_stats if stats is not None else {}
        for tid, counters in ledger.items():
            out.setdefault(tid, {})["ledger"] = dict(counters)
        return out

    def _stall_dump(self, waited_s: float, deadline_s: float) -> None:
        flight = getattr(self.engine, "flight", None)
        if flight is None:
            return
        sched = getattr(self.engine, "scheduler", None)
        srv = self.server
        path = flight.dump("handoff_stall", extra={
            "drain_phase": self.phase,
            "waited_s": round(waited_s, 3),
            "deadline_s": deadline_s,
            "slots_busy": (sum(s is not None for s in srv.slots)
                           if srv is not None else 0),
            "queued": len(srv.queue) if srv is not None else 0,
            "backlog": sched.backlog() if sched is not None else {},
        })
        stats = self._stats()
        if path is not None and stats is not None:
            stats.add(handoff_stall_dumps=1)

    def final_snapshot(self, reason: str = "exit") -> None:
        """The exit flush a TERM would lose: a last export of the stats
        block and a forced flight dump of the last operations."""
        stats = self._stats()
        if stats is not None:
            try:
                stats.maybe_export()
            except Exception:   # noqa: BLE001 — the exit goes on
                pass
        flight = getattr(self.engine, "flight", None)
        if flight is None:
            return
        try:
            flight.dump("handoff_exit", extra={"drain_phase": self.phase,
                                               "reason": reason},
                        force=True)
        except Exception:   # noqa: BLE001 — the exit goes on
            pass


def install_drain_signals(coord: DrainCoordinator, signals=None,
                          chain: bool = True) -> Optional[dict]:
    """Under ``STROM_HANDOFF=1`` and ``STROM_DRAIN_ON_SIGTERM=1`` (the
    coordinator's config), install SIGTERM and SIGINT handlers that
    drain, publish and retire, then write the final snapshot.  With
    ``chain`` a handler then calls the handler it displaced, or raises
    ``SystemExit(128 + signal)`` for the default action.  Returns
    ``{signal: previous handler}`` for :func:`uninstall_drain_signals`,
    or None with either switch off."""
    import signal as _signal
    if not (coord.cfg.enabled and coord.cfg.drain_on_sigterm):
        return None
    sigs = tuple(signals or (_signal.SIGTERM, _signal.SIGINT))
    prev: dict = {}

    def _handler(signum, frame):
        try:
            coord.drain()
        finally:
            coord.final_snapshot(reason=f"signal {signum}")
            if chain:
                p = prev.get(signum)
                if callable(p):
                    p(signum, frame)
                elif p == _signal.SIG_DFL:
                    raise SystemExit(128 + signum)

    for s in sigs:
        prev[s] = _signal.signal(s, _handler)
    return prev


def uninstall_drain_signals(prev: Optional[dict]) -> None:
    """Put back the handlers :func:`install_drain_signals` displaced."""
    import signal as _signal
    for s, h in (prev or {}).items():
        _signal.signal(s, h)


# -- the receiving side -------------------------------------------------------

def consume_bundle(base: str, engine=None, server=None, coordinator=None,
                   checkpoint=None, stats=None,
                   cfg: Optional[HandoffConfig] = None) -> Optional[dict]:
    """Replay ``base``'s bundle into a freshly booted replica:

    * exported sessions are submitted first, as ``prompt + emitted``
      with the remaining budget; their prompt pages restore from the
      prefix store.  The result's ``sessions`` maps each id to the
      tokens already delivered, so the caller composes ``emitted +
      continuation``;
    * the hot set is pre-faulted at ``restore`` class on a thread
      (``checkpoint``: the ``FaultingCheckpoint``); a caller that tears
      the stack down early joins ``prefault_thread`` before closing the
      engine;
    * the warm hints replay at ``prefetch`` class, through
      ``coordinator.add_warmup`` when given, else at once;
    * the tenants' boosts are re-applied (under ``STROM_TENANTS=1``) and
      their ledgers folded into ``stats``.

    A missing, torn or stale bundle returns None and counts one
    ``handoff_brownouts``.  With the gate off (``cfg.enabled``, by
    default ``STROM_HANDOFF``) it returns None and counts nothing."""
    if not (cfg or HandoffConfig()).enabled:
        return None
    stats = stats if stats is not None else getattr(engine, "stats", None)
    doc = load_handoff_bundle(base)
    if doc is None:
        if stats is not None:
            stats.add(handoff_brownouts=1)
        return None

    restored = 0
    sessions: Dict[object, List[int]] = {}
    for s in doc.get("sessions", []):
        emitted = [int(t) for t in s.get("emitted", [])]
        prompt = [int(t) for t in s["prompt"]] + emitted
        rid = s.get("rid")
        if server is not None:
            try:
                server.submit(rid, prompt, int(s["max_new"]),
                              eos_id=s.get("eos_id"),
                              temperature=float(s.get("temperature", 0.0)),
                              top_p=float(s.get("top_p", 1.0)),
                              seed=int(s.get("seed", 0)),
                              tenant=s.get("tenant"))
            except (ValueError, TypeError):
                continue   # one bad session never costs the others
        sessions[rid] = emitted
        restored += 1
    if restored and stats is not None:
        stats.add(handoff_sessions_restored=restored)

    hot = [str(n) for n in doc.get("hot_tensors", [])]
    prefault_thread = None
    if hot and checkpoint is not None and hasattr(checkpoint, "get"):
        def _prefault(names=tuple(hot), ckpt=checkpoint):
            for name in names:
                try:
                    ckpt.get(name, klass="restore")
                except Exception:   # noqa: BLE001 — the bulk lane still
                    return          # loads every tensor
        prefault_thread = threading.Thread(target=_prefault,
                                           name="strom-handoff-hot",
                                           daemon=True)
        prefault_thread.start()

    hints = [str(p) for p in doc.get("warm_hints", [])]
    n_hints = 0
    if engine is not None and hints:
        from nvme_strom_tpu_torch.io.warmup import prefetch_hints
        if coordinator is not None and hasattr(coordinator, "add_warmup"):
            for p in hints:
                coordinator.add_warmup(
                    lambda eng=engine, pp=p: prefetch_hints(eng, pp))
            n_hints = len(hints)
        else:
            for p in hints:
                n_hints += 1 if prefetch_hints(engine, p) else 0

    _restore_tenants(doc.get("tenants", {}), stats)
    if stats is not None:
        stats.set_gauges(handoff_source="bundle")
    return {"sessions": sessions, "restored": restored, "hints": n_hints,
            "hot_tensors": len(hot), "prefault_thread": prefault_thread,
            "bundle": bundle_path(base)}


def _restore_tenants(state: Dict[str, dict], stats) -> None:
    """Re-apply the tenants' SLO boosts and fold their shipped ledgers
    into ``stats``."""
    if not state:
        return
    try:
        from nvme_strom_tpu_torch.io.tenants import (get_registry,
                                                     tenants_enabled)
        if tenants_enabled():
            get_registry().restore_state(state)
    except Exception:   # noqa: BLE001 — isolation state is best effort
        pass
    if stats is None:
        return
    for tid, st in state.items():
        ledger = st.get("ledger") if isinstance(st, dict) else None
        if isinstance(ledger, dict):
            try:
                stats.add_tenant_stat(tid, **{k: int(v)
                                              for k, v in ledger.items()})
            except (TypeError, ValueError):
                pass


__all__ = ["DRAIN_PHASES", "HANDOFF_SUFFIX", "DrainCoordinator",
           "bundle_path", "consume_bundle", "install_drain_signals",
           "load_handoff_bundle", "uninstall_drain_signals",
           "write_handoff_bundle"]
