"""Live debug endpoint: the stack's state over plain HTTP (counterpart
of nvme_strom_tpu/obs/debugsrv.py).

With ``STROM_DEBUG_PORT`` set (unset by default: no thread, no socket)
the first engine of a process starts one loopback server, and every
later engine attaches as the live one.  Routes:

  ``/metrics``  OpenMetrics text of the live counter block
                (utils/stats.py ``openmetrics_from_snapshot``, the C
                counters drained first);
  ``/attrib``   the per-class attribution profiles (obs/attrib.py);
  ``/ledger``   the goodput/waste ledger and each ring's time in state
                (obs/ledger.py);
  ``/flight``   the flight recorder's recent ops and dump paths
                (io/flightrec.py);
  ``/health``   ring breaker states, device degradation, the health
                counters, and the ``boot_phase`` and ``drain_phase``
                gauges (io/health.py, io/coldstart.py, io/handoff.py);
  ``/locks``    the lock-order witness: whether it is armed, its mode,
                the acquisition edges it observed and the cycles it
                recorded (utils/lockwitness.py);
  ``/``         a JSON index of the routes.

One stdlib ``http.server`` daemon thread; each request serves a JSON (or
OpenMetrics) snapshot and changes nothing.  A route that raises answers
200 with ``{"error": ...}``.  ``STROM_DEBUG_PORT=0`` binds a port the OS
picks (:attr:`DebugServer.port`).
"""

from __future__ import annotations

import atexit
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from nvme_strom_tpu_torch.utils.lockwitness import make_lock

ROUTES = ("/metrics", "/attrib", "/ledger", "/flight", "/health",
          "/locks")


class DebugServer:
    """One process's debug endpoint: a loopback HTTP server over live
    references to the stats block, an engine and the attribution
    collector."""

    def __init__(self, stats, port: int = 0, host: str = "127.0.0.1"):
        self.stats = stats
        self._lock = make_lock("debugsrv.DebugServer._lock")
        self._engine = None
        self._closed = False
        srv = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):      # a triage tool: no access log
                pass

            def do_GET(self):
                srv._serve(self)

        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self.port = int(self._httpd.server_address[1])
        self.host = host
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="strom-debugsrv")
        self._thread.start()

    # -- the live engine ----------------------------------------------------

    def attach_engine(self, engine) -> None:
        with self._lock:
            self._engine = engine

    def detach_engine(self, engine) -> None:
        """Clear the reference if it is still ``engine`` (a later engine
        may have attached over a closing one)."""
        with self._lock:
            if self._engine is engine:
                self._engine = None

    def _eng(self):
        with self._lock:
            return self._engine

    # -- routing --------------------------------------------------------------

    def _serve(self, h) -> None:
        path = h.path.split("?", 1)[0].rstrip("/") or "/"
        routes = {"/metrics": self._metrics, "/attrib": self._attrib,
                  "/ledger": self._ledger, "/flight": self._flight,
                  "/health": self._health, "/locks": self._locks}
        try:
            if path == "/":
                body, ctype = json.dumps({"routes": list(ROUTES)}), \
                    "application/json"
            elif path in routes:
                body, ctype = routes[path]()
            else:
                h.send_error(404, "unknown route")
                return
        except Exception as e:         # a route answers, whatever failed
            body, ctype = json.dumps({"error": repr(e)}), "application/json"
        data = body.encode()
        h.send_response(200)
        h.send_header("Content-Type", ctype)
        h.send_header("Content-Length", str(len(data)))
        h.end_headers()
        h.wfile.write(data)

    def _snapshot(self) -> dict:
        eng = self._eng()
        if eng is not None:
            try:
                eng.sync_stats()    # the live C counters, not the last sync
            except Exception:
                pass
        return self.stats.snapshot()

    def _metrics(self):
        from nvme_strom_tpu_torch.utils.stats import openmetrics_from_snapshot
        return openmetrics_from_snapshot(self._snapshot()), \
            "text/plain; version=0.0.4"

    def _attrib(self):
        from nvme_strom_tpu_torch.obs.attrib import get_collector
        col = get_collector()
        doc = ({"enabled": False,
                "hint": "set STROM_ATTRIB=1 to collect attribution"}
               if col is None else {"enabled": True, **col.profiles()})
        return json.dumps(doc), "application/json"

    def _ledger(self):
        from nvme_strom_tpu_torch.obs.ledger import ledger_view
        return json.dumps(ledger_view(self._snapshot())), \
            "application/json"

    def _flight(self):
        eng = self._eng()
        flight = getattr(eng, "flight", None) if eng is not None else None
        if flight is None:
            doc = {"enabled": False}
        else:
            ops = flight.snapshot_ops()
            doc = {"enabled": True, "n_ops": len(ops), "ops": ops[-256:],
                   "dumps": flight.dumps,
                   "dump_paths": list(flight.dump_paths)}
        return json.dumps(doc, default=str), "application/json"

    def _health(self):
        snap = self._snapshot()
        eng = self._eng()
        sup = getattr(eng, "supervisor", None) if eng is not None else None
        doc = {
            "ring_health": (sup.ring_states() if sup is not None
                            else snap.get("ring_health", [])),
            "degraded": (bool(sup.degraded()) if sup is not None
                         else bool(snap.get("engine_degraded", 0))),
            "breaker_trips": int(snap.get("breaker_trips", 0)),
            "ring_restarts": int(snap.get("ring_restarts", 0)),
            "extents_requeued": int(snap.get("extents_requeued", 0)),
            "degraded_reads": int(snap.get("degraded_reads", 0)),
            "degraded_probes": int(snap.get("degraded_probes", 0)),
            # None for an ordinary boot; the cold start's phase otherwise
            "boot_phase": snap.get("boot_phase"),
            # None until a drain begins
            "drain_phase": snap.get("drain_phase"),
        }
        return json.dumps(doc), "application/json"

    def _locks(self):
        from nvme_strom_tpu_torch.utils import lockwitness
        w = lockwitness.witness()
        doc = {"armed": lockwitness.armed(),
               "mode": os.environ.get("STROM_LOCK_WITNESS", "0"),
               "edges": w.snapshot_edges(),
               "violations": list(w.violations)}
        return json.dumps(doc, default=list), "application/json"

    # -- lifecycle ------------------------------------------------------------

    def close(self) -> None:
        """Stop accepting, close the socket, join the thread
        (idempotent)."""
        if self._closed:
            return
        self._closed = True
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:
            pass
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -- the process's server (STROM_DEBUG_PORT) ---------------------------------

_singleton_lock = make_lock("debugsrv._singleton_lock")
_server: Optional[DebugServer] = None
_server_failed = False


def maybe_start_debug_server(stats, engine=None) -> Optional[DebugServer]:
    """Start the process's debug server the first time an engine comes
    up, only when ``STROM_DEBUG_PORT`` is set; later engines attach as
    the live engine.  A bad port or a refused bind is tried once."""
    global _server, _server_failed
    port = os.environ.get("STROM_DEBUG_PORT")
    if not port:
        return None
    with _singleton_lock:
        if _server is None and not _server_failed:
            try:
                _server = DebugServer(stats, port=int(port))
            except (OSError, ValueError):
                _server_failed = True
                return None
            atexit.register(_server.close)
        srv = _server
    if srv is not None and engine is not None:
        srv.attach_engine(engine)
    return srv


def reset() -> None:
    """Close and drop the process's server (tests)."""
    global _server, _server_failed
    with _singleton_lock:
        if _server is not None:
            _server.close()
        _server = None
        _server_failed = False
