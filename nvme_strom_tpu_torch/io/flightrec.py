"""Flight recorder: a bounded ring of recent I/O op records that dumps
itself to disk when a failure trigger fires (counterpart of
nvme_strom_tpu/io/flightrec.py).

Every completed engine read and write, and every degraded pread,
appends one tuple (class, ring, bytes, latency, outcome) to a
``deque(maxlen=N)``: one append an op, no lock on that path.  The
supervisor's breaker trip, ring restart and device-degraded verdicts
(io/health.py), the SLO governor (models/kv_offload.py), the servers'
tenant storms (models/serving.py), the cold-start stall
(io/coldstart.py) and the step watchdog (utils/watchdog.py) call
:meth:`FlightRecorder.dump`, which writes one atomic JSON file: the
recent ops, their latency p50/p99 and the engine's ``StromStats``
snapshot.  Dumps are rate-limited per reason, and each one written
counts ``flight_dumps``.  A dump is named
``strom_flight_<pid>_<reason>_<n>.json`` with ``n`` numbered across the
process (the reference numbers them per recorder, so two engines'
dumps of one reason overwrote each other).

Knobs (``FlightConfig``): ``STROM_FLIGHT`` (default on),
``STROM_FLIGHT_OPS``, ``STROM_FLIGHT_DIR`` (default the system temp
directory), ``STROM_FLIGHT_MIN_S``.  With an attribution collector
attached (``attrib``: the engine sets it under ``STROM_ATTRIB=1``,
obs/attrib.py), each dump also carries its ``summary()``: where recent
requests' time went when the trigger fired.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import tempfile
import time
from typing import Optional

from nvme_strom_tpu_torch.utils.config import FlightConfig
from nvme_strom_tpu_torch.utils.lockwitness import make_lock
from nvme_strom_tpu_torch.utils.stats import Log2Histogram, atomic_write_text

#: dump numbers, process-wide: two engines' recorders never write one
#: file name
_DUMP_SEQ = itertools.count(1)

#: the field order of an op record (the dump labels the tuples)
FIELDS = ("t_s", "kind", "klass", "ring", "fh", "offset", "bytes",
          "latency_us", "outcome", "err")


class FlightRecorder:
    """The op ring and trigger dumps of one engine."""

    def __init__(self, config: Optional[FlightConfig] = None,
                 stats=None):
        self.cfg = config or FlightConfig()
        self.stats = stats
        self._ops: collections.deque = collections.deque(
            maxlen=self.cfg.ops)
        self._lat = Log2Histogram()
        self._dump_lock = make_lock("flightrec.FlightRecorder._dump_lock")
        #: reason → monotonic time of its last dump (the rate limit is
        #: per reason: a breaker trip's dump must not hide the SLO
        #: violation's that follows it)
        self._last_dump: dict = {}
        self.dumps = 0
        #: paths written, newest last (the last 16)
        self.dump_paths: list = []
        #: an obs/attrib.py AttributionCollector whose summary each dump
        #: embeds (None: no ``attrib`` field)
        self.attrib = None

    def record(self, kind: str, klass: Optional[str], ring: int,
               fh: int, offset: int, nbytes: int, latency_us: int,
               outcome: str, err: Optional[int] = None) -> None:
        """Append one completed op.  An error record carries no latency
        (0) and stays out of the latency histogram."""
        self._ops.append((time.time(), kind, klass, ring, fh, offset,
                          nbytes, latency_us, outcome, err))
        if latency_us > 0:
            self._lat.observe(latency_us)

    def __len__(self) -> int:
        return len(self._ops)

    def snapshot_ops(self) -> list:
        """The recent ops as dicts, oldest first."""
        return [dict(zip(FIELDS, op)) for op in list(self._ops)]

    def dump(self, reason: str, extra: Optional[dict] = None,
             force: bool = False) -> Optional[str]:
        """Write the dump for ``reason``; its path, or None when the
        reason dumped less than ``min_interval_s`` ago (``force``
        bypasses that) or the write failed.  Never raises: a full disk
        must not turn a brown-out into a crash."""
        with self._dump_lock:
            now = time.monotonic()
            if not force and now - self._last_dump.get(reason, -1e9) \
                    < self.cfg.min_interval_s:
                return None
            ops = self.snapshot_ops()
            doc = {"reason": reason, "ts": time.time(), "pid": os.getpid(),
                   "n_ops": len(ops),
                   "latency_us_p50": self._lat.percentile(50),
                   "latency_us_p99": self._lat.percentile(99), "ops": ops}
            if extra:
                doc["extra"] = dict(extra)
            if self.stats is not None:
                doc["stats"] = self.stats.snapshot()
            if self.attrib is not None:
                try:
                    doc["attrib"] = self.attrib.summary()
                except Exception:
                    pass     # a dump never fails on its summary
            safe = "".join(c if c.isalnum() or c in "-_" else "_"
                           for c in reason)[:48]
            path = os.path.join(self.cfg.dir or tempfile.gettempdir(),
                                f"strom_flight_{os.getpid()}_{safe}_"
                                f"{next(_DUMP_SEQ)}.json")
            try:
                atomic_write_text(path, json.dumps(doc, default=str))
            except OSError:
                # nothing was written: the window stays open for the
                # next trigger of this reason
                return None
            self._last_dump[reason] = now
            self.dumps += 1
        if self.stats is not None:
            self.stats.add(flight_dumps=1)
        self.dump_paths.append(path)
        del self.dump_paths[:-16]
        return path


def flight_of(engine) -> Optional[FlightRecorder]:
    """The recorder behind any engine-shaped object (wrappers delegate
    attribute access); None when disabled or absent."""
    return getattr(engine, "flight", None)
