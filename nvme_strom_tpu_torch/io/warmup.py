"""Host-tier warm-state manifests, ``.warmhints.json`` (counterpart of
nvme_strom_tpu/io/warmup.py).

A long-running replica's host-DRAM tier (io/hostcache.py) has learned
which spans the workload reads again; a restart loses that.
:func:`collect_warm_hints` writes one file's resident spans into an
atomically published ``<path>.warmhints.json``, and
:func:`prefetch_hints` replays it through the engine at ``prefetch``
class with ``hot=True`` during the cold start's warming phase
(io/coldstart.py), so the lines fill and pin behind live traffic.

A manifest records its file's size and mtime_ns: one written for an
older version of the file loads as empty, and so does a corrupt one,
another version's or one with a span past the file's end.  A manifest
whose file is gone is an orphan, swept with the other sidecars by
checkpoint/manager.py ``find_orphan_manifests`` and
``sweep_orphan_manifests`` once older than their age gate.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence, Tuple

from nvme_strom_tpu_torch.io.plan import plan_and_submit
from nvme_strom_tpu_torch.utils.config import ColdStartConfig
from nvme_strom_tpu_torch.utils.stats import atomic_write_text

#: the manifest's suffix beside its file
WARMHINT_SUFFIX = ".warmhints.json"

_VERSION = 1


def hint_path(path: str) -> str:
    """``<path>.warmhints.json``."""
    return path + WARMHINT_SUFFIX


def collect_warm_hints(engine, path: str,
                       max_spans: Optional[int] = None) -> Optional[str]:
    """Write ``path``'s spans resident in the host tier (largest first,
    at most ``max_spans``, default ``ColdStartConfig.warm_hint_spans``,
    ``STROM_WARM_HINT_SPANS``) into its manifest; the manifest's path,
    or None when there is nothing to write (tier off, no resident span,
    a zero budget, no such file)."""
    if max_spans is None:
        max_spans = ColdStartConfig().warm_hint_spans
    if max_spans <= 0:
        return None
    from nvme_strom_tpu_torch.io import hostcache
    cache = hostcache._cache     # the tier as it is: never built here
    if cache is None:
        return None
    try:
        st = os.stat(path)
    except OSError:
        return None
    fkey = (st.st_dev, st.st_ino, st.st_mtime_ns, st.st_size)
    spans = cache.resident_spans(fkey)[:max_spans]
    if not spans:
        return None
    out = hint_path(path)
    write_warm_hints(out, spans, size=st.st_size, mtime_ns=st.st_mtime_ns)
    return out


def refresh_hints(engine, paths: Sequence[str],
                  max_spans: Optional[int] = None) -> List[str]:
    """:func:`collect_warm_hints` for each of ``paths`` (duplicates and
    empty names skipped); the paths whose manifest was written."""
    out: List[str] = []
    seen = set()
    for p in paths:
        if not p or p in seen:
            continue
        seen.add(p)
        if collect_warm_hints(engine, p, max_spans=max_spans):
            out.append(p)
    return out


def write_warm_hints(manifest: str, spans: Sequence[Tuple[int, int]], *,
                     size: int, mtime_ns: int) -> None:
    """Publish a manifest atomically (temp file and rename)."""
    doc = {"version": _VERSION, "size": int(size), "mtime_ns": int(mtime_ns),
           "spans": [[int(o), int(n)] for o, n in spans]}
    atomic_write_text(manifest, json.dumps(doc, sort_keys=True))


def load_warm_hints(path: str) -> List[Tuple[int, int]]:
    """``path``'s hint spans, checked against the file as it is now:
    a missing, corrupt, other-version or stale manifest, or one with a
    span outside the file, gives ``[]``."""
    try:
        with open(hint_path(path), "r") as f:
            doc = json.load(f)
        st = os.stat(path)
    except (OSError, ValueError):
        return []
    if (not isinstance(doc, dict) or doc.get("version") != _VERSION
            or doc.get("size") != st.st_size
            or doc.get("mtime_ns") != st.st_mtime_ns):
        return []
    spans = []
    for item in doc.get("spans", []):
        try:
            off, ln = int(item[0]), int(item[1])
        except (TypeError, ValueError, IndexError):
            return []
        if off < 0 or ln <= 0 or off + ln > st.st_size:
            return []
        spans.append((off, ln))
    return spans


def prefetch_hints(engine, path: str,
                   spans: Optional[Sequence[Tuple[int, int]]] = None,
                   klass: str = "prefetch") -> int:
    """Read ``spans`` (the manifest's by default) of ``path`` at
    ``klass`` with ``hot=True`` and wait for them; the spans read.
    Best effort: a failure warms less and never raises."""
    if spans is None:
        spans = load_warm_hints(path)
    if not spans:
        return 0
    warmed = 0
    try:
        fh = engine.open(path)
        try:
            for pieces in plan_and_submit(
                    engine, [(fh, off, ln) for off, ln in spans],
                    klass=klass, hot=True):
                done = bool(pieces)
                for piece in pieces:
                    try:
                        piece.wait()
                    except OSError:
                        done = False
                    finally:
                        piece.release()
                warmed += done
        finally:
            engine.close(fh)
    except OSError:
        pass
    stats = getattr(engine, "stats", None)
    if stats is not None and warmed:
        stats.add(coldstart_warm_spans=warmed)
    return warmed
