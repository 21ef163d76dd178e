"""Host-tier warm-state manifests, ``.warmhints.json`` (counterpart of
nvme_strom_tpu/io/warmup.py, with the reference's age-gated orphan sweep
of ``checkpoint/manager.py`` beside it).

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
whose file is gone is an orphan (:func:`find_orphan_manifests`, which
also lists the prefix store's ``.kvman.json``), removed only once older
than an age gate (:func:`sweep_orphan_manifests`), so a store being
recreated is never swept from under its process.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional, Sequence, Tuple

from nvme_strom_tpu_torch.io.plan import plan_and_submit
from nvme_strom_tpu_torch.utils.stats import atomic_write_text

#: the manifest's suffix beside its file
WARMHINT_SUFFIX = ".warmhints.json"
#: the prefix store's manifest (models/kv_offload.py), swept alike
KVMAN_SUFFIX = ".kvman.json"
SIDECAR_SUFFIXES = (KVMAN_SUFFIX, WARMHINT_SUFFIX)

_VERSION = 1


def hint_path(path: str) -> str:
    """``<path>.warmhints.json``."""
    return path + WARMHINT_SUFFIX


def collect_warm_hints(engine, path: str,
                       max_spans: int = 1024) -> Optional[str]:
    """Write ``path``'s spans resident in the host tier (largest first,
    at most ``max_spans``) into its manifest; the manifest's path, or
    None when there is nothing to write (tier off, no resident span,
    a zero budget, no such file)."""
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
                  max_spans: int = 1024) -> List[str]:
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


def _is_orphan(path: str, suffixes) -> bool:
    for suf in suffixes:
        if path.endswith(suf):
            return not os.path.exists(path[:-len(suf)])
    return False


def find_orphan_manifests(root: str, recursive: bool = True,
                          suffixes=SIDECAR_SUFFIXES) -> list:
    """Manifests under ``root`` whose file is gone, sorted."""
    out = []
    if recursive:
        for dirpath, _dirs, names in os.walk(root):
            out.extend(os.path.join(dirpath, n) for n in names
                       if _is_orphan(os.path.join(dirpath, n), suffixes))
    else:
        try:
            names = os.listdir(root)
        except OSError:
            return []
        out = [os.path.join(root, n) for n in names
               if _is_orphan(os.path.join(root, n), suffixes)]
    return sorted(out)


def sweep_orphan_manifests(paths, min_age: float) -> list:
    """Remove those of ``paths`` older than ``min_age`` seconds; the
    paths removed.  A race (removed meanwhile, no permission) skips the
    entry: debris is harmless, a wrong removal is not."""
    removed = []
    now = time.time()
    for p in paths:
        try:
            if now - os.path.getmtime(p) < min_age:
                continue
            os.unlink(p)
        except OSError:
            continue
        removed.append(p)
    return removed
