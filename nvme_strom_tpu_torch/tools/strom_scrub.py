"""strom_scrub — the offline CRC32C scrub of data at rest, and the sweep
of crashed saves' debris.

``STROM_VERIFY`` checks bytes as they are read; this tool walks a
checkpoint directory, a shard set or a KV prefix store, re-reads every
stamped span through the engine and names each file that holds damage:
which checkpoints can still be trusted after a suspected corruption.
It also removes the ``.tmp_step_*`` staging directories of crashed saves
and the orphaned sidecars (``.kvman.json``, ``.warmhints.json``,
``.handoff.json`` whose base file is gone), as ``CheckpointManager``
does at start, for directories no manager will open again.

    python -m nvme_strom_tpu_torch.tools.strom_scrub CKPT_DIR
    python -m nvme_strom_tpu_torch.tools.strom_scrub CKPT_DIR --gc
    python -m nvme_strom_tpu_torch.tools.strom_scrub SHARD_DIR --stamp
    python -m nvme_strom_tpu_torch.tools.strom_scrub model.safetensors

Exit code 0 clean, 1 damage, 2 usage or I/O error; ``--json`` prints
one line (the damage list and the counters).  Stamps: the safetensors
writers' ``crc32c.*`` metadata, the ``<file>.crc.json`` sidecars of
utils/checksum.py (WebDataset, fixedrec, TFRecord), and the prefix
store's ``.kvman.json`` manifest; every byte checked counts
``bytes_verified``.  Counterpart of nvme_strom_tpu/tools/strom_scrub.py:
either package scrubs what the other wrote, with the same report.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from nvme_strom_tpu_torch.checkpoint.manager import (_TMP_RE,
                                                     SIDECAR_SUFFIXES,
                                                     _gc_min_age,
                                                     _newest_mtime,
                                                     sweep_orphan_manifests)


def _engine(config=None):
    from nvme_strom_tpu_torch.io.faults import build_engine
    return build_engine(config)


def _crc_spans(eng, fh, spans) -> Dict[int, tuple]:
    """CRC32C of each ``(offset, length)`` span, read in chunks with
    half the queue depth in flight (a scrub is a bulk sequential read:
    at depth 1 it would hide the device's rate) and constant staging
    memory.  Returns ``{span index: (crc or None, error or None)}``."""
    from nvme_strom_tpu_torch.io.engine import crc32c, wait_exact
    chunk = eng.config.chunk_bytes
    depth = max(2, eng.config.queue_depth // 2)
    acc: Dict[int, int] = {}      # span → running crc (waits in order)
    done: Dict[int, tuple] = {}
    pend: List[tuple] = []        # (PendingRead, span index, is last)

    def drain_one():
        p, si, last = pend.pop(0)
        if si in done:            # the span already failed
            try:
                wait_exact(p)
            except OSError:
                pass
            finally:
                p.release()
            return
        try:
            crcv = crc32c(wait_exact(p), acc.pop(si, 0))
        except OSError as e:
            done[si] = (None, e)
            return
        finally:
            p.release()
        if last:
            done[si] = (crcv, None)
        else:
            acc[si] = crcv

    empty = crc32c(np.zeros(0, np.uint8))
    for si, (off, ln) in enumerate(spans):
        if ln == 0:
            done[si] = (empty, None)
            continue
        pos = 0
        while pos < ln and si not in done:
            n = min(chunk, ln - pos)
            pend.append((eng.submit_read(fh, off + pos, n, klass="scrub"),
                         si, pos + n == ln))
            pos += n
            while len(pend) >= depth:
                drain_one()
    while pend:
        drain_one()
    return done


def _scrub_stamped_spans(eng, path: str, spans, where_key: str
                         ) -> List[dict]:
    """Check the stamped spans of one file: ``spans`` are (offset,
    length, stamp, where) and ``where_key`` names the field of a damage
    entry ("tensor", "offset" or "page")."""
    try:
        fh = eng.open(path)
    except OSError as e:
        # an unopenable file is damage to report, never a crash
        return [{"file": path, where_key: spans[0][3] if spans else "",
                 "error": f"unreadable: {e}"}]
    try:
        got = _crc_spans(eng, fh, [(s[0], s[1]) for s in spans])
    finally:
        eng.close(fh)
    damage: List[dict] = []
    for si, (_off, ln, expected, wv) in enumerate(spans):
        crcv, err = got.get(si, (None, "not read"))
        if err is not None:
            damage.append({"file": path, where_key: wv,
                           "error": f"read failed: {err}"})
            continue
        eng.stats.add(bytes_verified=int(ln))
        if crcv != expected:
            eng.stats.add(checksum_failures=1)
            damage.append({"file": path, where_key: wv,
                           "error": f"crc32c {crcv:#010x} != "
                                    f"stamped {expected:#010x}"})
    return damage


def scrub_safetensors(eng, path: str) -> List[dict]:
    """The damage list of one safetensors file: one entry a failing or
    unreadable stamped tensor."""
    from nvme_strom_tpu_torch.formats.safetensors import (SafetensorsFile,
                                                          tensor_checksums)
    try:
        sf = SafetensorsFile(path)
        stamps = tensor_checksums(sf)
    except (OSError, ValueError) as e:
        return [{"file": path, "error": f"unreadable: {e}"}]
    if not stamps:
        return [{"file": path, "error": "unstamped (no crc32c metadata)",
                 "unstamped": True}]
    damage: List[dict] = []
    spans = []
    for name, expected in sorted(stamps.items()):
        t = sf.tensors.get(name)
        if t is None:
            damage.append({"file": path, "tensor": name,
                           "error": "stamped tensor missing"})
            continue
        spans.append((t["offset"], t["nbytes"], expected, name))
    damage.extend(_scrub_stamped_spans(eng, path, spans, "tensor"))
    return damage


def scrub_sidecar_file(eng, path: str, sc=None) -> List[dict]:
    """The damage list of one data shard against its ``.crc.json``
    sidecar (``sc``: the sidecar already parsed)."""
    if sc is None:
        from nvme_strom_tpu_torch.utils.checksum import load_sidecar
        sc = load_sidecar(path)
    if sc is None:
        return [{"file": path, "error": "unstamped (no .crc.json "
                                        "sidecar)", "unstamped": True}]
    spans = [(off,) + sc.spans[off] + (off,) for off in sorted(sc.spans)]
    return _scrub_stamped_spans(eng, path, spans, "offset")


def scrub_kv_store(eng, path: str) -> List[dict]:
    """The damage list of one KV prefix store's page file against the
    CRC32C stamps of its ``.kvman.json`` manifest
    (models/kv_offload.py ``PrefixStore``)."""
    man_path = path + ".kvman.json"
    try:
        with open(man_path) as f:
            man = json.load(f)
    except (OSError, ValueError) as e:
        return [{"file": path, "error": f"unreadable manifest "
                                        f"{man_path}: {e}"}]
    pb = int(man.get("page_bytes", 0))
    if man.get("version") != 1 or pb <= 0:
        return [{"file": path,
                 "error": f"unsupported kv manifest {man_path}"}]
    spans = [(int(slot) * pb, pb, int(row["crc"]), int(slot))
             for slot, row in sorted(man.get("pages", {}).items(),
                                     key=lambda kv: int(kv[0]))]
    if not spans:
        return []
    return _scrub_stamped_spans(eng, path, spans, "page")


def stamp_file(path: str) -> Optional[str]:
    """Write the sidecar of an unstamped shard (its format from the
    suffix, else a fixedrec footer); the sidecar's path, or None."""
    from nvme_strom_tpu_torch.utils import checksum as ck
    if path.endswith(".tar"):
        return ck.stamp_wds(path)
    if path.endswith((".tfrecord", ".tfrecords")):
        return ck.stamp_tfrecord(path)
    try:
        from nvme_strom_tpu_torch.formats.fixedrec import FixedRecIndex
        FixedRecIndex(path)
        return ck.stamp_fixedrec(path)
    except (OSError, ValueError):
        return None


def find_tmp_dirs(root: str) -> List[str]:
    """Crashed saves' staging directories under ``root``, at any depth."""
    out = []
    for dirpath, dirnames, _ in os.walk(root):
        for name in list(dirnames):
            if _TMP_RE.match(name):
                out.append(os.path.join(dirpath, name))
                dirnames.remove(name)    # never into debris
    return sorted(out)


def _orphan_suffix(path: str) -> Optional[str]:
    """The sidecar suffix of ``path`` (checkpoint/manager.py
    ``SIDECAR_SUFFIXES``), or None."""
    return next((s for s in SIDECAR_SUFFIXES if path.endswith(s)), None)


def collect_targets(path: str) -> Dict[str, List[str]]:
    """``{kind: paths}`` under ``path``: safetensors files, shards that
    can carry a sidecar, KV stores (a page file beside its
    ``.kvman.json``, whatever its name), and orphaned sidecars whose
    base file is gone (``--gc`` sweeps them)."""
    st: List[str] = []
    shards: List[str] = []
    kvstores: List[str] = []
    orphans: List[str] = []

    def one(p: str, name: str, walking: bool) -> None:
        suf = _orphan_suffix(name)
        if suf is not None:
            base = p[:-len(suf)]
            if not os.path.exists(base):
                orphans.append(p)
            elif suf == ".kvman.json" and not walking:
                kvstores.append(base)
            return
        if os.path.exists(p + ".kvman.json"):
            kvstores.append(p)
        elif name.endswith(".safetensors"):
            st.append(p)
        elif not walking or name.endswith((".tar", ".tfrecord",
                                           ".tfrecords", ".fixedrec",
                                           ".bin")):
            shards.append(p)

    if os.path.isfile(path):
        one(path, path, walking=False)
    else:
        for dirpath, dirnames, filenames in os.walk(path):
            dirnames[:] = [d for d in dirnames if not _TMP_RE.match(d)]
            for name in sorted(filenames):
                one(os.path.join(dirpath, name), name, walking=True)
    return {"safetensors": st, "shards": shards, "kvstores": kvstores,
            "orphan_manifests": sorted(orphans)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="strom_scrub",
        description="offline checksum scrubber and crashed-save GC")
    ap.add_argument("path", help="checkpoint dir, shard dir, or file")
    ap.add_argument("--gc", action="store_true",
                    help="remove .tmp_step_* staging dirs of crashed saves "
                         "and orphaned sidecars older than "
                         "STROM_CKPT_GC_AGE_S (default 3600 s), so a "
                         "live save is never swept")
    ap.add_argument("--force", action="store_true",
                    help="with --gc: whatever their age")
    ap.add_argument("--stamp", action="store_true",
                    help="write CRC32C sidecars for unstamped shards "
                         "instead of reporting them")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="one machine-readable JSON line")
    args = ap.parse_args(argv)

    if not os.path.exists(args.path):
        print(f"strom_scrub: {args.path}: no such path", file=sys.stderr)
        return 2
    targets = collect_targets(args.path)
    report: dict = {"path": args.path, "files_scanned": 0,
                    "damage": [], "unstamped": [], "stamped": [],
                    "tmp_dirs": [], "tmp_dirs_removed": [],
                    "tmp_dirs_live": [], "orphan_manifests": [],
                    "orphan_manifests_removed": []}
    try:
        return _scan(args, targets, report)
    except Exception as e:      # engine creation, the walk, other I/O
        # 1 is for damage: a scrub that could not run is not a verdict
        print(f"strom_scrub: error: {e}", file=sys.stderr)
        return 2


def _gc_tmp_dirs(args, report) -> None:
    tmp = find_tmp_dirs(args.path)
    report["tmp_dirs"] = tmp
    if not args.gc:
        return
    # the manager's age gate: a fresh staging dir may be a live save
    min_age = 0.0 if args.force else _gc_min_age()
    now = time.time()
    for t in tmp:
        try:
            fresh = now - _newest_mtime(t) < min_age
        except OSError:
            fresh = True     # removed meanwhile: leave it
        if fresh:
            report["tmp_dirs_live"].append(t)
            continue
        shutil.rmtree(t, ignore_errors=True)
        if os.path.exists(t):
            report["damage"].append({"file": t,
                                     "error": "staging dir could not be "
                                              "removed (permission?)"})
            continue
        report["tmp_dirs_removed"].append(t)


def _scan(args, targets, report) -> int:
    from nvme_strom_tpu_torch.utils.checksum import load_sidecar
    eng = _engine()
    try:
        for p in targets["safetensors"]:
            report["files_scanned"] += 1
            for d in scrub_safetensors(eng, p):
                (report["unstamped"] if d.get("unstamped")
                 else report["damage"]).append(d)
        for p in targets["kvstores"]:
            report["files_scanned"] += 1
            report["damage"].extend(scrub_kv_store(eng, p))
        for p in targets["shards"]:
            sc = load_sidecar(p)
            if sc is None:
                if args.stamp and stamp_file(p):
                    report["stamped"].append(p)
                    continue
                report["unstamped"].append(
                    {"file": p, "error": "unstamped", "unstamped": True})
                continue
            report["files_scanned"] += 1
            report["damage"].extend(scrub_sidecar_file(eng, p, sc))
        if os.path.isdir(args.path):
            _gc_tmp_dirs(args, report)
        report["orphan_manifests"] = list(targets["orphan_manifests"])
        if args.gc:
            report["orphan_manifests_removed"] = sweep_orphan_manifests(
                report["orphan_manifests"],
                0.0 if args.force else _gc_min_age())
        eng.sync_stats()
        snap = eng.stats.snapshot()
        report["bytes_verified"] = int(snap.get("bytes_verified", 0))
        report["checksum_failures"] = int(snap.get("checksum_failures", 0))
    finally:
        eng.close_all()
    _print_report(args, report)
    return 1 if report["damage"] else 0


def _print_report(args, report) -> None:
    if args.as_json:
        print(json.dumps(report, sort_keys=True))
        return
    print(f"scrubbed {report['files_scanned']} file(s), "
          f"{report['bytes_verified']} bytes verified")
    for d in report["damage"]:
        where = d.get("tensor", d.get("offset", d.get("page", "")))
        print(f"  DAMAGED {d['file']}"
              f"{' [' + str(where) + ']' if where != '' else ''}: "
              f"{d['error']}")
    for u in report["unstamped"]:
        print(f"  unstamped {u['file']} (run --stamp, or re-save "
              f"with a current writer)")
    for p in report["stamped"]:
        print(f"  stamped {p}")
    for t in report["tmp_dirs"]:
        if t in report["tmp_dirs_removed"]:
            tag = "removed"
        elif t in report["tmp_dirs_live"]:
            tag = ("recently written — possibly a live save "
                   "(--force to remove anyway)")
        else:
            tag = "crashed-save debris (use --gc)"
        print(f"  tmp {t}: {tag}")
    for m in report["orphan_manifests"]:
        tag = ("removed" if m in report["orphan_manifests_removed"]
               else "orphaned kv manifest — page file gone (use --gc)")
        print(f"  orphan {m}: {tag}")
    if not report["damage"]:
        print("no damage found")


if __name__ == "__main__":
    sys.exit(main())
