"""ssd2gpu_test — the chunked NVMe → card read test, with a byte-exact
check and the same-minute ceilings.

The flow of PG-Strom's ``ssd2gpu_test`` (counterpart of
nvme_strom_tpu/tools/ssd2tpu_test.py): CHECK_FILE, the backing device,
the extents, an engine of ``--chunk-bytes`` × ``--depth``, then chunked
reads with ``--depth`` in flight to one of:

  --dest host    the file into the engine's staging buffers (the raw
                 NVMe → host rate);
  --dest device  the file onto the card through ``DeviceStream``: each
                 chunk's copy reads its staging buffer in place with the
                 ``h2d_copy`` kernel (kernel 1);
  --dest null    submit, wait and release without touching a byte.

``--verify`` hashes every chunk (for ``--dest device``, read back from
the card after the timed window; past ``VERIFY_HOLD_BYTES`` the chunks
are checked and dropped with the clock stopped; the blocks the window
keeps are taken from the card's allocator before the clock) against a
plain ``pread`` of its range; ``--verify-pread`` adds a byte-for-byte
comparison of each chunk.

``--ceilings`` measures the headline of ``BASELINE.json`` in the same
minute: for ``--trials`` trials, in turns, the file to staging (the
raw-SSD ceiling), ``h2d_copy`` of the same bytes from one page-locked
buffer in chunks with ``--depth`` copies in flight (the host → device
ceiling at the stream's chunk and depth), and the stream itself; it
prints each leg's GiB/s and the stream's share of the lower ceiling.

    python -m nvme_strom_tpu_torch.tools.ssd2gpu_test FILE --dest device --verify
    python -m nvme_strom_tpu_torch.tools.ssd2gpu_test FILE --ceilings --verify

The last line of standard output is one JSON object (the run, or the
ceilings).  Exit code 1 when a check fails or a read failed.  The card is
``--device`` (default ``cuda:0``; ``cpu`` runs the plain copies).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import sys
import time

import numpy as np

from nvme_strom_tpu_torch.utils.stats import human_bytes as _human

#: device bytes a checked ``--dest device`` run holds before it reads
#: them back with the clock stopped
VERIFY_HOLD_BYTES = 4 << 30


def make_test_file(path: str, size: int) -> None:
    """Seeded pseudo-random bytes, so a verify is stable."""
    rng = np.random.default_rng(0xC0FFEE)
    with open(path, "wb") as f:
        left = size
        while left > 0:
            n = min(left, 64 << 20)
            f.write(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
            left -= n


def _say(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def describe(path: str) -> dict:
    """CHECK_FILE, the backing device and the extents of ``path``,
    printed to standard error; returns check_file's record."""
    from nvme_strom_tpu_torch.io.engine import (block_device, check_file,
                                                file_extents)
    info = check_file(path)
    _say(f"CHECK_FILE: size={_human(info['size'])} "
         f"O_DIRECT={'yes' if info['supports_direct'] else 'NO (fallback)'} "
         f"block={info['block_size']} fs_magic={info['fs_magic']:#x}")
    dev = block_device(path)
    if dev["device"]:
        topo = f"device={dev['device']} nvme={'yes' if dev['is_nvme'] else 'no'}"
        if dev["is_raid"]:
            topo += (f" md-raid{dev['raid_level']} "
                     f"members=[{', '.join(dev['members'])}]")
        topo += (" — NVMe-backed" if dev["nvme_backed"]
                 else " — not NVMe-backed")
        _say(topo)
    else:
        _say("device: no visible backing blockdev (overlay/tmpfs?)")
    try:
        exts = file_extents(path)
    except OSError as e:      # diagnostics only
        _say(f"extents: probe failed ({e.strerror})")
        exts = []
    if exts and not exts[0]["synthetic"]:
        _say(f"extents: {len(exts)} "
             f"(largest {_human(max(e['length'] for e in exts))}, "
             f"smallest {_human(min(e['length'] for e in exts))})")
    elif exts:
        _say("extents: not physically mapped (no FIEMAP)")
    return info


def engine_config(chunk_bytes: int, depth: int, no_uring: bool = False):
    """An engine of ``chunk_bytes`` buffers, ``depth`` deep, whose pool
    holds at least ``depth + 2`` chunks."""
    from nvme_strom_tpu_torch.utils.config import EngineConfig
    return EngineConfig(
        chunk_bytes=chunk_bytes, queue_depth=depth,
        buffer_pool_bytes=max(chunk_bytes * (depth + 2),
                              EngineConfig().buffer_pool_bytes),
        use_io_uring=not no_uring)


class _Check:
    """The check of one run: each chunk's sha256 against a ``pread``
    of its range (and, with ``exact``, its bytes).  The chunks tile the
    range in order, so every chunk equal is the whole range equal."""

    def __init__(self, path: str, exact: bool):
        self.f = open(path, "rb")
        self.exact = exact
        self.chunks = 0
        self.mismatches: list = []

    def chunk(self, off: int, ln: int, got: np.ndarray) -> None:
        got = np.ascontiguousarray(got).reshape(-1).view(np.uint8)
        self.f.seek(off)
        ref = self.f.read(ln)
        self.chunks += 1
        if got.nbytes != ln or (
                hashlib.sha256(got.tobytes()).digest()
                != hashlib.sha256(ref).digest()) or (
                self.exact and not np.array_equal(
                    np.frombuffer(ref, np.uint8), got)):
            self.mismatches.append(off)
            print(f"VERIFY MISMATCH at offset {off} len {ln}",
                  file=sys.stderr)

    def close(self) -> None:
        self.f.close()


def read_host(eng, fh, ranges, depth, check) -> tuple:
    """``ranges`` into staging, ``depth`` in flight; (payload bytes,
    fallback chunks).  ``check`` (or None) sees each view."""
    pending: list = []
    payload = fallback = 0

    def drain():
        nonlocal payload, fallback
        pr, off, ln = pending.pop(0)
        try:
            view = pr.wait()
            payload += view.nbytes
            fallback += bool(pr.was_fallback)
            if check is not None:
                check.chunk(off, ln, view)
        finally:
            pr.release()

    try:
        for off, ln in ranges:
            pending.append((eng.submit_read(fh, off, ln), off, ln))
            if len(pending) >= depth:
                drain()
        while pending:
            drain()
    finally:
        for pr, _, _ in pending:
            try:
                pr.wait()
            except OSError:
                pass
            pr.release()
    return payload, fallback


def _sync(dev) -> None:
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize(dev)


def _warm_allocator(dev, sizes) -> None:
    """Take device blocks of ``sizes`` from the caching allocator and
    give them back, so that the tensors a timed window keeps reuse them
    and no ``cudaMalloc`` falls inside the window."""
    if dev.type != "cuda":
        return
    import torch
    blocks = [torch.empty(n, dtype=torch.uint8, device=dev) for n in sizes]
    del blocks


def _read_device(eng, fh, ranges, depth, dev, check,
                 warm_alloc: bool = True) -> tuple:
    """``ranges`` onto ``dev`` through ``DeviceStream.stream_ranges``;
    (payload bytes, seconds of the window, seconds checking).  Checked
    chunks stay on the card until the window ends, or until they pass
    ``VERIFY_HOLD_BYTES``, when they are read back with the clock
    stopped.  The device blocks the window keeps (every chunk up to
    ``VERIFY_HOLD_BYTES`` when checked, else the stream's ``3 × depth``
    in flight) are taken from the allocator once before the clock,
    unless ``warm_alloc`` is false."""
    from nvme_strom_tpu_torch.ops.bridge import DeviceStream
    stream = DeviceStream(eng, device=dev, depth=depth)
    keep = []
    for _, ln in (ranges if check is not None else ranges[:3 * depth + 2]):
        if sum(keep) + ln > VERIFY_HOLD_BYTES:
            break
        keep.append(ln)
    if warm_alloc:
        _warm_allocator(dev, keep)
    held: list = []       # (offset, length, device tensor)
    held_bytes = payload = 0
    check_s = 0.0

    def read_back():
        nonlocal held_bytes, check_s
        t0 = time.monotonic()
        for off, ln, t in held:
            check.chunk(off, ln, t.cpu().numpy())
        held.clear()
        held_bytes = 0
        check_s += time.monotonic() - t0

    t0 = time.monotonic()
    paused = 0.0
    for (off, ln), t in zip(ranges, stream.stream_ranges(fh, ranges)):
        payload += t.numel()
        if check is not None:
            held.append((off, ln, t))
            held_bytes += ln
            if held_bytes >= VERIFY_HOLD_BYTES:
                _sync(dev)
                before = check_s
                read_back()
                paused += check_s - before
    _sync(dev)
    window = time.monotonic() - t0 - paused
    if check is not None:
        read_back()
    return payload, window, check_s


def run(args: argparse.Namespace) -> int:
    path = args.file
    made_temp = False
    if path is None:
        path = os.path.join(args.tmpdir or ".", "ssd2gpu_test.bin")
        _say(f"no file given — generating {_human(args.make_bytes)} test "
             f"file at {path}")
        make_test_file(path, args.make_bytes)
        made_temp = True
    try:
        if args.ceilings:
            return _ceilings(args, path)
        res, rc = one_run(path, args.dest, args.chunk_bytes, args.depth,
                          args.total_bytes, verify=args.verify,
                          exact=args.verify_pread,
                          force_buffered=args.force_buffered,
                          no_uring=args.no_uring, device=args.device,
                          warm_alloc=not args.cold_alloc)
        print(json.dumps(res))
        return rc
    finally:
        if made_temp and not args.keep:
            os.unlink(path)


def one_run(path, dest, chunk_bytes, depth, total_bytes=None,
            verify=False, exact=False, force_buffered=False,
            no_uring=False, device=None, quiet=False,
            warm_alloc=True) -> tuple:
    """One read of ``path`` to ``dest``; (result dict, exit code)."""
    from nvme_strom_tpu_torch.io.faults import build_engine
    from nvme_strom_tpu_torch.ops.bridge import h2d_copy
    from nvme_strom_tpu_torch.utils.stats import StromStats
    info = describe(path) if not quiet else None
    size = os.path.getsize(path)
    limit = min(total_bytes or size, size)
    cfg = engine_config(chunk_bytes, depth, no_uring)
    check = _Check(path, exact) if verify and dest != "null" else None
    dev = None
    if dest == "device":
        from nvme_strom_tpu_torch.device import resolve_device
        dev = resolve_device(device)
    rc = 0
    launches = h2d_copy.launches
    check_s = 0.0
    eng = build_engine(cfg, stats=StromStats())
    try:
        if not quiet:
            _say(f"engine: backend={eng.backend} "
                 f"chunk={_human(cfg.chunk_bytes)} depth={depth} "
                 f"pool={eng.n_buffers} bufs")
        if dev is not None and dev.type == "cuda":
            eng.cuda_mapping(dev.index)     # page-lock before the clock
        fh = eng.open(path, force_buffered=force_buffered)
        ranges = [(o, min(cfg.chunk_bytes, limit - o))
                  for o in range(0, limit, cfg.chunk_bytes)]
        fallback = 0
        try:
            if dev is not None:
                payload, dt, check_s = _read_device(
                    eng, fh, ranges, depth, dev, check, warm_alloc)
            else:
                t0 = time.monotonic()
                payload, fallback = read_host(
                    eng, fh, ranges, depth,
                    check if dest == "host" else None)
                dt = time.monotonic() - t0
        finally:
            eng.close(fh)
        eng.sync_stats()
        snap = eng.stats.snapshot()
    finally:
        eng.close_all()
        if check is not None:
            check.close()
    if check is not None and (check.mismatches
                              or check.chunks != len(ranges)):
        rc = 1
    if snap.get("requests_failed", 0):
        rc = 1
    gib_s = payload / (1 << 30) / dt if dt > 0 else 0.0
    res = {
        "file": path, "bytes": payload, "seconds": dt,
        "gib_per_s": gib_s, "dest": dest,
        "chunk_bytes": cfg.chunk_bytes, "depth": depth,
        "chunks": len(ranges), "fallback_chunks": fallback,
        "verify": ("ok" if check is not None and rc == 0 else
                   "FAILED" if check is not None else "skipped"),
        "chunks_verified": check.chunks if check is not None else 0,
        "verify_seconds": check_s,
        "warm_alloc": warm_alloc if dest == "device" else None,
        "h2d_copy_launches": h2d_copy.launches - launches,
        "o_direct": bool(info["supports_direct"]) if info else None,
        "bytes_direct": int(snap.get("bytes_direct", 0)),
        "bytes_fallback": int(snap.get("bytes_fallback", 0)),
        "bounce_bytes": int(snap.get("bounce_bytes", 0)),
        "stats": snap,
    }
    if not quiet:
        _say(f"{_human(payload)} in {dt:.3f}s = {gib_s:.3f} GiB/s "
             f"({fallback} fallback chunks, bounce "
             f"{_human(res['bounce_bytes'])})")
    return res, rc


def h2d_ceiling(dev, chunk_bytes: int, total_bytes: int, buffers: int = 1,
                inflight: int = 8, repeats: int = 1) -> dict:
    """GiB/s of ``total_bytes`` copied to ``dev`` by ``h2d_copy`` in
    ``chunk_bytes`` pieces from ``buffers`` page-locked buffers in
    turn, ``inflight`` copies in flight on the bridge's side stream (as
    the stream's copies go): the host → device ceiling at a stream's
    chunk and depth.  Median of ``repeats`` passes after one warm-up
    copy; ``launches`` counts the timed copies' kernel launches."""
    import torch
    from nvme_strom_tpu_torch.ops.bridge import (h2d_copy, host_to_device,
                                                 pinned_mapping)
    pinned = dev.type == "cuda"
    bufs = []
    for i in range(buffers):
        t = torch.empty(chunk_bytes, dtype=torch.uint8, pin_memory=pinned)
        t.numpy()[:] = np.random.default_rng(i).integers(
            0, 256, chunk_bytes, dtype=np.uint8)
        bufs.append(t)
    maps = [pinned_mapping(t, dev) for t in bufs] if pinned else []
    hosts = [t.numpy() for t in bufs]
    sizes = [min(chunk_bytes, total_bytes - o)
             for o in range(0, total_bytes, chunk_bytes)]
    host_to_device(None, hosts[0][:sizes[0]], dev,
                   mappings=maps).synchronize()
    launches = h2d_copy.launches
    times = []
    for _ in range(repeats):
        pending: list = []
        t0 = time.monotonic()
        for i, n in enumerate(sizes):
            pending.append(host_to_device(None, hosts[i % buffers][:n], dev,
                                          mappings=maps))
            if len(pending) > inflight:
                pending.pop(0).synchronize()
        for t in pending:
            t.synchronize()
        times.append(time.monotonic() - t0)
    dt = statistics.median(times)
    return {"gib_per_s": total_bytes / (1 << 30) / dt, "seconds": dt,
            "launches": h2d_copy.launches - launches}


def _ceilings(args, path: str) -> int:
    """``--trials`` trials of the three legs in turns (the order
    rotates a trial), then the medians and the stream's share of the
    lower ceiling."""
    from nvme_strom_tpu_torch.device import resolve_device
    describe(path)
    size = os.path.getsize(path)
    limit = min(args.total_bytes or size, size)
    legs = ("ssd", "h2d", "stream")
    trials = []
    rc = 0
    for k in range(args.trials):
        trial = {}
        for leg in legs[k % 3:] + legs[:k % 3]:
            if leg == "h2d":
                trial[leg] = h2d_ceiling(resolve_device(args.device),
                                         args.chunk_bytes, limit,
                                         inflight=args.depth)
                continue
            dest = "host" if leg == "ssd" else "device"
            res, r = one_run(path, dest, args.chunk_bytes, args.depth,
                             args.total_bytes,
                             verify=args.verify and leg == "stream",
                             exact=args.verify_pread,
                             force_buffered=args.force_buffered,
                             no_uring=args.no_uring, device=args.device,
                             quiet=True, warm_alloc=not args.cold_alloc)
            rc |= r
            trial[leg] = {k2: res[k2] for k2 in (
                "gib_per_s", "seconds", "bytes", "chunks", "verify",
                "chunks_verified", "h2d_copy_launches", "bytes_direct",
                "bytes_fallback", "bounce_bytes")}
        trials.append(trial)
        _say(f"trial {k + 1}: " + ", ".join(
            f"{leg} {trial[leg]['gib_per_s']:.3f} GiB/s" for leg in legs))
    med = {leg: statistics.median(t[leg]["gib_per_s"] for t in trials)
           for leg in legs}
    lower = min(med["ssd"], med["h2d"])
    out = {"ceilings": True, "file": path, "bytes": limit,
           "chunk_bytes": args.chunk_bytes, "depth": args.depth,
           "warm_alloc": not args.cold_alloc, "trials": trials,
           "median_gib_per_s": med,
           "lower_ceiling": "ssd" if med["ssd"] <= med["h2d"] else "h2d",
           "stream_share_of_lower_ceiling": (med["stream"] / lower
                                             if lower > 0 else None)}
    _say(f"medians: raw SSD {med['ssd']:.3f}, host→device {med['h2d']:.3f},"
         f" stream {med['stream']:.3f} GiB/s; stream = "
         f"{out['stream_share_of_lower_ceiling']:.4f} of the lower ceiling "
         f"({out['lower_ceiling']})")
    print(json.dumps(out))
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ssd2gpu_test",
        description="NVMe → card chunked read test (PG-Strom's "
                    "ssd2gpu_test)")
    ap.add_argument("file", nargs="?", default=None,
                    help="file to read (generated if omitted)")
    ap.add_argument("--chunk-bytes", type=int, default=8 << 20)
    ap.add_argument("--depth", type=int, default=8,
                    help="reads (and copies) kept in flight")
    ap.add_argument("--total-bytes", type=int, default=None,
                    help="stop after this many bytes")
    ap.add_argument("--dest", choices=("host", "device", "null"),
                    default="host")
    ap.add_argument("--device", default="cuda:0",
                    help="the card of --dest device and --ceilings "
                         "('cpu': the plain copies)")
    ap.add_argument("--verify", action="store_true",
                    help="each chunk's sha256 (read back from the card "
                         "for --dest device) against a pread's")
    ap.add_argument("--verify-pread", action="store_true",
                    help="also compare every chunk byte for byte")
    ap.add_argument("--ceilings", action="store_true",
                    help="raw SSD, host → device and the stream in "
                         "turns, --trials times, in the same minute")
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--cold-alloc", action="store_true",
                    help="--dest device: leave the card's allocator cold, "
                         "so the window's first chunks call cudaMalloc "
                         "(the cost the warm-up keeps out of the clock)")
    ap.add_argument("--force-buffered", action="store_true",
                    help="no O_DIRECT (the fallback path)")
    ap.add_argument("--no-uring", action="store_true",
                    help="the thread-pool backend")
    ap.add_argument("--make-bytes", type=int, default=256 << 20,
                    help="size of the generated file")
    ap.add_argument("--tmpdir", default=None)
    ap.add_argument("--keep", action="store_true",
                    help="keep the generated file")
    args = ap.parse_args(argv)
    if args.verify_pread:
        args.verify = True
    if args.dest == "null":
        args.verify = False
    if args.trials < 1:
        ap.error("--trials must be >= 1")
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
