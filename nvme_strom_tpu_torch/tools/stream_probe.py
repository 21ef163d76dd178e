"""stream_probe — where the NVMe → card stream's bandwidth goes.

One JSON line an experiment (counterpart of
nvme_strom_tpu/tools/stream_probe.py); every stream and link leg runs
the ``h2d_copy`` kernel (kernel 1) on a card:

1. ``link``: the host → device rate at the stream's own concurrency,
   ``depth`` chunks from as many page-locked buffers in flight at once:
   the stream's honest denominator, measured beside each row.
2. ``depth``: the stream at depth 4, 8, 16 and 32, each with the
   blocking drain and the opportunistic one (``DeviceStream(drain=
   "ready")``), beside that row's link and the engine alone (``raw``):
   "the pipeline is too shallow" apart from "the drain stalls the reads".
3. ``chunk``: the stream at 4, 8 and 16 MiB chunks with ``depth ×
   chunk`` held at one budget: if the rate rises with the chunk, the gap
   is a per-chunk cost, not bandwidth.
4. ``boundary``: ``h2d_copy`` GiB/s from a staging view (in place)
   against an unregistered heap array (through the bridge's pinned
   bounce buffer), in alternating order.

Each line carries ``bounce_bytes`` and ``overlap`` (the pool too small
for ``3 × depth`` buffers sends chunks through the overlap stage).

    python -m nvme_strom_tpu_torch.tools.stream_probe [--file F | --bytes N]
        [--repeats 2] [--device cpu]

The stream's file is read through O_DIRECT where the filesystem allows
it; each pass first asks the kernel to drop the file's cached pages
(``posix_fadvise``), which a filesystem may ignore, so a pass may read
warm.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

MIB = 1 << 20


def _engine(chunk_bytes: int, depth: int):
    """An engine ``depth`` deep whose pool holds ``3 × depth`` chunks
    where the 64-buffer cap allows (then every copy reads its staging
    buffer in place)."""
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.utils.config import EngineConfig
    from nvme_strom_tpu_torch.utils.stats import StromStats
    cfg = EngineConfig(chunk_bytes=chunk_bytes, queue_depth=max(depth, 8),
                       buffer_pool_bytes=max(256 * MIB,
                                             3 * depth * chunk_bytes))
    return StromEngine(cfg, stats=StromStats())


def _evict(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)


def _sync(dev) -> None:
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize(dev)


def probe_link(dev, chunk_bytes: int, outstanding: int,
               repeats: int = 3) -> float:
    """GiB/s of ``outstanding`` chunks copied at once by ``h2d_copy``,
    each from its own page-locked buffer (median of ``repeats``)."""
    from nvme_strom_tpu_torch.tools.ssd2gpu_test import h2d_ceiling
    return h2d_ceiling(dev, chunk_bytes, outstanding * chunk_bytes,
                       buffers=outstanding, inflight=outstanding,
                       repeats=repeats)["gib_per_s"]


def probe_raw(engine, path: str) -> float:
    """GiB/s of one pass of the file into staging, no device copy."""
    from nvme_strom_tpu_torch.tools.ssd2gpu_test import read_host
    size = os.path.getsize(path)
    chunk = engine.config.chunk_bytes
    ranges = [(o, min(chunk, size - o)) for o in range(0, size, chunk)]
    _evict(path)
    fh = engine.open(path)
    try:
        t0 = time.monotonic()
        n, _ = read_host(engine, fh, ranges, engine.config.queue_depth,
                          None)
        dt = time.monotonic() - t0
    finally:
        engine.close(fh)
    return n / (1 << 30) / dt


def probe_stream(engine, path: str, dev, depth: int, drain: str,
                 repeats: int = 2) -> tuple:
    """(median GiB/s, overlap) of ``DeviceStream.stream_file`` at one
    (depth, drain) point."""
    from nvme_strom_tpu_torch.ops.bridge import DeviceStream
    ds = DeviceStream(engine, device=dev, depth=depth, drain=drain)
    size = os.path.getsize(path)

    def one() -> float:
        _evict(path)
        t0 = time.monotonic()
        n = 0
        for arr in ds.stream_file(path):
            n += arr.numel()
        _sync(dev)
        if n != size:
            raise AssertionError(f"streamed {n} of {size} bytes")
        return size / (1 << 30) / (time.monotonic() - t0)

    return statistics.median(one() for _ in range(repeats)), ds.overlap


def probe_boundary(engine, dev, workdir: str, repeats: int = 7) -> dict:
    """``h2d_copy`` GiB/s of one chunk from a staging view (in place)
    against a heap array of the same bytes (the bridge's pinned bounce
    buffer), alternating; the bounce bytes of the heap copies.  The
    chunk's file is written to ``workdir`` and removed."""
    from nvme_strom_tpu_torch.ops.bridge import host_to_device
    sz = engine.config.chunk_bytes
    heap = np.random.default_rng(0).integers(0, 256, sz, dtype=np.uint8)
    tmp = os.path.join(workdir, f".stream_probe_pool.{os.getpid()}.bin")
    with open(tmp, "wb") as f:
        f.write(heap.tobytes())
    fh = engine.open(tmp)
    pr = engine.submit_read(fh, 0, sz)
    try:
        view = pr.wait()

        def rate(buf) -> float:
            t0 = time.monotonic()
            host_to_device(engine, buf, dev).synchronize()
            return sz / (1 << 30) / (time.monotonic() - t0)

        rate(view)
        rate(heap)
        rates: dict = {"heap": [], "pool": []}
        engine.sync_stats()
        b0 = engine.stats.bounce_bytes
        for i in range(repeats):
            for k in (("heap", "pool") if i % 2 == 0 else ("pool", "heap")):
                rates[k].append(rate(heap if k == "heap" else view))
        out = {k: statistics.median(v) for k, v in rates.items()}
        engine.sync_stats()
        out["bounce_bytes"] = engine.stats.bounce_bytes - b0
    finally:
        pr.release()
        engine.close(fh)
        os.unlink(tmp)
    out["staging_vs_heap"] = out["pool"] / out["heap"] if out["heap"] \
        else None
    return out


def run(path: str, dev, depths=(4, 8, 16, 32), chunks_mib=(4, 8, 16),
        budget_mib: int = 64, repeats: int = 2, emit=None) -> list:
    """Every experiment over the file ``path`` on ``dev``; each record
    also goes to ``emit`` as it is made."""
    from nvme_strom_tpu_torch.ops.bridge import h2d_copy
    records = []

    def out(rec: dict) -> None:
        records.append(rec)
        if emit is not None:
            emit(rec)

    def row(engine, kind, depth, drain, link, raw):
        st = engine.stats
        engine.sync_stats()
        b0, f0, l0 = st.bounce_bytes, st.bytes_fallback, h2d_copy.launches
        rate, overlap = probe_stream(engine, path, dev, depth, drain,
                                     repeats)
        engine.sync_stats()
        return {"probe": kind, "depth": depth, "drain": drain,
                "chunk_mib": engine.config.chunk_bytes // MIB,
                "stream_gibs": rate, "link_gibs": link, "raw_gibs": raw,
                "ratio": rate / link if link else None, "overlap": overlap,
                "bounce_bytes": st.bounce_bytes - b0,
                "bytes_fallback": st.bytes_fallback - f0,
                "h2d_copy_launches": h2d_copy.launches - l0}

    for depth in depths:
        with _engine(4 * MIB, depth) as engine:
            if dev.type == "cuda":
                engine.cuda_mapping(dev.index)
            link = probe_link(dev, engine.config.chunk_bytes,
                              max(2, depth))
            raw = probe_raw(engine, path)
            for drain in ("blocking", "ready"):
                out(row(engine, "depth", depth, drain, link, raw))
    for chunk_mib in chunks_mib:
        depth = max(2, budget_mib // chunk_mib)
        with _engine(chunk_mib * MIB, depth) as engine:
            if dev.type == "cuda":
                engine.cuda_mapping(dev.index)
            link = probe_link(dev, engine.config.chunk_bytes,
                              max(2, depth))
            raw = probe_raw(engine, path)
            out(row(engine, "chunk", depth, "ready", link, raw))
    with _engine(4 * MIB, 8) as engine:
        if dev.type == "cuda":
            engine.cuda_mapping(dev.index)
        out({"probe": "boundary",
             **probe_boundary(engine, dev,
                              os.path.dirname(os.path.abspath(path)))})
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="stream_probe",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--file", default=None,
                    help="file to stream (default: a seeded file of "
                         "--bytes under --dir, removed after)")
    ap.add_argument("--bytes", type=int, default=512 * MIB)
    ap.add_argument("--dir", default=".")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--device", default="cuda:0",
                    help="the card ('cpu': the plain copies)")
    args = ap.parse_args(argv)
    from nvme_strom_tpu_torch.device import resolve_device
    from nvme_strom_tpu_torch.tools.ssd2gpu_test import make_test_file
    dev = resolve_device(args.device)
    path = args.file
    made = path is None
    if made:
        path = os.path.join(args.dir, ".stream_probe.bin")
        make_test_file(path, args.bytes)
    try:
        run(path, dev, repeats=args.repeats,
            emit=lambda rec: print(json.dumps(rec), flush=True))
    finally:
        if made:
            os.unlink(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
