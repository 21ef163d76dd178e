"""transfer_diag — evidence that nothing on the host copies a read's
bytes on their way to the card.

1. **Alias proof.**  ``PendingRead.wait()`` returns a numpy view; its
   data pointer must lie inside the engine's staging pool
   (``pool_base``, ``pool_bytes``), the buffers O_DIRECT reads land in.
   On a card the pool is the memory the port registers with CUDA, so the
   proof also asks the registration for the view's device address: the
   ``h2d_copy`` kernel then reads the DMA target itself.

2. **Boundary timing** (median of ``--repeats``): ``staging``, kernel 1
   on the staging view in place; ``heap``, an unregistered numpy copy of
   the same bytes, which the bridge copies through its pinned bounce
   buffer (counted as ``bounce_bytes``); ``copy+heap``, a host copy
   first, then the same.  ``staging`` < ``heap`` is what registering
   the pool buys.

    python -m nvme_strom_tpu_torch.tools.transfer_diag [--bytes N] [--device cpu]

Prints one JSON line; exit code 1 unless the view aliases the pool (and,
on a card, its registration).  Counterpart of
nvme_strom_tpu/tools/transfer_diag.py.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time


def run(nbytes: int, repeats: int = 5, device=None) -> dict:
    import numpy as np
    from nvme_strom_tpu_torch.device import resolve_device
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.ops.bridge import h2d_copy, host_to_device
    from nvme_strom_tpu_torch.utils.config import EngineConfig

    dev = resolve_device(device)
    cfg = EngineConfig()
    nbytes = min(nbytes, cfg.chunk_bytes)
    out: dict = {"device": str(dev), "bytes": nbytes}
    with tempfile.NamedTemporaryFile(delete=False) as f:
        f.write(os.urandom(nbytes))
        path = f.name
    try:
        with StromEngine(cfg) as eng:
            pool = eng.pool_info()
            out["pool_locked"] = bool(pool["locked"])
            fh = eng.open(path)
            pr = eng.submit_read(fh, 0, nbytes)
            try:
                view = pr.wait()
                # -- 1. alias proof --
                addr = view.__array_interface__["data"][0]
                base, size = pool["pool_base"], pool["pool_bytes"]
                out["view_in_pool"] = bool(base <= addr
                                           and addr + nbytes <= base + size)
                out["view_aligned"] = addr % cfg.alignment == 0
                out["alignment"] = cfg.alignment
                out["view_registered"] = None
                if dev.type == "cuda":
                    mapped = eng.cuda_mapping(dev.index).device_ptr(addr,
                                                                    nbytes)
                    out["view_registered"] = mapped is not None
                # -- 2. boundary timing --
                heap = np.array(view)     # unregistered copy, same bytes

                def med(src_fn) -> tuple:
                    before = eng.stats.bounce_bytes
                    host_to_device(eng, src_fn(), dev).synchronize()
                    ts = []
                    for _ in range(repeats):
                        t0 = time.monotonic()
                        host_to_device(eng, src_fn(), dev).synchronize()
                        ts.append(time.monotonic() - t0)
                    per_call = ((eng.stats.bounce_bytes - before)
                                // (repeats + 1))
                    return statistics.median(ts), per_call

                launches = h2d_copy.launches
                out["t_staging_s"], out["bounce_staging"] = med(lambda: view)
                out["t_heap_s"], out["bounce_heap"] = med(lambda: heap)
                out["t_copy_heap_s"], out["bounce_copy_heap"] = med(
                    lambda: np.array(heap))
                out["h2d_copy_launches"] = h2d_copy.launches - launches
            finally:
                pr.release()
                eng.close(fh)
        out["staging_vs_heap"] = out["t_staging_s"] / max(out["t_heap_s"],
                                                          1e-9)
        ok = out["view_in_pool"] and out["view_registered"] is not False
        out["verdict"] = ("the copy reads the DMA target in place" if ok
                          else "BROKEN: the view does not alias the "
                               "registered staging pool")
        return out
    finally:
        os.unlink(path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="transfer_diag",
        description="zero-copy boundary evidence (alias proof + timing)")
    ap.add_argument("--bytes", type=int, default=4 << 20)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--device", default="cuda:0",
                    help="the card ('cpu': the plain copies)")
    args = ap.parse_args(argv)
    res = run(args.bytes, args.repeats, args.device)
    print(json.dumps(res))
    return 0 if res["view_in_pool"] and res["view_registered"] is not False \
        else 1


if __name__ == "__main__":
    sys.exit(main())
