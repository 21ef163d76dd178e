"""Serve a checkpoint: NVMe safetensors → the card → continuous batching.

    python -m nvme_strom_tpu_torch.serve --weights DIR \\
        --request 1,2,3:16 --request 7,8:32 [--paged BLOCKS]

``DIR`` holds ``*.safetensors`` and ``strom_config.json`` (the model
config).  Each ``--request`` is ``comma-separated-prompt-ids:max_new``;
token ids in, token ids out.  Runs on ``cuda:0`` unless ``--device``
says otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nvme_strom_tpu_torch.serve")
    ap.add_argument("--weights", required=True,
                    help="checkpoint dir with strom_config.json")
    ap.add_argument("--request", action="append", default=[],
                    metavar="IDS:MAX_NEW",
                    help="prompt token ids and budget (repeatable)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=None,
                    help="per-slot capacity (default: model max_seq)")
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="base sampling seed; request i uses seed+i")
    ap.add_argument("--paged", type=int, default=0, metavar="BLOCKS",
                    help="serve from a shared pool of BLOCKS KV blocks")
    ap.add_argument("--block-len", type=int, default=128)
    ap.add_argument("--lookahead", type=int, default=1,
                    help="decode steps per host readback")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    if not args.request:
        ap.error("at least one --request")
    if args.slots < 1:
        ap.error(f"--slots must be >= 1, got {args.slots}")
    if args.paged < 0 or args.block_len < 1:
        ap.error("--paged must be >= 0 and --block-len >= 1")

    cfg_path = os.path.join(args.weights, "strom_config.json")
    if not os.path.exists(cfg_path):
        ap.error(f"{cfg_path} not found")

    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.models.serving import (DecodeServer,
                                                     PagedDecodeServer)
    from nvme_strom_tpu_torch.models.transformer import TransformerConfig
    from nvme_strom_tpu_torch.parallel.weights import LazyCheckpoint

    with open(cfg_path) as f:
        cfg = TransformerConfig(**json.load(f))
    max_len = args.max_len or cfg.max_seq
    reqs = []
    for i, spec in enumerate(args.request):
        ids_part, _, new_part = spec.partition(":")
        try:
            ids = [int(t) for t in ids_part.split(",") if t.strip()]
            max_new = int(new_part or 16)
        except ValueError:
            ap.error(f"bad --request {spec!r} (want IDS:MAX_NEW)")
        if not ids or max(ids) >= cfg.vocab or min(ids) < 0:
            ap.error(f"--request {spec!r}: ids must be in [0, {cfg.vocab})")
        if max_new < 1 or len(ids) + max_new > max_len:
            ap.error(f"--request {spec!r}: need 1 <= MAX_NEW and prompt + "
                     f"MAX_NEW <= {max_len}")
        reqs.append((f"r{i}", ids, max_new))

    engine = StromEngine()
    try:
        t0 = time.monotonic()
        params = LazyCheckpoint(args.weights).load(engine,
                                                   device=args.device)
        print(f"weights: {len(params)} tensors in "
              f"{time.monotonic() - t0:.2f}s", flush=True)
        if args.paged:
            srv = PagedDecodeServer(params, cfg, args.slots, max_len,
                                    total_blocks=args.paged,
                                    block_len=args.block_len,
                                    device=args.device)
        else:
            srv = DecodeServer(params, cfg, args.slots, max_len,
                               device=args.device)
        for i, (rid, ids, max_new) in enumerate(reqs):
            srv.submit(rid, ids, max_new, eos_id=args.eos_id,
                       temperature=args.temperature, top_p=args.top_p,
                       seed=args.seed + i)
        t0 = time.monotonic()
        results = srv.run(lookahead=args.lookahead)
        dt = time.monotonic() - t0
        total = sum(len(v) for v in results.values())
        for rid, _, _ in reqs:
            print(f"{rid}: {','.join(map(str, results[rid]))}")
        print(f"served {len(reqs)} requests / {total} tokens in {dt:.3f}s "
              f"({total / dt:.1f} tok/s, {args.slots} slots)")
        engine.sync_stats()
        s = engine.stats
        print(f"engine stats: direct={s.bytes_direct} "
              f"fallback={s.bytes_fallback} bounce={s.bounce_bytes}")
    finally:
        engine.close_all()
    return 0


if __name__ == "__main__":
    sys.exit(main())
