"""Train a ViT on fixed-record image shards (counterpart of
examples/train_vit.py):

    fixedrec shards ─ engine ─► ShardedLoader (zero-copy) ─► decode on
    the card ─► ViT train step (AdamW)

    python -m nvme_strom_tpu_torch.train_vit --steps 20 --global-batch 32
    python -m nvme_strom_tpu_torch.train_vit --steps 4 --image-size 32 \\
        --device cpu

Each record is ``C·H·W`` image bytes followed by a 4-byte little-endian
int32 label.  Records stream NVMe → staging → device with one
``h2d_copy`` a staging piece and no host copy (the loader's ``fixedrec``
path), and are decoded on the device: the image bytes are sliced and
scaled by 1/255, the label bytes viewed as int32 and clipped to
``[0, classes)``.  Without ``--data-dir`` it writes 4 seeded shards of
4·global-batch records to a temporary directory.  The model has the
example's widths (patch 8, d 192, 4 layers, 4 heads, d_ff 768).  At the
end it prints the images a second and the engine's stats line.  The
example's ``--tp`` (tensor parallel) waits for multi-GPU support: any
value but 1 exits with an error.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nvme_strom_tpu_torch.train_vit")
    ap.add_argument("--data-dir", default=None,
                    help="dir of .sfr fixedrec shards (synthesized if "
                         "omitted)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor parallel ways (1 only for now)")
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--classes", type=int, default=100)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    if args.tp != 1:
        ap.error(f"--tp {args.tp}: tensor parallel waits for multi-GPU "
                 "support (ROADMAP Queue 1 item 12); use --tp 1")

    import torch

    from nvme_strom_tpu_torch.data.loader import ShardedLoader
    from nvme_strom_tpu_torch.device import resolve_device
    from nvme_strom_tpu_torch.io.faults import build_engine
    from nvme_strom_tpu_torch.models.transformer import (adamw,
                                                         trainable_params)
    from nvme_strom_tpu_torch.models.vit import (ViTConfig, init_vit_params,
                                                 make_vit_train_step)

    dev = resolve_device(args.device)
    cfg = ViTConfig(image_size=args.image_size, patch_size=8, d_model=192,
                    n_layers=4, n_heads=4, d_ff=768, n_classes=args.classes)
    img_bytes = cfg.channels * cfg.image_size ** 2
    rec_bytes = img_bytes + 4                      # ++ int32 label
    print(f"device: {dev} model: d={cfg.d_model} L={cfg.n_layers} "
          f"img={cfg.image_size} rec={rec_bytes}B", flush=True)

    tmp = None
    data_dir = args.data_dir
    if data_dir is None:
        tmp = tempfile.TemporaryDirectory(prefix="strom_vit_")
        data_dir = tmp.name
        synthesize_shards(data_dir, img_bytes, args.classes, n_shards=4,
                          per_shard=4 * args.global_batch)
        print(f"data: synthesized 4 shards under {data_dir}")
    shards = sorted(os.path.join(data_dir, f)
                    for f in os.listdir(data_dir) if f.endswith(".sfr"))
    if not shards:
        ap.error(f"no .sfr shards found under {data_dir}")

    engine = build_engine()
    try:
        params = trainable_params(init_vit_params(0, cfg), dev)
        step = make_vit_train_step(cfg, adamw(params, args.lr))

        t0 = time.monotonic()
        loss = None
        it = 0
        while it < args.steps:
            n_epoch = 0
            with ShardedLoader(shards, args.global_batch, fmt="fixedrec",
                               engine=engine, device=dev) as loader:
                for rec in loader:
                    loss = step(params, *decode_records(rec, cfg))
                    it += 1
                    n_epoch += 1
                    if it % 5 == 0 or it == args.steps:
                        print(f"step {it}: loss={float(loss):.4f}",
                              flush=True)
                    if it >= args.steps:
                        break
            if n_epoch == 0:
                raise RuntimeError(
                    f"shards under {data_dir} yield zero full batches of "
                    f"{args.global_batch}")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.monotonic() - t0
        print(f"{args.steps} steps in {dt:.2f}s "
              f"({args.steps * args.global_batch / dt:.1f} img/s)")
        engine.sync_stats()
        s = engine.stats
        print(f"engine stats: direct={s.bytes_direct} "
              f"fallback={s.bytes_fallback} bounce={s.bounce_bytes} "
              f"to_device={s.bytes_to_device}")
    finally:
        engine.close_all()
        if tmp:
            tmp.cleanup()
    return 0


def decode_records(records, cfg):
    """Records (B, C·H·W + 4) uint8, on whatever device holds them →
    (images (B, H, W, C) in ``cfg.dtype`` scaled by 1/255, labels (B,)
    int32 from the 4 little-endian label bytes, clipped to
    ``[0, cfg.n_classes)``)."""
    import torch
    img_bytes = cfg.channels * cfg.image_size ** 2
    imgs = records[:, :img_bytes].reshape(-1, cfg.image_size,
                                          cfg.image_size, cfg.channels)
    imgs = imgs.to(cfg.dtype) / 255.0
    labels = records[:, img_bytes:].contiguous().view(torch.int32)[:, 0]
    return imgs, labels.clamp(0, cfg.n_classes - 1)


def synthesize_shards(dirpath: str, img_bytes: int, n_classes: int,
                      n_shards: int, per_shard: int, seed: int = 0) -> list:
    """Fixedrec shards of seeded random image bytes, each record
    followed by its little-endian int32 label; returns their paths."""
    from nvme_strom_tpu_torch.formats.fixedrec import write_fixedrec
    rng = np.random.default_rng(seed)
    paths = []
    for s in range(n_shards):
        rec = np.empty((per_shard, img_bytes + 4), np.uint8)
        rec[:, :img_bytes] = rng.integers(0, 256, size=(per_shard,
                                                        img_bytes),
                                          dtype=np.uint8)
        labels = rng.integers(0, n_classes, size=per_shard,
                              dtype=np.int32).astype("<i4")
        rec[:, img_bytes:] = labels[:, None].view(np.uint8).reshape(
            per_shard, 4)
        path = os.path.join(dirpath, f"shard-{s:04d}.sfr")
        write_fixedrec(path, rec)
        paths.append(path)
    return paths


if __name__ == "__main__":
    sys.exit(main())
