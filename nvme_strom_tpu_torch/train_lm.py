"""Train the flagship LM on one GPU through every layer of the port
(counterpart of examples/train_lm.py):

    WebDataset shards ─ engine ─► ShardedLoader ─► prefetch ─► Trainer
    safetensors ─ engine ─► warm start            │
    CheckpointManager (O_DIRECT writes) ◄─────────┘

    python -m nvme_strom_tpu_torch.train_lm --flash --steps 20
    python -m nvme_strom_tpu_torch.train_lm --tiny --steps 5 --device cpu

Without ``--data-dir`` it writes seeded synthetic shards of int32 token
samples (4 shards of 8·global-batch samples) to a temporary directory.
At the end it prints the engine's stats line.  The JAX example's
``--mix``, ``--from-hf``, ``--tp``, ``--lora``, ``--offload-opt``,
``--offload-acts``, ``--lr-schedule`` and ``--grad-clip`` are not ported
yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import os
import sys
import tarfile
import tempfile
import time

import numpy as np


def synthesize_shards(dirpath: str, vocab: int, seq_len: int,
                      n_shards: int, per_shard: int, seed: int = 0) -> list:
    """Tar shards of int32 token samples (one ``.bin`` member each),
    made from ``seed``; returns their paths."""
    rng = np.random.default_rng(seed)
    paths = []
    for s in range(n_shards):
        path = os.path.join(dirpath, f"lm-{s:04d}.tar")
        with tarfile.open(path, "w") as tf:
            for i in range(per_shard):
                toks = rng.integers(0, vocab, seq_len,
                                    dtype=np.int32).tobytes()
                ti = tarfile.TarInfo(f"{s:04d}{i:05d}.bin")
                ti.size = len(toks)
                tf.addfile(ti, io.BytesIO(toks))
        paths.append(path)
    return paths


def token_batches(shards, global_batch: int, vocab: int, engine, device):
    """Endless epochs of (global_batch, seq) int32 token batches on
    ``device``."""
    from nvme_strom_tpu_torch.data.loader import ShardedLoader

    def decode(parts):
        (payload,) = parts.values()
        return np.frombuffer(payload, dtype=np.int32) % vocab

    while True:
        n = 0
        with ShardedLoader(shards, global_batch, decode=decode,
                           engine=engine, device=device) as loader:
            for b in loader:
                n += 1
                yield b
        if n == 0:
            raise RuntimeError(f"the shards yield no full batch of "
                               f"{global_batch}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-dir", default=None,
                    help="dir of WebDataset .tar shards of int32 token "
                         "samples (seq-len each); synthesized if omitted")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--init-weights", default=None,
                    help="safetensors file or dir to warm-start from")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--xent-chunks", type=int, default=0,
                    help="cross-entropy over N sequence slices (0 = off)")
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=("none", "full"))
    ap.add_argument("--flash", action="store_true",
                    help="attention through the flash kernels")
    ap.add_argument("--watchdog", type=float, default=0.0,
                    metavar="SECONDS", help="per-step deadline (0 = off)")
    ap.add_argument("--save-every", type=int, default=10)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny config instead of the flagship")
    ap.add_argument("--device", default=None,
                    help="default cuda:0; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)

    from nvme_strom_tpu_torch.io.faults import build_engine
    from nvme_strom_tpu_torch.data.prefetch import prefetch_to_device
    from nvme_strom_tpu_torch.models.transformer import (flagship_config,
                                                         tiny_config)
    from nvme_strom_tpu_torch.train import Trainer

    cfg = dataclasses.replace(
        tiny_config() if args.tiny else flagship_config(),
        remat_policy=args.remat)
    if args.xent_chunks > 1:
        cfg = dataclasses.replace(cfg, xent_chunks=args.xent_chunks)
    attn_fn = None
    if args.flash:
        from nvme_strom_tpu_torch.ops.flash_attention import make_flash_attn
        attn_fn = make_flash_attn()
    print(f"model: d={cfg.d_model} L={cfg.n_layers} vocab={cfg.vocab} "
          f"seq={args.seq_len} batch={args.global_batch} "
          f"flash={args.flash}")

    tmp = None
    data_dir = args.data_dir
    if data_dir is None:
        tmp = tempfile.TemporaryDirectory(prefix="strom_lm_")
        data_dir = tmp.name
        synthesize_shards(data_dir, cfg.vocab, args.seq_len, n_shards=4,
                          per_shard=8 * args.global_batch)
        print(f"data: synthesized 4 shards under {data_dir}")
    shards = sorted(os.path.join(data_dir, f) for f in os.listdir(data_dir)
                    if f.endswith(".tar"))
    if not shards:
        ap.error(f"no .tar shards found under {data_dir}")
    ckpt_dir = args.ckpt_dir or os.path.join(tmp.name if tmp else ".",
                                             "ckpt")

    engine = build_engine()
    try:
        with Trainer(cfg, lr=args.lr, ckpt_dir=ckpt_dir, engine=engine,
                     attn_fn=attn_fn, accum_steps=args.accum_steps,
                     init_weights=args.init_weights,
                     save_every=args.save_every, async_save=True,
                     watchdog_s=args.watchdog, device=args.device,
                     hooks=[_log_step]) as tr:
            if tr.resumed_from is not None:
                print(f"resumed from step {tr.resumed_from}")
            it = prefetch_to_device(
                token_batches(shards, args.global_batch, cfg.vocab, engine,
                              tr.device), size=2)
            t0 = time.monotonic()
            try:
                res = tr.fit(it, steps=args.steps)
            finally:
                it.close()          # stop the loader before the engine
            dt = time.monotonic() - t0
        n = res.steps - (res.resumed_from or 0)
        print(f"{n} steps in {dt:.2f}s ({n / max(dt, 1e-9):.2f} steps/s), "
              f"last loss {res.last_loss:.4f}")
        engine.sync_stats()
        s = engine.stats
        print(f"engine stats: direct={s.bytes_direct} "
              f"fallback={s.bytes_fallback} bounce={s.bounce_bytes} "
              f"written_direct={s.bytes_written_direct} "
              f"to_device={s.bytes_to_device}")
    finally:
        engine.close_all()
        if tmp:
            tmp.cleanup()
    return 0


def _log_step(step: int, loss: float, dt: float) -> None:
    if step % 5 == 0:
        print(f"step {step}: loss={loss:.4f} ({dt * 1e3:.1f} ms)")


if __name__ == "__main__":
    sys.exit(main())
