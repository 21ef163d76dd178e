"""Perplexity of a checkpoint over tokens on NVMe (counterpart of
examples/eval_ppl.py):

    python -m nvme_strom_tpu_torch.eval_ppl --weights DIR --npy heldout.npy
    python -m nvme_strom_tpu_torch.eval_ppl --weights DIR --data-dir shards/ \\
        --batches 50

The weights load through ``LazyCheckpoint``.  The tokens come from one
``.npy`` of shape (n_sequences, seq_len) int32, streamed one batch of
rows at a time through ``DeviceStream.stream_ranges`` (NVMe → staging
→ ``h2d_copy``; the file need not fit in device memory, and
``--batches`` caps the reads), or from WebDataset shards of int32 token
samples through the loader.  The metric is pure token cross-entropy
(:func:`eval_loss`; an MoE model's router penalty is left out) and its
perplexity.  ``--int8`` / ``--int4`` quantize the loaded weights
(``--int8 --int4``: int8 lm_head, int4 the rest), so the perplexity
difference is the quantization's cost.  Runs on ``cuda:0`` unless
``--device`` says otherwise, in the config's dtype unless ``--dtype``
says otherwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time


def eval_loss(params, tokens, cfg, xent_chunks: int = 0):
    """Token-mean next-token cross-entropy of ``tokens`` (b, s), a
    float32 scalar.  ``xent_chunks`` > 1 takes the chunked path of
    ``transformer.loss_fn`` with the router's aux coefficient zeroed;
    otherwise the full logits' log-softmax."""
    import torch

    from nvme_strom_tpu_torch.models.transformer import forward, loss_fn
    with torch.no_grad():
        if xent_chunks > 1:
            return loss_fn(params, tokens, dataclasses.replace(
                cfg, xent_chunks=xent_chunks, router_aux_coef=0.0))
        logits = forward(params, tokens, cfg)
        lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        ll = lp.gather(-1, tokens[:, 1:].long()[..., None])
        return -ll.mean()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nvme_strom_tpu_torch.eval_ppl")
    ap.add_argument("--weights", required=True,
                    help="checkpoint dir with strom_config.json")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--npy", default=None,
                     help=".npy of (n, seq) int32 token sequences")
    src.add_argument("--data-dir", default=None,
                     help="dir of WebDataset .tar token shards")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--batches", type=int, default=0,
                    help="cap on evaluated batches (0 = everything)")
    ap.add_argument("--xent-chunks", type=int, default=0,
                    help="the cross-entropy in N sequence slices: the "
                         "(b, s, vocab) logits never materialize")
    ap.add_argument("--int4", action="store_true",
                    help="weight-only int4 (lm_head stays full precision; "
                         "with --int8 the int8-lm_head mixed recipe)")
    ap.add_argument("--int8", action="store_true",
                    help="weight-only int8 quantization after the load")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default=None, help="compute dtype (default: the "
                    "config's)")
    args = ap.parse_args(argv)

    cfg_path = os.path.join(args.weights, "strom_config.json")
    if not os.path.exists(cfg_path):
        ap.error(f"{cfg_path} not found")

    import torch

    from nvme_strom_tpu_torch.device import resolve_device
    from nvme_strom_tpu_torch.io.faults import build_engine
    from nvme_strom_tpu_torch.models.transformer import TransformerConfig
    from nvme_strom_tpu_torch.parallel.weights import LazyCheckpoint

    with open(cfg_path) as f:
        raw = json.load(f)
    # remat is a training setting, and a JAX-written config spells it
    # in fields of its own
    known = {f.name for f in dataclasses.fields(TransformerConfig)} - {
        "remat_policy"}
    cfg = TransformerConfig(**{k: v for k, v in raw.items() if k in known})
    if args.dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=getattr(torch, args.dtype))
    dev = resolve_device(args.device)

    engine = build_engine()
    try:
        params = LazyCheckpoint(args.weights).load(engine, device=dev)
        params = _quantize(params, args)

        def batches():
            if args.npy:
                yield from _npy_batches(ap, args, engine, dev, cfg.vocab)
                return
            yield from _wds_batches(ap, args, engine, dev, cfg.vocab)

        t0 = time.monotonic()
        total_loss, total_tok, n = 0.0, 0, 0
        for tokens in batches():
            if args.batches and n >= args.batches:
                break
            loss = float(eval_loss(params, tokens, cfg, args.xent_chunks))
            ntok = tokens.shape[0] * (tokens.shape[1] - 1)
            total_loss += loss * ntok
            total_tok += ntok
            n += 1
        if n == 0:
            ap.error("no full batches to evaluate")
        dt = time.monotonic() - t0
        ce = total_loss / total_tok
        print(f"evaluated {n} batches / {total_tok} predicted tokens "
              f"in {dt:.2f}s")
        print(f"cross-entropy: {ce:.6f} nats/token   "
              f"perplexity: {math.exp(ce):.2f}")
        engine.sync_stats()
        s = engine.stats
        print(f"engine stats: direct={s.bytes_direct} "
              f"fallback={s.bytes_fallback} bounce={s.bounce_bytes}")
    finally:
        engine.close_all()
    return 0


def _quantize(params, args):
    from nvme_strom_tpu_torch.models.quant import (quantize_weights_int4,
                                                   quantize_weights_int8)
    if args.int8:
        # with --int4 too: int8 only the lm_head, int4 takes the rest
        params = quantize_weights_int8(
            params, suffixes=("lm_head",) if args.int4 else None)
        what = "lm_head (mixed recipe)" if args.int4 else "matmul weights"
        print(f"int8: {what} quantized (ppl delta vs fp measures the "
              "cost)", flush=True)
    if args.int4:
        params = quantize_weights_int4(params)
        print("int4: matmul weights packed 2/byte (ppl delta vs fp "
              "measures the cost)", flush=True)
    return params


def _npy_batches(ap, args, engine, dev, vocab):
    """(batch, seq) int32 device tensors of consecutive rows, one
    batch's bytes streamed at a time."""
    import torch

    from nvme_strom_tpu_torch.formats.npy import plan_npy
    from nvme_strom_tpu_torch.ops.bridge import DeviceStream, split_ranges
    entry = plan_npy(args.npy)
    if len(entry.shape) != 2:
        ap.error(f"--npy must be (n, seq), got {entry.shape}")
    if entry.dtype != "<i4":
        ap.error(f"--npy must be int32 token ids, got {entry.dtype}")
    n, seq = entry.shape
    if seq < 2:
        ap.error(f"--npy seq length {seq} < 2: nothing to predict")
    row = seq * 4
    ds = DeviceStream(engine, device=dev, depth=engine.config.queue_depth)
    fh = engine.open(args.npy)
    try:
        for i in range(0, n - args.batch + 1, args.batch):
            ranges, _ = split_ranges(
                [(entry.offset + i * row, args.batch * row)],
                engine.config.chunk_bytes)
            parts = list(ds.stream_ranges(fh, ranges))
            flat = parts[0] if len(parts) == 1 else torch.cat(parts)
            toks = flat.view(torch.int32).reshape(args.batch, seq)
            if int(toks.max()) >= vocab or int(toks.min()) < 0:
                ap.error(f"--npy holds ids outside [0, {vocab}) at "
                         f"batch {i}")
            yield toks
    finally:
        engine.close(fh)


def _wds_batches(ap, args, engine, dev, vocab):
    import glob

    import numpy as np

    from nvme_strom_tpu_torch.data.loader import ShardedLoader
    shards = sorted(glob.glob(os.path.join(args.data_dir, "*.tar")))
    if not shards:
        ap.error(f"no .tar shards under {args.data_dir}")

    def decode(parts):
        (payload,) = parts.values()
        return np.frombuffer(payload, dtype=np.int32) % vocab
    with ShardedLoader(shards, args.batch, fmt="wds", decode=decode,
                       engine=engine, device=dev) as loader:
        yield from loader


if __name__ == "__main__":
    sys.exit(main())
