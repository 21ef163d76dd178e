"""Generate from a checkpoint: NVMe safetensors → the card → greedy or
sampled decode, optionally with the SSD-backed KV cache.

    python -m nvme_strom_tpu_torch.generate --weights DIR \\
        --prompt 1,2,3 --new 32

    # history past a window of 256 positions spills to PAGEFILE and
    # streams back through the engine every step (greedy only)
    python -m nvme_strom_tpu_torch.generate --weights DIR \\
        --prompt 1,2,3 --new 32 --offload PAGEFILE --offload-window 256

    # weight-only int8 after the load; --int4 packs int4 instead, and
    # --int8 --int4 is the mixed recipe (int8 lm_head, int4 the rest)
    python -m nvme_strom_tpu_torch.generate --weights DIR --int8

    # a local HF Llama checkpoint, converted into DIR once
    # (tools/convert_llama.py) and read from there on every later run
    python -m nvme_strom_tpu_torch.generate --from-hf HF_DIR --out-dir DIR

``DIR`` holds ``*.safetensors`` and ``strom_config.json`` (the model
config).  Token ids in, token ids out.  Runs on ``cuda:0`` unless
``--device`` says otherwise; there the decode steps attend with the
decode kernel (``ops/decode_attention.py``, kernel 2), and on the CPU
with the dense path.  ``--dtype`` is the compute dtype (bfloat16).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nvme_strom_tpu_torch.generate")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--weights", default=None,
                     help="checkpoint dir with strom_config.json")
    src.add_argument("--from-hf", default=None, metavar="HF_DIR",
                     help="HF Llama checkpoint dir, converted into "
                          "--out-dir first (reused when already there)")
    ap.add_argument("--out-dir", default=None,
                    help="conversion output dir of --from-hf")
    ap.add_argument("--prompt", default="1,2,3,4",
                    help="comma-separated token ids")
    ap.add_argument("--new", type=int, default=32,
                    help="tokens to generate")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy")
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0,
                    help="sampling seed")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float16", "float32"),
                    help="compute dtype of the model")
    ap.add_argument("--int8", action="store_true",
                    help="weight-only int8 quantization after the load "
                         "(models/quant.py)")
    ap.add_argument("--int4", action="store_true",
                    help="packed int4 (with --int8: the mixed recipe, "
                         "int8 lm_head and int4 everything else)")
    ap.add_argument("--offload", default=None, metavar="PAGEFILE",
                    help="decode with the SSD-backed KV cache, spilling "
                         "pages to this file (greedy only; the device "
                         "holds a bounded window, older history streams "
                         "from NVMe every step)")
    ap.add_argument("--offload-window", type=int, default=1024,
                    help="device window positions for --offload")
    ap.add_argument("--offload-quant", choices=["int8"], default=None,
                    help="quantize cold pages")
    ap.add_argument("--offload-chunked-prefill", action="store_true",
                    help="prefill the prompt in page-sized chunks too "
                         "(a bounded window for any prompt length)")
    args = ap.parse_args(argv)

    if args.from_hf:
        if not args.out_dir:
            ap.error("--from-hf needs --out-dir for the conversion")
        if not os.path.exists(os.path.join(args.out_dir,
                                           "strom_config.json")):
            from nvme_strom_tpu_torch.tools.convert_llama import convert
            summary = convert(args.from_hf, args.out_dir)
            print(f"converted {summary['tensors']} tensors", flush=True)
        args.weights = args.out_dir
    cfg_path = os.path.join(args.weights, "strom_config.json")
    if not os.path.exists(cfg_path):
        ap.error(f"{cfg_path} not found")
    if args.new < 1:
        ap.error("--new must be >= 1")
    try:
        prompt_ids = [int(t) for t in args.prompt.split(",") if t.strip()]
    except ValueError:
        ap.error(f"bad --prompt {args.prompt!r} (want comma-separated ids)")
    if not prompt_ids:
        ap.error("empty prompt")

    import torch

    from nvme_strom_tpu_torch.io.faults import build_engine
    from nvme_strom_tpu_torch.models.transformer import TransformerConfig
    from nvme_strom_tpu_torch.parallel.weights import LazyCheckpoint

    with open(cfg_path) as f:
        cfg = TransformerConfig(**json.load(f),
                                dtype=getattr(torch, args.dtype))
    if max(prompt_ids) >= cfg.vocab or min(prompt_ids) < 0:
        ap.error(f"prompt ids must be in [0, {cfg.vocab})")
    total = len(prompt_ids) + args.new
    if total > cfg.max_seq:
        ap.error(f"prompt+new = {total} exceeds max_seq {cfg.max_seq}")
    if args.offload:
        if args.temperature != 0.0:
            ap.error("--offload decode is greedy (temperature 0)")
        page_len = max(4, args.offload_window // 4)
        window_pages = max(1, args.offload_window // page_len)
        if args.offload_chunked_prefill and window_pages < 2:
            ap.error("--offload-chunked-prefill needs --offload-window "
                     ">= 8 (at least two pages)")

    engine = build_engine()
    try:
        t0 = time.monotonic()
        params = LazyCheckpoint(args.weights).load(engine,
                                                   device=args.device)
        print(f"weights: {len(params)} tensors in "
              f"{time.monotonic() - t0:.2f}s", flush=True)
        params = _quantize(params, args)
        dev = params["tok_embed"].device
        prompt = torch.tensor([prompt_ids], dtype=torch.int32, device=dev)
        sync = (torch.cuda.synchronize if dev.type == "cuda"
                else (lambda: None))
        t0 = time.monotonic()
        if args.offload:
            from nvme_strom_tpu_torch.models.kv_offload import (
                OffloadConfig, offloaded_generate)
            ocfg = OffloadConfig(path=args.offload, page_len=page_len,
                                 window_pages=window_pages,
                                 quantize=args.offload_quant)
            out = offloaded_generate(
                params, prompt, cfg, ocfg, engine, args.new,
                eos_id=args.eos_id,
                chunked_prefill=args.offload_chunked_prefill)
            sync()
            dt = time.monotonic() - t0
            print(f"offloaded decode: window={ocfg.window} "
                  f"page_len={page_len} "
                  f"quant={args.offload_quant or 'off'}")
        else:
            from nvme_strom_tpu_torch.models.decode import generate
            from nvme_strom_tpu_torch.ops.decode_attention import (
                decode_attention)
            gen = torch.Generator(device=dev).manual_seed(args.seed)
            # the card's decode steps attend with kernel 2; the CPU keeps
            # the dense path
            out = generate(params, prompt, cfg, args.new,
                           temperature=args.temperature, generator=gen,
                           eos_id=args.eos_id,
                           cache_attn=(decode_attention
                                       if dev.type == "cuda" else None))
            sync()
            dt = time.monotonic() - t0
        ids = [int(t) for t in out[0].tolist()]
        print(f"generated {args.new} tokens in {dt:.3f}s "
              f"({args.new / dt:.1f} tok/s)")
        print("output ids:", ",".join(map(str, ids)))
        engine.sync_stats()
        s = engine.stats
        print(f"engine stats: direct={s.bytes_direct} "
              f"fallback={s.bytes_fallback} bounce={s.bounce_bytes}")
    finally:
        engine.close_all()
    return 0


def _quantize(params, args):
    """``--int8`` / ``--int4`` on the loaded params, printing the
    quantized leaves' MiB against the same weights' in float32."""
    from nvme_strom_tpu_torch.models.quant import (quantize_weights_int4,
                                                   quantize_weights_int8,
                                                   quantized_nbytes)
    if args.int8:
        params = quantize_weights_int8(
            params, suffixes=("lm_head",) if args.int4 else None)
        q, fp = quantized_nbytes(params)
        what = ("lm_head only (mixed recipe)" if args.int4
                else "matmul weights")
        print(f"int8: {what} {q >> 20} MiB (vs {fp >> 20} MiB fp32)",
              flush=True)
    if args.int4:
        params = quantize_weights_int4(params)
        q, fp = quantized_nbytes(params)
        print(f"int4: all quantized leaves now {q >> 20} MiB (vs "
              f"{fp >> 20} MiB fp32; incl. any int8 lm_head)", flush=True)
    return params


if __name__ == "__main__":
    sys.exit(main())
