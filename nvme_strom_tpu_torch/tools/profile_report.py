"""profile_report — where a train step's device time goes.

Runs two steps of the flagship train step (seq ``--seq``, batch
``--batch``, ``--remat``, attention through the flash kernels 4–6 or the
dense path) under ``torch.profiler`` after untraced warm-up steps, and
prints one JSON line:

- each class's share of the window's wall time (``category_frac``; they
  sum to the busy share) and of the device time (``category_ms``);
- the device-busy share (``busy_frac``: the kernels' time over the wall
  time of the two steps; the rest is the card waiting on the host);
- the top kernels by device time, overall and in each class.

Kernels are classed by name, the first matching class wins
(:data:`_CLASSES`): collectives (NCCL, the ring kernel 7), attention
(the port's kernels 2–6 and SDPA's), matmul (cuBLAS / CUTLASS / sm90 /
``nvjet`` GEMMs), copy (memcpy, memset, ``h2d_copy``), elementwise,
then other.  User annotations on the device timeline are left out: they
span kernels already counted.

Counterpart of the parts of nvme_strom_tpu/tools/profile_report.py that
are not about XLA: ``torch.profiler`` takes the place of the xplane and
HLO parsing.

    python -m nvme_strom_tpu_torch.tools.profile_report [--batch 8]
        [--seq 2048] [--remat none|dots|full] [--attn flash|dense]
        [--device cpu]

On the CPU (``--device cpu``) there are no device kernels: the report
classes the CPU operators instead, which checks the parse, not the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _log(msg: str) -> None:
    print(f"profile: {msg}", file=sys.stderr, flush=True)


#: class → name keywords (lower case), first match wins: a NCCL or ring
#: kernel is a collective whatever else its name says, an attention
#: kernel that runs GEMMs inside is attention, and ``copy`` comes after
#: both so a kernel named for its data movement inside a GEMM stays
#: matmul
_CLASSES = (
    ("collective", ("nccl", "ici_ring")),
    ("attention", ("flash_fwd", "flash_dq", "flash_dkv", "flash_bwd",
                   "decode_split", "decode_combine", "paged_split",
                   "paged_combine", "fmha", "flash_attn", "attention",
                   "sdpa")),
    ("matmul", ("gemm", "cutlass", "xmma", "nvjet", "cublas", "gemv",
                "matmul", "aten::mm", "aten::addmm", "aten::bmm")),
    ("copy", ("memcpy", "memset", "h2d_", "copy", "cat_", "transpose")),
    ("elementwise", ("elementwise", "vectorized", "reduce", "softmax",
                     "norm", "unrolled", "scatter", "gather", "index",
                     "multi_tensor_apply", "aten::")),
)


def classify(name: str) -> str:
    """The class of a kernel (or CPU operator) by its name."""
    low = name.lower()
    for bucket, keys in _CLASSES:
        if any(k in low for k in keys):
            return bucket
    return "other"


def summarize(events, wall_ms: float, steps: int, top: int = 8) -> dict:
    """The report of ``events``, ``(name, device ms, calls)`` over a
    window of ``wall_ms``."""
    by_cat: dict = {}
    by_op: dict = {}
    by_cat_op: dict = {}
    for name, ms, calls in events:
        cat = classify(name)
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
        short = name[:60]
        by_op[short] = by_op.get(short, 0.0) + ms
        co = by_cat_op.setdefault(cat, {})
        co[short] = co.get(short, 0.0) + ms
    busy = sum(by_cat.values())
    order = sorted(by_cat, key=lambda c: -by_cat[c])
    return {
        "steps_traced": steps,
        "device_busy_ms": busy,
        "window_wall_ms": wall_ms,
        "busy_frac": busy / wall_ms if wall_ms else None,
        "category_ms": {c: by_cat[c] for c in order},
        "category_frac": {c: by_cat[c] / wall_ms if wall_ms else None
                          for c in order},
        "category_share_of_busy": {c: by_cat[c] / busy if busy else None
                                   for c in order},
        "top_ops_ms": dict(sorted(by_op.items(),
                                  key=lambda kv: -kv[1])[:top]),
        "category_top_ops_ms": {
            c: dict(sorted(by_cat_op[c].items(),
                           key=lambda kv: -kv[1])[:4]) for c in order},
    }


def capture(batch: int, seq: int, remat: str, attn: str, device=None,
            warmup: int = 2, steps: int = 2, seed: int = 0) -> dict:
    """``warmup`` untraced steps, then ``steps`` under torch.profiler,
    of the flagship train step; the report of :func:`summarize` with
    the variant."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from nvme_strom_tpu_torch.device import resolve_device
    from nvme_strom_tpu_torch.models.transformer import (
        adamw, flagship_config, init_params, make_train_step,
        trainable_params)
    dev = resolve_device(device)
    cfg = dataclasses.replace(flagship_config(), remat_policy=remat)
    attn_fn = None
    if attn == "flash":
        from nvme_strom_tpu_torch.ops.flash_attention import make_flash_attn
        attn_fn = make_flash_attn()
    params = trainable_params(init_params(seed, cfg), dev)
    step = make_train_step(cfg, adamw(params, 3e-4), attn_fn=attn_fn)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = [torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                            device=dev, dtype=torch.int32)
              for _ in range(warmup + steps)]
    _log(f"tracing the train step on {dev}: d={cfg.d_model} "
         f"L={cfg.n_layers} b={batch} s={seq} remat={remat} attn={attn}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    for t in tokens[:warmup]:
        step(params, t)
    sync()
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    losses = []
    with profile(activities=acts) as prof:
        t0 = time.monotonic()
        for t in tokens[warmup:]:
            losses.append(step(params, t))
        sync()
        wall_ms = (time.monotonic() - t0) * 1e3
    if dev.type == "cuda":
        # kernels and copies only: a user annotation on the device
        # timeline ("Optimizer.step#AdamW.step") spans kernels already
        # counted
        events = [(e.key, e.self_device_time_total / 1e3, e.count)
                  for e in prof.key_averages()
                  if e.device_type.name == "CUDA"
                  and not getattr(e, "is_user_annotation", False)
                  and e.self_device_time_total > 0]
    else:
        events = [(e.key, e.self_cpu_time_total / 1e3, e.count)
                  for e in prof.key_averages()
                  if e.key.startswith("aten::")
                  and e.self_cpu_time_total > 0]
    rep = summarize(events, wall_ms, steps)
    rep["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")
    rep["variant"] = f"b={batch} s={seq} remat={remat} attn={attn}"
    rep["losses"] = [float(x) for x in losses]
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="profile_report",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--remat", default="none",
                    choices=("none", "dots", "full"))
    ap.add_argument("--attn", default="flash", choices=("flash", "dense"))
    ap.add_argument("--device", default="cuda:0",
                    help="the card ('cpu': CPU operators, the plain "
                         "versions)")
    args = ap.parse_args(argv)
    rep = capture(args.batch, args.seq, args.remat, args.attn, args.device)
    print(json.dumps({"metric": "train:profile-breakdown", **rep}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
