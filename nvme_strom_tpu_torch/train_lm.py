"""Train the flagship LM on one GPU through every layer of the port
(counterpart of examples/train_lm.py):

    WebDataset shards ─ engine ─► ShardedLoader ─► prefetch ─► Trainer
    (--mix: MixtureLoader)                              │   (or the LoRA
    safetensors ─ engine ─► warm start                  │    loop)
    CheckpointManager (O_DIRECT writes) ◄───────────────┘
    --offload-opt: Adam moments on NVMe (parallel/opt_offload.py)
    --remat nvme --offload-acts: layer inputs on NVMe
                                  (parallel/act_offload.py)

    python -m nvme_strom_tpu_torch.train_lm --flash --steps 20
    python -m nvme_strom_tpu_torch.train_lm --tiny --steps 5 --device cpu
    torchrun --nproc-per-node 4 -m nvme_strom_tpu_torch.train_lm --tp 2

Without ``--data-dir`` or ``--mix`` it writes seeded synthetic shards of
int32 token samples (4 shards of 8·global-batch samples) to a temporary
directory.  ``--lora RANK`` trains adapters over a frozen base (reloaded
on every resume; checkpoints hold the adapters and their optimizer state
only); ``--offload-opt DIR`` keeps the AdamW moments on NVMe, refusing a
moment manifest whose step differs from the resumed checkpoint's;
``--lr-schedule``, ``--warmup-steps`` and ``--grad-clip`` are optax's
warmup / cosine schedule and global-norm clip.  At the end it prints the
engine's stats line.

Under ``torchrun`` (one process a card) the processes form a mesh of
``dp = world / tp`` by ``tp`` (``--tp``, parallel/mesh.py): each ``dp``
group reads its own rows of every batch, the Trainer holds each rank's
slices, and the checkpoint (default ``./ckpt``, which every rank must
see) is written tile by tile.  Rank 0 synthesizes the shards and prints
the log.  Without ``torchrun`` it runs on one device, and a ``--tp``
other than 1 exits with an error.

``--from-hf HF_DIR`` warm-starts from a local HuggingFace Llama
checkpoint: converted once (tools/convert_llama.py) into
``--ckpt-dir/hf_converted`` and reused while its ``source.json`` names
the same ``config.json``; the model config is the checkpoint's, its
``max_seq`` capped at ``--seq-len``.  It excludes ``--init-weights``
and ``--tiny``, and needs ``--ckpt-dir``.
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


def token_batches(shards, global_batch: int, vocab: int, engine, device,
                  mesh=None):
    """Endless epochs of (global_batch, seq) int32 token batches on
    ``device`` (under a ``mesh``, this rank's ``dp`` rows of each)."""
    from nvme_strom_tpu_torch.data.loader import ShardedLoader

    def decode(parts):
        (payload,) = parts.values()
        return np.frombuffer(payload, dtype=np.int32) % vocab

    while True:
        n = 0
        with ShardedLoader(shards, global_batch, decode=decode,
                           engine=engine, device=device,
                           mesh=mesh) as loader:
            for b in loader:
                n += 1
                yield b
        if n == 0:
            raise RuntimeError(f"the shards yield no full batch of "
                               f"{global_batch}")


def _mixture_batches(specs, global_batch: int, vocab: int, engine,
                     device, mesh=None):
    """Endless (global_batch, seq) token batches drawn from the
    ``(shards, weight)`` corpora by ``MixtureLoader`` (seed 0)."""
    from contextlib import ExitStack
    from nvme_strom_tpu_torch.data.loader import ShardedLoader
    from nvme_strom_tpu_torch.data.mixture import MixtureLoader

    def decode(parts):
        (payload,) = parts.values()
        return np.frombuffer(payload, dtype=np.int32) % vocab

    with ExitStack() as stack:
        loaders = [(stack.enter_context(ShardedLoader(
            shards, global_batch, decode=decode, engine=engine,
            device=device, mesh=mesh)), w) for shards, w in specs]
        for b, _src in MixtureLoader(loaders, seed=0):
            yield b


def _parse_mix(ap, text: str) -> list:
    specs = []
    for part in text.split(","):
        d, _, w = part.rpartition(":")
        try:
            weight = float(w)
        except ValueError:
            weight = -1.0
        if not d or weight <= 0:
            ap.error(f"--mix entry {part!r}: want DIR:WEIGHT with a "
                     "positive weight")
        shards = sorted(os.path.join(d, f) for f in os.listdir(d)
                        if f.endswith(".tar"))
        if not shards:
            ap.error(f"--mix: no .tar shards under {d}")
        specs.append((shards, weight))
    return specs


class _OffloadStep:
    """The torch-optimizer face ``Trainer`` drives for --offload-opt:
    ``step()`` hands the gradients to ``OffloadedAdam.update``; the
    moments are on NVMe, so there is no ``state`` to checkpoint."""

    def __init__(self):
        self.state: dict = {}
        self.offl = None
        self.params = None

    def step(self) -> None:
        self.offl.update(self.params,
                         {n: p.grad for n, p in self.params.items()})


def _train_lora(args, cfg, attn_fn, engine, batches, lr) -> int:
    """The LoRA loop: a frozen base (the warm start, else seed-0
    weights, loaded on every run), rank-``args.lora`` adapters drawn
    from seed 1, AdamW over the adapters; checkpoints hold the adapters
    and their optimizer state."""
    import contextlib
    import torch
    from nvme_strom_tpu_torch.checkpoint.manager import CheckpointManager
    from nvme_strom_tpu_torch.device import resolve_device
    from nvme_strom_tpu_torch.models.lora import (
        adapter_leaves, count_params, lora_init, make_lora_train_step)
    from nvme_strom_tpu_torch.models.transformer import adamw, init_params
    from nvme_strom_tpu_torch.train import optimizer_state, restore_state
    from nvme_strom_tpu_torch.utils.watchdog import StepWatchdog

    dev = resolve_device(args.device)
    mgr = CheckpointManager(args.ckpt_dir, engine=engine)
    start = mgr.latest_step()
    if args.init_weights:
        from nvme_strom_tpu_torch.parallel.weights import LazyCheckpoint
        loaded = LazyCheckpoint(args.init_weights).load(engine, device=dev)
        base = {n: t.float() for n, t in loaded.items()}
    else:
        base = {n: torch.from_numpy(a).to(dev)
                for n, a in init_params(0, cfg).items()}
    alpha = args.lora_alpha if args.lora_alpha is not None \
        else float(args.lora)
    adapters = lora_init(torch.Generator().manual_seed(1), base, args.lora,
                         device=dev)
    leaves = adapter_leaves(adapters)
    opt = adamw(list(leaves.values()), args.lr)
    step_fn = make_lora_train_step(cfg, opt, alpha=alpha, attn_fn=attn_fn,
                                   accum_steps=args.accum_steps, lr=lr,
                                   grad_clip=args.grad_clip)
    print(f"lora: rank {args.lora} alpha {alpha:g} — "
          f"{count_params(adapters)} trainable of {count_params(base)} "
          "base params")
    if start is not None:
        restore_state(mgr, start, leaves, opt, dev)
        print(f"resumed from step {start}")
    start = start or 0
    wd = (StepWatchdog(args.watchdog, engine=engine)
          if args.watchdog > 0 else None)
    t0 = time.monotonic()
    loss = None
    try:
        for step in range(start, args.steps):
            with (wd.step(f"step {step + 1}") if wd
                  else contextlib.nullcontext()):
                loss = step_fn(adapters, base, next(batches))
                if ((step + 1) % args.save_every == 0
                        or step + 1 == args.steps):
                    mgr.save_async(step + 1,
                                   (leaves, optimizer_state(opt, leaves)))
                    print(f"step {step + 1}: loss={float(loss):.4f} "
                          "(checkpointed)")
                elif (step + 1) % 5 == 0:
                    print(f"step {step + 1}: loss={float(loss):.4f}")
        mgr.wait_pending()
    finally:
        if wd is not None:
            wd.close()
        mgr.close()
    dt = time.monotonic() - t0
    n = args.steps - start
    print(f"{n} steps in {dt:.2f}s ({n / max(dt, 1e-9):.2f} steps/s), "
          f"last loss {float('nan') if loss is None else float(loss):.4f}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mix", default=None, metavar="DIR:W,DIR:W",
                    help="train on a weighted mixture of shard dirs "
                         "(seeded per-step source draws) instead of one "
                         "--data-dir")
    ap.add_argument("--data-dir", default=None,
                    help="dir of WebDataset .tar shards of int32 token "
                         "samples (seq-len each); synthesized if omitted")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--init-weights", default=None,
                    help="safetensors file or dir to warm-start from")
    ap.add_argument("--from-hf", default=None, metavar="HF_DIR",
                    help="warm-start from a HuggingFace Llama checkpoint "
                         "dir: converted once into --ckpt-dir/"
                         "hf_converted, the model config taken from it")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--lr-schedule", choices=("constant", "cosine"),
                    default="constant",
                    help="after the warmup: constant, or cosine decay to "
                         "10%% of --lr over --steps")
    ap.add_argument("--warmup-steps", type=int, default=0,
                    help="linear warmup from 0 to --lr over N steps")
    ap.add_argument("--grad-clip", type=float, default=0.0,
                    metavar="NORM",
                    help="clip gradients to this global L2 norm before "
                         "the update (0 = off)")
    ap.add_argument("--xent-chunks", type=int, default=0,
                    help="cross-entropy over N sequence slices (0 = off)")
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--remat", default="none",
                    choices=("none", "full", "dots", "nvme"),
                    help="'dots' keeps the weight products and recomputes "
                         "the rest; 'full' recomputes whole layers; "
                         "'nvme' also moves the layer inputs to NVMe "
                         "(--offload-acts DIR)")
    ap.add_argument("--offload-acts", default=None, metavar="DIR",
                    help="backing dir of --remat nvme")
    ap.add_argument("--offload-opt", default=None, metavar="DIR",
                    help="keep the AdamW moments on NVMe under DIR")
    ap.add_argument("--lora", type=int, default=0, metavar="RANK",
                    help="train rank-RANK LoRA adapters over a frozen "
                         "base instead of every weight")
    ap.add_argument("--lora-alpha", type=float, default=None,
                    help="LoRA scale numerator (default: RANK)")
    ap.add_argument("--flash", action="store_true",
                    help="attention through the flash kernels")
    ap.add_argument("--watchdog", type=float, default=0.0,
                    metavar="SECONDS", help="per-step deadline (0 = off)")
    ap.add_argument("--save-every", type=int, default=10)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny config instead of the flagship")
    ap.add_argument("--device", default=None,
                    help="default cuda:0; 'cpu' runs the plain versions")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor parallel ways (under torchrun; dp is "
                         "world / tp)")
    args = ap.parse_args(argv)
    if args.offload_opt and args.lora:
        ap.error("--offload-opt is for full fine-tunes; LoRA optimizer "
                 "state is adapter-sized and fits in device memory")
    if (args.remat == "nvme") != bool(args.offload_acts):
        ap.error("--remat nvme and --offload-acts DIR go together")
    if args.remat == "nvme" and args.lora:
        ap.error("--remat nvme is for full fine-tunes; LoRA's frozen "
                 "base already skips most activation memory")
    if args.mix and args.data_dir:
        ap.error("--mix and --data-dir conflict: list every corpus in "
                 "--mix (DIR:W,DIR:W)")
    if args.from_hf:
        if args.init_weights or args.tiny:
            ap.error("--from-hf is mutually exclusive with "
                     "--init-weights/--tiny (it supplies both weights "
                     "and model config)")
        if not args.ckpt_dir:
            ap.error("--from-hf needs --ckpt-dir: the converted shards "
                     "are a durable multi-GB artifact")

    from nvme_strom_tpu_torch.parallel.mesh import (
        init_distributed, make_mesh, process_info, shutdown_distributed)
    dist_up = init_distributed()
    try:
        world = process_info()[1]
        if world % args.tp:
            ap.error(f"--tp {args.tp} needs a multiple of {args.tp} "
                     "processes (torchrun --nproc-per-node N); this run "
                     f"has {world}")
        if world > 1 and args.lora:
            ap.error("--lora trains on one device (its adapters' tensor "
                     "parallel is not ported)")
        mesh = make_mesh({"dp": -1, "tp": args.tp}) if world > 1 else None
        return _main(ap, args, mesh)
    finally:
        if dist_up:
            shutdown_distributed()


def _main(ap, args, mesh) -> int:
    from nvme_strom_tpu_torch.parallel.mesh import (all_gather_object,
                                                    barrier, local_device)
    rank = mesh.rank if mesh is not None else 0
    say = print if rank == 0 else (lambda *a, **k: None)

    from nvme_strom_tpu_torch.io.faults import build_engine
    from nvme_strom_tpu_torch.data.prefetch import prefetch_to_device
    from nvme_strom_tpu_torch.device import resolve_device
    from nvme_strom_tpu_torch.models.transformer import (
        flagship_config, lr_schedule, tiny_config)
    from nvme_strom_tpu_torch.train import Trainer

    if args.from_hf:
        base = _from_hf(ap, args, rank, say)
    else:
        base = tiny_config() if args.tiny else flagship_config()
    cfg = dataclasses.replace(base, remat_policy=args.remat)
    if args.xent_chunks > 1:
        cfg = dataclasses.replace(cfg, xent_chunks=args.xent_chunks)
    attn_fn = None
    if args.flash:
        from nvme_strom_tpu_torch.ops.flash_attention import make_flash_attn
        attn_fn = make_flash_attn()
    lr = lr_schedule(args.lr, args.lr_schedule, args.warmup_steps,
                     args.steps)
    say(f"model: d={cfg.d_model} L={cfg.n_layers} vocab={cfg.vocab} "
        f"seq={args.seq_len} batch={args.global_batch} "
        f"flash={args.flash} remat={args.remat}"
        + (f" mesh={mesh.shape}" if mesh is not None else ""))

    tmp = None
    mix = _parse_mix(ap, args.mix) if args.mix else None
    data_dir = args.data_dir
    if mix is None and data_dir is None:
        # rank 0 writes the shards, every rank reads its rows of them
        if rank == 0:
            tmp = tempfile.TemporaryDirectory(prefix="strom_lm_")
            synthesize_shards(tmp.name, cfg.vocab, args.seq_len,
                              n_shards=4, per_shard=8 * args.global_batch)
            say(f"data: synthesized 4 shards under {tmp.name}")
        data_dir = all_gather_object(tmp.name if tmp else None)[0]
    if mix is None:
        shards = sorted(os.path.join(data_dir, f)
                        for f in os.listdir(data_dir) if f.endswith(".tar"))
        if not shards:
            ap.error(f"no .tar shards found under {data_dir}")
    args.ckpt_dir = args.ckpt_dir or os.path.join(
        data_dir if mix is None and not args.data_dir else ".", "ckpt")

    engine = build_engine()
    act_store = offl = it = None
    try:
        dev = resolve_device(local_device() if mesh is not None
                             else args.device)
        it = prefetch_to_device(
            _mixture_batches(mix, args.global_batch, cfg.vocab, engine, dev,
                             mesh)
            if mix is not None else
            token_batches(shards, args.global_batch, cfg.vocab, engine,
                          dev, mesh), size=2)
        t0 = time.monotonic()
        if args.lora:
            _train_lora(args, cfg, attn_fn, engine, it, lr)
        else:
            if args.offload_acts:
                from nvme_strom_tpu_torch.parallel.act_offload import (
                    ActivationStore)
                act_store = ActivationStore(
                    os.path.join(args.offload_acts,
                                 "acts.bin" if mesh is None
                                 else f"acts-{rank:05d}.bin"),
                    cfg.n_layers, engine=engine)
                say(f"offload-acts: {cfg.n_layers} layer slots under "
                    f"{args.offload_acts}")
            opt_step = _OffloadStep() if args.offload_opt else None
            with Trainer(cfg, lr=args.lr, ckpt_dir=args.ckpt_dir,
                         engine=engine, attn_fn=attn_fn,
                         accum_steps=args.accum_steps,
                         init_weights=args.init_weights,
                         save_every=args.save_every, async_save=True,
                         watchdog_s=args.watchdog, device=dev,
                         hooks=[_log_step] if rank == 0 else [],
                         optimizer=(lambda ps: opt_step) if opt_step is not None
                         else None,
                         lr_schedule=None if opt_step is not None or not callable(lr)
                         else lr,
                         grad_clip=args.grad_clip,
                         act_store=act_store, mesh=mesh) as tr:
                if tr.resumed_from is not None:
                    say(f"resumed from step {tr.resumed_from}")
                if opt_step is not None:
                    from nvme_strom_tpu_torch.parallel.opt_offload import (
                        OffloadedAdam)
                    offl = OffloadedAdam(args.offload_opt, tr.params, lr=lr,
                                         weight_decay=1e-4, engine=engine,
                                         shardings=tr.shardings)
                    opt_step.offl, opt_step.params = offl, tr.params
                    say(f"offload-opt: {offl.moment_bytes() >> 20} MiB "
                          f"of moments on NVMe, peak "
                          f"{offl.peak_group_bytes() >> 20} MiB on the "
                          f"device, {offl.num_groups()} groups, resumed at "
                          f"step {offl.step}")
                    if offl.step != (tr.resumed_from or 0):
                        # step-M params with step-N moments (and the
                        # t = N+1 bias correction) diverge silently
                        raise SystemExit(
                            f"offload-opt: moment manifest is at step "
                            f"{offl.step} but params resume at step "
                            f"{tr.resumed_from or 0}: Adam would run a "
                            "divergent trajectory.  Restore the params "
                            f"checkpoint matching step {offl.step}, or "
                            "start a fresh moment dir")
                res = tr.fit(it, steps=args.steps)
            n = res.steps - (res.resumed_from or 0)
            dt = time.monotonic() - t0
            say(f"{n} steps in {dt:.2f}s ({n / max(dt, 1e-9):.2f} "
                  f"steps/s), last loss {res.last_loss:.4f}")
        it.close()              # stop the loader before the engine
        it = None
        engine.sync_stats()
        s = engine.stats
        say(f"engine stats: direct={s.bytes_direct} "
              f"fallback={s.bytes_fallback} bounce={s.bounce_bytes} "
              f"written_direct={s.bytes_written_direct} "
              f"to_device={s.bytes_to_device}")
    finally:
        if it is not None:
            it.close()
        if offl is not None:
            offl.close()
        if act_store is not None:
            act_store.close()
        engine.close_all()
        barrier()               # every rank is done with the shards
        if tmp:
            tmp.cleanup()
    return 0


def _from_hf(ap, args, rank: int, say):
    """Convert ``--from-hf`` into ``--ckpt-dir/hf_converted`` (rank 0,
    once: a conversion of the same ``config.json`` is reused, one of
    another checkpoint refused), point ``--init-weights`` at it and
    return its config with ``max_seq`` capped at ``--seq-len``."""
    import json
    from nvme_strom_tpu_torch.models.transformer import TransformerConfig
    from nvme_strom_tpu_torch.parallel.mesh import barrier
    from nvme_strom_tpu_torch.tools.convert_llama import (convert,
                                                          converted_for)
    conv_dir = os.path.join(args.ckpt_dir, "hf_converted")
    same = converted_for(args.from_hf, conv_dir)
    if same is False:
        ap.error(f"{conv_dir} holds a conversion of a different "
                 "checkpoint; refusing to mix — use a fresh --ckpt-dir "
                 "or delete hf_converted/")
    if same:
        say(f"from-hf: reusing converted shards under {conv_dir}")
    elif rank == 0:
        summary = convert(args.from_hf, conv_dir)
        say(f"from-hf: converted {summary['tensors']} tensors into "
            f"{summary['shards']} shard(s) under {conv_dir}")
    barrier()
    with open(os.path.join(conv_dir, "strom_config.json")) as f:
        cfg = TransformerConfig(**json.load(f))
    if cfg.max_seq > args.seq_len:
        # HF configs carry max_position_embeddings up to 128k; the
        # training length is a run's choice
        cfg = dataclasses.replace(cfg, max_seq=args.seq_len)
    args.init_weights = conv_dir
    return cfg


def _log_step(step: int, loss: float, dt: float) -> None:
    if step % 5 == 0:
        print(f"step {step}: loss={loss:.4f} ({dt * 1e3:.1f} ms)")


if __name__ == "__main__":
    sys.exit(main())
