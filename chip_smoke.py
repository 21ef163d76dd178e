#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``nvme_strom_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's native libraries from the checkout, then:

1. prints the card (``nvidia-smi``) and the build times;
2. holds each CUDA kernel against its plain PyTorch version on the card
   and times kernel, plain version and a library call at the shapes the
   main path gives it; for the flash kernels it also counts the outputs
   that one bf16 rounding of the probability or dS operand would put
   outside the tolerance, against the two-part split the kernels use;
   for ``h2d_copy`` it times the shipped design of the kernel beside
   two others at 4 MiB and 64 MiB, and ``copy_`` (the probe), and
   checks it from a host-tier line and an arena bridge slab; the
   split-K decode and paged attention kernels are also checked on GQA
   groups of 7 and 16 and head dims 40, 96 and 256 at positions around
   a split edge, two calls bitwise equal, and timed back to back and by
   device time (``device_ms``) at the flagship shape, at a 16k-context
   GQA shape (``LONG_GQA``) and against SDPA over ``max_len`` (the
   crossover), and their wrappers' host time a call (``host_us``); their
   any-width path (head dims 100 and 576) is checked in bf16 and f32
   and timed at the flagship shape (``any_width``); decode, paged and
   flash attention are also checked in fp16, and timed in fp16 at the
   main paths' shapes (``fp16_times``);
3. main path — streams a 2 GiB file of seeded random bytes through
   ``DeviceStream`` onto the card, on both of its paths (copies from the
   staging buffers in place, and through the overlap stage), the direct
   one also on a one-ring engine beside the default ring count, and
   checks every pass on the device;
4. main path — writes flagship-width weights (seeded) as safetensors,
   streams them onto the card with ``LazyCheckpoint`` and serves the
   same 8 greedy requests with ``DecodeServer`` and
   ``PagedDecodeServer``, whose tokens must agree;
5. checks the kernel path against the plain path at float32 through a
   whole decode step; main path — serves 8 chat requests over two
   shared 1024-token system prompts through the SSD-backed KV prefix
   store (``prefix_store_phase``): cold, NVMe hit (every page restored
   through ``h2d_copy`` from the staging buffers, ``bounce_bytes`` 0,
   bitwise the cold run's pages), ``STROM_VERIFY=full``, a flipped page
   healed by recompute, and the paged server's HBM hit, whose tokens
   must all agree; cold against hit tokens are reported in bf16 and
   asserted equal in float32 (``prefix_store_f32_phase``); main path —
   offloaded long-context decode (``offload_phase``): the flagship at
   batch 8 over a 1024-token prompt, 7 cold pages of 8 MiB streamed
   back through ``h2d_copy`` every step (tok/s, MiB a step,
   ``bounce_bytes`` 0, every eviction write O_DIRECT), float32 tokens
   equal to the dense generate's, int8 pages, a host tier of 4 pages,
   ``STROM_VERIFY=full`` with a flipped byte, a saved and reloaded
   session; an 8192-token chunked prefill against the dense prefill;
   Llama-3-8B's widths (2 layers) over a 32768-position history, every
   ``attend`` against a dense float32 softmax; and ``python -m
   nvme_strom_tpu_torch.generate --offload`` on the serving checkpoint,
   whose ids must equal the API's; main path — both of those
   decode-class sources under a prefetch storm (``qos_phase``: a thread
   streams seeded random batches of 8 × 4 MiB of the stream file onto
   the card as ``klass="prefetch"``): the prefix store's chat traffic
   through both servers (restores as ``klass="decode", hot=True``) and
   (a)'s 16 offloaded steps (``klass="decode"``), on one ring, on the
   default ring count with the QoS scheduler, both again with every read
   padded by 2 ms, with the host-DRAM tier (512 MiB, lines of the
   engine's chunk), and with the prefix store's SLO governor at
   ``STROM_KV_P99_MS`` half the default mode's first restore p50; two
   trials a mode in alternating order, the median reported:
   restore-batch and step p50/p99, the storm's GiB/s, ring depths, the
   scheduler's and the tier's counters, the governor's boosts and the
   decode weight (it must rise, then decay back to its base once
   single-page restores run alone); tokens equal to the earlier
   phases', pages bitwise, ``bounce_bytes`` 0, no arena fallback, tier
   hits from its registered carve, a flipped byte in a resident line
   caught and healed, a page put over a resident line's slot restored
   fresh; main path — tenants (``tenant_phase``, ``STROM_TENANTS``
   on): the prefix store's 8 chat requests as a gold victim behind 16
   seeded 1500-token requests of a bronze aggressor, through both
   servers, alone, with the aggressor, with its token bucket at 2 a
   second and with a 64-page store: the victim's tokens equal the
   prefix phase's hit every time, every shed on the aggressor, every
   aggressor request done, the cut store's quota evictions all the
   aggressor's and the victim's pages restored bitwise afterwards;
   victim TTFT p50/p99 alone and under the aggressor; main path —
   recovery (``resilience_phase``): engines from ``build_engine`` with
   ``STROM_RESILIENT=1`` and a seeded ``STROM_FAULTS`` read plan (an EIO
   every 7th read, a half read every 11th, a 50 ms straggler every
   13th), set for each run only: (a) phase 4's weights loaded clean,
   resilient without faults and faulted, in turns, twice, tensors
   bitwise; (b) the prefix store's chat requests on both servers and
   its 22-page restore batch, clean and faulted with hedging past 5 ms,
   tokens equal to the NVMe hit's and pages bitwise; (c) offload (a)'s
   setup, 8 timed steps, with EIO and short writes injected into the
   eviction writes too, tokens equal and the page file byte-identical
   to a clean run's; (e) one trial of the qos governor mode on a
   resilient engine, its target set from the trial's own restores, the
   decode class's hedge budget raised and decayed back; faults injected
   and recovered, no read buffered or bounced (its faulted engines'
   breaker budgets sit above what the plan injects); main path —
   failure domains (``health_phase``, the supervisor of io/health.py
   and the flight recorder on by default): (a) phase 4's weights on a
   resilient engine, clean, then with ring 1 wedged after 4 dispatches
   (``STROM_FAULT_RING_STALL_*``): the stall trips ring 1, it restarts,
   its parked reads requeue, tensors bitwise, nothing buffered or
   bounced; (b) the prefix store's requests on both servers under an
   ``estorm`` of the store file: the first four requests' restore opens
   the device breaker and browns out to buffered preads, the last four,
   queued while degraded, are shed by the server's own probe of the
   supervisor until a probe recovers the device; ``bounce_bytes`` equals
   ``degraded_bytes`` and grows no more after recovery, tokens equal the
   NVMe hit's; (c) the ``breaker_trip``, ``ring_restart`` and
   ``device_degraded`` flight dumps parse and carry op records with
   class and ring; (d) the stream file's second GiB to the card direct
   and degraded, bitwise equal; main path — cold start
   (``coldstart_phase``): the serving replica booted eagerly (load,
   then 256 MiB of the stream file and the prefix store's pages as its
   warm state, then the server) and on a ``FaultingCheckpoint`` (the
   server at once, its first step faulting weights in at decode class
   from the first tensor while the bulk lane restores from the last,
   the warm state a warm-up thunk), two trials each in turns, every
   read padded 2 ms: TTFT from boot and time to steady, tokens
   identical, each tensor read once, both lanes used; then the chaos
   drill, ring 1 wedged under the bulk lane, whose restore-class reads
   are not retried, so a failed claim is re-claimed at decode class;
   main path — critical-path attribution (``attrib_phase``): the prefix
   store's NVMe hit on both servers under ``STROM_ATTRIB=1`` and
   ``STROM_DEBUG_PORT=0``, attribution on and off in turns, every
   retired request folded (coverage + unattributed within 1% of wall,
   ``nvme_read`` and ``bridge`` nonzero), every debug route answering,
   a flight dump carrying ``attrib``; main path — static analysis and
   the lock-order witness (``lint_phase``): ``strom_lint`` over the
   checkout exits 0 and the kernel entry points it parses are exactly
   the built library's exports, then the prefix store's chat traffic on
   the default engine (rings, the QoS scheduler, a host tier) through
   both servers under ``STROM_LOCK_WITNESS=strict``: 0 cycles, the
   edges and ``/locks`` printed (``--lint`` runs it alone on weights
   made on the card); then the cost of
   the default supervisor and recorder against none, in turns: a 2 GiB
   stream pass and the prefix store's requests on both servers; main
   path — speculative decoding (``speculative_phase``): Llama-3-8B
   widths at 2 layers drafted by the flagship, the draft's steps on
   ``decode_attention``: float32 tokens equal ``decode.generate``'s
   (also for a self draft, acceptance >= 0.9), bf16 tok/s against
   ``decode.generate`` on kernel 2 in turns; then
   serves 4 requests with both servers on a 2-layer model with a GQA
   group of 7 at head_dim 128 (``GQA_SERVE``), whose tokens must
   agree;
6. training path — seeded WebDataset shards of flagship-length samples
   through ``ShardedLoader`` and ``prefetch_to_device`` into a
   ``Trainer`` with the flash kernels, warm-started from phase 4's
   weights: 10 steps at seq 2048, batch 8, checkpoints every 5 steps;
   a second ``Trainer`` resumes from step 10 with bitwise-equal
   parameters and AdamW moments and runs to step 12 under the profiler;
   then ``STROM_VERIFY`` on reads (``verify_phase``): phase 4's weights
   loaded unverified and under ``STROM_VERIFY=full`` in turns (every
   payload byte verified, tensors bitwise equal, both times printed), a
   flipped payload byte in a copy raising ``ChecksumError``, both
   servers on the verified weights; the training shards stamped with
   ``stamp_wds``, a verified epoch equal to the unverified one, and a
   flipped sample byte raising with the shard's name; then (d) of the
   recovery phase (``resilience_loader_phase``): those shards with the
   flipped byte on a faulted resilient engine under
   ``STROM_VERIFY=full`` and a shard error budget of 1, the epoch
   completing on the other 3 shards with the damaged one quarantined;
7. checks one float32 train step of the flagship through the flash
   kernels against the same step through their plain versions; then
   training beyond device memory (``train_offload_phase``): one step of
   the flagship's widths at 16 layers under remat none, full, dots and
   nvme (layer inputs through the NVMe activation store), loss and
   gradients against none's, activation peaks in that order, nvme's
   writes and reads one a layer, O_DIRECT, nothing bounced;
   ``OffloadedAdam`` (64 MiB groups) against the in-HBM AdamW over 10
   flagship steps fed the same gradients, the moments' device memory
   within twice a peak group, every moment byte written O_DIRECT, the
   moment file resumed bitwise and a dirty manifest refused; QLoRA rank
   16 over an int4 base of Llama-3-8B widths (2 layers): t=0 logits,
   a falling loss, the base untouched and without gradients, the
   adapter checkpoint resumed bitwise, ms a step against a bf16 base in
   turns; ``python -m nvme_strom_tpu_torch.train_lm`` with both
   offloads, a 3:1 ``--mix``, warmup + cosine and a clip for 2 steps,
   then resumed to 3; then the data path (``data_formats_phase``):
   64 MiB of seeded token samples as wds, tfrecord and fixedrec shards,
   one epoch each and one of wds_raw over the wds shards, every batch
   bitwise the wds path's, GiB/s and host CPU seconds, zero-copy pieces
   one ``h2d_copy`` each; ``MixtureLoader``'s 256 draws against numpy's;
   ``prefetch_to_device``'s copies running beside a held consumer
   stream, bitwise the loader's; then the ViT trainer (``vit_phase``):
   the reference ViT's default widths on fixedrec shards of 150,532-byte
   records, one loader epoch (GiB/s, one ``h2d_copy`` a piece, nothing
   bounced), the first batch's logits decoded on the card against a
   float32 CPU forward, 20 AdamW steps of batch 64 (img/s, finite
   losses) and two profiled (the device-busy share); and
   ``eval_ppl --npy`` over phase 4's weights (``eval_ppl_phase``): card
   and CPU float32 cross-entropies within 1e-3 relative, then bf16,
   ``--int8`` and ``--int4``, no card run bouncing a byte;
8. holds the ring all-gather (kernel 7) against its plain version on 4
   ranks of the card at the row width of phase 9's restore (and on a
   small ragged width), three calls in a row, and times it back to back,
   on the device alone (torch.profiler) and by the difference, the
   wrapper's host time a call; on a machine with two or four cards also
   across them against ``torch.cuda.nccl``;
9. read-once restore path — restores the newest training checkpoint of
   phase 6 with the read-all path, then with ``STROM_ICI_SCATTER=1``
   over an exchange group of 4 ranks on the card (each rank reads a
   quarter of the payload, the ring gathers them), and loads phase 4's
   weights both ways: every tensor bitwise equal;
10. prints a ``health {json}`` and a ``coldstart {json}`` line among
   the summaries, then one JSON line of per-kernel results, the card
   again, and the
   result line ``{"ok": true, "device": {...}}`` last.  Each kernel's
   entry has ``name``, ``route``, ``source``, ``replaces``,
   ``launches``, ``max_abs_err``, ``ms`` (and the same time again as
   ``kernel_ms``), ``plain_ms``, ``bound_ms``, ``bound_by`` and
   ``library_ms``; the flash kernels' entries add ``tflops`` (the
   algorithm's flops over ``ms``) and ``units`` (``wgmma`` for the
   tensor-core kernels, ``fma`` for the fp32 FMA ones); the attention
   kernels' entries add ``device_ms`` and ``library_device_ms`` (the
   device time of ``ms`` and ``library_ms``, the calls queued ahead),
   ``host_us``, ``split_len``, ``long_gqa``, ``any_width`` and (decode)
   ``long_gqa8`` and ``crossover``; the ring's entry adds ``device_ms``,
   ``host_us``, ``design`` and, on two or four cards, ``two_cards`` and
   ``four_cards``.

The weight-only int8 / int4 kernels (``check_quant``, after the fp16
times): ``quant_gemv`` against ``quant_matmul_plain`` (max |err| over
max |plain| 1e-2 in bf16 / fp16, 1e-5 in fp32, TF32 off) and
``dequant`` against ``dequant_plain`` bitwise, two calls of each bitwise
equal, at Llama-3-8B's MLP weights at M 1, 3, 8, 16 and one M past
``QUANT_GEMV_MAX_ROWS`` (also through ``quant_matmul``'s dequant route),
Mixtral-8x7B's int8 expert leaves, int4 groups of 128 and 24, d_out 1000
and 1003 and the int8 lm_head; then every Llama-3-8B weight timed at M 8
(``quant ...`` lines: GEMV and dequant ms and device ms, bounds, today's
``wmat`` + ``torch.matmul``, the bf16 matmul, ``torch._weight_int8pack_mm``
/ ``_weight_int4pack_mm`` where the installed torch runs them on CUDA)
and the GEMV against dequant + matmul at M 1-64 (``quant crossover``).
Main path 1j (``moe_quant_phase``) must launch both; it also logs each
mode's prefill step (the dequant route) and fails if a CUDA leaf was
dequantized by torch ops.  ``python3 chip_smoke.py --quant`` runs the
check and that path alone after the build.

Main path 6, before phase 8, is Direct SQL (``sql_phase``): tables
written from the seed by the port's own writers (``sql/pqwrite.py``,
``formats/arrow.py``) under ``.bench_torch/sql/``, scanned through the
engine and ``h2d_copy``, decoded and aggregated on the card, every answer
held against numpy: (a) ``SELECT k, COUNT(*), SUM(v), MEAN(v) ... GROUP
BY k`` over 1 GiB (2^27 rows, 16 row groups of 1 MiB PLAIN pages) with
``bounce_bytes`` 0, at both fold methods and windows 0 and 64 MiB,
beside an engine-only read of the file, then both windows on 8 MiB row
groups; (b) a string key of 8 RLE_DICTIONARY labels, each chunk's
indices decoded on the card equal to numpy's, bounce within the raw
index bytes; (c) GZIP level 1, bounce equal to the decompressed page
bytes; (d) a 1/8 BETWEEN with ORDER BY v DESC LIMIT 10, at least 27 of
32 row groups skipped by the zone maps; (e) the star join; (f) nulls in
v2 pages; (g) a ``DeviceTable`` of (a) queried with 0 NVMe bytes, and a
control fold with TF32 on that must fail the SUM limit (5e-8 of a
group's sum of |v|); (h) 256 MiB of Arrow IPC bitwise, bounce 0; (i)
``multi_groupby`` over 4 files.  Part (j) runs in main path 4's
ranks: ``dist_groupby`` over (i)'s files.  ``python3 chip_smoke.py
--sql`` runs the phase alone after the build; ``--multigpu`` runs (j)
with main path 4.

Main path 4, after phase 9, is data and tensor parallel across
processes (``multigpu_phase``): the one-rank references on ``cuda:0``,
then every count at 0 and the ranks started as ``chip_smoke.py
--multigpu-worker``, two on ``cuda:0`` over gloo on one card, one a card
over NCCL on 2-4 cards; every rank must launch kernels 1, 2 and 4-6
(and kernel 7 across cards); part (j) is Direct SQL's ``dist_groupby``.  ``python3 chip_smoke.py --multigpu`` runs
that path alone after the build.

Main path 5 is sequence and pipeline parallelism across processes
(``sp_pp_phase``), started as ``chip_smoke.py --sp-pp-worker`` the same
way after the one-rank references: (a) the ring on the flash kernels and
(b) Ulysses on them at LONG_GQA's heads, batch 1, 16384 tokens, against
one rank's flash over the whole sequence (self-calibrated against
float32), the ring launching each flash kernel n(n + 1)/2 times a call
over n ranks; (c) the float32 flagship through ``Trainer`` under sp and
(d) through ``make_pp_train_step``, against one rank; (e) the loader's
``seq_axis``; (f) bf16 steps at Llama-3-8B's widths.  Every rank must
launch ``h2d_copy`` and kernels 4-6.  ``python3 chip_smoke.py --sp-pp``
runs that path alone after the build.

Each path is driven with every launch count set to 0 just before it and
read just after: every kernel of the serving path must have launched in
phases 3-4, again in the prefix-store run and in the GQA serve run of
phase 5, ``h2d_copy`` in its offload run, kernels 1-3 in its qos and
tenant runs, in the recovery run and in the failure-domain run,
kernels 1-2 in the cold-start run, kernels 1-3 in the attribution
and lint runs, ``decode_attention`` in the speculative run, the flash kernels
and ``h2d_copy``
in phase 6, kernels 1-3 in its verify run, ``h2d_copy`` in the
recovering loader's run, ``h2d_copy`` and the flash kernels in
the training-beyond-device-memory run, ``h2d_copy`` in the data-format,
ViT, eval_ppl and SQL runs, and ``h2d_copy`` and ``ici_ring_gather`` in
phase 9, which must also end with no brown-out (``ici_fallbacks`` 0).
Any failure exits non-zero before the result line; so does a machine
without CUDA, or a directory without the package.
"""

from __future__ import annotations

import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA_DIR = os.path.join(ROOT, ".bench_torch")
SEED = 1234
STREAM_BYTES = 2 << 30
#: H100 SXM HBM3 bandwidth (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
#: PCIe Gen5 x16, one direction: the host link the h2d copy crosses
PCIE_BYTES_PER_S = 64e9
#: H100 SXM float32 outside the tensor cores (NVIDIA data sheet): the
#: least time for float32 work
F32_FLOPS_PER_S = 67e12
#: H100 SXM dense bf16 tensor cores (NVIDIA data sheet): the least time
#: for bf16 attention, whatever units the kernel uses
BF16_FLOPS_PER_S = 989e12
#: (rtol, atol) of the attention kernels against their plain versions.
#: bf16: both accumulate in fp32 and round the output once, so they may
#: differ by one bf16 ulp (2**-7 relative), plus fp32 summation-order
#: noise where the output is near zero.
BF16_TOL = (2 ** -7, 2e-5)
#: fp16: as bf16, one fp16 ulp (2**-10 relative)
F16_TOL = (2 ** -10, 2e-5)
F32_TOL = (1e-4, 1e-4)
F32_LOGITS_TOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


class _env:
    """Set environment variables for a block, restoring them after."""

    def __init__(self, **kv):
        self.kv = {k: str(v) for k, v in kv.items()}

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in self.kv}
        os.environ.update(self.kv)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class _uncounted:
    """A block whose kernel launches are checks against a reference or
    timings, not the main path's: each wrapper's count is put back."""

    def __init__(self, kernels):
        self.kernels = kernels

    def __enter__(self):
        self.saved = {n: fn.launches for n, fn in self.kernels.items()}

    def __exit__(self, *exc):
        for n, fn in self.kernels.items():
            fn.launches = self.saved[n]


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call, CUDA events around ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds per call: CUDA events around ``iters``
    calls queued behind a spin kernel, so the card runs them back to
    back without waiting on the host.  Unlike ``time_ms`` it leaves out
    the host's cost of launching, which bounds a call whose kernels take
    less.  The spin doubles until it outlasts the queuing."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 1 << 22
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued = not start.query()    # the spin still ran: all queued
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / iters
        if cycles >= 1 << 34:
            raise RuntimeError("device_ms: the calls never queued ahead "
                               "of the card")
        cycles *= 2


def host_us(fn, iters: int = 200, rounds: int = 5) -> float:
    """Host microseconds a call: the median over ``rounds`` of
    perf_counter around ``iters`` calls that start on an idle card and
    are not waited for.  For calls whose kernels take less time than
    their launch, the launch queue never fills, so this is the host's
    own cost of a call."""
    import statistics
    import torch
    per = []
    for _ in range(rounds):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        per.append((time.perf_counter() - t0) / iters * 1e6)
        torch.cuda.synchronize()
    return statistics.median(per)


def bound(nbytes, byte_rate, flops=0.0, flop_rate=F32_FLOPS_PER_S):
    """(ms, "bytes" or "operations"): the least time the card could take
    for work that moves ``nbytes`` at ``byte_rate`` and does ``flops``
    operations at ``flop_rate`` (default float32)."""
    t_bytes, t_ops = nbytes / byte_rate, flops / flop_rate
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


class Rotor:
    """Calls ``fn(args)`` over a ring of input sets larger than the L2
    cache, so every timed call reads its inputs from memory."""

    def __init__(self, fn, sets):
        self.fn, self.sets, self.i = fn, sets, 0

    def __call__(self):
        self.i = (self.i + 1) % len(self.sets)
        return self.fn(*self.sets[self.i])


# -- phase 2: kernels against their plain versions ---------------------------

def check_h2d(dev, results):
    import numpy as np
    import torch
    from nvme_strom_tpu_torch.ops.bridge import (h2d_copy, h2d_copy_plain,
                                                 pinned_mapping)
    big = 256 << 20
    src = torch.empty(big + 64, dtype=torch.uint8, pin_memory=True)
    src.numpy()[:] = np.random.default_rng(SEED).integers(
        0, 256, big + 64, dtype=np.uint8)
    m = pinned_mapping(src, dev)
    host = src.numpy()
    worst = 0
    # (bytes, source offset, destination offset)
    for n, so, do in [(1, 0, 0), (4095, 0, 0), (4095, 3, 1),
                      ((1 << 20) + 3, 0, 0), ((1 << 20) + 3, 5, 0),
                      ((1 << 20) + 3, 13, 7), (big, 0, 0), (big, 7, 0)]:
        dst = torch.empty(n + 16, dtype=torch.uint8, device=dev)[do:do + n]
        h2d_copy(host[so:so + n], dst, src_ptr=m.dev_base + so)
        torch.cuda.synchronize()
        if not torch.equal(dst.cpu(), src[so:so + n]):
            raise AssertionError(f"h2d_copy differs at n={n} src+{so} "
                                 f"dst+{do}")
        ref = torch.empty(n, dtype=torch.uint8, device=dev)
        h2d_copy_plain(host[so:so + n], ref)
        worst = max(worst, (dst.int() - ref.int()).abs().max().item())
        if not torch.equal(dst, ref):
            raise AssertionError(f"h2d_copy != plain at n={n}")
    log("h2d_copy: byte-identical at 1 B, 4095 B, 1 MiB+3 B, 256 MiB, "
        "aligned and misaligned")
    worst = max(worst, h2d_from_carves(dev))
    # time at the main path's shape: one staging chunk (4 MiB), over
    # 16 distinct chunks (64 MiB > L2)
    chunk, nsets = 4 << 20, 16
    dst = torch.empty(chunk, dtype=torch.uint8, device=dev)
    offs = [i * chunk for i in range(nsets)]
    kern = Rotor(lambda o: h2d_copy(host[o:o + chunk], dst,
                                    src_ptr=m.dev_base + o),
                 [(o,) for o in offs])
    plain = Rotor(lambda o: h2d_copy_plain(host[o:o + chunk], dst),
                  [(o,) for o in offs])
    lib = Rotor(lambda o: dst.copy_(src[o:o + chunk], non_blocking=True),
                [(o,) for o in offs])
    ms = time_ms(kern, 50)
    lib_ms = time_ms(lib, 50)
    probe = h2d_probe(dev, src, m)
    dst_big = torch.empty(big, dtype=torch.uint8, device=dev)
    big_ms = time_ms(lambda: h2d_copy(host[:big], dst_big,
                                      src_ptr=m.dev_base), 3, warmup=1)
    # every byte crosses the host link once and is written to HBM once;
    # the link is the slower of the two
    bound_ms, bound_by = bound(chunk, min(PCIE_BYTES_PER_S,
                                          HBM_BYTES_PER_S))
    results["h2d_copy"] = dict(
        name="h2d_copy", route="cuda",
        source="nvme_strom_tpu_torch/csrc/h2d_copy.cu",
        replaces="nvme_strom_tpu/ops/bridge.py:46",
        max_abs_err=float(worst), ms=ms, plain_ms=time_ms(plain, 20),
        library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
        shape=f"{chunk} B per launch", ms_256mib=big_ms, probe=probe,
        ok=True)
    log(f"h2d_copy 4 MiB: kernel {ms:.4f} ms "
        f"({chunk / ms / 1e6:.2f} GB/s), 256 MiB: {big_ms:.3f} ms "
        f"({big / big_ms / 1e6:.2f} GB/s)")


def h2d_from_carves(dev):
    """h2d_copy from a resident line of the host-DRAM tier and from an
    arena bridge slab, each carve registered with CUDA on its first copy
    and read in place, held against the plain version of the same bytes;
    returns the largest difference."""
    import numpy as np
    import torch
    from nvme_strom_tpu_torch.io import arena, hostcache
    from nvme_strom_tpu_torch.ops.bridge import h2d_copy, h2d_copy_plain
    from nvme_strom_tpu_torch.utils.config import HostCacheConfig
    rng = np.random.default_rng(SEED + 1)
    chunk, fkey = 4 << 20, ("chip_smoke", 0)
    hostcache.reset()
    cache = hostcache.configure(HostCacheConfig(budget_mb=16,
                                                line_bytes=chunk))
    slab = arena.carve_or_none(chunk, "bridge")
    if slab is None:
        raise AssertionError("the pinned arena gave no bridge slab")
    worst, line = 0, None
    try:
        cache.fill(fkey, 0, rng.integers(0, 256, chunk, dtype=np.uint8),
                   "decode")
        segs, _ = cache.probe_range(fkey, 0, chunk, "decode")
        line = segs[0][3]
        slab.view[:] = rng.integers(0, 256, chunk, dtype=np.uint8)
        for label, host, reg in (
                ("host-tier line", cache.line_view(line, 3, chunk),
                 cache.arena.cuda),
                ("arena bridge slab", slab.view[5:], slab.cuda)):
            dst = torch.empty(host.nbytes, dtype=torch.uint8, device=dev)
            h2d_copy(host, dst, src_ptr=reg.device_ptr(
                host.ctypes.data, host.nbytes, dev.index))
            ref = h2d_copy_plain(host, torch.empty(
                host.nbytes, dtype=torch.uint8, device=dev))
            torch.cuda.synchronize()
            worst = max(worst, (dst.int() - ref.int()).abs().max().item())
            if not torch.equal(dst, ref) or reg.devices != [dev.index]:
                raise AssertionError(f"h2d_copy from a {label} != plain")
            log(f"h2d_copy from a {label} ({host.nbytes} B, read in place "
                "from its registered carve): byte-identical to plain")
    finally:
        if line is not None:
            cache.unpin(line)
        slab.release()
        hostcache.reset()
    return worst


#: designs of the h2d kernel the probe times, in the order of
#: csrc/h2d_copy.cu `kDesigns`
H2D_DESIGNS = [
    "SM loads: 2 a thread in flight, 8 blocks/SM (shipped)",
    "SM loads: 4 unrolled, grid for 1 a thread, 8 blocks/SM",
    "bulk: 8 KiB pieces, 4 stages, 4 blocks/SM",
]


def h2d_probe(dev, src, m, rounds=5):
    """GB/s of each design in H2D_DESIGNS at 4 MiB and 64 MiB, beside
    ``copy_`` at each size: the median of ``rounds`` rounds, each of which
    times every design and ``copy_`` in turn; each design's copy is
    checked byte for byte once.  Sources rotate over 64 MiB (4 MiB) and
    256 MiB (64 MiB) of pinned host memory, so no timed call reads what
    an earlier one cached.  The probe's launches go through no wrapper
    and count nowhere."""
    import statistics
    import torch
    from nvme_strom_tpu_torch import _build
    lib = _build.kernel_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = []
    for n, nsets, iters in ((4 << 20, 16, 50), (64 << 20, 4, 8)):
        dst = torch.empty(n, dtype=torch.uint8, device=dev)
        offs = [(i * n,) for i in range(nsets)]
        runs = {"copy_": Rotor(lambda o: dst.copy_(
            src[o:o + n], non_blocking=True), offs)}
        for design, label in enumerate(H2D_DESIGNS):
            def run(o, design=design):
                _build.check(lib.strom_h2d_copy_probe(
                    m.dev_base + o, dst.data_ptr(), n, design, stream,
                    dev.index), "h2d_copy probe")
            dst.zero_()
            run(offs[1][0])
            torch.cuda.synchronize()
            if not torch.equal(dst.cpu(), src[offs[1][0]:offs[1][0] + n]):
                raise AssertionError(f"h2d probe {label}: bytes differ at "
                                     f"{n} B")
            runs[label] = Rotor(run, offs)
        times = {label: [] for label in runs}
        for _ in range(rounds):
            for label, fn in runs.items():
                times[label].append(time_ms(fn, iters))
        rows.append({"bytes": n, "gb_per_s": {
            label: [n / t / 1e6 for t in sorted(ts, reverse=True)]
            for label, ts in times.items()}})
        del dst, runs
    log(f"h2d probe, GB/s at 4 MiB and 64 MiB a launch (median of "
        f"{rounds} rounds, min-max):")
    for label in rows[0]["gb_per_s"]:
        log(f"  {label}: " + ", ".join(
            f"{statistics.median(r['gb_per_s'][label]):.2f} "
            f"({r['gb_per_s'][label][0]:.2f}-{r['gb_per_s'][label][-1]:.2f})"
            for r in rows))
    return rows


def _attn_inputs(b, nh, nkv, S, d, dtype, pos, dev, gen, nan_tail=True):
    import torch
    q = torch.randn(b, nh, 1, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, nkv, S, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, nkv, S, d, generator=gen, device=dev).to(dtype)
    if nan_tail:
        for i, p in enumerate(pos):
            k[i, :, p + 1:] = float("nan")
            v[i, :, p + 1:] = float("nan")
    return q, k, v


def _compare(name, got, want, tol):
    """Max |got - want|; raises unless every element is within
    ``atol + rtol * |want|`` for ``tol = (rtol, atol)``."""
    import torch
    err = (got.float() - want.float()).abs().max().item()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite output")
    torch.testing.assert_close(got.float(), want.float(), rtol=tol[0],
                               atol=tol[1])
    return err


def _attn_bound(pos, nh, nkv, d, itemsize, table_bytes=0):
    """Bound of one decode-attention call at positions ``pos`` (one per
    row): the K and V rows of the live positions, q, the output, pos and
    the block-table entries read once; q·k and p·v at 2 flops per
    multiply-add over every live key and query head."""
    live = sum(p + 1 for p in pos)
    nbytes = (2 * live * nkv * d + 2 * len(pos) * nh * d) * itemsize \
        + 4 * len(pos) + table_bytes
    return bound(nbytes, HBM_BYTES_PER_S, 4.0 * live * nh * d)


#: (nh, nkv, d) shapes past the powers of two that the decode kernels
#: take: a group of 7 (two chunks of 4 rows, one masked) at d 96 and at
#: d 128 (28 over 4 kv heads), a group of 16 (four chunks) at d 256, and
#: d 40 on the 64-wide build; each runs with positions at split_len - 1,
#: split_len and split_len + 1
WIDE_SHAPES = [(7, 1, 96), (28, 4, 128), (16, 1, 256), (4, 4, 40)]
#: the long GQA timing shape: a Llama-3-8B-like layer at 16k context
#: (b, nh, nkv, d, S), every row at position S - 1; and a group of 8 at
#: the same width (Llama-3-70B-like heads), decode only
LONG_GQA = (4, 32, 8, 128, 16384)
LONG_GQA8 = (4, 64, 8, 128, 16384)
#: max_len of the kernel-vs-SDPA crossover sweep, at the flagship heads
CROSSOVER_LENS = [128, 512, 2048, 8192]


def _sdpa(q, k, v, mask=None):
    """SDPA over the kv-width cache, the GQA group expanded inside."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=q.shape[1] != k.shape[1])


def _rotating(make, set_bytes, at_least=64 << 20):
    """Input sets enough to pass the 50 MB L2 in rotation (2 at least)."""
    return [make() for _ in range(max(2, -(-at_least // set_bytes)))]


def _repeatable(name, fn, args):
    """Raise unless two calls give the same bits."""
    import torch
    if not torch.equal(fn(*args), fn(*args)):
        raise AssertionError(f"{name}: two calls differ")


def _wide_cases(L, with_S):
    """WIDE_SHAPES in bf16 and f32 at positions around the split edge L:
    (label, b, nh, nkv, [S,] d, dtype, pos, tol)."""
    import torch
    return [(f"nh {nh} nkv {nkv} d {d} {str(dt)[6:]} at the split edge", 3,
             nh, nkv, *((2 * L + 3,) if with_S else ()), d, dt,
             [L - 1, L, L + 1], tol)
            for nh, nkv, d in WIDE_SHAPES
            for dt, tol in ((torch.bfloat16, BF16_TOL),
                            (torch.float32, F32_TOL))]


def check_decode(dev, results):
    import torch
    from nvme_strom_tpu_torch.device import sm_count
    from nvme_strom_tpu_torch.ops.decode_attention import (
        SPLIT_LEN, decode_attention, decode_attention_plain, kernel_launch)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flagship_pos = [0, 1, 511, 2047] * 2
    cases = [  # (label, b, nh, nkv, S, d, dtype, pos, tol)
        ("flagship bf16", 8, 8, 8, 2048, 64, torch.bfloat16, flagship_pos,
         BF16_TOL),
        ("flagship f32", 8, 8, 8, 2048, 64, torch.float32, flagship_pos,
         F32_TOL),
        ("flagship f16", 8, 8, 8, 2048, 64, torch.float16, flagship_pos,
         F16_TOL),
        ("GQA bf16", 4, 32, 8, 4097, 128, torch.bfloat16,
         [4096, 100, 0, 2500], BF16_TOL),
        ("GQA scalar pos bf16", 4, 32, 8, 4097, 128, torch.bfloat16,
         [777] * 4, BF16_TOL),
    ] + _wide_cases(SPLIT_LEN, with_S=True)
    worst = 0.0
    for label, b, nh, nkv, S, d, dt, pos, tol in cases:
        q, k, v = _attn_inputs(b, nh, nkv, S, d, dt, pos, dev, gen)
        p = (pos[0] if len(set(pos)) == 1
             else torch.tensor(pos, dtype=torch.int32, device=dev))
        err = _compare(f"decode_attention {label}",
                       decode_attention(q, k, v, p),
                       decode_attention_plain(q, k, v, p), tol)
        _repeatable(f"decode_attention {label}", decode_attention,
                    (q, k, v, p))
        if dt == torch.bfloat16:
            worst = max(worst, err)
        log(f"decode_attention {label}: max |kernel - plain| = {err:.3g} "
            f"(rtol, atol {tol}); two calls bitwise equal")
    # timing at the flagship serving shape, NaN-free inputs, 4 caches
    # (134 MB) in rotation so the cache is read from HBM every call
    b, nh, nkv, S, d = 8, 8, 8, 2048, 64
    pos_t = torch.tensor(flagship_pos, dtype=torch.int32, device=dev)
    sets = [_attn_inputs(b, nh, nkv, S, d, torch.bfloat16, flagship_pos,
                         dev, gen, nan_tail=False) for _ in range(4)]
    mask = (torch.arange(S, device=dev)[None, :]
            <= pos_t[:, None])[:, None, None, :]
    bound_ms, bound_by = _attn_bound(flagship_pos, nh, nkv, d, 2)
    kern = Rotor(lambda q, k, v: decode_attention(q, k, v, pos_t), sets)
    lib = Rotor(lambda q, k, v: _sdpa(q, k, v, mask), sets)
    results["decode_attention"] = dict(
        name="decode_attention", route="cuda",
        source="nvme_strom_tpu_torch/csrc/decode_attention.cu",
        replaces="nvme_strom_tpu/ops/decode_attention.py:35",
        max_abs_err=worst, ms=time_ms(kern, 100),
        device_ms=device_ms(kern, 100),
        plain_ms=time_ms(Rotor(lambda q, k, v: decode_attention_plain(
            q, k, v, pos_t), sets), 20),
        library_ms=time_ms(lib, 50), library_device_ms=device_ms(lib, 50),
        bound_ms=bound_ms, bound_by=bound_by,
        shape=f"b={b} nh={nh} nkv={nkv} S={S} d={d} "
        f"bf16 pos={flagship_pos}",
        split_len=kernel_launch(b, nh, nkv, d, S, 1, sm_count(0))[2],
        ok=True)
    del sets
    results["decode_attention"]["long_gqa"] = decode_long(dev, gen,
                                                          LONG_GQA)
    results["decode_attention"]["long_gqa8"] = decode_long(dev, gen,
                                                           LONG_GQA8)
    results["decode_attention"]["crossover"] = decode_crossover(dev, gen)
    results["decode_attention"]["any_width"] = any_width(
        "decode_attention", decode_attention, decode_attention_plain,
        lambda d, dt, nan: (*_attn_inputs(b, nh, nkv, S, d, dt,
                                          flagship_pos, dev, gen, nan),
                            pos_t),
        flagship_pos, nh, nkv, 0)


#: head dims of the any-width path (not a multiple of 8, or above 256)
#: checked and timed at the flagship serving shape: ragged and wide
ANY_WIDTH_D = (100, 576)


def any_width(name, kernel, plain, make, pos, nh, nkv, table_bytes):
    """``kernel`` against ``plain`` at each of ANY_WIDTH_D in bf16 and
    f32 (NaN past each position, two calls bitwise equal), then its
    time in bf16, back to back and on the device, with its bound.
    ``make(d, dtype, nan)`` gives the inputs (the last is the positions,
    on the card); ``table_bytes`` the block-table bytes the bound counts."""
    import torch
    rows = []
    for d in ANY_WIDTH_D:
        worst = 0.0
        for dt, tol in ((torch.bfloat16, BF16_TOL),
                        (torch.float32, F32_TOL)):
            args = make(d, dt, True)
            err = _compare(f"{name} d {d} {str(dt)[6:]}", kernel(*args),
                           plain(*args), tol)
            _repeatable(f"{name} d {d}", kernel, args)
            worst = max(worst, err) if dt == torch.bfloat16 else worst
            del args
        sets = _rotating(lambda: make(d, torch.bfloat16, False),
                         2 * len(pos) * nkv * (max(pos) + 1) * d * 2)
        kern = Rotor(kernel, sets)
        bound_ms, _ = _attn_bound(pos, nh, nkv, d, 2, table_bytes)
        row = {"d": d, "max_abs_err": worst, "ms": time_ms(kern, 50),
               "device_ms": device_ms(kern, 50), "bound_ms": bound_ms}
        del sets, kern
        rows.append(row)
        log(f"{name} any-width path at d {d} (flagship shape otherwise): "
            f"max |kernel - plain| {worst:.3g} in bf16, f32 within "
            f"{F32_TOL}; {row['ms']:.4f} ms back to back, "
            f"{row['device_ms']:.4f} ms on the device, bound "
            f"{bound_ms:.5f} ms")
    return rows


def decode_long(dev, gen, shape):
    """Kernel, plain version and SDPA at a long ``shape`` (b, nh, nkv, d,
    S), two caches (537 MB) in rotation."""
    import torch
    from nvme_strom_tpu_torch.device import sm_count
    from nvme_strom_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_plain, kernel_launch)
    b, nh, nkv, d, S = shape
    pos = [S - 1] * b
    sets = [_attn_inputs(b, nh, nkv, S, d, torch.bfloat16, pos, dev, gen,
                         nan_tail=False) for _ in range(2)]
    bound_ms, bound_by = _attn_bound(pos, nh, nkv, d, 2)
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    kern = Rotor(lambda q, k, v: decode_attention(q, k, v, p), sets)
    out = dict(
        shape=f"b={b} nh={nh} nkv={nkv} S={S} d={d} bf16 pos={S - 1}",
        ms=time_ms(kern, 50), device_ms=device_ms(kern, 50),
        plain_ms=time_ms(Rotor(lambda q, k, v: decode_attention_plain(
            q, k, v, p), sets), 3, warmup=1),
        library_ms=time_ms(Rotor(_sdpa, sets), 50),
        library_device_ms=device_ms(Rotor(_sdpa, sets), 50),
        bound_ms=bound_ms, bound_by=bound_by,
        split_len=kernel_launch(b, nh, nkv, d, S, 1, sm_count(0))[2])
    out["bound_share"] = out["bound_ms"] / out["ms"]
    log(f"decode_attention long GQA ({out['shape']}): kernel "
        f"{out['ms']:.4f} ms = {out['bound_share']:.3f} of its "
        f"{bound_ms:.4f} ms bound at split_len {out['split_len']} "
        f"({out['device_ms']:.4f} ms on the device), SDPA "
        f"{out['library_ms']:.4f} ms ({out['library_device_ms']:.4f}), "
        f"plain {out['plain_ms']:.4f} ms")
    return out


def decode_crossover(dev, gen):
    """Kernel against SDPA at the flagship heads (b 8, nh 8, nkv 8,
    d 64, bf16), every row at max_len - 1, caches in rotation past L2."""
    import torch
    from nvme_strom_tpu_torch.ops.decode_attention import decode_attention
    b, nh, nkv, d = 8, 8, 8, 64
    rows = []
    for S in CROSSOVER_LENS:
        pos = [S - 1] * b
        sets = _rotating(lambda: _attn_inputs(
            b, nh, nkv, S, d, torch.bfloat16, pos, dev, gen,
            nan_tail=False), 2 * b * nkv * S * d * 2)
        p = torch.tensor(pos, dtype=torch.int32, device=dev)
        kern = Rotor(lambda q, k, v: decode_attention(q, k, v, p), sets)
        lib = Rotor(_sdpa, sets)
        row = {"max_len": S, "ms": time_ms(kern, 100),
               "device_ms": device_ms(kern, 100),
               "library_ms": time_ms(lib, 100),
               "library_device_ms": device_ms(lib, 100),
               "bound_ms": _attn_bound(pos, nh, nkv, d, 2)[0]}
        rows.append(row)
        log(f"decode crossover max_len {S}: kernel {row['ms']:.4f} ms, "
            f"SDPA {row['library_ms']:.4f} ms; on the device kernel "
            f"{row['device_ms']:.4f} ms, SDPA "
            f"{row['library_device_ms']:.4f} ms; bound "
            f"{row['bound_ms']:.5f} ms ({len(sets)} caches in rotation)")
        del sets
    return rows


def _paged_inputs(b, nh, nkv, bk, max_blocks, d, dtype, pos, dev, gen,
                  garbage=True):
    """A pool holding every row's blocks in shuffled order plus one NaN
    block that every padding table entry points at."""
    import torch
    live = [p // bk + 1 for p in pos]
    n_pool = sum(live) + 1
    q = torch.randn(b, nh, 1, d, generator=gen, device=dev).to(dtype)
    kp = torch.randn(n_pool, nkv, bk, d, generator=gen, device=dev).to(dtype)
    vp = torch.randn(n_pool, nkv, bk, d, generator=gen, device=dev).to(dtype)
    trash = n_pool - 1
    if garbage:
        kp[trash] = float("nan")
        vp[trash] = float("nan")
    perm = torch.randperm(n_pool - 1, generator=torch.Generator()
                          .manual_seed(SEED)).tolist()
    table = torch.full((b, max_blocks), trash, dtype=torch.int32)
    at = 0
    for i, n in enumerate(live):
        table[i, :n] = torch.tensor(perm[at:at + n], dtype=torch.int32)
        at += n
    return q, kp, vp, table.to(dev)


def _gathered_sdpa(q, kp, vp, table, mask=None):
    """The library's paged attention: gather each row's blocks, then
    SDPA."""
    b, nb = table.shape
    _, nkv, bk, d = kp.shape
    idx = table.long()
    k = kp[idx].permute(0, 2, 1, 3, 4).reshape(b, nkv, nb * bk, d)
    v = vp[idx].permute(0, 2, 1, 3, 4).reshape(b, nkv, nb * bk, d)
    return _sdpa(q, k, v, mask)


def check_paged(dev, results):
    import torch
    from nvme_strom_tpu_torch.device import sm_count
    from nvme_strom_tpu_torch.ops.decode_attention import (SPLIT_LEN,
                                                           kernel_launch)
    from nvme_strom_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_plain)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    ragged = [0, 127, 128, 1000, 2047, 5, 300, 1500]
    bk, max_blocks = 128, 16
    cases = [  # (label, b, nh, nkv, d, dtype, pos, tol)
        ("flagship bf16", 8, 8, 8, 64, torch.bfloat16, ragged, BF16_TOL),
        ("flagship f32", 8, 8, 8, 64, torch.float32, ragged, F32_TOL),
        ("flagship f16", 8, 8, 8, 64, torch.float16, ragged, F16_TOL),
        ("GQA bf16", 4, 32, 8, 128, torch.bfloat16, [2047, 0, 129, 900],
         BF16_TOL),
    ] + _wide_cases(SPLIT_LEN, with_S=False)
    worst = 0.0
    for label, b, nh, nkv, d, dt, pos, tol in cases:
        q, kp, vp, table = _paged_inputs(b, nh, nkv, bk, max_blocks, d, dt,
                                         pos, dev, gen)
        p = torch.tensor(pos, dtype=torch.int32, device=dev)
        err = _compare(f"paged_attention {label}",
                       paged_attention(q, kp, vp, table, p),
                       paged_attention_plain(q, kp, vp, table, p), tol)
        _repeatable(f"paged_attention {label}", paged_attention,
                    (q, kp, vp, table, p))
        if dt == torch.bfloat16:
            worst = max(worst, err)
        log(f"paged_attention {label}: max |kernel - plain| = {err:.3g} "
            f"(rtol, atol {tol}); two calls bitwise equal")
    b, nh, nkv, d = 8, 8, 8, 64
    p = torch.tensor(ragged, dtype=torch.int32, device=dev)
    sets = [_paged_inputs(b, nh, nkv, bk, max_blocks, d, torch.bfloat16,
                          ragged, dev, gen, garbage=False)
            for _ in range(4)]
    S = bk * max_blocks
    mask = (torch.arange(S, device=dev)[None, :] <= p[:, None])[:, None,
                                                                None, :]
    bound_ms, bound_by = _attn_bound(
        ragged, nh, nkv, d, 2,
        table_bytes=4 * sum(p // bk + 1 for p in ragged))
    kern = Rotor(lambda q, kp, vp, t: paged_attention(q, kp, vp, t, p), sets)
    lib = Rotor(lambda q, kp, vp, t: _gathered_sdpa(q, kp, vp, t, mask),
                sets)
    results["paged_attention"] = dict(
        name="paged_attention", route="cuda",
        source="nvme_strom_tpu_torch/csrc/paged_attention.cu",
        replaces="nvme_strom_tpu/ops/paged_attention.py:36",
        max_abs_err=worst, ms=time_ms(kern, 100),
        device_ms=device_ms(kern, 100),
        plain_ms=time_ms(Rotor(lambda q, kp, vp, t: paged_attention_plain(
            q, kp, vp, t, p), sets), 20),
        library_ms=time_ms(lib, 50), library_device_ms=device_ms(lib, 50),
        bound_ms=bound_ms, bound_by=bound_by,
        shape=f"b={b} nh={nh} nkv={nkv} d={d} "
        f"block_k={bk} bf16 pos={ragged}",
        split_len=kernel_launch(b, nh, nkv, d, S, bk, sm_count(0))[2],
        ok=True)
    del sets
    results["paged_attention"]["long_gqa"] = paged_long(dev, gen)
    results["paged_attention"]["any_width"] = any_width(
        "paged_attention", paged_attention, paged_attention_plain,
        lambda d, dt, nan: (*_paged_inputs(b, nh, nkv, bk, max_blocks, d,
                                           dt, ragged, dev, gen, nan), p),
        ragged, nh, nkv, 4 * sum(x // bk + 1 for x in ragged))


def paged_long(dev, gen):
    """Kernel, plain version and gather + SDPA at LONG_GQA in pool blocks
    of 128 keys, two pools in rotation."""
    import torch
    from nvme_strom_tpu_torch.device import sm_count
    from nvme_strom_tpu_torch.ops.decode_attention import kernel_launch
    from nvme_strom_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_plain)
    b, nh, nkv, d, S = LONG_GQA
    bk = 128
    pos = [S - 1] * b
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    sets = [_paged_inputs(b, nh, nkv, bk, S // bk, d, torch.bfloat16, pos,
                          dev, gen, garbage=False) for _ in range(2)]
    bound_ms, bound_by = _attn_bound(pos, nh, nkv, d, 2,
                                     table_bytes=4 * b * (S // bk))
    kern = Rotor(lambda q, kp, vp, t: paged_attention(q, kp, vp, t, p),
                 sets)
    out = dict(
        shape=f"b={b} nh={nh} nkv={nkv} S={S} d={d} block_k={bk} bf16 "
        f"pos={S - 1}",
        ms=time_ms(kern, 50), device_ms=device_ms(kern, 50),
        plain_ms=time_ms(Rotor(lambda q, kp, vp, t: paged_attention_plain(
            q, kp, vp, t, p), sets), 3, warmup=1),
        library_ms=time_ms(Rotor(_gathered_sdpa, sets), 20),
        library_device_ms=device_ms(Rotor(_gathered_sdpa, sets), 20),
        bound_ms=bound_ms, bound_by=bound_by,
        split_len=kernel_launch(b, nh, nkv, d, S, bk, sm_count(0))[2])
    out["bound_share"] = out["bound_ms"] / out["ms"]
    log(f"paged_attention long GQA ({out['shape']}): kernel "
        f"{out['ms']:.4f} ms = {out['bound_share']:.3f} of its "
        f"{bound_ms:.4f} ms bound at split_len {out['split_len']} "
        f"({out['device_ms']:.4f} ms on the device), gather + SDPA "
        f"{out['library_ms']:.4f} ms ({out['library_device_ms']:.4f}), "
        f"plain {out['plain_ms']:.4f} ms")
    return out


def attention_host_us(dev):
    """Host microseconds a call of ``decode_attention`` and
    ``paged_attention`` at the flagship serving shape (the timing shapes
    of check_decode and check_paged), positions on the card as the
    servers pass them.  It calls only the wrappers' public signature, so
    it times any tree's package that is first on ``sys.path``."""
    import torch
    from nvme_strom_tpu_torch.ops.decode_attention import decode_attention
    from nvme_strom_tpu_torch.ops.paged_attention import paged_attention
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    pos = [0, 1, 511, 2047] * 2
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    q, k, v = _attn_inputs(8, 8, 8, 2048, 64, torch.bfloat16, pos, dev,
                           gen, nan_tail=False)
    args = _paged_inputs(8, 8, 8, 128, 16, 64, torch.bfloat16, pos, dev,
                         gen, garbage=False)
    out = {"decode": host_us(lambda: decode_attention(q, k, v, p)),
           "paged": host_us(lambda: paged_attention(*args, p))}
    log(f"attention wrappers' host time a call (us): {out}")
    return out


#: (rtol, atol as a fraction of max |plain|) of the flash kernels against
#: their plain versions: both compute in fp32 from the same inputs and
#: round once, so bf16 results may differ by one bf16 ulp (2**-7); sums
#: over up to 2048 keys or queries run in another order, which the
#: relative atol covers where a value is near zero.  lse is fp32 on both
#: sides: atol 1e-4 absolute.
FLASH_BF16_TOL = (2 ** -7, 1e-4)
FLASH_F16_TOL = (2 ** -10, 1e-4)
FLASH_F32_TOL = (1e-4, 1e-5)
FLASH_TOL = {"bfloat16": FLASH_BF16_TOL, "float16": FLASH_F16_TOL,
             "float32": FLASH_F32_TOL}
LSE_ATOL = 1e-4


def _flash_compare(name, got, want, tol):
    atol = tol[1] * want.float().abs().max().item() + 1e-6
    return _compare(name, got, want, (tol[0], atol))


def _flash_case(dev, gen, b, h, s, skv, d, dtype):
    """q, k contiguous and v, dout as (b, s, h, d) views, the layouts the
    model hands the kernels."""
    import torch

    def bhsd(n):
        return torch.randn(b, h, n, d, generator=gen, device=dev).to(dtype)

    def bshd(n):
        return torch.randn(b, n, h, d, generator=gen, device=dev).to(
            dtype).transpose(1, 2)
    return bhsd(s), bhsd(skv), bshd(skv), bshd(s)


def _flash_pairs(b, h, s, skv, causal):
    """Unmasked (query, key) pairs: the work the kernels must do."""
    return b * h * (s * (s + 1) // 2 if causal else s * skv)


def split_trap(q, k, v, do, causal, scale, tol):
    """Why the tensor-core kernels split P and dS into two bf16 parts:
    out, dV, dK and dQ of the plain versions recomputed with the
    product's probability or dS operand rounded once to bf16 (``one``)
    and split x = hi + lo into two bf16 parts (``split``), both products
    in fp32, counted against the plain versions at the kernels'
    tolerance."""
    import torch
    from nvme_strom_tpu_torch.ops import flash_attention as fa
    out, lse = fa.flash_fwd_plain(q, k, v, causal, scale)
    delta = (do.float() * out.float()).sum(-1)
    p, ds = fa._probs_and_ds(q, k, v, do, lse, delta, causal, scale)
    qf, vf, dof = q.float(), v.float(), do.float()
    # the forward's operand: exp(s − m), normalised after the product
    sc = fa._masked_scores(q, k, causal, scale, prescale=True)
    pf = torch.exp(sc - sc.amax(-1, keepdim=True))
    l = pf.sum(-1, keepdim=True)

    def parts(x):
        hi = x.bfloat16().float()
        return hi, (x - hi).bfloat16().float()

    def outside(got, want):
        atol = tol[1] * want.float().abs().max().item() + 1e-6
        return int(((got.float() - want.float()).abs()
                    > tol[0] * want.float().abs() + atol).sum().item())
    dk, dv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, scale)
    dq = fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, scale)
    counts = {}
    for name, x, other, scale_by, want in (
            ("out", pf, vf, l, out),
            ("dv", p.transpose(-1, -2), dof, 1.0, dv),
            ("dk", ds.transpose(-1, -2), qf, 1.0, dk),
            ("dq", ds, k.float(), 1.0, dq)):
        hi, lo = parts(x)
        one = ((hi @ other) / scale_by).to(q.dtype)
        two = ((hi @ other + lo @ other) / scale_by).to(q.dtype)
        counts[name] = {"elements": want.numel(), "one": outside(one, want),
                        "split": outside(two, want)}
    return counts


def check_flash(dev, results):
    """Kernels 4-6 against their plain versions, bitwise determinism of
    the backward, and times at the main path's shape."""
    import torch
    import torch.nn.functional as F
    from nvme_strom_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    cases = [  # (label, b, h, s, skv, d, dtype, causal, dlse)
        ("flagship bf16 causal", 8, 8, 2048, 2048, 64, torch.bfloat16,
         True, False),
        ("flagship f32 causal", 8, 8, 2048, 2048, 64, torch.float32, True,
         False),
        ("ragged causal s=777 d=128 bf16", 2, 8, 777, 777, 128,
         torch.bfloat16, True, False),
        ("non-causal s=1000 skv=1536 d=128 bf16", 2, 8, 1000, 1536, 128,
         torch.bfloat16, False, False),
        ("dlse != 0, causal s=2048 d=64 bf16", 2, 8, 2048, 2048, 64,
         torch.bfloat16, True, True),
        # one row past the tensor-core kernels' 128-row tiles
        ("causal s=129 d=128 bf16", 2, 8, 129, 129, 128, torch.bfloat16,
         True, False),
        # fp16 runs the fp32 FMA kernels, rounded once to fp16
        ("ragged causal s=777 d=128 f16", 2, 8, 777, 777, 128,
         torch.float16, True, False),
    ]
    worst = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for label, b, h, s, skv, d, dt, causal, with_dlse in cases:
        tol = FLASH_TOL[str(dt)[6:]]
        scale = d ** -0.5
        q, k, v, do = _flash_case(dev, gen, b, h, s, skv, d, dt)
        out, lse = fa.flash_fwd(q, k, v, causal, scale)
        out_p, lse_p = fa.flash_fwd_plain(q, k, v, causal, scale)
        errs = {"flash_fwd": _flash_compare(f"flash_fwd out {label}", out,
                                            out_p, tol)}
        lse_err = _compare(f"flash_fwd lse {label}", lse, lse_p,
                           (0.0, LSE_ATOL))
        delta = (do.float() * out.float()).sum(-1)
        if with_dlse:
            delta = delta - torch.randn(delta.shape, generator=gen,
                                        device=dev)
        delta = delta.contiguous()
        args = (q, k, v, do, lse, delta, causal, scale)
        dq = fa.flash_bwd_dq(*args)
        dk, dv = fa.flash_bwd_dkv(*args)
        errs["flash_bwd_dq"] = _flash_compare(
            f"flash_bwd_dq {label}", dq, fa.flash_bwd_dq_plain(*args), tol)
        dk_p, dv_p = fa.flash_bwd_dkv_plain(*args)
        errs["flash_bwd_dkv"] = max(
            _flash_compare(f"flash_bwd_dkv dk {label}", dk, dk_p, tol),
            _flash_compare(f"flash_bwd_dkv dv {label}", dv, dv_p, tol))
        # no atomics: a second backward is bitwise the same
        dk2, dv2 = fa.flash_bwd_dkv(*args)
        if not (torch.equal(dq, fa.flash_bwd_dq(*args))
                and torch.equal(dk, dk2) and torch.equal(dv, dv2)):
            raise AssertionError(f"flash backward not deterministic "
                                 f"({label})")
        if dt == torch.bfloat16:
            for n, e in errs.items():
                worst[n] = max(worst[n], e)
        log(f"flash {label}: max |kernel - plain| out {errs['flash_fwd']:.3g}"
            f" lse {lse_err:.3g} dq {errs['flash_bwd_dq']:.3g} dk/dv "
            f"{errs['flash_bwd_dkv']:.3g}; backward bitwise repeatable "
            f"(rtol, atol/max {tol})")
        del q, k, v, do, out, lse, out_p, lse_p, dq, dk, dv, dk_p, dv_p
    log("flash: bf16 tolerances one bf16 ulp (rtol 2**-7) + "
        "1e-4*max|plain|; f16 one f16 ulp (rtol 2**-10) + 1e-4*max|plain|; "
        "f32 rtol 1e-4 + 1e-5*max|plain|; lse atol 1e-4")
    q, k, v, do = _flash_case(dev, gen, 1, 4, 2048, 2048, 64, torch.bfloat16)
    trap = split_trap(q, k, v, do, True, 64 ** -0.5, FLASH_BF16_TOL)
    log(f"flash split (b 1, h 4, s 2048, d 64, causal): elements outside "
        f"the bf16 tolerance with the probability or dS operand rounded "
        f"once to bf16 (one) or split into hi + lo (split): {trap}")
    del q, k, v, do

    # times at the main path's shape: b 8, h 8, s 2048, d 64, bf16,
    # causal, model layouts; two input sets (> 50 MB L2) in rotation
    b, h, s, d = 8, 8, 2048, 64
    scale = d ** -0.5
    sets = []
    for _ in range(2):
        q, k, v, do = _flash_case(dev, gen, b, h, s, s, d, torch.bfloat16)
        out, lse = fa.flash_fwd(q, k, v, True, scale)
        delta = (do.float() * out.float()).sum(-1).contiguous()
        sets.append((q, k, v, do, lse, delta))
    pairs = _flash_pairs(b, h, s, s, True)
    elem = b * h * s * d * 2                     # one bf16 (b,h,s,d)
    rows = b * h * s * 4                         # one fp32 (b,h,s)

    def fwd(q, k, v, *_):
        return fa.flash_fwd(q, k, v, True, scale)

    def fwd_plain(q, k, v, *_):
        return fa.flash_fwd_plain(q, k, v, True, scale)

    def sdpa(q, k, v, *_):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    def dq(q, k, v, do, lse, delta):
        return fa.flash_bwd_dq(q, k, v, do, lse, delta, True, scale)

    def dq_plain(q, k, v, do, lse, delta):
        return fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, True, scale)

    def dkv(q, k, v, do, lse, delta):
        return fa.flash_bwd_dkv(q, k, v, do, lse, delta, True, scale)

    def dkv_plain(q, k, v, do, lse, delta):
        return fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, True, scale)

    # SDPA's backward (dq, dk and dv in one call), timed alone: one
    # graph per input set, retained
    graphs = []
    for q, k, v, do, _, _ in sets:
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        graphs.append((sdpa(qs, ks, vs), (qs, ks, vs), do))

    def sdpa_bwd(out, inputs, do):
        return torch.autograd.grad(out, inputs, do, retain_graph=True)

    specs = [  # name, source, replaces, kernel, plain, library, flops, bytes
        ("flash_fwd", "flash_attention_fwd.cu", 74, fwd, fwd_plain,
         Rotor(sdpa, sets), 4 * d * pairs, 4 * elem + rows),
        ("flash_bwd_dq", "flash_attention_bwd.cu", 147, dq, dq_plain,
         Rotor(sdpa_bwd, graphs), 6 * d * pairs, 5 * elem + 2 * rows),
        ("flash_bwd_dkv", "flash_attention_bwd.cu", 181, dkv, dkv_plain,
         None, 8 * d * pairs, 6 * elem + 2 * rows),
    ]
    for name, src, line, kern, plain, lib, flops, nbytes in specs:
        bound_ms, bound_by = bound(nbytes, HBM_BYTES_PER_S, flops,
                                   BF16_FLOPS_PER_S)
        ms = time_ms(Rotor(kern, sets), 10)
        results[name] = dict(
            name=name, route="cuda",
            source=f"nvme_strom_tpu_torch/csrc/{src}",
            replaces=f"nvme_strom_tpu/ops/flash_attention.py:{line}",
            max_abs_err=worst[name],
            ms=ms, tflops=flops / ms / 1e9, units=fa.flash_route(
                name.split("_")[-1], torch.bfloat16),
            plain_ms=time_ms(Rotor(plain, sets), 3, warmup=1),
            library_ms=time_ms(lib, 10) if lib is not None else None,
            bound_ms=bound_ms, bound_by=bound_by,
            shape=f"b={b} h={h} s={s} d={d} bf16 causal", ok=True)
    results["flash_bwd_dq"]["library_covers"] = \
        "SDPA backward: dq, dk and dv in one call (rows 5 and 6)"
    bwd_ms = results["flash_bwd_dq"]["ms"] + results["flash_bwd_dkv"]["ms"]
    log(f"flash backward (b={b} h={h} s={s} d={d} bf16 causal): dq "
        f"{results['flash_bwd_dq']['ms']:.4f} ms + dk/dv "
        f"{results['flash_bwd_dkv']['ms']:.4f} ms = {bwd_ms:.4f} ms against "
        f"SDPA's whole backward {results['flash_bwd_dq']['library_ms']:.4f}"
        f" ms")
    results["flash_bwd_dkv"]["library_covers"] = \
        "in flash_bwd_dq's library_ms"
    del sets, graphs
    return trap


def fp16_times(dev, results):
    """fp16 on kernels 2-6 at the main paths' shapes: decode and paged
    attention at the flagship serving shape (back to back and on the
    device), the flash kernels (fp32 FMA kernels, no tensor cores) at
    the training shape; each beside its bf16 kernel's time in
    ``results``.  The checks against the plain versions ran in
    check_decode, check_paged and check_flash."""
    import torch
    from nvme_strom_tpu_torch.ops import flash_attention as fa
    from nvme_strom_tpu_torch.ops.decode_attention import decode_attention
    from nvme_strom_tpu_torch.ops.paged_attention import paged_attention
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    f16 = torch.float16
    pos = [0, 1, 511, 2047] * 2
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    sets = [_attn_inputs(8, 8, 8, 2048, 64, f16, pos, dev, gen, False)
            for _ in range(4)]
    kern = Rotor(lambda q, k, v: decode_attention(q, k, v, p), sets)
    results["decode_attention"]["fp16"] = {
        "ms": time_ms(kern, 100), "device_ms": device_ms(kern, 100)}
    ragged = [0, 127, 128, 1000, 2047, 5, 300, 1500]
    pr = torch.tensor(ragged, dtype=torch.int32, device=dev)
    sets = [_paged_inputs(8, 8, 8, 128, 16, 64, f16, ragged, dev, gen,
                          garbage=False) for _ in range(4)]
    kern = Rotor(lambda q, kp, vp, t: paged_attention(q, kp, vp, t, pr),
                 sets)
    results["paged_attention"]["fp16"] = {
        "ms": time_ms(kern, 100), "device_ms": device_ms(kern, 100)}
    del sets, kern
    b, h, s, d = 8, 8, 2048, 64
    scale = d ** -0.5
    sets = []
    for _ in range(2):
        q, k, v, do = _flash_case(dev, gen, b, h, s, s, d, f16)
        out, lse = fa.flash_fwd(q, k, v, True, scale)
        delta = (do.float() * out.float()).sum(-1).contiguous()
        sets.append((q, k, v, do, lse, delta))
    for name, fn in (
            ("flash_fwd", lambda q, k, v, *_: fa.flash_fwd(q, k, v, True,
                                                           scale)),
            ("flash_bwd_dq", lambda *a: fa.flash_bwd_dq(*a, True, scale)),
            ("flash_bwd_dkv", lambda *a: fa.flash_bwd_dkv(*a, True, scale))):
        results[name]["fp16"] = {
            "ms": time_ms(Rotor(fn, sets), 5, warmup=1),
            "units": fa.flash_route(name.split("_")[-1], f16)}
    del sets
    log("fp16 (kernel ms back to back; attention also on the device): " +
        json.dumps({n: results[n]["fp16"] for n in (
            "decode_attention", "paged_attention", "flash_fwd",
            "flash_bwd_dq", "flash_bwd_dkv")}))


# -- phase 3: the headline stream --------------------------------------------

def _weighted_sum_np(words, first):
    import numpy as np
    idx = np.arange(first, first + words.size, dtype=np.int64)
    return int((words * (idx % 65521 + 1)).sum())


def write_stream_file(path):
    """STREAM_BYTES seeded random bytes, on disk and out of the page
    cache; returns the reference checksum."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    block = 64 << 20
    total = 0
    with open(path, "wb") as f:
        for off in range(0, STREAM_BYTES, block):
            data = rng.integers(0, 1 << 63, block // 8, dtype=np.int64)
            total += _weighted_sum_np(data, off // 8)
            f.write(data.tobytes())
        f.flush()
        os.fsync(f.fileno())
        os.posix_fadvise(f.fileno(), 0, 0, os.POSIX_FADV_DONTNEED)
    return total & ((1 << 64) - 1)


def stream_once(ds, path, dev, want):
    """One pass of ``ds.stream_file``, checksummed on the device;
    returns its seconds and the host seconds spent in the checksum's
    launches (the rest is inside the stream)."""
    import torch
    acc = torch.zeros((), dtype=torch.int64, device=dev)
    first = 0
    consumer_s = 0.0
    t0 = time.monotonic()
    for chunk in ds.stream_file(path):
        t1 = time.monotonic()
        words = chunk.view(torch.int64)
        idx = torch.arange(first, first + words.numel(), device=dev)
        acc += (words * (idx % 65521 + 1)).sum()
        first += words.numel()
        consumer_s += time.monotonic() - t1
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    got = acc.item() & ((1 << 64) - 1)
    if first * 8 != STREAM_BYTES or got != want:
        raise AssertionError(f"stream checksum {got:#x} != {want:#x} "
                             f"({first * 8} bytes)")
    return dt, consumer_s


def stream_phase(dev, path, want):
    """The 2 GiB stream through both of ``DeviceStream``'s paths, picked
    by the size of the engine's staging pool: the default pool (64
    buffers) is large enough for each copy to read its staging buffer in
    place; a pool of 8 buffers is too small for depth 3, so chunks go
    through the overlap stage's slabs (arena carves).  The direct path
    also runs on a one-ring engine (``STROM_RINGS=1``) beside the default
    ring count.  Passes run direct, one ring, overlap, overlap, one ring,
    direct, so each has a pass before and after the others; the first is
    the headline (the file's first read since it was written and dropped
    from the page cache)."""
    from nvme_strom_tpu_torch.io.engine import StromEngine, check_file
    from nvme_strom_tpu_torch.ops.bridge import DeviceStream, h2d_copy
    from nvme_strom_tpu_torch.utils.config import EngineConfig
    small = EngineConfig(buffer_pool_bytes=8 * EngineConfig().chunk_bytes)
    passes = []
    with StromEngine() as eng_d, StromEngine(small) as eng_o, \
            StromEngine(EngineConfig(n_rings=1)) as eng_1:
        engines = {"direct": eng_d, "overlap": eng_o, "direct_1_ring": eng_1}
        register_s = {}
        for name, eng in engines.items():
            t0 = time.monotonic()
            eng.cuda_mapping(dev.index)      # page-lock the staging pool
            register_s[name] = time.monotonic() - t0
        streams = {n: DeviceStream(e, device=dev)
                   for n, e in engines.items()}
        if streams["direct"].overlap or not streams["overlap"].overlap \
                or streams["direct_1_ring"].overlap:
            raise AssertionError("the pool sizes did not pick the paths")
        rings = {n: e.n_rings for n, e in engines.items()}
        for name in ("direct", "direct_1_ring", "overlap", "overlap",
                     "direct_1_ring", "direct"):
            before = h2d_copy.launches
            dt, consumer_s = stream_once(streams[name], path, dev, want)
            passes.append({"path": name, "seconds": dt,
                           "gib_per_s": STREAM_BYTES / dt / 2**30,
                           "consumer_s": consumer_s,
                           "launches": h2d_copy.launches - before})
            log(f"stream pass {len(passes)} ({name}): {STREAM_BYTES} B in "
                f"{dt:.3f} s = {passes[-1]['gib_per_s']:.3f} GiB/s "
                f"({consumer_s:.3f} s of it in the checksum's launches), "
                f"checksum ok, h2d_copy launches {passes[-1]['launches']}")
        stats = {}
        for name, eng in engines.items():
            eng.sync_stats()
            stats[name] = eng.stats.snapshot()
        backend = eng_d.backend
    # the storage side alone, on the same file
    ceilings = read_ceilings(path)
    direct = check_file(path)["supports_direct"]
    by_path = {n: [p["gib_per_s"] for p in passes if p["path"] == n]
               for n in engines}
    log(f"stream: staging pools registered in {register_s} s; engine "
        f"{backend}, rings {rings}, O_DIRECT {'yes' if direct else 'no'}; "
        f"stats {stats}; after it, on the same file: {ceilings}")
    log(f"stream GiB/s on the default ring count ({rings['direct']} "
        f"rings): {by_path['direct']}; STROM_RINGS=1: "
        f"{by_path['direct_1_ring']}")
    for p in passes:
        if p["launches"] <= 0:
            raise AssertionError(f"a {p['path']} pass launched no h2d_copy")
    for name, st in stats.items():
        if st["bytes_fallback"] == 0 and st["bounce_bytes"] != 0:
            raise AssertionError(f"{name}: direct reads but bounce_bytes "
                                 "!= 0")
        if (st["overlap_chunks"] > 0) != (name == "overlap"):
            raise AssertionError(f"{name}: overlap_chunks "
                                 f"{st['overlap_chunks']}")
        if st["arena_fallbacks"]:
            raise AssertionError(f"{name}: arena_fallbacks "
                                 f"{st['arena_fallbacks']}")
    return {"gib_per_s": passes[0]["gib_per_s"],
            "seconds": passes[0]["seconds"], "passes": passes,
            "gib_per_s_by_path": by_path, "rings": rings,
            "register_s": register_s,
            "engine": backend, "stats": stats, **ceilings}


def read_ceilings(path):
    """GiB/s of the same file read by the engine alone (3 reads in
    flight, as DeviceStream keeps, no device copy) and by one thread of
    plain 4 MiB O_DIRECT preads: what the storage side allows."""
    import mmap
    from nvme_strom_tpu_torch.io.engine import StromEngine
    chunk = 4 << 20
    spans = [(o, chunk) for o in range(0, STREAM_BYTES, chunk)]
    with StromEngine() as eng:
        fh = eng.open(path)
        t0 = time.monotonic()
        pending = []
        for off, ln in spans:
            pending.extend(eng.submit_readv([(fh, off, ln)]))
            while len(pending) > 3:
                p = pending.pop(0)
                p.wait()
                p.release()
        for p in pending:
            p.wait()
            p.release()
        engine_s = time.monotonic() - t0
        eng.close(fh)
    buf = mmap.mmap(-1, chunk)
    fd = os.open(path, os.O_RDONLY | os.O_DIRECT)
    try:
        t0 = time.monotonic()
        for off, _ in spans:
            os.preadv(fd, [buf], off)
        raw_s = time.monotonic() - t0
    finally:
        os.close(fd)
        buf.close()
    return {"engine_only_gib_per_s": STREAM_BYTES / engine_s / 2**30,
            "raw_odirect_gib_per_s": STREAM_BYTES / raw_s / 2**30}


# -- phase 4: serving at flagship width --------------------------------------

def write_checkpoint(ckdir, cfg):
    import dataclasses
    from nvme_strom_tpu_torch.convert import params_from_jax
    from nvme_strom_tpu_torch.models.transformer import init_params
    from nvme_strom_tpu_torch.parallel.weights import save_checkpoint
    os.makedirs(ckdir, exist_ok=True)
    params = params_from_jax(init_params(SEED, cfg), cfg, "cpu")
    save_checkpoint(os.path.join(ckdir, "model.safetensors"), params)
    keep = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name not in ("dtype", "n_experts")}
    with open(os.path.join(ckdir, "strom_config.json"), "w") as f:
        json.dump(keep, f, indent=1)
    return params


def serve(server, requests):
    """Staggered admission: half the requests, two lookahead batches,
    then the rest; returns ({rid: tokens}, seconds)."""
    import torch
    out = {}
    t0 = time.monotonic()
    half = len(requests) // 2
    for rid, ids in requests[:half]:
        server.submit(rid, ids, 32)
    for _ in range(2):
        out.update(server.step_many(8))
    for rid, ids in requests[half:]:
        server.submit(rid, ids, 32)
    out.update(server.run(lookahead=8))
    torch.cuda.synchronize()
    return out, time.monotonic() - t0


def profile_run(run, label):
    """``run(done)`` under torch.profiler, where calling ``done()`` ends
    the profiled window (the run may go on unprofiled; the window also
    ends with the run): device time by kernel and the share of the
    window's wall time the device was busy (the profiler's own overhead
    lengthens the wall time).  Device time is kernels and copies only
    (``profile_report.device_events``): a user annotation such as the
    optimizer's spans kernels that are already counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from nvme_strom_tpu_torch.tools.profile_report import device_events
    prof = profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA])
    window = {}

    def done():
        if "secs" not in window:
            torch.cuda.synchronize()
            prof.stop()
            window["secs"] = time.monotonic() - window["t0"]
    prof.start()
    window["t0"] = time.monotonic()
    try:
        run(done)
    finally:
        done()
    secs = window["secs"]
    events = device_events(prof)
    busy_us = sum(e.self_device_time_total for e in events)
    # what the share leaves out: user annotations on the device timeline
    annotation_us = sum(e.self_device_time_total
                        for e in prof.key_averages()
                        if e.device_type.name == "CUDA"
                        and getattr(e, "is_user_annotation", False))
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    flash = {e.key[:60]: (e.self_device_time_total / 1e3, e.count)
             for e in events if "flash_" in e.key}
    flash_ms = sum(ms for ms, _ in flash.values())
    out = {"wall_s": secs, "device_busy_s": busy_us / 1e6,
           "device_busy_share": busy_us / 1e6 / secs,
           "annotation_s": annotation_us / 1e6,
           "top_kernels": [(e.key[:60], e.self_device_time_total / 1e3,
                            e.count) for e in top],
           "flash_kernels": flash, "flash_ms": flash_ms,
           "flash_share": flash_ms * 1e3 / busy_us if busy_us else 0.0}
    log(f"profile ({label}): device busy {busy_us / 1e6:.4f} s of "
        f"{secs:.4f} s wall = {out['device_busy_share']:.3f} (kernels and "
        f"copies; user annotations left out: {annotation_us / 1e6:.4f} "
        f"s); top "
        f"kernels (name, ms, calls) {out['top_kernels']}; flash kernels "
        f"{flash} = {flash_ms:.3f} ms, {out['flash_share']:.3f} of busy")
    return out


def serve_phase(dev, ckdir, cfg, cpu_params):
    import numpy as np
    import torch
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.models.serving import (DecodeServer,
                                                     PagedDecodeServer)
    from nvme_strom_tpu_torch.parallel.weights import LazyCheckpoint
    with StromEngine() as eng:
        t0 = time.monotonic()
        params = LazyCheckpoint(ckdir).load(eng, device=dev)
        torch.cuda.synchronize()
        load_s = time.monotonic() - t0
        eng.sync_stats()
        st = eng.stats.snapshot()
    for name, t in cpu_params.items():
        if not torch.equal(params[name].cpu(), t):
            raise AssertionError(f"weight {name} differs after the load")
    nbytes = sum(t.numel() * t.element_size() for t in params.values())
    log(f"weights: {len(params)} tensors, {nbytes} B in {load_s:.3f} s; "
        f"stats {st}")
    rng = np.random.default_rng(SEED)
    lengths = [16, 100, 250, 400, 700, 1000, 1250, 1500]
    requests = [(f"r{i}", rng.integers(0, cfg.vocab, n).tolist())
                for i, n in enumerate(lengths)]
    report = {"weights_bytes": nbytes, "weights_load_s": load_s}
    outs = {}
    # the first server meets every GEMM shape and allocation for the
    # first time: it runs twice, and its first (cold) run is reported
    # apart from the warm ones
    for label, make in (
            ("dense_cold", lambda: DecodeServer(params, cfg, 8, 2048,
                                                device=dev)),
            ("dense", lambda: DecodeServer(params, cfg, 8, 2048,
                                           device=dev)),
            ("paged", lambda: PagedDecodeServer(params, cfg, 8, 2048,
                                                total_blocks=128,
                                                block_len=128,
                                                device=dev))):
        srv = make()
        out, secs = serve(srv, requests)
        toks = sum(len(v) for v in out.values())
        if set(out) != {r for r, _ in requests} or \
                any(len(v) != 32 for v in out.values()):
            raise AssertionError(f"{label}: incomplete results")
        s = srv.stats()
        report[label] = {"tokens": toks, "seconds": secs,
                         "tok_per_s": toks / secs,
                         "ttft_ms_avg": s["ttft_ms_avg"],
                         "ttft_ms_max": s["ttft_ms_max"],
                         "timings": dict(srv.timings)}
        outs[label] = out
        log(f"serve {label}: {toks} tokens in {secs:.3f} s = "
            f"{toks / secs:.1f} tok/s, TTFT avg {s['ttft_ms_avg']} ms "
            f"max {s['ttft_ms_max']} ms, timings {srv.timings}")
    # the same runs under torch.profiler: the device-busy share
    for label, srv in (
            ("dense", DecodeServer(params, cfg, 8, 2048, device=dev)),
            ("paged", PagedDecodeServer(params, cfg, 8, 2048,
                                        total_blocks=128, block_len=128,
                                        device=dev))):
        report[f"{label}_profile"] = profile_run(
            lambda done, srv=srv: serve(srv, requests), f"{label} serve")
    for label in ("dense_cold", "paged"):
        if outs[label] != outs["dense"]:
            diff = [r for r in outs["dense"]
                    if outs["dense"][r] != outs[label][r]]
            raise AssertionError(f"dense and {label} tokens differ for "
                                 f"{diff}")
    log("serve: dense and paged servers gave identical tokens")
    return params, report


#: the GQA serve run: a 2-layer model at a Qwen2-7B-like attention
#: width, 28 query heads over 4 kv heads (a group of 7) at head_dim 128
GQA_SERVE = dict(d_model=3584, n_layers=2, n_heads=28, n_kv_heads=4,
                 d_ff=18944)


def gqa_serve_phase(dev, cfg):
    """GQA_SERVE's seeded weights on the card, then DecodeServer and
    PagedDecodeServer on 4 requests (prompts 16-1100, 16 new tokens
    each): their greedy tokens must agree."""
    import dataclasses
    import numpy as np
    import torch
    from nvme_strom_tpu_torch.models.serving import (DecodeServer,
                                                     PagedDecodeServer)
    from nvme_strom_tpu_torch.models.transformer import param_shapes
    gcfg = dataclasses.replace(cfg, **GQA_SERVE)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = {}
    for name, shape in param_shapes(gcfg).items():
        if len(shape) == 1:
            params[name] = torch.ones(shape, device=dev)
        else:
            fan_in = 1 if name == "tok_embed" else shape[0]
            params[name] = (torch.randn(shape, generator=gen, device=dev)
                            * fan_in ** -0.5).to(gcfg.dtype)
    rng = np.random.default_rng(SEED + 6)
    requests = [(f"g{i}", rng.integers(0, gcfg.vocab, n).tolist())
                for i, n in enumerate([16, 300, 700, 1100])]
    outs, report = {}, {"config": GQA_SERVE}
    for label, srv in (
            ("dense", DecodeServer(params, gcfg, 4, 2048, device=dev)),
            ("paged", PagedDecodeServer(params, gcfg, 4, 2048,
                                        total_blocks=64, block_len=128,
                                        device=dev))):
        t0 = time.monotonic()
        for rid, ids in requests:
            srv.submit(rid, ids, 16)
        outs[label] = srv.run(lookahead=8)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        toks = sum(len(v) for v in outs[label].values())
        report[label] = {"tokens": toks, "seconds": secs,
                         "tok_per_s": toks / secs}
        log(f"GQA serve {label} ({GQA_SERVE}): {toks} tokens in "
            f"{secs:.3f} s")
    if outs["dense"] != outs["paged"] or \
            any(len(v) != 16 for v in outs["dense"].values()):
        raise AssertionError(f"GQA serve: dense {outs['dense']} and paged "
                             f"{outs['paged']} tokens differ")
    log("GQA serve: dense and paged servers gave identical tokens")
    return report


def f32_phase(dev, cfg, params):
    """Kernel path vs plain path at float32 through one whole decode
    step after a prefill: decode_attention, and paged_attention over the
    same cache cut into blocks."""
    import dataclasses
    import torch
    from nvme_strom_tpu_torch.models import decode as dec
    from nvme_strom_tpu_torch.ops.decode_attention import decode_attention
    from nvme_strom_tpu_torch.ops.paged_attention import paged_attention
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = {k: v.float() for k, v in params.items()}
    b, s, max_len, bk = 4, 300, 512, 128
    gen = torch.Generator(device=dev).manual_seed(SEED)
    prompt = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    cache = dec.init_cache(cfg32, b, max_len, device=dev)
    logits, cache = dec.prefill(p32, prompt, cfg32, cache)
    tok = logits.argmax(-1)

    def paged(q, ck, cv, pos):
        nb = ck.shape[2] // bk

        def pool(c):
            return (c.reshape(b, cfg.n_kv_heads, nb, bk, cfg.head_dim)
                    .permute(0, 2, 1, 3, 4)
                    .reshape(b * nb, cfg.n_kv_heads, bk, cfg.head_dim)
                    .contiguous())
        table = torch.arange(b * nb, dtype=torch.int32,
                             device=dev).view(b, nb)
        return paged_attention(q, pool(ck), pool(cv), table,
                               torch.full((b,), pos, dtype=torch.int32,
                                          device=dev))

    def step(attn):
        c = {"k": cache["k"].clone(), "v": cache["v"].clone(),
             "pos": cache["pos"]}
        return dec.decode_step(p32, tok, cfg32, c, cache_attn=attn)[0]

    plain = step(None)
    out = {}
    for label, attn in (("decode_attention", decode_attention),
                        ("paged_attention", paged)):
        err = (step(attn) - plain).abs().max().item()
        if not err <= F32_LOGITS_TOL:
            raise AssertionError(f"f32 decode-step logits via {label} "
                                 f"differ from plain by {err}")
        out[label] = err
        log(f"f32 decode-step logits via {label}: max |kernel - plain| = "
            f"{err:.3g} (tol {F32_LOGITS_TOL})")
    return out


# -- phase 5b: the SSD-backed KV prefix store ---------------------------------

#: the prefix-store traffic: a chat service whose sessions share one of
#: two system prompts of 8 pages and come back after the server restarts
PREFIX_SYSTEM_TOKENS = 1024
PREFIX_USER_TOKENS = (16, 400)
PREFIX_REQUESTS = 8
PREFIX_NEW_TOKENS = 32
PREFIX_PAGE_TOKENS = 128
PREFIX_STORE_BYTES = 1 << 30
#: engine counters a store run reports (deltas over the run)
STORE_COUNTERS = ("bytes_direct", "bytes_fallback", "bounce_bytes",
                  "bytes_to_device", "bytes_verified", "checksum_failures",
                  "kv_pages_written", "kv_pages_deduped", "kv_pages_restored",
                  "kv_prefix_hits", "kv_prefix_misses",
                  "kv_restore_failures", "kv_store_evictions")


def prefix_requests(vocab):
    """PREFIX_REQUESTS seeded requests: system prompt i % 2, then a user
    turn of 16-400 tokens."""
    import numpy as np
    rng = np.random.default_rng(SEED + 7)
    systems = [rng.integers(0, vocab, PREFIX_SYSTEM_TOKENS).tolist()
               for _ in range(2)]
    return [(f"p{i}", systems[i % 2] + rng.integers(
        0, vocab, int(rng.integers(PREFIX_USER_TOKENS[0],
                                   PREFIX_USER_TOKENS[1] + 1))).tolist())
            for i in range(PREFIX_REQUESTS)]


def store_run(label, srv, requests, eng, store, rid_prefix=""):
    """Every request admitted in one step, run to the end: tokens, tok/s,
    TTFT, the engine's counter deltas, the store's device copies and the
    h2d_copy launches of the run."""
    import torch
    from nvme_strom_tpu_torch.ops.bridge import h2d_copy
    eng.sync_stats()
    before = eng.stats.snapshot()
    h0, c0 = h2d_copy.launches, store.copies if store is not None else 0
    t0 = time.monotonic()
    for rid, ids in requests:
        srv.submit(rid_prefix + rid, ids, PREFIX_NEW_TOKENS)
    out = srv.run(lookahead=8)
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    eng.sync_stats()
    after = eng.stats.snapshot()
    s = srv.stats()
    toks = sum(len(v) for v in out.values())
    if len(out) != len(requests) or \
            any(len(v) != PREFIX_NEW_TOKENS for v in out.values()):
        raise AssertionError(f"prefix store {label}: incomplete results")
    rep = {"tokens": toks, "seconds": secs, "tok_per_s": toks / secs,
           "ttft_ms_avg": s["ttft_ms_avg"], "ttft_ms_max": s["ttft_ms_max"],
           "stats": {k: after[k] - before[k] for k in STORE_COUNTERS},
           "h2d_launches": h2d_copy.launches - h0,
           "store_copies": (store.copies if store is not None else 0) - c0,
           "kv_restore_p99_ms": after.get("kv_restore_p99_ms")}
    log(f"prefix store {label}: {toks} tokens in {secs:.3f} s = "
        f"{rep['tok_per_s']:.1f} tok/s, TTFT avg {rep['ttft_ms_avg']} ms "
        f"max {rep['ttft_ms_max']} ms; h2d_copy launches "
        f"{rep['h2d_launches']}, store copies {rep['store_copies']}; "
        f"stats {rep['stats']}; restore p99 {rep['kv_restore_p99_ms']} ms")
    return {(r[len(rid_prefix):]): v for r, v in out.items()}, rep


def _writer_pages(srv, requests, store):
    """{chain key: (k, v)} of every full prompt page, taken from the
    cache slot of the first request (in slot order) that computed it:
    the bytes the store's page holds."""
    P = store.page_tokens
    pages = {}
    for slot, (_, ids) in enumerate(requests):
        for j, kx in enumerate(store.chain_keys(ids)):
            if kx not in pages:
                pages[kx] = (srv.k_cache[:, slot, :, j * P:(j + 1) * P],
                             srv.v_cache[:, slot, :, j * P:(j + 1) * P])
    return pages


def _flip_page_byte(store, key, at=100):
    """Flip one byte of ``key``'s page in the closed store's file."""
    with open(store.manifest_path) as f:
        man = json.load(f)
    slot = next(int(s) for s, row in man["pages"].items()
                if row["key"] == key.hex())
    with open(store.path, "r+b") as f:
        f.seek(slot * store.page_bytes + at)
        b = f.read(1)
        f.seek(slot * store.page_bytes + at)
        f.write(bytes([b[0] ^ 0x01]))
        f.flush()
        os.fsync(f.fileno())
        os.posix_fadvise(f.fileno(), 0, 0, os.POSIX_FADV_DONTNEED)
    return slot


def _copy_store(src, dst, page_bytes):
    """A copy of a closed store: its clean manifest and the bytes of
    every page it lists, at the same slots."""
    with open(src + ".kvman.json") as f:
        man = json.load(f)
    with open(src, "rb") as fi, open(dst, "wb") as fo:
        for slot in man["pages"]:
            fi.seek(int(slot) * page_bytes)
            fo.seek(int(slot) * page_bytes)
            fo.write(fi.read(page_bytes))
        fo.flush()
        os.fsync(fo.fileno())
        os.posix_fadvise(fo.fileno(), 0, 0, os.POSIX_FADV_DONTNEED)
    with open(dst + ".kvman.json", "w") as f:
        json.dump(man, f)


def prefix_store_phase(dev, cfg, params, shared):
    """The prefix store on both servers at flagship width, pages of
    PREFIX_PAGE_TOKENS (1 MiB) in a PREFIX_STORE_BYTES store under
    DATA_DIR, 8 requests (two shared system prompts of 8 pages):
    1. cold: each server over an empty store (every page misses and is
       written), flushed;
    2. NVMe hit: new servers over a new store object reattaching the
       dense run's clean manifest: every page restores through h2d_copy;
       the restored bytes must equal the cold run's bitwise, with
       bounce_bytes 0 and h2d_copy launches >= the pieces copied;
    3. run 2 under STROM_VERIFY=full (every page checked on staging);
    4. one byte of one system-prompt page flipped on disk, then
       STROM_VERIFY=full: the page fails its check and heals through
       recompute;
    5. HBM hit: the paged server of run 2 again, from its in-memory
       prefix cache.
    Dense-hit, paged-hit and HBM-hit tokens must be identical (the same
    suffix block_step on bitwise-equal prefix KV); cold against hit is
    reported (bf16 is not bitwise across prefill shapes) and asserted
    in float32 by prefix_store_f32_phase.  ``shared`` receives what
    qos_phase replays: a copy of the cold store, its pages, the requests
    and the NVMe-hit tokens."""
    import shutil
    import torch
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.models.kv_offload import PrefixStore
    from nvme_strom_tpu_torch.models.serving import (DecodeServer,
                                                     PagedDecodeServer)
    sdir = os.path.join(DATA_DIR, "kv_store")
    shutil.rmtree(sdir, ignore_errors=True)
    requests = prefix_requests(cfg.vocab)
    report, toks = {}, {}
    P = PREFIX_PAGE_TOKENS

    def store(name, fresh=False):
        path = os.path.join(sdir, name)
        if fresh:
            for p in (path, path + ".kvman.json"):
                if os.path.exists(p):
                    os.remove(p)
        return PrefixStore(cfg, eng, path, P, PREFIX_STORE_BYTES)

    def dense(st):
        return DecodeServer(params, cfg, PREFIX_REQUESTS, 2048, device=dev,
                            kv_store=st)

    def paged(st):
        return PagedDecodeServer(params, cfg, PREFIX_REQUESTS, 2048,
                                 total_blocks=128, block_len=P, device=dev,
                                 kv_store=st)

    with StromEngine() as eng:
        eng.cuda_mapping(dev.index)          # page-lock staging first
        # 1. cold
        st = store("chat.kvstore", fresh=True)
        srv = dense(st)
        toks["dense_cold"], report["dense_cold"] = store_run(
            "dense cold", srv, requests, eng, st)
        cold_pages = _writer_pages(srv, requests, st)
        page_bytes = st.page_bytes
        st.close()
        qos_store = os.path.join(sdir, "qos.kvstore")
        _copy_store(st.path, qos_store, page_bytes)
        shared["prefix"] = {
            "store": qos_store, "requests": requests,
            "pages": {kx: (k.clone(), v.clone())
                      for kx, (k, v) in cold_pages.items()}}
        del srv
        st_p = store("chat_paged.kvstore", fresh=True)
        toks["paged_cold"], report["paged_cold"] = store_run(
            "paged cold", paged(st_p), requests, eng, st_p)
        st_p.close()
        for label in ("dense_cold", "paged_cold"):
            r = report[label]["stats"]
            if r["kv_pages_restored"] or not r["kv_pages_written"] or \
                    r["kv_prefix_misses"] != len(cold_pages) + \
                    r["kv_pages_deduped"]:
                raise AssertionError(f"{label}: not every page missed "
                                     f"and was written: {r}")
        torch.cuda.empty_cache()
        # 2. NVMe hit, through a store object reattaching the manifest
        st = store("chat.kvstore")
        if st.pages_resident() != len(cold_pages):
            raise AssertionError(f"reattached {st.pages_resident()} pages "
                                 f"of {len(cold_pages)}")
        srv = dense(st)
        toks["dense_hit"], report["dense_hit"] = store_run(
            "dense NVMe hit", srv, requests, eng, st)
        for slot, (_, ids) in enumerate(requests):
            for j, kx in enumerate(st.chain_keys(ids)):
                k, v = cold_pages[kx]
                if not (torch.equal(srv.k_cache[:, slot, :, j * P:(j + 1) * P],
                                    k) and
                        torch.equal(srv.v_cache[:, slot, :, j * P:(j + 1) * P],
                                    v)):
                    raise AssertionError(f"restored page {j} of slot {slot} "
                                         "differs from the cold run's")
        del srv
        psrv = paged(st)
        toks["paged_hit"], report["paged_hit"] = store_run(
            "paged NVMe hit", psrv, requests, eng, st)
        # the restore alone: every resident page of the run, one batch,
        # three times, bytes compared with the cold run's
        keys = list(cold_pages)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            got = st.restore_many({0: (0, keys)}, device=dev)[0]
            torch.cuda.synchronize()
            times.append(time.monotonic() - t0)
        for j, kx in enumerate(keys):
            if not (torch.equal(got[j][0], cold_pages[kx][0])
                    and torch.equal(got[j][1], cold_pages[kx][1])):
                raise AssertionError(f"restore_many page {j} differs")
        nbytes = len(keys) * st.page_bytes
        report["restore"] = {
            "pages": len(keys), "bytes": nbytes, "seconds": times,
            "gib_per_s": [nbytes / t / 2**30 for t in times],
            "kv_restore_p99_ms": st.restore_p99_ms()}
        log(f"prefix store restore of {len(keys)} pages ({nbytes} B), one "
            f"batch: {[f'{t * 1e3:.2f}' for t in times]} ms = "
            f"{[f'{g:.3f}' for g in report['restore']['gib_per_s']]} GiB/s;"
            f" restore p99 {st.restore_p99_ms()} ms; bitwise equal to the "
            "cold run's pages")
        del got
        # 5. HBM hit: the same paged server, from its block cache
        toks["paged_hbm_hit"], report["paged_hbm_hit"] = store_run(
            "paged HBM hit", psrv, requests, eng, st, rid_prefix="h")
        del psrv
        st.close()
        torch.cuda.empty_cache()
        # 3. the NVMe hit under STROM_VERIFY=full
        os.environ["STROM_VERIFY"] = "full"
        try:
            st = store("chat.kvstore")
            toks["dense_verify"], report["dense_verify"] = store_run(
                "dense NVMe hit, STROM_VERIFY=full", dense(st), requests,
                eng, st)
            toks["paged_verify"], report["paged_verify"] = store_run(
                "paged NVMe hit, STROM_VERIFY=full", paged(st), requests,
                eng, st)
            st.close()
            # 4. one flipped byte on disk
            sys0 = st.chain_keys(requests[0][1])[3]
            slot = _flip_page_byte(st, sys0)
            st = store("chat.kvstore")
            toks["dense_heal"], report["dense_heal"] = store_run(
                "dense, a flipped byte in page slot "
                f"{slot}, STROM_VERIFY=full", dense(st), requests, eng, st)
            st.close()
        finally:
            os.environ.pop("STROM_VERIFY", None)
    # checks
    hit = toks["dense_hit"]
    for label in ("paged_hit", "paged_hbm_hit", "dense_verify",
                  "paged_verify"):
        if toks[label] != hit:
            diff = [r for r in hit if toks[label][r] != hit[r]]
            raise AssertionError(f"prefix store: {label} tokens differ from "
                                 f"the dense NVMe hit's for {diff}")
    n_keys = len(cold_pages)
    for label in ("dense_hit", "paged_hit", "dense_verify", "paged_verify"):
        r = report[label]
        st_ = r["stats"]
        if st_["kv_prefix_misses"] or st_["kv_restore_failures"] or \
                st_["kv_pages_written"]:
            raise AssertionError(f"{label}: not every page restored: {st_}")
        if st_["bounce_bytes"] != 0:
            raise AssertionError(f"{label}: bounce_bytes "
                                 f"{st_['bounce_bytes']} on the restores")
        if not r["h2d_launches"] >= r["store_copies"] > 0:
            raise AssertionError(f"{label}: h2d_copy launches "
                                 f"{r['h2d_launches']} < pieces copied "
                                 f"{r['store_copies']}")
    if report["paged_hbm_hit"]["stats"]["kv_pages_restored"]:
        raise AssertionError("the HBM hit run read the store")
    for label in ("dense_verify", "paged_verify"):
        # one batch: each resident page read and checked once
        st_ = report[label]["stats"]
        if st_["bytes_verified"] != n_keys * page_bytes or \
                st_["checksum_failures"]:
            raise AssertionError(f"{label}: verify counters {st_}")
    heal = report["dense_heal"]["stats"]
    if heal["kv_restore_failures"] < 1 or heal["checksum_failures"] < 1:
        raise AssertionError(f"the flipped page was not caught: {heal}")
    # the system prompt the damaged page is not part of restores the same
    # bytes as run 2: same tokens
    clean = [rid for i, (rid, _) in enumerate(requests) if i % 2]
    if any(toks["dense_heal"][r] != hit[r] for r in clean):
        raise AssertionError("heal run: requests on the undamaged prompt "
                             "changed tokens")
    shared["prefix"]["hit_tokens"] = hit
    report["n_pages"] = n_keys
    report["cold_vs_hit_equal"] = {
        rid: toks["dense_cold"][rid] == hit[rid] for rid, _ in requests}
    report["heal_vs_hit_equal"] = {
        rid: toks["dense_heal"][rid] == hit[rid] for rid, _ in requests}
    report["ttft_ms_avg"] = {k: report[k]["ttft_ms_avg"] for k in (
        "dense_cold", "paged_cold", "dense_hit", "paged_hit",
        "paged_hbm_hit")}
    log(f"prefix store: {n_keys} pages; dense-hit, paged-hit, HBM-hit and "
        f"verified tokens identical; cold == hit per request (bf16) "
        f"{report['cold_vs_hit_equal']}; heal == hit "
        f"{report['heal_vs_hit_equal']}; TTFT avg ms {report['ttft_ms_avg']}")
    return report


def prefix_store_f32_phase(dev, cfg, params):
    """The store in float32 (f32_phase's config): the dense server's
    cold run against its NVMe-hit run, and against a run whose restored
    page fails its check and is recomputed: tokens must be equal, and
    the first-token logits of the cold prefill and the restored-prefix
    block_step close."""
    import dataclasses
    import shutil
    import torch
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.models import decode as dec
    from nvme_strom_tpu_torch.models.kv_offload import PrefixStore
    from nvme_strom_tpu_torch.models.serving import DecodeServer
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = {k: v.float() for k, v in params.items()}
    sdir = os.path.join(DATA_DIR, "kv_store_f32")
    shutil.rmtree(sdir, ignore_errors=True)
    path = os.path.join(sdir, "chat.kvstore")
    requests = prefix_requests(cfg.vocab)
    P = PREFIX_PAGE_TOKENS
    toks, report = {}, {}
    with StromEngine() as eng:
        eng.cuda_mapping(dev.index)          # page-lock staging first

        def run(label):
            st = PrefixStore(cfg32, eng, path, P, PREFIX_STORE_BYTES)
            toks[label], report[label] = store_run(
                f"f32 {label}", DecodeServer(p32, cfg32, PREFIX_REQUESTS,
                                             2048, device=dev, kv_store=st),
                requests, eng, st)
            return st
        run("cold").close()
        st = run("hit")
        # first-token logits of one request, cold prefill against the
        # restored prefix + suffix block_step
        ids = requests[0][1]
        s = len(ids)
        keys = st.chain_keys(ids)
        cache = dec.init_cache(cfg32, 1, s, device=dev)
        cold, _ = dec.prefill(p32, torch.tensor([ids], device=dev), cfg32,
                              cache)
        got = st.restore_many({0: (0, keys)}, device=dev)[0]
        cache = dec.init_cache(cfg32, 1, -(-s // P) * P, device=dev)
        for j in range(len(keys)):
            cache["k"][:, 0, :, j * P:(j + 1) * P] = got[j][0]
            cache["v"][:, 0, :, j * P:(j + 1) * P] = got[j][1]
        cache["pos"] = len(keys) * P
        suffix = ids[len(keys) * P:]
        hit, _ = dec.block_step(p32, torch.tensor([suffix], device=dev),
                                cfg32, cache, last=len(suffix) - 1)
        report["first_logits_max_abs_diff"] = (hit - cold).abs().max().item()
        st.close()
        _flip_page_byte(st, keys[3])
        os.environ["STROM_VERIFY"] = "full"
        try:
            run("heal").close()
        finally:
            os.environ.pop("STROM_VERIFY", None)
    if report["heal"]["stats"]["kv_restore_failures"] < 1:
        raise AssertionError(f"f32 heal: the flipped page was not caught "
                             f"{report['heal']['stats']}")
    for label in ("hit", "heal"):
        if toks[label] != toks["cold"]:
            diff = [r for r in toks["cold"] if toks[label][r] !=
                    toks["cold"][r]]
            raise AssertionError(f"f32 prefix store: {label} tokens differ "
                                 f"from cold for {diff}")
    if not report["first_logits_max_abs_diff"] <= F32_LOGITS_TOL:
        raise AssertionError(f"f32 first-token logits, cold against hit, "
                             f"differ by {report['first_logits_max_abs_diff']}")
    log(f"prefix store f32: cold, NVMe-hit and healed tokens identical; "
        f"first-token logits max |hit - cold| "
        f"{report['first_logits_max_abs_diff']:.3g} (tol {F32_LOGITS_TOL})")
    return report


# -- phase 5c: offloaded long-context KV decode -------------------------------

#: (a) the flagship at bench_suite config 10's full-size settings: batch
#: 8, a 1024-token prompt, pages of 128 positions (8 MiB in bf16), a
#: window of 2 pages: 7 cold pages, 56 MiB streamed a step
OFFLOAD_BATCH = 8
OFFLOAD_PROMPT = 1024
OFFLOAD_PAGE = 128
OFFLOAD_WINDOW_PAGES = 2
OFFLOAD_STEPS = 16
#: (b) one 8192-token prompt through chunked prefill: 64 pages
OFFLOAD_LONG_PROMPT = 8192
#: (c) Llama-3-8B's published widths cut to 2 of 32 layers and a 32000
#: vocabulary, a 32768-position history at batch 1: 255 cold pages of
#: 1 MiB
LLAMA3_8B_2L = dict(vocab=32000, d_model=4096, n_layers=2, n_heads=32,
                    n_kv_heads=8, d_ff=14336, max_seq=32768 + 64,
                    rope_theta=500000.0)
OFFLOAD_LONG_HISTORY = 32768
OFFLOAD_LONG_STEPS = 8
#: (rtol, atol) of a bf16 attend against a dense float32 softmax over
#: the whole history; of float32 chunked-prefill logits against the
#: dense prefill at 8192 positions (the JAX test allows 2e-4 at 27
#: positions; 64 chunks of online-softmax sums in another order than
#: one dense softmax may drift further); of int8 pages against dense
OFFLOAD_ATTEND_TOL = (2e-2, 2e-2)
OFFLOAD_F32_LOGITS_TOL = (1e-3, 1e-3)
OFFLOAD_INT8_TOL = (3e-2, 3e-2)
#: engine counters an offload run reports (deltas over the run)
OFFLOAD_COUNTERS = ("bytes_direct", "bytes_fallback", "bytes_written_direct",
                    "bounce_bytes", "bytes_to_device", "bytes_verified",
                    "checksum_failures")


class Counters:
    """Engine counter deltas since construction (or ``reset``) of
    ``names`` (OFFLOAD_COUNTERS by default)."""

    def __init__(self, eng, names=None):
        self.eng = eng
        self.names = names or OFFLOAD_COUNTERS
        self.reset()

    def _now(self):
        self.eng.sync_stats()
        return self.eng.stats.snapshot()

    def reset(self):
        self._t0 = self._now()

    def delta(self):
        now = self._now()
        d = {k: now[k] - self._t0[k] for k in self.names}
        d["bytes_read"] = d["bytes_direct"] + d["bytes_fallback"]
        return d


def _dense_attend(q, ks, vs):
    """float32 softmax attention of q (b, nh, 1, hd) over ks / vs (b,
    nkv, S, hd), the plain reference of ``PagedKVCache.attend``."""
    import torch
    g = q.shape[1] // ks.shape[1]
    k = ks.float().repeat_interleave(g, dim=1)
    v = vs.float().repeat_interleave(g, dim=1)
    p = torch.softmax(q.float() @ k.transpose(-1, -2)
                      / q.shape[-1] ** 0.5, dim=-1)
    return p @ v


def _close(name, got, want, tol):
    """max |got - want|; raises past ``tol`` (rtol, atol)."""
    import torch
    err = (got.float() - want.float()).abs().max().item()
    try:
        torch.testing.assert_close(got.float(), want.float(), rtol=tol[0],
                                   atol=tol[1])
    except AssertionError as e:
        raise AssertionError(f"{name}: max error {err}: {e}") from None
    return err


def _greedy_steps(params, cfg, cache, tok, n, logits=None):
    """n offload decode steps from ``tok``; returns the tokens (and
    appends each step's logits to ``logits``)."""
    import torch
    from nvme_strom_tpu_torch.models.kv_offload import offload_decode_step
    out = []
    for _ in range(n):
        lg = offload_decode_step(params, tok, cfg, cache)
        if logits is not None:
            logits.append(lg)
        tok = lg.argmax(-1).to(torch.int32)
        out.append(tok)
    return out


def _flip_byte(path, at):
    with open(path, "r+b") as f:
        f.seek(at)
        b = f.read(1)
        f.seek(at)
        f.write(bytes([b[0] ^ 0x01]))
        f.flush()
        os.fsync(f.fileno())
        os.posix_fadvise(f.fileno(), 0, 0, os.POSIX_FADV_DONTNEED)


def _read_split(cache):
    """Wrap ``cache``'s page iterator to add the wall seconds spent
    waiting for each page (its reads and copies) to the returned cell."""
    spent = [0.0]
    orig = cache._iter_layer_pages

    def pages(layer):
        it = orig(layer)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                spent[0] += time.perf_counter() - t0
                return
            spent[0] += time.perf_counter() - t0
            yield item
    cache._iter_layer_pages = pages
    return spent


def _verify_run(params, cfg, cache, kv, tok0, toks, step_bytes):
    """A cache made under STROM_VERIFY=full: the prompt's k/v appended,
    two steps whose every streamed byte is checked (and whose tokens
    are the unverified run's ``toks``), then one flipped byte of the
    page file must raise ChecksumError.  Returns the two steps' counter
    deltas."""
    import torch
    from nvme_strom_tpu_torch.utils.checksum import ChecksumError
    cache.append(*kv)
    cache.flush()
    ctr = Counters(cache.engine)
    v_toks = _greedy_steps(params, cfg, cache, tok0, 2)
    st = ctr.delta()
    if (st["bytes_verified"] != 2 * step_bytes
            or st["bytes_read"] != 2 * step_bytes
            or st["checksum_failures"] != 0
            or not all(torch.equal(a, c) for a, c in zip(v_toks, toks))):
        raise AssertionError(f"(a) verify: {st}")
    _flip_byte(cache.ocfg.path, 100)
    q = torch.zeros(cache.batch, cfg.n_heads, 1, cfg.head_dim,
                    dtype=cfg.dtype, device=cache.device)
    try:
        cache.attend(0, q)
    except ChecksumError as e:
        if "corrupt" not in str(e):
            raise
    else:
        raise AssertionError("(a) verify: a flipped byte passed")
    if ctr.delta()["checksum_failures"] != 1:
        raise AssertionError("(a) verify: checksum_failures != 1")
    return st


def offload_flagship(dev, cfg, params, odir, shared):
    """(a): batch 8, a 1024-token prompt through the dense prefill and
    ``append``; one warm step and 16 timed steps; then the same prompt
    in float32 (tokens equal the dense generate), against the dense
    bf16 decode_step, with int8 pages, with a host tier of 4 pages,
    under STROM_VERIFY=full with a flipped byte, and across a saved and
    reloaded session.  ``shared`` receives the prompt's k/v, the first
    token and the timed run's tokens, which qos_phase replays."""
    import dataclasses
    import torch
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.models import decode as dec
    from nvme_strom_tpu_torch.models.kv_offload import (
        OffloadConfig, PagedKVCache, offloaded_generate)
    from nvme_strom_tpu_torch.ops.bridge import h2d_copy
    b, s, n = OFFLOAD_BATCH, OFFLOAD_PROMPT, OFFLOAD_STEPS
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    prompt = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev,
                           dtype=torch.int32)
    dense = dec.init_cache(cfg, b, s + n + 4, device=dev)
    logits0, dense = dec.prefill(params, prompt, cfg, dense)
    k0 = dense["k"][..., :s, :].clone()
    v0 = dense["v"][..., :s, :].clone()
    tok0 = logits0.argmax(-1).to(torch.int32)
    report = {}

    def ocfg(name, **kw):
        return OffloadConfig(path=os.path.join(odir, name),
                             page_len=OFFLOAD_PAGE,
                             window_pages=OFFLOAD_WINDOW_PAGES, **kw)

    # the timed bf16 run
    with StromEngine() as eng:
        ctr = Counters(eng)
        with PagedKVCache(cfg, ocfg("a.bin"), eng, b, device=dev) as cache:
            cache.append(k0, v0)
            cache.flush()
            written = ctr.delta()
            n_cold = cache.n_cold
            if n_cold != 7:
                raise AssertionError(f"(a): {n_cold} cold pages, want 7")
            step_bytes = (cfg.n_layers * n_cold * 2 * cache._pb_layer)
            wrote = n_cold * cache._page_stride
            if written["bytes_written_direct"] != wrote:
                raise AssertionError(
                    f"(a): {written['bytes_written_direct']} of {wrote} "
                    f"evicted bytes written O_DIRECT")
            lgs: list = []
            warm = _greedy_steps(params, cfg, cache, tok0, 1, lgs)
            torch.cuda.synchronize()
            ctr.reset()
            launches0 = h2d_copy.launches
            t0 = time.monotonic()
            toks = warm + _greedy_steps(params, cfg, cache, warm[-1], n, lgs)
            torch.cuda.synchronize()
            secs = time.monotonic() - t0
            st = ctr.delta()
            launches = h2d_copy.launches - launches0
            # where a step's time goes: page reads against the rest, two
            # steps; then the device's share over two more (profiler)
            spent = _read_split(cache)
            t1 = time.monotonic()
            _greedy_steps(params, cfg, cache, toks[-1], 2)
            torch.cuda.synchronize()
            split_s = time.monotonic() - t1
            read_s = spent[0]
            prof = profile_run(
                lambda done: (_greedy_steps(params, cfg, cache, toks[-1], 2),
                              done()), "offload (a), two steps")
    del prof["flash_kernels"], prof["flash_ms"], prof["flash_share"]
    shared["offload"] = {"k0": k0, "v0": v0, "tok0": tok0, "toks": toks}
    want_launches = n * cfg.n_layers * n_cold * 2
    if launches != want_launches or st["bounce_bytes"] != 0:
        raise AssertionError(f"(a): {launches} h2d launches (want "
                             f"{want_launches}), bounce {st['bounce_bytes']}")
    if st["bytes_read"] != n * step_bytes:
        raise AssertionError(f"(a): read {st['bytes_read']} B, want "
                             f"{n * step_bytes}")
    report["a"] = {
        "tok_s": b * n / secs, "ms_step": secs / n * 1e3,
        "mib_step": st["bytes_read"] / n / 2**20,
        "direct_share": st["bytes_direct"] / max(1, st["bytes_read"]),
        "bounce_bytes": st["bounce_bytes"], "h2d_launches": launches,
        "bytes_written": wrote,
        "bytes_written_direct": written["bytes_written_direct"],
        "read_gib_s": st["bytes_read"] / secs / 2**30,
        "two_steps_s": split_s, "two_steps_read_s": read_s,
        "profile": prof}
    log(f"offload (a): flagship b {b}, prompt {s}, 7 cold pages: "
        f"{report['a']['tok_s']:.1f} tok/s, {report['a']['ms_step']:.2f} "
        f"ms a step, {report['a']['mib_step']:.1f} MiB streamed a step "
        f"({report['a']['read_gib_s']:.2f} GiB/s), direct share "
        f"{report['a']['direct_share']:.3f}, bounce {st['bounce_bytes']}, "
        f"written {wrote} B, {written['bytes_written_direct']} O_DIRECT, "
        f"{launches} h2d launches; two steps {split_s * 1e3:.1f} ms, "
        f"{read_s * 1e3:.1f} of it waiting for pages")

    # bf16 against the dense decode_step on the same tokens
    n1 = n + 1                   # the warm step and the timed ones
    dl, errs, agree = dense, [], 0
    for i, t in enumerate([tok0] + toks[:-1]):
        want, dl = dec.decode_step(params, t, cfg, dl)
        errs.append((lgs[i] - want).abs().max().item())
        agree += int((lgs[i].argmax(-1) == want.argmax(-1)).sum())
    report["a"]["bf16_vs_dense"] = {"max_logit_err": max(errs),
                                    "token_agreement": agree / (b * n1)}
    log(f"offload (a) bf16 against the dense decode_step over {n1} steps: "
        f"max logit error {max(errs):.4g}, argmax agreement "
        f"{agree}/{b * n1}")

    # float32: tokens equal the dense generate's
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = {k: v.float() for k, v in params.items()}
    with StromEngine() as eng:
        got = offloaded_generate(p32, prompt, cfg32, ocfg("f32.bin"), eng,
                                 n1 + 1)
    want = dec.generate(p32, prompt, cfg32, n1 + 1)
    if not torch.equal(got.long(), want.long()):
        raise AssertionError("(a) float32: offloaded tokens differ from "
                             "the dense generate's")
    log(f"offload (a) float32: {b}x{n1 + 1} tokens identical to the dense "
        "generate")

    # int8 pages: attend against dense, tokens against bf16
    with StromEngine() as eng:
        ctr = Counters(eng)
        with PagedKVCache(cfg, ocfg("q.bin", quantize="int8"), eng, b,
                          device=dev) as cache:
            cache.append(k0, v0)
            q = torch.randn(b, cfg.n_heads, 1, cfg.head_dim, generator=gen,
                            device=dev).bfloat16()
            int8_err = _close("(a) int8 attend", cache.attend(0, q),
                              _dense_attend(q, k0[0], v0[0]),
                              OFFLOAD_INT8_TOL)
            ctr.reset()
            q_toks = _greedy_steps(params, cfg, cache, tok0, n1)
        st = ctr.delta()
    q_agree = sum(int((a == c).sum()) for a, c in zip(q_toks, toks))
    report["a"]["int8"] = {"attend_err": int8_err,
                           "token_agreement_bf16": q_agree / (b * n1),
                           "mib_step": st["bytes_read"] / n1 / 2**20,
                           "bounce_bytes": st["bounce_bytes"]}
    log(f"offload (a) int8 pages: attend max error {int8_err:.4g} (tol "
        f"{OFFLOAD_INT8_TOL}), tokens agree with bf16 {q_agree}/{b * n1}, "
        f"{report['a']['int8']['mib_step']:.1f} MiB read a step")

    # the host tier: 4 of 7 pages from host memory
    with StromEngine() as eng:
        ctr = Counters(eng)
        launches0 = h2d_copy.launches
        with PagedKVCache(cfg, ocfg("h.bin", host_cache_pages=4), eng, b,
                          device=dev) as cache:
            cache.append(k0, v0)
            ctr.reset()
            h_toks = _greedy_steps(params, cfg, cache, tok0, n1)
            hits, misses = cache.host_cache_hits, cache.host_cache_misses
        st = ctr.delta()
        h_launches = h2d_copy.launches - launches0
    if not all(torch.equal(a, c) for a, c in zip(h_toks, toks)):
        raise AssertionError("(a) host tier: tokens differ from the run "
                             "without it")
    if (hits != n1 * cfg.n_layers * 4 or st["bounce_bytes"] != 0
            or st["bytes_read"] >= n1 * step_bytes
            or h_launches != n1 * cfg.n_layers * n_cold * 2):
        raise AssertionError(f"(a) host tier: hits {hits}, misses {misses}"
                             f", bounce {st['bounce_bytes']}, read "
                             f"{st['bytes_read']}, launches {h_launches}")
    report["a"]["host_tier"] = {"hits": hits, "misses": misses,
                                "mib_step": st["bytes_read"] / n1 / 2**20,
                                "bounce_bytes": st["bounce_bytes"],
                                "h2d_launches": h_launches}
    log(f"offload (a) host tier of 4 pages: {hits} hits, {misses} misses, "
        f"{report['a']['host_tier']['mib_step']:.1f} MiB read a step, "
        f"bounce 0, tokens identical, {h_launches} h2d launches")

    # STROM_VERIFY=full: every streamed byte checked; a flip raises
    with StromEngine() as eng:
        os.environ["STROM_VERIFY"] = "full"   # read when the cache is made
        try:
            cache = PagedKVCache(cfg, ocfg("v.bin"), eng, b, device=dev)
        finally:
            os.environ.pop("STROM_VERIFY", None)
        with cache:
            st = _verify_run(params, cfg, cache, (k0, v0), tok0, toks,
                             step_bytes)
    report["a"]["verify"] = {"bytes_verified": st["bytes_verified"],
                             "bytes_read": st["bytes_read"]}
    log(f"offload (a) STROM_VERIFY=full: {st['bytes_verified']} B checked "
        f"= {st['bytes_read']} B streamed over 2 steps; the flipped byte "
        "raised ChecksumError, checksum_failures 1")

    # a session saved after 8 steps and reloaded continues identically
    half = n // 2
    sess = os.path.join(odir, "session")
    with StromEngine() as eng:
        with PagedKVCache(cfg, ocfg("s.bin"), eng, b, device=dev) as cache:
            cache.append(k0, v0)
            s_toks = _greedy_steps(params, cfg, cache, tok0, half)
            cache.save_session(sess)
        cache = PagedKVCache.load_session(cfg, eng, sess, device=dev)
        try:
            s_toks += _greedy_steps(params, cfg, cache, s_toks[-1],
                                    n1 - half)
        finally:
            cache.close()
    if not all(torch.equal(a, c) for a, c in zip(s_toks, toks)):
        raise AssertionError("(a) session: the resumed continuation "
                             "differs")
    log(f"offload (a) session saved after {half} steps and reloaded: "
        f"{n1 - half} more steps identical")
    return report


def offload_chunked(dev, cfg, params, odir):
    """(b): batch 1, an 8192-token prompt through ``offloaded_prefill``
    (64 pages), its last-position logits against the dense prefill's in
    float32 (asserted) and bf16 (logged), then 16 bf16 decode steps."""
    import dataclasses
    import torch
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.models import decode as dec
    from nvme_strom_tpu_torch.models.kv_offload import (
        OffloadConfig, PagedKVCache, offloaded_prefill)
    s, n = OFFLOAD_LONG_PROMPT, OFFLOAD_STEPS
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    prompt = torch.randint(0, cfg.vocab, (1, s), generator=gen, device=dev,
                           dtype=torch.int32)
    report = {}
    for label, c in (("f32", dataclasses.replace(cfg, dtype=torch.float32)),
                     ("bf16", cfg)):
        p = {k: v.to(c.dtype) if v.dim() > 1 else v
             for k, v in params.items()}
        dense = dec.init_cache(c, 1, s, device=dev)
        want, dense = dec.prefill(p, prompt, c, dense)
        del dense
        torch.cuda.empty_cache()
        with StromEngine() as eng:
            ctr = Counters(eng)
            with PagedKVCache(c, OffloadConfig(
                    path=os.path.join(odir, f"b_{label}.bin"),
                    page_len=OFFLOAD_PAGE,
                    window_pages=OFFLOAD_WINDOW_PAGES), eng, 1,
                    device=dev) as cache:
                torch.cuda.synchronize()
                t0 = time.monotonic()
                got = offloaded_prefill(p, prompt, c, cache)
                torch.cuda.synchronize()
                secs = time.monotonic() - t0
                st = ctr.delta()
                r = {"prefill_s": secs, "pages": cache.n_cold,
                     "gib_streamed": st["bytes_read"] / 2**30,
                     "read_gib_s": st["bytes_read"] / secs / 2**30,
                     "bounce_bytes": st["bounce_bytes"],
                     "direct_share": st["bytes_direct"]
                     / max(1, st["bytes_read"]),
                     "max_logit_err": (got - want).abs().max().item(),
                     "argmax_equal": bool(torch.equal(got.argmax(-1),
                                                      want.argmax(-1)))}
                if label == "f32":
                    _close("(b) float32 chunked prefill logits", got, want,
                           OFFLOAD_F32_LOGITS_TOL)
                else:
                    tok = got.argmax(-1).to(torch.int32)
                    torch.cuda.synchronize()
                    ctr.reset()
                    t0 = time.monotonic()
                    _greedy_steps(p, c, cache, tok, n)
                    torch.cuda.synchronize()
                    dsecs = time.monotonic() - t0
                    d = ctr.delta()
                    r.update(decode_tok_s=n / dsecs,
                             decode_ms_step=dsecs / n * 1e3,
                             decode_mib_step=d["bytes_read"] / n / 2**20,
                             decode_bounce_bytes=d["bounce_bytes"])
                    st["bounce_bytes"] += d["bounce_bytes"]
            if st["bounce_bytes"] != 0:
                raise AssertionError(f"(b) {label}: bounce "
                                     f"{st['bounce_bytes']}")
        report[label] = r
        log(f"offload (b) {label}: {s}-token chunked prefill "
            f"{secs:.3f} s over {r['pages']} pages, "
            f"{r['gib_streamed']:.3f} GiB streamed "
            f"({r['read_gib_s']:.2f} GiB/s), direct share "
            f"{r['direct_share']:.3f}, bounce 0; last logits max error "
            f"against the dense prefill {r['max_logit_err']:.4g}"
            + (f" (tol {OFFLOAD_F32_LOGITS_TOL})" if label == "f32" else
               f"; then {r['decode_tok_s']:.1f} tok/s, "
               f"{r['decode_ms_step']:.2f} ms a step, "
               f"{r['decode_mib_step']:.1f} MiB a step"))
    return report


def _card_params(cfg, seed, dev):
    """Seeded random weights made on the card (the JAX init scheme:
    norms ones, matrices normal / sqrt(fan_in), fan_in the input dim and
    1 for the token embedding), in the model dtype; norms and MoE routers
    float32, as ``convert.params_from_jax`` holds them."""
    import torch
    from nvme_strom_tpu_torch.models.transformer import param_shapes
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for name, shape in param_shapes(cfg).items():
        if len(shape) == 1:
            out[name] = torch.ones(shape, device=dev)
        else:
            fan = 1.0 if name == "tok_embed" else shape[-2]
            dtype = torch.float32 if name.endswith(".router") else cfg.dtype
            out[name] = (torch.randn(shape, generator=gen, device=dev)
                         / fan ** 0.5).to(dtype)
    return out


def offload_long(dev, odir):
    """(c): Llama-3-8B's widths (2 of 32 layers), a 32768-position
    seeded history at batch 1 through ``append`` (255 cold pages of 1
    MiB), then 8 decode steps; every layer's ``attend`` output is held
    against a dense float32 softmax over the whole history."""
    import torch
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.models.kv_offload import (OffloadConfig,
                                                        PagedKVCache)
    from nvme_strom_tpu_torch.models.transformer import TransformerConfig
    cfg = TransformerConfig(**LLAMA3_8B_2L)
    params = _card_params(cfg, SEED + 11, dev)
    S, n = OFFLOAD_LONG_HISTORY, OFFLOAD_LONG_STEPS
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    shape = (cfg.n_layers, 1, cfg.n_kv_heads, S, cfg.head_dim)
    hist_k = torch.randn(shape, generator=gen, device=dev).to(cfg.dtype)
    hist_v = torch.randn(shape, generator=gen, device=dev).to(cfg.dtype)
    tok = torch.randint(0, cfg.vocab, (1,), generator=gen, device=dev,
                        dtype=torch.int32)
    errs, ref_max = [], []
    with StromEngine() as eng:
        ctr = Counters(eng)
        with PagedKVCache(cfg, OffloadConfig(
                path=os.path.join(odir, "c.bin"), page_len=OFFLOAD_PAGE,
                window_pages=OFFLOAD_WINDOW_PAGES), eng, 1,
                device=dev) as cache:
            t0 = time.monotonic()
            cache.append(hist_k, hist_v)
            cache.flush()
            seed_s = time.monotonic() - t0
            written = ctr.delta()
            if cache.n_cold != 255:
                raise AssertionError(f"(c): {cache.n_cold} cold pages")
            extra = [[] for _ in range(cfg.n_layers)]
            attend = cache.attend
            check_s = [0.0]

            def checked(layer, q, valid=None):
                out = attend(layer, q, valid)
                torch.cuda.synchronize()
                c0 = time.monotonic()
                c = cache.count          # the step's staged position
                extra[layer].append(
                    (cache.k_win[layer, :, :, c:c + 1].clone(),
                     cache.v_win[layer, :, :, c:c + 1].clone()))
                ks = torch.cat([hist_k[layer]] + [k for k, _ in
                                                  extra[layer]], dim=2)
                vs = torch.cat([hist_v[layer]] + [v for _, v in
                                                  extra[layer]], dim=2)
                want = _dense_attend(q, ks, vs)
                errs.append(_close(f"(c) layer {layer} attend", out, want,
                                   OFFLOAD_ATTEND_TOL))
                ref_max.append(want.abs().max().item())
                torch.cuda.synchronize()
                check_s[0] += time.monotonic() - c0
                return out
            cache.attend = checked
            ctr.reset()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            _greedy_steps(params, cfg, cache, tok, n)
            torch.cuda.synchronize()
            secs = time.monotonic() - t0 - check_s[0]
            st = ctr.delta()
    if st["bounce_bytes"] != 0:
        raise AssertionError(f"(c): bounce {st['bounce_bytes']}")
    r = {"seed_s": seed_s, "bytes_written": written["bytes_written_direct"],
         "ms_step": secs / n * 1e3, "tok_s": n / secs,
         "mib_step": st["bytes_read"] / n / 2**20,
         "read_gib_s": st["bytes_read"] / secs / 2**30,
         "direct_share": st["bytes_direct"] / max(1, st["bytes_read"]),
         "bounce_bytes": st["bounce_bytes"], "attend_max_err": max(errs),
         "attend_ref_max": max(ref_max)}
    log(f"offload (c) Llama-3-8B widths, 2 layers, history {S}: seeded in "
        f"{seed_s:.2f} s ({written['bytes_written_direct']} B O_DIRECT); "
        f"{r['ms_step']:.1f} ms a step ({r['tok_s']:.2f} tok/s), "
        f"{r['mib_step']:.1f} MiB streamed a step = "
        f"{r['read_gib_s']:.2f} GiB/s, direct share "
        f"{r['direct_share']:.3f}, bounce 0; attend max error "
        f"{max(errs):.3g} (|ref| up to {max(ref_max):.3g}, tol "
        f"{OFFLOAD_ATTEND_TOL}) over {len(errs)} calls")
    return r


def offload_generate_main(dev, cfg, ckdir, params, odir):
    """``python -m nvme_strom_tpu_torch.generate --offload`` on the
    serving checkpoint: a 1000-token prompt, 64 new tokens, a window of
    256; its ids must equal ``offloaded_generate``'s."""
    import contextlib
    import io
    import torch
    from nvme_strom_tpu_torch import generate
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.models.kv_offload import (OffloadConfig,
                                                        offloaded_generate)
    rng = torch.Generator().manual_seed(SEED + 13)
    ids = torch.randint(0, cfg.vocab, (1000,), generator=rng).tolist()
    buf = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(buf):
        rc = generate.main(["--weights", ckdir, "--prompt",
                            ",".join(map(str, ids)), "--new", "64",
                            "--offload", os.path.join(odir, "main.bin"),
                            "--offload-window", "256", "--device",
                            str(dev)])
    secs = time.monotonic() - t0
    out = buf.getvalue()
    if rc != 0:
        raise AssertionError(f"generate.main returned {rc}: {out}")
    line = next(x for x in out.splitlines() if x.startswith("output ids:"))
    got = [int(t) for t in line.split(":", 1)[1].strip().split(",")]
    with StromEngine() as eng:
        want = offloaded_generate(
            params, torch.tensor([ids], dtype=torch.int32, device=dev), cfg,
            OffloadConfig(path=os.path.join(odir, "api.bin"), page_len=64,
                          window_pages=4), eng, 64)
    if got != want[0].tolist():
        raise AssertionError("generate.main --offload ids differ from the "
                             "API's")
    stats = next(x for x in out.splitlines()
                 if x.startswith("engine stats"))
    log(f"generate.main --offload (1000-token prompt, 64 new, window "
        f"256): ids equal the API's; {secs:.2f} s with the weights' load; "
        f"{stats}")
    return {"seconds": secs, "engine_stats": stats}


def offload_phase(dev, cfg, ckdir, params, shared):
    """Offloaded long-context KV decode, (a)-(c) and the entry point,
    each timed; page files under DATA_DIR/offload."""
    import shutil
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    odir = os.path.join(DATA_DIR, "offload")
    shutil.rmtree(odir, ignore_errors=True)
    os.makedirs(odir)
    report, secs = {}, {}
    t = time.monotonic()
    report["flagship"] = offload_flagship(dev, cfg, params, odir, shared)
    secs["a"] = time.monotonic() - t
    t = time.monotonic()
    report["chunked"] = offload_chunked(dev, cfg, params, odir)
    secs["b"] = time.monotonic() - t
    torch.cuda.empty_cache()
    t = time.monotonic()
    report["long"] = offload_long(dev, odir)
    secs["c"] = time.monotonic() - t
    torch.cuda.empty_cache()
    t = time.monotonic()
    report["generate_main"] = offload_generate_main(dev, cfg, ckdir,
                                                    params, odir)
    secs["generate_main"] = time.monotonic() - t
    report["seconds"] = secs
    log(f"offload phase seconds: {secs}, total {sum(secs.values()):.1f}")
    shutil.rmtree(odir, ignore_errors=True)
    return report


# -- phase 5d: decode-class reads under a storm: rings, QoS, host tier ------

#: (label, STROM_RINGS, STROM_FAULT_READ_DELAY_MS, host tier MiB): one
#: ring without a scheduler; the default ring count with it; both with
#: every engine read padded by 2 ms (the reference's bench_mixed pad,
#: which makes queueing visible where storage is 9p); the default with
#: the host-DRAM tier on, lines of the engine's chunk
QOS_MODES = (("1 ring", "1", "0", 0), ("auto rings", "0", "0", 0),
             ("1 ring, 2 ms pad", "1", "2", 0),
             ("auto rings, 2 ms pad", "0", "2", 0),
             ("auto rings, host tier", "0", "0", 512),
             ("auto rings, governor", "0", "0", 0))
#: the mode whose store runs the SLO governor, its STROM_KV_P99_MS half
#: the restore-batch p50 of QOS_GOVERNOR_BASE's first trial: a trial's
#: p99 is its slowest of six restores, and one outlier there (132 ms
#: against a p50 of 22) set a target no governor trial reached
QOS_GOVERNOR = "auto rings, governor"
QOS_GOVERNOR_BASE = "auto rings"
#: after the storm, single-page restores alone until the governor has
#: decayed every boost, at most this long
QOS_DECAY_S = 20.0
#: trials per mode, in alternating order; the median trial (by decode
#: p99) is the mode's
QOS_TRIALS = 2
#: the storm: batches of 8 reads of one chunk at seeded random offsets
QOS_STORM_READS = 8
#: restore batches of every stored page after the servers' runs
QOS_RESTORES = 4
#: engine counters a qos run reports (deltas over the run)
QOS_COUNTERS = ("bytes_direct", "bytes_fallback", "bounce_bytes",
                "bytes_to_device", "sched_enqueued", "sched_dispatches",
                "sched_promotions", "arena_fallbacks", "cache_hits",
                "cache_misses", "bytes_served_cache", "cache_admissions",
                "cache_admission_rejections", "cache_fill_failures",
                "cache_evictions", "cache_invalidations",
                "checksum_failures", "kv_restore_failures",
                "kv_pages_restored", "kv_slo_boosts")


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else 0.0


class Storm:
    """A thread streaming seeded random batches of QOS_STORM_READS
    chunks of the stream file onto the card through
    ``DeviceStream.stream_ranges(klass="prefetch")``, and a sampler of
    the engine's ring depths, until ``stop()``."""

    def __init__(self, eng, dev, path, seed):
        import threading
        from nvme_strom_tpu_torch.ops.bridge import DeviceStream
        self.eng, self.bytes, self.error = eng, 0, None
        self.depth_max = [0] * eng.n_rings
        self._stop = threading.Event()
        chunk = eng.config.chunk_bytes
        size = os.path.getsize(path)
        ds = DeviceStream(eng, device=dev, depth=QOS_STORM_READS,
                          klass="prefetch")

        def storm():
            import numpy as np
            rng = np.random.default_rng(seed)
            fh = eng.open(path)
            try:
                while not self._stop.is_set():
                    base = int(rng.integers(
                        0, size - QOS_STORM_READS * chunk))
                    base -= base % 4096
                    for t in ds.stream_ranges(fh, [
                            (base + i * chunk, chunk)
                            for i in range(QOS_STORM_READS)]):
                        self.bytes += t.numel()
            except Exception as e:   # re-raised by stop()
                self.error = e
            finally:
                eng.close(fh)

        def sample():
            while not self._stop.wait(0.005):
                for r, d in enumerate(eng.ring_depths()):
                    self.depth_max[r] = max(self.depth_max[r], d)

        self._threads = [threading.Thread(target=storm),
                         threading.Thread(target=sample)]
        self._t0 = time.monotonic()
        for t in self._threads:
            t.start()

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=120)
        secs = time.monotonic() - self._t0
        if any(t.is_alive() for t in self._threads):
            raise AssertionError("the storm did not stop")
        if self.error is not None:
            raise self.error
        return self.bytes / secs / 2**30


def _governor_decay(store, keys, dev):
    """Single-page restores with no storm until the store's governor has
    decayed to no boost (its p99 falls under half the target once the
    fast restores outnumber the storm's 100 to 1): (restores, seconds)."""
    t0 = time.monotonic()
    n = 0
    while store.slo.boost and time.monotonic() - t0 < QOS_DECAY_S:
        store.restore_many({0: (n % len(keys), [keys[n % len(keys)]])},
                           device=dev)
        n += 1
    return n, time.monotonic() - t0


def qos_run(dev, cfg, params, mode, shared, stream_path, trial,
            p99_target_ms=0.0, resilient=False, own_target=False):
    """One run of ``mode``: a new engine with the mode's rings, pad and
    host tier; the storm; the prefix store's chat traffic through both
    servers (restores as decode, hot) and QOS_RESTORES more restores of
    every page; offloaded decode (a), 16 timed steps.  With
    ``p99_target_ms`` the store's SLO governor runs (STROM_KV_P99_MS),
    and after the storm single-page restores run until it has decayed.
    ``resilient``: the engine is wrapped in a ResilientEngine (no
    faults), whose decode-class hedge budget is the governor's second
    lever; the budget's base, peak and value after the decay are
    reported.  ``own_target``: the governor's target comes from this run
    alone, half the p50 of its restores up to the end of the QOS_RESTORES
    batches, and the governor is fed their p99 once there, so whether
    it fires depends on no other trial's spread.  Returns the decode-class times, the storm's GiB/s, tokens
    and counters."""
    import torch
    from nvme_strom_tpu_torch.io import hostcache
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.io.resilient import ResilientEngine
    from nvme_strom_tpu_torch.models.kv_offload import (OffloadConfig,
                                                        PagedKVCache,
                                                        PrefixStore)
    from nvme_strom_tpu_torch.models.serving import (DecodeServer,
                                                     PagedDecodeServer)
    from nvme_strom_tpu_torch.utils.config import (HostCacheConfig,
                                                   KVServeConfig)
    label, rings, pad, tier_mb = mode
    pre, off = shared["prefix"], shared["offload"]
    with _env(STROM_RINGS=rings, STROM_FAULT_READ_DELAY_MS=pad):
        eng = StromEngine()          # both are read when it is made
    if resilient:
        eng = ResilientEngine(eng)
    out = {"mode": label, "trial": trial, "n_rings": eng.n_rings}
    try:
        cache = (hostcache.configure(HostCacheConfig(budget_mb=tier_mb),
                                     engine=eng) if tier_mb else None)
        # page-lock the staging pool and the tier's lines first: a
        # registration is set-up, not a decode-class read's time
        t0 = time.monotonic()
        eng.cuda_mapping(dev.index)
        if cache is not None:
            cache.arena.cuda.mapping(dev.index)
        out["register_s"] = time.monotonic() - t0
        eng.sync_stats()
        before = eng.stats.snapshot()
        os.environ["STROM_KV_P99_MS"] = repr(p99_target_ms)
        try:
            target = KVServeConfig().p99_target_ms
        finally:
            os.environ.pop("STROM_KV_P99_MS", None)
        store = PrefixStore(cfg, eng, pre["store"], PREFIX_PAGE_TOKENS,
                            PREFIX_STORE_BYTES, p99_target_ms=target)
        sched = eng.scheduler
        base_w = sched.policies["decode"].weight if sched else None
        peak_w = [base_w]
        base_hb = eng.hedge_budgets["decode"] if resilient else None
        peak_hb = [base_hb]
        restore_ms: list = []
        boosted_ms: list = []     # restores begun with the boost on
        observe_ms: list = []     # the governor's own time, in them
        restore = store.restore_many

        def timed_restore(*a, **k):
            on = store.slo.boost > 0
            t0 = time.perf_counter()
            got = restore(*a, **k)
            restore_ms.append((time.perf_counter() - t0) * 1e3)
            if on:
                boosted_ms.append(restore_ms[-1])
            if sched is not None:
                peak_w[0] = max(peak_w[0], sched.policies["decode"].weight)
            if resilient:
                peak_hb[0] = max(peak_hb[0], eng.hedge_budgets["decode"])
            return got
        store.restore_many = timed_restore
        observe = store.slo.observe

        def timed_observe(*a, **k):
            t0 = time.perf_counter()
            observe(*a, **k)
            observe_ms.append((time.perf_counter() - t0) * 1e3)
        store.slo.observe = timed_observe
        ocfg = OffloadConfig(path=os.path.join(DATA_DIR, "qos", "a.bin"),
                             page_len=OFFLOAD_PAGE,
                             window_pages=OFFLOAD_WINDOW_PAGES)
        kv = PagedKVCache(cfg, ocfg, eng, OFFLOAD_BATCH, device=dev)
        storm = Storm(eng, dev, stream_path, SEED + 11 + trial)
        try:
            t0 = time.monotonic()
            toks = {}
            for name, srv in (
                    ("dense", DecodeServer(params, cfg, PREFIX_REQUESTS,
                                           2048, device=dev,
                                           kv_store=store)),
                    ("paged", PagedDecodeServer(
                        params, cfg, PREFIX_REQUESTS, 2048,
                        total_blocks=128, block_len=PREFIX_PAGE_TOKENS,
                        device=dev, kv_store=store))):
                for rid, ids in pre["requests"]:
                    srv.submit(rid, ids, PREFIX_NEW_TOKENS)
                toks[name] = srv.run(lookahead=8)
                del srv
            keys = list(pre["pages"])
            for _ in range(QOS_RESTORES):
                got = store.restore_many({0: (0, keys)}, device=dev)[0]
            pages_equal = all(
                torch.equal(got[j][0], pre["pages"][kx][0])
                and torch.equal(got[j][1], pre["pages"][kx][1])
                for j, kx in enumerate(keys))
            del got
            if own_target:
                store.slo.target_ms = target = _pct(restore_ms, 0.5) / 2
                store.slo.observe(eng, _pct(restore_ms, 0.99), eng.stats)
                if sched is not None:
                    peak_w[0] = max(peak_w[0],
                                    sched.policies["decode"].weight)
                if resilient:
                    peak_hb[0] = max(peak_hb[0],
                                     eng.hedge_budgets["decode"])
            kv.append(off["k0"], off["v0"])
            kv.flush()
            tok = _greedy_steps(params, cfg, kv, off["tok0"], 1)
            step_ms, wait_ms, o_toks = [], [], list(tok)
            spent = _read_split(kv)
            for _ in range(OFFLOAD_STEPS):
                torch.cuda.synchronize()
                w0, t1 = spent[0], time.perf_counter()
                o_toks += _greedy_steps(params, cfg, kv, o_toks[-1], 1)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t1) * 1e3)
                wait_ms.append((spent[0] - w0) * 1e3)
            decode_s = time.monotonic() - t0
        finally:
            storm_gib_s = storm.stop()
            kv.close()
        try:
            eng.sync_stats()
            after = eng.stats.snapshot()
            if target:
                # alone now: the governor's decay, outside the counters
                store.restore_many = restore
                boosted = store.slo.boost
                decay_n, decay_s = _governor_decay(store, list(pre["pages"]),
                                                   dev)
                out["governor"] = {
                    "target_ms": target, "boost_after_storm": boosted,
                    "boost_after_decay": store.slo.boost,
                    "decode_weight_base": base_w,
                    "decode_weight_peak": peak_w[0],
                    "decode_weight_after": sched.policies["decode"].weight,
                    "decay_restores": decay_n, "decay_s": decay_s,
                    "restore_p99_boosted_ms": _pct(boosted_ms, 0.99),
                    "restores_boosted": len(boosted_ms),
                    "observe_ms_max": max(observe_ms)}
                if resilient:
                    dec_a = after.get("class_stats", {}).get("decode", {})
                    dec_b = before.get("class_stats", {}).get("decode", {})
                    out["governor"].update({
                        "hedge_budget_base": base_hb,
                        "hedge_budget_peak": peak_hb[0],
                        "hedge_budget_after": eng.hedge_budgets["decode"],
                        "decode_hedges": {
                            k: dec_a.get(k, 0) - dec_b.get(k, 0)
                            for k in ("hedges_issued", "hedges_won",
                                      "hedges_denied")}})
        finally:
            store.close()
        out.update({
            "decode_s": decode_s, "storm_gib_s": storm_gib_s,
            "restore_ms": restore_ms, "step_ms": step_ms,
            "restore_p50_ms": _pct(restore_ms, 0.5),
            "restore_p99_ms": _pct(restore_ms, 0.99),
            "step_p50_ms": _pct(step_ms, 0.5),
            "step_p99_ms": _pct(step_ms, 0.99),
            "step_wait_p50_ms": _pct(wait_ms, 0.5),
            "ring_depth_max": storm.depth_max,
            "stats": {k: after[k] - before[k] for k in QOS_COUNTERS},
            "class_dispatches": {
                k: v.get("dispatches", 0) - before.get("class_stats", {})
                .get(k, {}).get("dispatches", 0)
                for k, v in after.get("class_stats", {}).items()},
            "tokens_equal": toks["dense"] == pre["hit_tokens"] ==
            toks["paged"],
            "pages_equal": pages_equal,
            "offload_tokens_equal": all(
                torch.equal(a, c) for a, c in zip(o_toks, off["toks"]))})
        if cache is not None:
            out["tier"] = {"registered": cache.arena.cuda.devices,
                           **cache.counters()}
    finally:
        hostcache.reset()
        eng.close_all()
    return out


def _qos_tier_checks(dev, cfg, shared):
    """The host tier under STROM_VERIFY=full: a byte flipped in a
    resident line of the store is caught and the page heals through the
    miss path; and a page rewritten into the slot of a resident line (a
    full store's eviction, then ``put``) restores its new bytes."""
    import torch
    from nvme_strom_tpu_torch.io import hostcache
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.models.kv_offload import PrefixStore
    from nvme_strom_tpu_torch.utils.config import HostCacheConfig
    pre = shared["prefix"]
    keys = list(pre["pages"])
    rep = {}
    os.environ["STROM_VERIFY"] = "full"   # read by the tier and the store
    try:
        with StromEngine() as eng:
            cache = hostcache.configure(HostCacheConfig(budget_mb=512),
                                        engine=eng)
            try:
                st = PrefixStore(cfg, eng, pre["store"], PREFIX_PAGE_TOKENS,
                                 PREFIX_STORE_BYTES)
                st.restore_many({0: (0, keys)}, device=dev)
                fkey = eng.file_key(st._fh)
                line = next(ln for k, ln in cache._lines.items()
                            if k[0] == fkey)
                cache.arena.view[line.slot * cache.line_bytes + 100] ^= 0x01
                eng.sync_stats()
                b = eng.stats.snapshot()
                got = st.restore_many({0: (0, keys)}, device=dev)[0]
                eng.sync_stats()
                a = eng.stats.snapshot()
                d = {k: a[k] - b[k] for k in QOS_COUNTERS}
                ok = all(torch.equal(got[j][0], pre["pages"][kx][0])
                         and torch.equal(got[j][1], pre["pages"][kx][1])
                         for j, kx in enumerate(keys))
                st.close()
                if not ok or d["checksum_failures"] != 1 or \
                        d["kv_restore_failures"] or \
                        d["cache_invalidations"] < 1:
                    raise AssertionError(f"tier verify: pages equal {ok}, "
                                         f"counters {d}")
                rep["verify_flip"] = d
                log(f"qos: a byte flipped in a resident line of the store, "
                    f"STROM_VERIFY=full: caught ({d['checksum_failures']} "
                    f"failure, {d['cache_invalidations']} line dropped), "
                    f"healed through the miss path, pages bitwise equal")
                # a full store of 4 pages, a fifth put over a resident
                # line's slot
                path = os.path.join(DATA_DIR, "qos", "small.kvstore")
                small = PrefixStore(cfg, eng, path, PREFIX_PAGE_TOKENS,
                                    4 * st.page_bytes)
                shape = st._kv_shape
                gen = torch.Generator().manual_seed(SEED + 12)
                pages = [(torch.randn(shape, generator=gen).to(cfg.dtype),
                          torch.randn(shape, generator=gen).to(cfg.dtype))
                         for _ in range(5)]
                ks = small.chain_keys(list(range(5 * PREFIX_PAGE_TOKENS
                                                 + 1)))
                small.put([(kx, k, v) for kx, (k, v) in
                           zip(ks[:4], pages[:4])])
                small.flush()
                for _ in range(2):
                    small.restore_many({0: (0, ks[:4])}, device=dev)
                eng.sync_stats()
                b = eng.stats.snapshot()
                small.put([(ks[4], *pages[4])])
                small.flush()
                got = small.restore_many({0: (4, [ks[4]])}, device=dev)[0][4]
                eng.sync_stats()
                a = eng.stats.snapshot()
                d = {k: a[k] - b[k] for k in ("cache_invalidations",
                                             "cache_hits", "cache_misses")}
                fresh = (torch.equal(got[0].cpu(), pages[4][0])
                         and torch.equal(got[1].cpu(), pages[4][1]))
                small.close()
                if not fresh or d["cache_invalidations"] < 1:
                    raise AssertionError(f"tier put: fresh {fresh}, {d}")
                rep["put_over_resident"] = d
                log(f"qos: a page put into a resident line's slot: the line "
                    f"dropped ({d}), the restore gives the new bytes")
            finally:
                hostcache.reset()
    finally:
        os.environ.pop("STROM_VERIFY", None)
    return rep


def qos_phase(dev, cfg, params, shared, stream_path):
    """Decode-class reads under a prefetch storm, every mode of
    QOS_MODES QOS_TRIALS times in alternating order, the median trial of
    each (by decode p99) reported; then the host tier's verify and
    staleness checks.  QOS_GOVERNOR's target is half the restore-batch
    p50 of QOS_GOVERNOR_BASE's first trial, which runs before it.
    Raises unless every trial's tokens equal the prefix store's NVMe-hit
    tokens and the offloaded run's, the restored pages are bitwise the
    cold run's, nothing bounced, no carve fell back, the tier served hits
    from its registered carve, and the governor boosted the decode
    weight and decayed it back to its base."""
    import torch
    os.makedirs(os.path.join(DATA_DIR, "qos"), exist_ok=True)
    t0 = time.monotonic()
    card = card_line()
    runs = {m[0]: [] for m in QOS_MODES}
    target = None
    for trial in range(QOS_TRIALS):
        for mode in (QOS_MODES if trial % 2 == 0 else QOS_MODES[::-1]):
            r = qos_run(dev, cfg, params, mode, shared, stream_path, trial,
                        p99_target_ms=(target if mode[0] == QOS_GOVERNOR
                                       else 0.0))
            if mode[0] == QOS_GOVERNOR_BASE and target is None:
                target = r["restore_p50_ms"] / 2
            runs[mode[0]].append(r)
            log(f"qos {mode[0]} (trial {trial}, {r['n_rings']} rings; "
                f"{card}; registered in {r['register_s']:.3f} s): "
                f"restore-batch ms p50 {r['restore_p50_ms']:.2f} "
                f"p99 {r['restore_p99_ms']:.2f} (each "
                f"{[round(x, 2) for x in r['restore_ms']]}), offloaded "
                f"step ms p50 "
                f"{r['step_p50_ms']:.2f} p99 {r['step_p99_ms']:.2f} (p50 "
                f"{r['step_wait_p50_ms']:.2f} of it waiting for pages); "
                f"decode side {r['decode_s']:.2f} s; storm "
                f"{r['storm_gib_s']:.3f} GiB/s; ring depth max "
                f"{r['ring_depth_max']}; class dispatches "
                f"{r['class_dispatches']}; counters {r['stats']}"
                + (f"; tier {r['tier']}" if "tier" in r else "")
                + (f"; governor {r['governor']}" if "governor" in r
                   else ""))
            torch.cuda.empty_cache()
    report = {}
    for label, rs in runs.items():
        for r in rs:
            st = r["stats"]
            if not (r["tokens_equal"] and r["offload_tokens_equal"]
                    and r["pages_equal"]):
                raise AssertionError(f"qos {label}: tokens or pages differ "
                                     f"from the prefix and offload phases'")
            if st["bytes_fallback"] == 0 and st["bounce_bytes"] != 0:
                raise AssertionError(f"qos {label}: bounce_bytes "
                                     f"{st['bounce_bytes']}")
            if st["arena_fallbacks"] or st["kv_restore_failures"]:
                raise AssertionError(f"qos {label}: {st}")
            if r["n_rings"] > 1 and (not st["sched_dispatches"] or
                                     not r["class_dispatches"].get("decode")):
                raise AssertionError(f"qos {label}: the scheduler granted "
                                     f"no decode batch: {r}")
            g = r.get("governor")
            if label == QOS_GOVERNOR and (
                    st["kv_slo_boosts"] < 1 or g["decode_weight_peak"] <=
                    g["decode_weight_base"] or g["boost_after_decay"] or
                    g["decode_weight_after"] != g["decode_weight_base"]):
                raise AssertionError(f"qos {label}: the governor did not "
                                     f"fire and decay: {g}, {st}")
            if label != QOS_GOVERNOR and st["kv_slo_boosts"]:
                raise AssertionError(f"qos {label}: a boost with no target")
            if "tier" in r and (st["cache_hits"] <= 0
                                or st["bytes_served_cache"] <= 0
                                or r["tier"]["registered"] != [dev.index]
                                or not st["cache_admission_rejections"]):
                raise AssertionError(f"qos {label}: the tier served no hit "
                                     f"from its registered carve: {r}")
        med = sorted(rs, key=lambda r: r["restore_p99_ms"] +
                     r["step_p99_ms"])[len(rs) // 2]
        report[label] = {k: med[k] for k in (
            "n_rings", "register_s", "restore_p50_ms", "restore_p99_ms",
            "step_p50_ms", "step_wait_p50_ms", "decode_s",
            "step_p99_ms", "storm_gib_s", "ring_depth_max",
            "class_dispatches", "stats")}
        if "tier" in med:
            report[label]["tier"] = med["tier"]
        if "governor" in med:
            report[label]["governor"] = med["governor"]
        report[label]["trials"] = [
            {k: r[k] for k in ("restore_p99_ms", "step_p99_ms",
                               "storm_gib_s")} for r in rs]
    report["tier_checks"] = _qos_tier_checks(dev, cfg, shared)
    # resilience_phase's (e) sets its numbers beside this mode's
    shared["qos"] = {"governor": report[QOS_GOVERNOR]}
    report["seconds"] = time.monotonic() - t0
    report["card"] = card
    log(f"qos ({card}): median trial per mode "
        + json.dumps({k: {n: v for n, v in r.items() if n != "stats"}
                      for k, r in report.items()
                      if isinstance(r, dict) and "n_rings" in r})
        + f"; phase {report['seconds']:.1f} s")
    return report


# -- tenants: a bronze aggressor beside a gold victim -------------------------

#: the aggressor's seeded requests: long prompts, few new tokens
TENANT_AGGR_REQUESTS = 16
TENANT_AGGR_PROMPT = 1500
TENANT_AGGR_NEW = 8
#: the victim's decode TTFT p99 target
TENANT_VICTIM_SLO_MS = 100
TENANT_SPEC = (f"victim:tier=gold,slo_ms={TENANT_VICTIM_SLO_MS};"
               "aggr:tier=bronze,quota=0.25")
#: the cut store: the victim's resident pages and as many free pages
#: again, which the aggressor's 16 × 11 pages overflow
TENANT_CUT_PAGES = 64
TENANT_COUNTERS = ("bounce_bytes", "bytes_fallback", "kv_pages_written",
                   "kv_pages_restored", "kv_prefix_misses",
                   "kv_restore_failures", "kv_store_evictions",
                   "tenant_admissions_shed", "tenant_quota_evictions",
                   "tenant_borrows", "tenant_slo_boosts")


def tenant_phase(dev, cfg, params, shared):
    """Tenants at flagship width (STROM_TENANTS on, TENANT_SPEC): the
    prefix store's 8 chat requests as the gold victim, and
    TENANT_AGGR_REQUESTS seeded bronze requests of TENANT_AGGR_PROMPT
    tokens submitted ahead of them, through both servers (8 slots of
    2048 positions) over a copy of the prefix phase's store.  Runs, each
    on both servers: the victim alone (after a warm-up run); with the
    aggressor; with the aggressor's bucket at rate 2, burst 2; with the
    aggressor in a store of TENANT_CUT_PAGES pages, then the victim
    again.  Raises unless the
    victim's tokens equal the prefix phase's NVMe hit on every run and
    server, every shed falls on the aggressor, every aggressor request
    completes, the cut store's quota evictions are all the aggressor's,
    and the victim's last pass restores every page from NVMe bitwise."""
    import numpy as np
    import torch
    from nvme_strom_tpu_torch.io import tenants
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.models.kv_offload import PrefixStore
    from nvme_strom_tpu_torch.models.serving import (DecodeServer,
                                                     PagedDecodeServer)
    from nvme_strom_tpu_torch.ops.bridge import h2d_copy
    from nvme_strom_tpu_torch.utils.config import TenantConfig
    pre = shared["prefix"]
    victims, hit = pre["requests"], pre["hit_tokens"]
    rng = np.random.default_rng(SEED + 21)
    aggrs = [(f"a{i}", rng.integers(0, cfg.vocab,
                                    TENANT_AGGR_PROMPT).tolist())
             for i in range(TENANT_AGGR_REQUESTS)]
    tdir = os.path.join(DATA_DIR, "tenants")
    os.makedirs(tdir, exist_ok=True)
    P = PREFIX_PAGE_TOKENS
    t_phase = time.monotonic()
    card = card_line()
    report = {"card": card, "runs": {}}

    def run(label, make, eng, store, with_aggr, spec=TENANT_SPEC):
        reg = tenants.configure(TenantConfig(enabled=True, spec=spec))
        eng.sync_stats()
        before = eng.stats.snapshot()
        h0, c0 = h2d_copy.launches, store.copies
        srv = make(store)
        t0 = time.monotonic()
        if with_aggr:
            for rid, ids in aggrs:
                srv.submit(rid, ids, TENANT_AGGR_NEW, tenant="aggr")
        for rid, ids in victims:
            srv.submit(rid, ids, PREFIX_NEW_TOKENS, tenant="victim")
        out = srv.run(lookahead=8)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        eng.sync_stats()
        after = eng.stats.snapshot()
        st = srv.stats()
        ttft = [srv.request_metrics[rid]["ttft_ms"] for rid, _ in victims]
        attft = [srv.request_metrics[rid]["ttft_ms"] for rid, _ in aggrs
                 if with_aggr]
        per = after.get("tenant_stats", {})
        per0 = before.get("tenant_stats", {})
        r = {"seconds": secs,
             "victim_ttft_p50_ms": _pct(ttft, 0.5),
             "victim_ttft_p99_ms": _pct(ttft, 0.99),
             "aggr_ttft_p50_ms": _pct(attft, 0.5),
             "tenant_sheds": st.get("tenant_sheds", {}),
             "admissions_shed": st["admissions_shed"],
             "victim_share_boost": reg.get("victim").share_boost,
             "stats": {k: after[k] - before[k] for k in TENANT_COUNTERS},
             "quota_evictions": {
                 t: v.get("quota_evictions", 0)
                 - per0.get(t, {}).get("quota_evictions", 0)
                 for t, v in per.items()},
             "h2d_launches": h2d_copy.launches - h0,
             "store_copies": store.copies - c0}
        vt = {rid: out[rid] for rid, _ in victims}
        if vt != hit:
            diff = [rid for rid in hit if vt.get(rid) != hit[rid]]
            raise AssertionError(f"tenants {label}: victim tokens differ "
                                 f"from the prefix store's hit for {diff}")
        if with_aggr and (set(out) != set(vt) | {rid for rid, _ in aggrs}
                          or any(len(out[rid]) != TENANT_AGGR_NEW
                                 for rid, _ in aggrs)):
            raise AssertionError(f"tenants {label}: an aggressor request "
                                 "did not complete")
        if set(r["tenant_sheds"]) - {"aggr"}:
            raise AssertionError(f"tenants {label}: a shed fell on the "
                                 f"victim: {r['tenant_sheds']}")
        if with_aggr and not r["tenant_sheds"].get("aggr"):
            raise AssertionError(f"tenants {label}: nothing was shed")
        if r["stats"]["bytes_fallback"] == 0 and r["stats"]["bounce_bytes"]:
            raise AssertionError(f"tenants {label}: bounce_bytes "
                                 f"{r['stats']['bounce_bytes']}")
        if r["stats"]["kv_restore_failures"] or \
                not r["h2d_launches"] >= r["store_copies"] > 0:
            raise AssertionError(f"tenants {label}: restores {r}")
        report["runs"][label] = r
        log(f"tenants {label} ({card}): {secs:.3f} s; victim TTFT ms p50 "
            f"{r['victim_ttft_p50_ms']:.2f} p99 {r['victim_ttft_p99_ms']:.2f}"
            f"; aggressor TTFT p50 {r['aggr_ttft_p50_ms']:.2f} ms; "
            f"tenant_sheds {r['tenant_sheds']}, admissions_shed "
            f"{r['admissions_shed']}; victim share_boost "
            f"{r['victim_share_boost']}; h2d_copy {r['h2d_launches']} "
            f"(store copies {r['store_copies']}); quota evictions "
            f"{r['quota_evictions']}; counters {r['stats']}")
        return srv

    def dense(st):
        return DecodeServer(params, cfg, PREFIX_REQUESTS, 2048, device=dev,
                            kv_store=st)

    def paged(st):
        return PagedDecodeServer(params, cfg, PREFIX_REQUESTS, 2048,
                                 total_blocks=128, block_len=P, device=dev,
                                 kv_store=st)

    try:
        with StromEngine() as eng:
            eng.cuda_mapping(dev.index)
            for name, make in (("dense", dense), ("paged", paged)):
                path = os.path.join(tdir, f"{name}.kvstore")
                _copy_store(pre["store"], path, 1 << 20)
                st = PrefixStore(cfg, eng, path, P, PREFIX_STORE_BYTES)
                run(f"{name} victim alone, warm-up", make, eng, st, False)
                run(f"{name} victim alone", make, eng, st, False)
                run(f"{name} victim + aggressor", make, eng, st, True)
                run(f"{name} victim + aggressor, bucket 2/s", make, eng, st,
                    True, spec=TENANT_SPEC + ",rate=2,burst=2")
                st.close()
                # the cut store
                path = os.path.join(tdir, f"{name}_cut.kvstore")
                _copy_store(pre["store"], path, 1 << 20)
                st = PrefixStore(cfg, eng, path, P,
                                 TENANT_CUT_PAGES * st.page_bytes)
                label = f"{name} victim + aggressor, {TENANT_CUT_PAGES}-page" \
                        " store"
                run(label, make, eng, st, True)
                q = report["runs"][label]
                if not q["quota_evictions"].get("aggr") or any(
                        v for t, v in q["quota_evictions"].items()
                        if t != "aggr"):
                    raise AssertionError(f"tenants {label}: quota evictions "
                                         f"{q['quota_evictions']}")
                srv = run(f"{name} victim after the cut store", make, eng, st,
                          False)
                again = report["runs"][f"{name} victim after the cut store"]
                if again["stats"]["kv_prefix_misses"] or again["stats"][
                        "kv_pages_restored"] < len(pre["pages"]):
                    raise AssertionError(f"tenants {name}: the victim's pages "
                                         f"did not all survive: {again}")
                for slot, (_, ids) in enumerate(victims):
                    for j, kx in enumerate(st.chain_keys(ids)):
                        k, v = pre["pages"][kx]
                        if name == "dense":
                            cols = slice(j * P, (j + 1) * P)
                            gk = srv.k_cache[:, slot, :, cols]
                            gv = srv.v_cache[:, slot, :, cols]
                        else:   # the block the HBM cache holds the page in
                            blk = srv._pc[srv._chain_keys(ids)[j]]["blk"]
                            gk, gv = srv.k_pool[:, blk], srv.v_pool[:, blk]
                        if not (torch.equal(gk, k) and torch.equal(gv, v)):
                            raise AssertionError(
                                f"tenants {name}: page {j} of victim {slot} "
                                "differs after the cut store")
                del srv
                st.close()
                torch.cuda.empty_cache()
    finally:
        tenants.reset()
    runs = report["runs"]
    report["victim_ttft_p99_ms"] = {
        k: (runs[f"{k} victim alone"]["victim_ttft_p99_ms"],
            runs[f"{k} victim + aggressor"]["victim_ttft_p99_ms"])
        for k in ("dense", "paged")}
    report["seconds"] = time.monotonic() - t_phase
    log(f"tenants ({card}): victim TTFT p99 ms (alone, with the aggressor) "
        f"{report['victim_ttft_p99_ms']}; victim tokens equal the prefix "
        f"store's hit on every run; phase {report['seconds']:.1f} s")
    return report


# -- phase 6: training at flagship width --------------------------------------

TRAIN_SEQ = 2048
TRAIN_BATCH = 8
TRAIN_STEPS = 10
RESUME_STEPS = 12
SAVE_EVERY = 5


def _same_state(tr_a, tr_b):
    """Raise unless two trainers' parameters and optimizer state are
    bitwise equal."""
    import torch
    from nvme_strom_tpu_torch.train import optimizer_state
    oa = optimizer_state(tr_a.optimizer, tr_a.params)
    ob = optimizer_state(tr_b.optimizer, tr_b.params)
    if sorted(oa) != sorted(ob):
        raise AssertionError(f"optimizer state keys {sorted(oa)} != "
                             f"{sorted(ob)}")
    for name, p in tr_a.params.items():
        if not torch.equal(p.detach(), tr_b.params[name].detach()):
            raise AssertionError(f"resumed parameter {name} differs")
        for key in oa:
            if not torch.equal(oa[key][name].cpu(), ob[key][name].cpu()):
                raise AssertionError(f"resumed optimizer {key} of {name} "
                                     "differs")
    return len(tr_a.params), len(oa)


def train_phase(dev, ckdir, cfg):
    """Seeded WebDataset shards → ShardedLoader → prefetch_to_device →
    Trainer with the flash kernels, warm-started from ``ckdir``: 10
    steps with a checkpoint every 5; a second Trainer resumes from step
    10 (bitwise-equal state) and runs steps 11-12 under the profiler."""
    import math
    import shutil
    import statistics
    import torch
    from nvme_strom_tpu_torch.data.prefetch import prefetch_to_device
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.ops.flash_attention import make_flash_attn
    from nvme_strom_tpu_torch.train import Trainer
    from nvme_strom_tpu_torch.train_lm import (synthesize_shards,
                                              token_batches)
    shard_dir = os.path.join(DATA_DIR, "train_shards")
    ckpt = os.path.join(DATA_DIR, "train_ckpt")
    for d in (shard_dir, ckpt):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(shard_dir)
    shards = synthesize_shards(shard_dir, cfg.vocab, TRAIN_SEQ, n_shards=4,
                               per_shard=8 * TRAIN_BATCH, seed=SEED)
    report = {}
    with StromEngine() as eng:
        def make(log_to):
            return Trainer(cfg, attn_fn=make_flash_attn(), init_weights=ckdir,
                           ckpt_dir=ckpt, save_every=SAVE_EVERY, engine=eng,
                           device=dev, seed=SEED,
                           hooks=[lambda s, l, dt: log_to.append((s, l, dt))])

        def batches():
            return prefetch_to_device(token_batches(
                shards, TRAIN_BATCH, cfg.vocab, eng, dev), size=2)

        steps = []
        tr = make(steps)
        if tr.resumed_from is not None:
            raise AssertionError("a fresh checkpoint dir resumed")
        it = batches()
        try:
            res = tr.fit(it, steps=TRAIN_STEPS)
        finally:
            it.close()
        torch.cuda.synchronize()
        losses = [l for _, l, _ in steps]
        if res.steps != TRAIN_STEPS or len(steps) != TRAIN_STEPS or \
                not all(math.isfinite(l) for l in losses):
            raise AssertionError(f"training: {res}, losses {losses}")
        plain_ms = [dt * 1e3 for s, _, dt in steps
                    if s > 1 and s % SAVE_EVERY]
        ms = statistics.median(plain_ms)
        report.update(
            steps_per_s=res.steps_per_s,
            tokens_per_s_fit=res.steps_per_s * TRAIN_BATCH * TRAIN_SEQ,
            ms_per_step_median=ms,
            tokens_per_s_median_step=TRAIN_BATCH * TRAIN_SEQ / ms * 1e3,
            step_ms=[dt * 1e3 for _, _, dt in steps], losses=losses,
            save_phases=tr.manager.last_save_phases,
            checkpoint_steps=tr.manager.all_steps())
        log(f"train: {TRAIN_STEPS} steps (seq {TRAIN_SEQ}, batch "
            f"{TRAIN_BATCH}, flash) at {res.steps_per_s:.3f} steps/s = "
            f"{report['tokens_per_s_fit']:.0f} tokens/s (fit, with 2 saves "
            f"and the first step); median step without a save {ms:.2f} ms "
            f"= {report['tokens_per_s_median_step']:.0f} tokens/s; step ms "
            f"{[round(x, 2) for x in report['step_ms']]}; losses "
            f"{[round(x, 4) for x in losses]}; last save "
            f"{tr.manager.last_save_phases}")

        steps2 = []
        tr2 = make(steps2)
        if tr2.resumed_from != TRAIN_STEPS or tr2.step != TRAIN_STEPS:
            raise AssertionError(f"resumed from {tr2.resumed_from}, "
                                 f"expected {TRAIN_STEPS}")
        n_params, n_keys = _same_state(tr, tr2)
        log(f"resume: second trainer resumed from step {tr2.resumed_from}"
            f"; {n_params} parameters and {n_keys} AdamW state tensors "
            f"each bitwise equal to the first trainer's")
        tr.close()
        del tr
        it = batches()

        def run(done):
            # the window is the two steps: it ends in the last step's
            # hook, before fit's final save
            tr2.hooks.append(lambda s, l, dt: s == RESUME_STEPS and done())
            r = tr2.fit(it, steps=RESUME_STEPS)
            if r.steps != RESUME_STEPS:
                raise AssertionError(f"resumed run ended at {r.steps}")
        try:
            report["profile"] = profile_run(
                run, f"train steps {TRAIN_STEPS + 1}-{RESUME_STEPS}")
        finally:
            it.close()
        if not all(math.isfinite(l) for _, l, _ in steps2):
            raise AssertionError(f"resumed losses {steps2}")
        report["resumed_losses"] = [l for _, l, _ in steps2]
        tr2.close()
        eng.sync_stats()
        report["stats"] = eng.stats.snapshot()
    log(f"train: engine stats {report['stats']}")
    return report


# -- STROM_VERIFY on the weights load and the loader --------------------------

def _load_timed(eng, path, dev):
    """LazyCheckpoint(path).load onto ``dev``: (params, seconds, counter
    deltas of the load)."""
    import torch
    from nvme_strom_tpu_torch.parallel.weights import LazyCheckpoint
    eng.sync_stats()
    before = eng.stats.snapshot()
    t0 = time.monotonic()
    params = LazyCheckpoint(path).load(eng, device=dev)
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    eng.sync_stats()
    after = eng.stats.snapshot()
    return params, secs, {k: after[k] - before[k] for k in (
        "bytes_direct", "bytes_fallback", "bounce_bytes", "bytes_verified",
        "checksum_failures")}


def _loader_epoch(shards, eng, dev, vocab):
    """One epoch of the training phase's batches on the card (its
    decode), copied out: [batch tensors], h2d_copy launches."""
    import numpy as np
    from nvme_strom_tpu_torch.data.loader import ShardedLoader
    from nvme_strom_tpu_torch.ops.bridge import h2d_copy

    def decode(parts):
        (payload,) = parts.values()
        return np.frombuffer(payload, dtype=np.int32) % vocab
    h0 = h2d_copy.launches
    with ShardedLoader(shards, TRAIN_BATCH, decode=decode, engine=eng,
                       device=dev) as loader:
        out = [b.clone() for b in loader]
    return out, h2d_copy.launches - h0


def verify_phase(dev, ckdir, cfg):
    """STROM_VERIFY on the two reads every user path starts with.
    Weights: the serving checkpoint (its CRC32C stamps written by
    ``save_checkpoint``) loaded onto the card unverified and under
    STROM_VERIFY=full, alternately twice each, the verified load
    checking its whole payload and bitwise the unverified one; then one
    payload byte flipped in a copy of the file: the load must raise
    ChecksumError with one failure counted.  Both servers then serve 4
    requests on the verified weights (tokens equal).  Loader: the
    training phase's 4 shards stamped with ``stamp_wds``, one epoch
    unverified and one under STROM_VERIFY=full, batches equal and
    copied by h2d_copy; a flipped sample byte in a copy of a shard must
    raise (ShardReadError over a ChecksumError) naming it; the copies
    stay under DATA_DIR/verify/shards for resilience_loader_phase."""
    import glob
    import shutil
    import numpy as np
    import torch
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.models.serving import (DecodeServer,
                                                     PagedDecodeServer)
    from nvme_strom_tpu_torch.data.loader import ShardReadError
    from nvme_strom_tpu_torch.utils.checksum import ChecksumError, stamp_wds
    report = {}
    vdir = os.path.join(DATA_DIR, "verify")
    shutil.rmtree(vdir, ignore_errors=True)
    os.makedirs(vdir)
    wpath = os.path.join(ckdir, "model.safetensors")
    with StromEngine() as eng:
        eng.cuda_mapping(dev.index)          # page-lock staging first
        loads = {"unverified": [], "verified": []}
        for _ in range(2):
            for mode in ("unverified", "verified"):
                if mode == "verified":
                    os.environ["STROM_VERIFY"] = "full"
                try:
                    params, secs, st = _load_timed(eng, wpath, dev)
                finally:
                    os.environ.pop("STROM_VERIFY", None)
                loads[mode].append((secs, st))
                if mode == "unverified":
                    plain = params
                else:
                    verified = params
                del params
        payload = sum(t.numel() * t.element_size() for t in plain.values())
        for name, t in plain.items():
            if not torch.equal(verified[name], t):
                raise AssertionError(f"verified load: {name} differs")
        for secs, st in loads["verified"]:
            if st["bytes_verified"] < payload or st["checksum_failures"]:
                raise AssertionError(f"verified load: {st} of {payload} B")
        for secs, st in loads["unverified"]:
            if st["bytes_verified"] or st["checksum_failures"]:
                raise AssertionError(f"unverified load checked: {st}")
        del plain
        report["weights"] = {
            "payload_bytes": payload,
            "unverified_s": [s for s, _ in loads["unverified"]],
            "verified_s": [s for s, _ in loads["verified"]],
            "verified_stats": loads["verified"][-1][1]}
        log(f"verify: weights load of {payload} B, unverified "
            f"{[round(s, 4) for s in report['weights']['unverified_s']]} s, "
            f"STROM_VERIFY=full "
            f"{[round(s, 4) for s in report['weights']['verified_s']]} s "
            f"(alternating); verified {loads['verified'][-1][1]}; tensors "
            "bitwise equal")
        # one flipped payload byte in a copy
        bad = os.path.join(vdir, "flipped.safetensors")
        shutil.copyfile(wpath, bad)
        at = os.path.getsize(bad) - payload // 3
        _flip_byte(bad, at)
        os.environ["STROM_VERIFY"] = "full"
        try:
            eng.sync_stats()
            f0 = eng.stats.snapshot()["checksum_failures"]
            try:
                _load_timed(eng, bad, dev)
            except ChecksumError as e:
                caught = str(e)
            else:
                raise AssertionError("a flipped weights byte loaded")
            eng.sync_stats()
            fails = eng.stats.snapshot()["checksum_failures"] - f0
        finally:
            os.environ.pop("STROM_VERIFY", None)
        if fails != 1 or "corrupt weights" not in caught:
            raise AssertionError(f"flipped weights: {fails} failures, "
                                 f"{caught!r}")
        report["weights"]["flip"] = {"at": at, "failures": fails}
        log(f"verify: a byte flipped at {at} of a copy: {caught}")
        # the verified weights serve
        rng = np.random.default_rng(SEED)
        reqs = [(f"v{i}", rng.integers(0, cfg.vocab, n).tolist())
                for i, n in enumerate((16, 300, 700, 1500))]
        outs = []
        for srv in (DecodeServer(verified, cfg, 4, 2048, device=dev),
                    PagedDecodeServer(verified, cfg, 4, 2048,
                                      total_blocks=64, block_len=128,
                                      device=dev)):
            for rid, ids in reqs:
                srv.submit(rid, ids, 8)
            outs.append(srv.run(lookahead=8))
            del srv
        if outs[0] != outs[1]:
            raise AssertionError("verified weights: dense and paged "
                                 "tokens differ")
        del verified
        torch.cuda.empty_cache()
        # the loader
        shards = sorted(glob.glob(os.path.join(DATA_DIR, "train_shards",
                                               "*.tar")))
        if len(shards) != 4:
            raise AssertionError(f"training shards: {shards}")
        for p in shards:
            stamp_wds(p)
        t0 = time.monotonic()
        plain_b, h_plain = _loader_epoch(shards, eng, dev, cfg.vocab)
        plain_s = time.monotonic() - t0
        os.environ["STROM_VERIFY"] = "full"
        try:
            eng.sync_stats()
            before = eng.stats.snapshot()
            t0 = time.monotonic()
            ver_b, h_ver = _loader_epoch(shards, eng, dev, cfg.vocab)
            ver_s = time.monotonic() - t0
            eng.sync_stats()
            after = eng.stats.snapshot()
            st = {k: after[k] - before[k] for k in ("bytes_verified",
                                                   "checksum_failures")}
            samples = sum(b.shape[0] for b in ver_b)
            if len(ver_b) != len(plain_b) or not ver_b or any(
                    not torch.equal(a, b) for a, b in zip(ver_b, plain_b)):
                raise AssertionError("verified epoch differs")
            if st["bytes_verified"] != samples * TRAIN_SEQ * 4 or \
                    st["checksum_failures"] or not (h_ver and h_plain):
                raise AssertionError(f"verified epoch: {st}, h2d_copy "
                                     f"{h_ver}")
            # one flipped byte of a sample in a copy of shard 2
            bad_dir = os.path.join(vdir, "shards")
            os.makedirs(bad_dir)
            bad_shards = []
            for p in shards:
                q = os.path.join(bad_dir, os.path.basename(p))
                shutil.copyfile(p, q)
                shutil.copyfile(p + ".crc.json", q + ".crc.json")
                bad_shards.append(q)
            _flip_byte(bad_shards[2], 512 + 100)
            try:
                _loader_epoch(bad_shards, eng, dev, cfg.vocab)
            except ShardReadError as e:
                if not isinstance(e.__cause__, ChecksumError):
                    raise
                caught = str(e)
            else:
                raise AssertionError("a flipped sample byte loaded")
            if os.path.basename(bad_shards[2]) not in caught:
                raise AssertionError(f"the error names no shard: {caught}")
        finally:
            os.environ.pop("STROM_VERIFY", None)
        report["loader"] = {"batches": len(ver_b), "unverified_s": plain_s,
                            "verified_s": ver_s, "stats": st,
                            "h2d_launches": h_ver}
        log(f"verify: loader epoch of {len(ver_b)} batches, unverified "
            f"{plain_s:.4f} s, STROM_VERIFY=full {ver_s:.4f} s, {st}, "
            f"batches equal, {h_ver} h2d_copy launches; a flipped sample "
            f"byte: {caught}")
    return report


def f32_train_phase(dev, cfg):
    """One float32 train step of the flagship (batch 2, seq 2048), TF32
    off: loss and every gradient through the flash kernels against the
    same step through their plain versions.  Both sides are float32
    end to end; they differ only in summation order, so loss agrees to
    1e-4 and each gradient to rtol 1e-3 + 1e-4*max|plain|."""
    import dataclasses
    import torch
    from nvme_strom_tpu_torch.models.transformer import (init_params,
                                                         trainable_params,
                                                         value_and_grad)
    from nvme_strom_tpu_torch.ops import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    class PlainFlash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            scale = q.shape[-1] ** -0.5
            out, lse = fa.flash_fwd_plain(q, k, v, True, scale)
            ctx.save_for_backward(q, k, v, out, lse)
            return out

        @staticmethod
        def backward(ctx, dout):
            q, k, v, out, lse = ctx.saved_tensors
            scale = q.shape[-1] ** -0.5
            delta = (dout.float() * out.float()).sum(-1)
            args = (q, k, v, dout, lse, delta, True, scale)
            return (fa.flash_bwd_dq_plain(*args),
                    *fa.flash_bwd_dkv_plain(*args))

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params = trainable_params(init_params(SEED, cfg32), dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab, (2, TRAIN_SEQ), generator=gen,
                           device=dev)
    loss_k, g_k = value_and_grad(params, tokens, cfg32,
                                 fa.make_flash_attn())
    loss_p, g_p = value_and_grad(params, tokens, cfg32, PlainFlash.apply)
    loss_err = abs(loss_k.item() - loss_p.item())
    if not loss_err <= 1e-4:
        raise AssertionError(f"f32 train step loss {loss_k.item()} vs "
                             f"plain {loss_p.item()}")
    worst = 0.0
    for name in params:
        want = g_p[name]
        atol = 1e-4 * want.abs().max().item()
        torch.testing.assert_close(g_k[name], want, rtol=1e-3, atol=atol,
                                   msg=lambda m: f"f32 grad {name}: {m}")
        rel = ((g_k[name] - want).abs().max().item()
               / max(want.abs().max().item(), 1e-30))
        worst = max(worst, rel)
    log(f"f32 train step: loss {loss_k.item():.6f} (kernel) vs "
        f"{loss_p.item():.6f} (plain), |diff| {loss_err:.3g}; largest "
        f"gradient difference {worst:.3g} of its tensor's max |plain|, "
        f"over {len(params)} gradients")
    return {"loss_err": loss_err, "grad_max_rel_err": worst}


# -- phase 8: the ring all-gather (kernel 7) ---------------------------------

ICI_RANKS = 4


class SpanLog:
    """A tracer for the exchange's spans: (name, seconds, args)."""

    enabled = True

    def __init__(self):
        self.spans = []

    def add_span(self, name, t0_ns, t1_ns, **args):
        self.spans.append((name, (t1_ns - t0_ns) / 1e9, args))


def _primed(devs, width, seed):
    """Rows and per-rank (n, width) outputs with each own slot filled."""
    import torch
    n = len(devs)
    gen = torch.Generator(device=devs[0]).manual_seed(seed)
    rows = torch.randint(0, 256, (n, width), generator=gen,
                         dtype=torch.uint8, device=devs[0])
    slots = []
    for r, d in enumerate(devs):
        s = torch.empty(n, width, dtype=torch.uint8, device=d)
        s[r] = rows[r].to(d)
        slots.append(s)
    return rows, slots


def kernel_device_ms(fn, iters, name):
    """Mean device milliseconds of a kernel whose name holds ``name``,
    over the launches torch.profiler records in ``iters`` calls of ``fn``
    (one a call; the profiler may miss one, and a window in which it
    recorded none is taken again, twice at most): the kernel's own time,
    for calls that wait for their kernels and so cannot be queued ahead
    of the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):   # a window whose launches the profiler all missed
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type.name == "CUDA" and name in e.key]
        count = sum(e.count for e in hits)
        if count:
            break
    if not 0 < count <= iters:
        raise RuntimeError(f"kernel_device_ms: {count} {name} kernels in "
                           f"{iters} calls")
    return sum(e.self_device_time_total for e in hits) / 1e3 / count


def ring_times(dev, width, n=ICI_RANKS, iters=10):
    """Kernel 7 on ``n`` ranks of one card with (n, width) slots: ``ms``
    back to back (CUDA events around ``iters`` calls, each waiting for
    its kernel as a caller does), ``device_ms`` (the kernel alone, by
    torch.profiler) and ``host_us`` (the difference a call: the
    wrapper's own work, through which the card idles).  It calls only
    the wrapper's public signature, so it times any tree's package that
    is first on ``sys.path``."""
    from nvme_strom_tpu_torch.ops.ici import ici_ring_gather
    from nvme_strom_tpu_torch.parallel.mesh import exchange_group
    group = exchange_group(devices=[dev] * n)
    _, slots = _primed([dev] * n, width, SEED + 4)

    def call():
        ici_ring_gather(slots, group)
    ms = time_ms(call, iters)
    dms = kernel_device_ms(call, iters, "ici_ring")
    return {"ms": ms, "device_ms": dms, "host_us": (ms - dms) * 1e3}


def check_ici(dev, results, row_bytes):
    """Kernel 7 against its plain version, bitwise, on ICI_RANKS ranks
    of the card at the restore's row width (padded) and at a ragged
    width, three calls in a row; times at the restore's width."""
    import numpy as np
    import torch
    from nvme_strom_tpu_torch.ops.ici import (IciExchange, _padded,
                                              ici_ring_gather,
                                              ici_ring_gather_plain)
    from nvme_strom_tpu_torch.parallel.mesh import exchange_group
    n = ICI_RANKS
    devs = [dev] * n
    group = exchange_group(devices=devs)
    width = _padded(row_bytes)
    first = None
    for call in range(3):
        rows, slots = _primed(devs, width, SEED + 3)
        ici_ring_gather(slots, group)
        for r, s in enumerate(slots):
            if not torch.equal(s, rows):
                raise AssertionError(f"ici_ring_gather call {call}: rank {r} "
                                     "differs from the rows")
        if first is None:
            first = [s.clone() for s in slots]
        elif not all(torch.equal(a, b) for a, b in zip(first, slots)):
            raise AssertionError(f"ici_ring_gather call {call} differs from "
                                 "call 0")
        del slots
    _, plain = _primed(devs, width, SEED + 3)
    ici_ring_gather_plain(plain)
    if not all(torch.equal(a, b) for a, b in zip(first, plain)):
        raise AssertionError("ici_ring_gather != plain")
    del first, plain
    ragged = 12_345
    ex = IciExchange(group)
    rows = np.random.default_rng(SEED).integers(0, 256, (n, ragged),
                                                dtype=np.uint8)
    for _ in range(3):
        if ex.all_gather(rows).numpy().tobytes() != rows.tobytes():
            raise AssertionError("IciExchange ragged rows differ")
    log(f"ici_ring_gather: {n} ranks on {dev}, width {width} B and ragged "
        f"{ragged} B, 3 calls each, bitwise equal to plain and the rows")

    times = ring_times(dev, width, n)
    _, slots = _primed(devs, width, SEED + 4)

    def library():
        # the same n*(n-1) slot copies on the copy path, from each row's
        # origin (the port never calls this)
        for r in range(n):
            for src in range(n):
                if src != r:
                    slots[r][src].copy_(slots[src][src])

    plain_ms = time_ms(lambda: ici_ring_gather_plain(slots), 10)
    library_ms = time_ms(library, 10)
    # each rank's own row read once and the n - 1 other rows of every
    # rank's output written once; a ring whose every push reads and
    # writes HBM moves 2·n·(n - 1) rows (logged, not a result)
    bound_ms, bound_by = bound(n * n * width, HBM_BYTES_PER_S)
    log(f"ici_ring_gather: ring-traffic figure (2·n·(n-1) rows over HBM) "
        f"{bound(2 * n * (n - 1) * width, HBM_BYTES_PER_S)[0]:.4f} ms")
    results["ici_ring_gather"] = dict(
        name="ici_ring_gather", route="cuda",
        source="nvme_strom_tpu_torch/csrc/ici_ring.cu",
        replaces="nvme_strom_tpu/ops/ici.py:159", max_abs_err=0.0,
        **times, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=bound_ms, bound_by=bound_by,
        shape=f"{n} ranks on one card, {width} B slots", ok=True,
        design=f"TMA bulk copies of {group.ring.chunk >> 10} KB chunks, "
        "interleaved over the blocks, each taken round the ring before the "
        "next, a flag a chunk",
        blocks_per_rank=group.ring.blocks)
    del slots
    torch.cuda.empty_cache()
    for cards, key in ((2, "two_cards"), (4, "four_cards")):
        if torch.cuda.device_count() >= cards:
            results["ici_ring_gather"][key] = ici_across_cards(width, cards)
        else:
            log(f"ici_ring_gather across {cards} cards: not run "
                f"({torch.cuda.device_count()} card(s))")


def ici_across_cards(width, cards):
    """The ring across cuda:0 .. cuda:cards-1 (peer access, one rank a
    card), bitwise over three calls, timed against
    torch.cuda.nccl.all_gather of the same rows."""
    import torch
    import torch.cuda.nccl as nccl
    from nvme_strom_tpu_torch.ops.ici import ici_ring_gather
    from nvme_strom_tpu_torch.parallel.mesh import exchange_group
    devs = [torch.device("cuda", i) for i in range(cards)]
    group = exchange_group(devices=devs)
    rows, slots = _primed(devs, width, SEED + 5)
    for _ in range(3):
        ici_ring_gather(slots, group)
        for s in slots:
            if not torch.equal(s.to(devs[0]), rows):
                raise AssertionError(f"{cards}-card ring differs from the "
                                     "rows")
    ms = time_ms(lambda: ici_ring_gather(slots, group), 10)
    ins = [rows[r].to(d) for r, d in enumerate(devs)]
    outs = [torch.empty(cards * width, dtype=torch.uint8, device=d)
            for d in devs]
    nccl_ms = time_ms(lambda: nccl.all_gather(ins, outs), 10)
    # each card sends n - 1 rows to its right neighbour
    bound_ms = (cards - 1) * width / 450e9 * 1e3
    log(f"ici_ring_gather {cards} cards, {width} B rows: kernel {ms:.4f} "
        f"ms, nccl.all_gather {nccl_ms:.4f} ms, NVLink bound "
        f"{bound_ms:.4f} ms")
    return {"ms": ms, "nccl_ms": nccl_ms, "bound_ms": bound_ms}


# -- phase 9: the read-once restore ------------------------------------------

def restore_phase(dev, ckdir, cpu_params):
    """The newest training checkpoint restored with the read-all path and
    with the read-once scatter over ICI_RANKS ranks of the card, then
    phase 4's weights loaded both ways: every tensor bitwise equal."""
    import torch
    from nvme_strom_tpu_torch.checkpoint.manager import CheckpointManager
    from nvme_strom_tpu_torch.checkpoint.scatter import build_restore_manifest
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.ops.ici import ici_unit_bytes
    from nvme_strom_tpu_torch.parallel.mesh import exchange_group
    from nvme_strom_tpu_torch.parallel.weights import LazyCheckpoint
    from nvme_strom_tpu_torch.utils.stats import COUNTERS
    group = exchange_group(devices=[dev] * ICI_RANKS)
    report = {}
    with StromEngine() as eng:
        eng.tracer = SpanLog()
        mgr = CheckpointManager(os.path.join(DATA_DIR, "train_ckpt"),
                                engine=eng)
        step = mgr.latest_step()
        man = build_restore_manifest(mgr.step_dir(step), ICI_RANKS,
                                     ici_unit_bytes())

        def timed(label, run):
            eng.sync_stats()
            before = eng.stats.snapshot()
            t0 = time.monotonic()
            out = run()
            torch.cuda.synchronize()
            secs = time.monotonic() - t0
            eng.sync_stats()
            after = eng.stats.snapshot()
            delta = {k: after[k] - before[k] for k in COUNTERS}
            report[label] = {"seconds": secs, "stats": delta}
            log(f"{label}: {secs:.3f} s; stats {delta}")
            return out, delta

        os.environ.pop("STROM_ICI_SCATTER", None)
        off, _ = timed("restore read-all", lambda: mgr.restore(device=dev))
        os.environ["STROM_ICI_SCATTER"] = "1"
        try:
            n_spans = len(eng.tracer.spans)
            on, st = timed("restore scatter", lambda: mgr.restore(
                device=dev, ici_group=group))
            spans = {n: (s, a) for n, s, a in eng.tracer.spans[n_spans:]}
            exch, ex_args = spans["strom.ici.exchange"]
            scat, sc_args = spans["strom.ici.scatter"]
            if mgr.last_restore_step != step or set(on) != set(off):
                raise AssertionError("scatter restore read another step")
            for name in off:
                if not torch.equal(on[name], off[name]):
                    raise AssertionError(f"scatter restore: {name} differs")
            if st["ici_fallbacks"] != 0:
                raise AssertionError("the scatter restore browned out")
            if st["ici_bytes_read"] != man.total_bytes:
                raise AssertionError(f"ici_bytes_read {st['ici_bytes_read']}"
                                     f" != payload {man.total_bytes}")
            worst = max(man.host_bytes)
            if worst > man.total_bytes / ICI_RANKS + man.shares.unit_bytes:
                raise AssertionError(f"a host's share is {worst} B")
            report["restore scatter"].update(
                exchange_s=exch, scatter_setup_s=scat,
                share_read_s=sc_args["read_s"], ring_s=ex_args["ring_s"],
                exchange_out_s=ex_args["out_s"],
                exchange_share=exch / report["restore scatter"]["seconds"],
                payload_bytes=man.total_bytes, host_bytes=man.host_bytes,
                tensors=len(on))
            log(f"restore: step {step}, {len(on)} tensors bitwise equal; "
                f"payload {man.total_bytes} B, host shares {man.host_bytes};"
                f" scatter set-up {scat:.3f} s: share reads "
                f"{sc_args['read_s']:.3f} s, exchange {exch:.4f} s (priming "
                f"copies and ring {ex_args['ring_s']:.4f} s, host buffer "
                f"and copy out {ex_args['out_s']:.4f} s)")
            del on, off
            os.environ.pop("STROM_ICI_SCATTER")
            w_off, _ = timed("weights read-all", lambda: LazyCheckpoint(
                ckdir).load(eng, device=dev))
            os.environ["STROM_ICI_SCATTER"] = "1"
            w_on, st = timed("weights scatter", lambda: LazyCheckpoint(
                ckdir).load(eng, device=dev, ici_group=group))
        finally:
            os.environ.pop("STROM_ICI_SCATTER", None)
        for name, t in cpu_params.items():
            if not (torch.equal(w_on[name], w_off[name])
                    and torch.equal(w_on[name].cpu(), t)):
                raise AssertionError(f"scatter weights: {name} differs")
        if st["ici_fallbacks"] != 0 or st["ici_bytes_read"] == 0:
            raise AssertionError(f"weights scatter stats {st}")
        log(f"weights: {len(w_on)} tensors bitwise equal with scatter on "
            "and off")
    return report


# -- resilience: fault injection and recovery on the main paths -------------

#: the read plan of every faulted run: an EIO every 7th read, a half
#: read every 11th, a 50 ms straggler every 13th (seeded: SEED).  The
#: resilient wait polls in 20 ms slices (io/resilient.py ``_POLL_S``), so
#: a straggler must outlast one slice to be hedged
RESILIENCE_READ_FAULTS = ("eio:every=7, short:every=11:frac=0.5, "
                          "delay:every=13:delay_s=0.05")
#: the eviction writes' plan in (c)
RESILIENCE_WRITE_FAULTS = "weio:every=5:max_count=4, wshort:every=9:frac=0.5"
#: hedge a read in flight past this, below the injected 50 ms, in (b)
RESILIENCE_HEDGE_AFTER_S = "0.005"
#: timed offloaded steps of (c), after one warm step
RESILIENCE_STEPS = 8
RESILIENCE_COUNTERS = ("bytes_direct", "bytes_fallback", "bounce_bytes",
                       "bytes_written_direct", "faults_injected",
                       "resilient_retries", "hedges_issued", "hedges_won",
                       "hedges_denied", "stuck_cancelled", "write_retries",
                       "waste_hedge_loss_bytes", "waste_retry_reread_bytes",
                       "shards_quarantined", "checksum_failures",
                       "kv_restore_failures")


#: the supervisor's error budgets of the faulted runs: the read plan
#: fails about one read in four, far past the defaults (8 errors of a
#: ring, 16 of the device, in 5 s), which would brown the device out to
#: buffered reads; the phase measures recovery by retry and hedge, so its
#: budgets sit above what the plan injects (the brown-out is
#: health_phase's)
RESILIENCE_BREAKER = {"STROM_BREAKER_ERRORS": "1000000",
                      "STROM_BREAKER_DEVICE_ERRORS": "1000000"}


#: (label, environment) of each engine the resilience phase builds with
#: ``build_engine``: the bare engine, the resilient wrapper alone, and
#: the resilient wrapper over the seeded read plan
_RES_MODES = (
    ("clean", {}),
    ("resilient", {"STROM_RESILIENT": "1"}),
    ("faulted", {"STROM_RESILIENT": "1",
                 "STROM_FAULTS": RESILIENCE_READ_FAULTS,
                 "STROM_FAULTS_SEED": SEED, **RESILIENCE_BREAKER}))


def _res_engine(dev, env):
    """``build_engine()`` under ``env``, its staging pool page-locked."""
    from nvme_strom_tpu_torch.io.faults import build_engine
    with _env(**env):
        eng = build_engine()
    eng.cuda_mapping(dev.index)
    return eng


def _res_direct_ok(st):
    """Every recovered read stayed on the direct path: no byte read
    buffered, none bounced."""
    return st["bytes_fallback"] == 0 and st["bounce_bytes"] == 0


def _resilience_weights(dev, ckdir):
    """(a) the serving checkpoint loaded in the three modes of
    _RES_MODES, in turns, twice: tensors bitwise the first clean load's;
    the faulted loads injected and recovered faults with no bounce."""
    import torch
    from nvme_strom_tpu_torch.parallel.weights import LazyCheckpoint
    wpath = os.path.join(ckdir, "model.safetensors")
    times = {m: [] for m, _ in _RES_MODES}
    stats = {}
    ref = None
    for _ in range(2):
        for label, env in _RES_MODES:
            with _res_engine(dev, env) as eng:
                ctr = Counters(eng, RESILIENCE_COUNTERS)
                t0 = time.monotonic()
                params = LazyCheckpoint(wpath).load(eng, device=dev)
                torch.cuda.synchronize()
                times[label].append(time.monotonic() - t0)
                st = ctr.delta()
            stats.setdefault(label, []).append(st)
            if ref is None:
                ref = params
            elif any(not torch.equal(params[k], ref[k]) for k in ref):
                raise AssertionError(f"resilience (a) {label}: tensors "
                                     "differ from the clean load's")
            if not _res_direct_ok(st):
                raise AssertionError(f"resilience (a) {label}: {st}")
            del params
    for st in stats["faulted"]:
        if st["faults_injected"] < 1 or st["resilient_retries"] < 1:
            raise AssertionError(f"resilience (a): no fault recovered {st}")
    del ref
    return {"load_s": times, "faulted_stats": stats["faulted"]}


def _resilience_store(dev, cfg, params, shared):
    """(b) the prefix phase's chat requests over its store copy through
    both servers, then the 22-page restore batch three times, on the
    clean engine and under the read plan with hedging past
    RESILIENCE_HEDGE_AFTER_S: tokens equal the prefix phase's NVMe hit,
    pages bitwise, no bounce, hedges issued."""
    import torch
    from nvme_strom_tpu_torch.models.kv_offload import PrefixStore
    from nvme_strom_tpu_torch.models.serving import (DecodeServer,
                                                     PagedDecodeServer)
    pre = shared["prefix"]
    keys = list(pre["pages"])
    out = {}
    for label, env in (_RES_MODES[0], (_RES_MODES[2][0], {
            **_RES_MODES[2][1],
            "STROM_HEDGE_AFTER_S": RESILIENCE_HEDGE_AFTER_S})):
        with _res_engine(dev, env) as eng:
            ctr = Counters(eng, RESILIENCE_COUNTERS)
            store = PrefixStore(cfg, eng, pre["store"], PREFIX_PAGE_TOKENS,
                                PREFIX_STORE_BYTES)
            toks = {}
            for name, srv in (
                    ("dense", DecodeServer(params, cfg, PREFIX_REQUESTS,
                                           2048, device=dev,
                                           kv_store=store)),
                    ("paged", PagedDecodeServer(
                        params, cfg, PREFIX_REQUESTS, 2048,
                        total_blocks=128, block_len=PREFIX_PAGE_TOKENS,
                        device=dev, kv_store=store))):
                for rid, ids in pre["requests"]:
                    srv.submit(rid, ids, PREFIX_NEW_TOKENS)
                toks[name] = srv.run(lookahead=8)
                del srv
            ms = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = store.restore_many({0: (0, keys)}, device=dev)[0]
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            pages_equal = all(
                torch.equal(got[j][0], pre["pages"][kx][0])
                and torch.equal(got[j][1], pre["pages"][kx][1])
                for j, kx in enumerate(keys))
            del got
            store.close()
            st = ctr.delta()
        out[label] = {"restore_ms": ms, "stats": st,
                      "tokens_equal": {n: t == pre["hit_tokens"]
                                       for n, t in toks.items()},
                      "pages_equal": pages_equal}
        if not (all(out[label]["tokens_equal"].values()) and pages_equal):
            raise AssertionError(f"resilience (b) {label}: tokens or pages "
                                 f"differ: {out[label]}")
        if not _res_direct_ok(st) or st["kv_restore_failures"]:
            raise AssertionError(f"resilience (b) {label}: {st}")
    st = out["faulted"]["stats"]
    if st["faults_injected"] < 1 or st["resilient_retries"] < 1 or \
            st["hedges_issued"] < 1:
        raise AssertionError(f"resilience (b): no hedge or retry {st}")
    return out


def _resilience_offload(dev, cfg, params, shared):
    """(c) offload (a)'s setup (b 8 over 7 cold 8 MiB pages), one warm
    and RESILIENCE_STEPS timed steps, clean and under the read plan with
    RESILIENCE_WRITE_FAULTS on the eviction writes: tokens equal offload
    (a)'s, the faulted page file byte-identical to the clean one, writes
    retried, no bounce on the page reads."""
    import torch
    from nvme_strom_tpu_torch.models.kv_offload import (OffloadConfig,
                                                        PagedKVCache)
    off = shared["offload"]
    odir = os.path.join(DATA_DIR, "resilience")
    os.makedirs(odir, exist_ok=True)
    want = off["toks"][:1 + RESILIENCE_STEPS]
    out, files = {}, {}
    for label, env in (_RES_MODES[0], (_RES_MODES[2][0], {
            **_RES_MODES[2][1], "STROM_FAULTS": RESILIENCE_READ_FAULTS
            + ", " + RESILIENCE_WRITE_FAULTS})):
        path = os.path.join(odir, f"{label}.bin")
        if os.path.exists(path):
            os.remove(path)
        with _res_engine(dev, env) as eng:
            ctr = Counters(eng, RESILIENCE_COUNTERS)
            with PagedKVCache(cfg, OffloadConfig(
                    path=path, page_len=OFFLOAD_PAGE,
                    window_pages=OFFLOAD_WINDOW_PAGES), eng, OFFLOAD_BATCH,
                    device=dev) as cache:
                cache.append(off["k0"], off["v0"])
                cache.flush()
                written = ctr.delta()
                wrote = cache.n_cold * cache._page_stride
                toks = _greedy_steps(params, cfg, cache, off["tok0"], 1)
                torch.cuda.synchronize()
                ctr.reset()
                t0 = time.monotonic()
                toks += _greedy_steps(params, cfg, cache, toks[-1],
                                      RESILIENCE_STEPS)
                torch.cuda.synchronize()
                secs = time.monotonic() - t0
                reads = ctr.delta()
        with open(path, "rb") as f:
            files[label] = f.read()
        out[label] = {"ms_step": secs / RESILIENCE_STEPS * 1e3,
                      "bytes_written": wrote, "write_stats": written,
                      "read_stats": reads,
                      "tokens_equal": all(torch.equal(a, c)
                                          for a, c in zip(toks, want))}
        if not out[label]["tokens_equal"] or not _res_direct_ok(reads):
            raise AssertionError(f"resilience (c) {label}: {out[label]}")
    out["page_files_equal"] = files["clean"] == files["faulted"]
    w = out["faulted"]["write_stats"]
    if not out["page_files_equal"] or w["write_retries"] < 1 or \
            out["faulted"]["read_stats"]["faults_injected"] < 1:
        raise AssertionError(f"resilience (c): page files equal "
                             f"{out['page_files_equal']}, {out}")
    return out


def _resilience_governor(dev, cfg, params, shared, stream_path):
    """(e) one trial of qos_phase's governor mode on a resilient engine
    (no faults), its target set inside the trial (qos_run
    ``own_target``): the decode class's hedge budget must rise with the
    governor's boost and decay back to its base."""
    r = qos_run(dev, cfg, params, ("auto rings, governor, resilient", "0",
                                   "0", 0), shared, stream_path, 0,
                resilient=True, own_target=True)
    g = r["governor"]
    if not (r["tokens_equal"] and r["offload_tokens_equal"]
            and r["pages_equal"]):
        raise AssertionError(f"resilience (e): tokens or pages differ {r}")
    if not (g["hedge_budget_peak"] > g["hedge_budget_base"]
            == g["hedge_budget_after"]):
        raise AssertionError(f"resilience (e): the hedge budget did not "
                             f"rise and decay back: {g}")
    base = shared["qos"]["governor"]
    return {"governor": g, "restore_p99_ms": r["restore_p99_ms"],
            "step_p99_ms": r["step_p99_ms"],
            "without_resilience": {**{k: base[k] for k in (
                "restore_p99_ms", "step_p99_ms")},
                "target_ms": base["governor"]["target_ms"]}}


def resilience_phase(dev, cfg, ckdir, params, shared, stream_path):
    """Fault injection and recovery under the serving paths at flagship
    width, every engine from ``build_engine`` with STROM_RESILIENT=1 and
    the seeded STROM_FAULTS plan set for its run only: (a) the weights
    load, (b) the prefix store's restores on both servers, (c) offloaded
    decode with faulted eviction writes, (e) the SLO governor's hedge
    lever.  (d), the loader, runs after the training phase
    (resilience_loader_phase).  Every check raises."""
    t0 = time.monotonic()
    card = card_line()
    rep = {"weights": _resilience_weights(dev, ckdir)}
    w = rep["weights"]["load_s"]
    log(f"resilience (a) weights load ({card}), s in turns: clean "
        f"{[round(x, 4) for x in w['clean']]}, resilient "
        f"{[round(x, 4) for x in w['resilient']]}, faulted "
        f"{[round(x, 4) for x in w['faulted']]}; tensors bitwise; faulted "
        f"counters {rep['weights']['faulted_stats']}")
    rep["store"] = _resilience_store(dev, cfg, params, shared)
    log(f"resilience (b) prefix store, both servers: restore batch ms "
        f"clean {[round(x, 2) for x in rep['store']['clean']['restore_ms']]}"
        f", faulted "
        f"{[round(x, 2) for x in rep['store']['faulted']['restore_ms']]}; "
        f"tokens and pages equal; faulted counters "
        f"{rep['store']['faulted']['stats']}")
    rep["offload"] = _resilience_offload(dev, cfg, params, shared)
    o = rep["offload"]
    log(f"resilience (c) offloaded decode: ms a step clean "
        f"{o['clean']['ms_step']:.2f}, faulted {o['faulted']['ms_step']:.2f};"
        f" page files equal; eviction writes {o['faulted']['write_stats']}"
        f" of {o['faulted']['bytes_written']} B; page reads "
        f"{o['faulted']['read_stats']}")
    rep["governor"] = _resilience_governor(dev, cfg, params, shared,
                                           stream_path)
    g = rep["governor"]
    log(f"resilience (e) governor on a resilient engine: {g}")
    rep["seconds"] = time.monotonic() - t0
    rep["card"] = card
    return rep


def resilience_loader_phase(dev, cfg):
    """(d) the 4 stamped training shards of verify_phase's copy, one
    sample byte of shard 2 flipped on disk, under STROM_VERIFY=full on
    a resilient, faulted engine, ``shard_error_budget`` 1: the epoch
    completes on the other 3 shards through h2d_copy, shard 2
    quarantined."""
    import glob
    import numpy as np
    from nvme_strom_tpu_torch.data.loader import ShardedLoader
    from nvme_strom_tpu_torch.formats.wds import WdsShardIndex
    from nvme_strom_tpu_torch.ops.bridge import h2d_copy
    from nvme_strom_tpu_torch.utils.config import LoaderConfig
    shards = sorted(glob.glob(os.path.join(DATA_DIR, "verify", "shards",
                                           "*.tar")))
    if len(shards) != 4:
        raise AssertionError(f"resilience (d): shards {shards}")
    per = [len(WdsShardIndex(p).order) for p in shards]
    want = sum(per[:2] + per[3:]) // TRAIN_BATCH

    def decode(parts):
        (payload,) = parts.values()
        return np.frombuffer(payload, dtype=np.int32) % cfg.vocab
    env = {**_RES_MODES[2][1], "STROM_VERIFY": "full"}
    h0 = h2d_copy.launches
    t0 = time.monotonic()
    with _env(**env):
        eng = _res_engine(dev, {})
        ctr = Counters(eng, RESILIENCE_COUNTERS)
        with ShardedLoader(shards, TRAIN_BATCH, decode=decode, engine=eng,
                           config=LoaderConfig(shard_error_budget=1),
                           device=dev) as loader:
            batches = [b.clone() for b in loader]
            quarantined = list(loader.quarantined)
        st = ctr.delta()
        eng.close_all()
    rep = {"batches": len(batches), "want_batches": want,
           "quarantined": [os.path.basename(p) for p in quarantined],
           "seconds": time.monotonic() - t0,
           "h2d_launches": h2d_copy.launches - h0, "stats": st}
    if (quarantined != [shards[2]] or len(batches) != want
            or st["shards_quarantined"] != 1 or not rep["h2d_launches"]
            or st["checksum_failures"] < 2):
        raise AssertionError(f"resilience (d): {rep}")
    log(f"resilience (d) loader: {rep}")
    return rep


#: the health phase's breaker knobs, set for its engines only: a stall is
#: a ring whose oldest request waits past 0.2 s, a tripped ring restarts
#: at once, a degraded device is probed every 2 s (so a queued prefill
#: sheds for a while), and 4 errors in the window open the device breaker
HEALTH_BREAKER = {"STROM_BREAKER_STALL_S": "0.2",
                  "STROM_BREAKER_RESTART_S": "0",
                  "STROM_BREAKER_HALF_OPEN_S": "0.05",
                  "STROM_BREAKER_DEVICE_ERRORS": "4",
                  "STROM_DEGRADED_PROBE_S": "2"}
#: (a): ring 1 parks every dispatch after its first HEALTH_STALL_AFTER
HEALTH_STALL_AFTER = 4
#: (b): the first reads of the prefix store's page file fail, as many as
#: open the device breaker; a read retries up to 8 times, so the one
#: whose failure opens it browns out on its next attempt
HEALTH_ESTORM = "estorm:max_count=4:path=kvstore"
HEALTH_RETRIES = "8"
HEALTH_COUNTERS = ("bytes_direct", "bytes_fallback", "bounce_bytes",
                   "breaker_trips", "ring_restarts", "extents_requeued",
                   "degraded_reads", "degraded_bytes", "degraded_probes",
                   "faults_injected", "resilient_retries", "flight_dumps",
                   "serve_admissions_shed", "waste_degraded_bytes")


def _health_weights(dev, ckdir, fdir):
    """(a) the serving checkpoint loaded on a resilient default engine,
    clean, then with ring 1 wedged after HEALTH_STALL_AFTER dispatches:
    the stall trips ring 1's breaker, the ring restarts, its parked reads
    requeue; tensors bitwise the clean load's, no byte buffered or
    bounced."""
    import torch
    from nvme_strom_tpu_torch.parallel.weights import LazyCheckpoint
    wpath = os.path.join(ckdir, "model.safetensors")
    out, ref = {}, None
    for label, env in (("clean", {}), ("stalled", {
            "STROM_FAULT_RING_STALL_RING": "1",
            "STROM_FAULT_RING_STALL_AFTER": HEALTH_STALL_AFTER})):
        with _res_engine(dev, {"STROM_RESILIENT": "1",
                               "STROM_FLIGHT_DIR": fdir,
                               **HEALTH_BREAKER, **env}) as eng:
            if eng.n_rings < 2:
                raise AssertionError(f"health (a): {eng.n_rings} ring")
            ctr = Counters(eng, HEALTH_COUNTERS)
            t0 = time.monotonic()
            params = LazyCheckpoint(wpath).load(eng, device=dev)
            torch.cuda.synchronize()
            secs = time.monotonic() - t0
            st = ctr.delta()
            states = eng.supervisor.ring_states()
        if ref is None:
            ref = params
        elif any(not torch.equal(params[k], ref[k]) for k in ref):
            raise AssertionError("health (a): the stalled load's tensors "
                                 "differ from the clean load's")
        out[label] = {"load_s": secs, "stats": st, "ring_states": states}
        if st["bounce_bytes"] or st["bytes_fallback"]:
            raise AssertionError(f"health (a) {label}: {st}")
    st = out["stalled"]["stats"]
    if st["breaker_trips"] < 1 or st["ring_restarts"] < 1 or \
            st["extents_requeued"] < 1:
        raise AssertionError(f"health (a): the stall was not tripped, "
                             f"restarted and requeued: {st}")
    return out


def _health_store(dev, cfg, params, shared, fdir):
    """(b) the prefix store's requests on each server over a resilient
    engine under HEALTH_ESTORM: the first four requests' restore meets
    the storm and opens the device breaker; the last four, queued while
    degraded, are shed by the server's own probe of the supervisor until
    a probe recovers the device.  The degraded pages reach the card
    through the pinned buffer: bounce_bytes equals degraded_bytes, and
    grows no more after recovery; tokens equal the prefix phase's."""
    import torch
    from nvme_strom_tpu_torch.models.kv_offload import PrefixStore
    from nvme_strom_tpu_torch.models.serving import (DecodeServer,
                                                     PagedDecodeServer)
    from nvme_strom_tpu_torch.ops.bridge import h2d_copy
    pre = shared["prefix"]
    reqs = pre["requests"]
    out = {}
    for name in ("dense", "paged"):
        with _res_engine(dev, {"STROM_RESILIENT": "1",
                               "STROM_FAULTS": HEALTH_ESTORM,
                               "STROM_RETRY_MAX": HEALTH_RETRIES,
                               "STROM_FLIGHT_DIR": fdir,
                               **HEALTH_BREAKER}) as eng:
            ctr = Counters(eng, HEALTH_COUNTERS)
            at_recovery = {}

            def on_degraded(on, ctr=ctr, at=at_recovery):
                if not on:
                    at.update(ctr.delta(), t=time.monotonic())
            eng.supervisor.add_degraded_listener(on_degraded)
            store = PrefixStore(cfg, eng, pre["store"], PREFIX_PAGE_TOKENS,
                                PREFIX_STORE_BYTES)
            srv = (DecodeServer(params, cfg, PREFIX_REQUESTS, 2048,
                                device=dev, kv_store=store)
                   if name == "dense" else
                   PagedDecodeServer(params, cfg, PREFIX_REQUESTS, 2048,
                                     total_blocks=128,
                                     block_len=PREFIX_PAGE_TOKENS,
                                     device=dev, kv_store=store))
            h0 = h2d_copy.launches
            t0 = time.monotonic()
            half = len(reqs) // 2
            for rid, ids in reqs[:half]:
                srv.submit(rid, ids, PREFIX_NEW_TOKENS)
            toks = dict(srv.step_many(8))
            degraded_after_wave1 = eng.supervisor.degraded()
            for rid, ids in reqs[half:]:
                srv.submit(rid, ids, PREFIX_NEW_TOKENS)
            toks.update(srv.run(lookahead=8))
            torch.cuda.synchronize()
            secs = time.monotonic() - t0
            st = ctr.delta()
            store.close()
            del srv
        rep = {"seconds": secs, "stats": st,
               "degraded_after_wave1": degraded_after_wave1,
               "recovered": bool(at_recovery),
               "recovered_after_s": at_recovery.get("t", t0) - t0,
               "bounce_at_recovery": at_recovery.get("bounce_bytes"),
               "h2d_launches": h2d_copy.launches - h0,
               "tokens_equal": toks == pre["hit_tokens"]}
        out[name] = rep
        log(f"health (b) {name}: {rep}")
        if not (rep["tokens_equal"] and degraded_after_wave1
                and rep["recovered"]):
            raise AssertionError(f"health (b) {name}: {rep}")
        if not (st["breaker_trips"] >= 1 and st["degraded_reads"] >= 1
                and st["serve_admissions_shed"] >= 1
                and st["degraded_bytes"] > 0
                and st["bounce_bytes"] == st["degraded_bytes"]
                and st["bounce_bytes"] == rep["bounce_at_recovery"]):
            raise AssertionError(f"health (b) {name}: {st}, bounce at "
                                 f"recovery {rep['bounce_at_recovery']}")
    return out


def _health_dumps(fdir, n_dumped):
    """(c) the flight dumps (a) and (b) wrote: every file parses, each of
    breaker_trip, ring_restart and device_degraded has a dump whose op
    records carry their class and ring, and flight_dumps counted every
    file."""
    import glob
    paths = sorted(glob.glob(os.path.join(fdir, "strom_flight_*.json")))
    docs: dict = {}
    for p in paths:
        with open(p) as f:
            doc = json.load(f)
        docs.setdefault(doc["reason"], []).append(doc)
    rep = {"files": len(paths), "flight_dumps": n_dumped, "reasons": {}}
    for reason in ("breaker_trip", "ring_restart", "device_degraded"):
        usable = [d for d in docs.get(reason, []) if d["ops"] and all(
            "klass" in o and "ring" in o for o in d["ops"])]
        if not usable:
            raise AssertionError(f"health (c): no {reason} dump with op "
                                 f"records in {paths}")
        doc = max(usable, key=lambda d: d["n_ops"])
        rep["reasons"][reason] = {
            "dumps": len(docs[reason]), "n_ops": doc["n_ops"],
            "extra": doc.get("extra"),
            "classes": sorted({str(o["klass"]) for o in doc["ops"]}),
            "rings": sorted({o["ring"] for o in doc["ops"]})}
    if n_dumped < len(paths):
        raise AssertionError(f"health (c): {len(paths)} dumps, "
                             f"flight_dumps {n_dumped}")
    return rep


#: (d): the degraded path's rate over this span of the stream file (its
#: second GiB, which the cold start's warm payload does not read; the
#: buffered reads fill the page cache)
HEALTH_RATE_SPAN = (1 << 30, 1 << 30)


def _health_degraded_rate(dev, stream_path, fdir):
    """(d) HEALTH_RATE_SPAN of the stream file to the card through
    ``DeviceStream.stream_ranges`` on a healthy engine, then on one whose
    device breaker is open (probes held off): every range a buffered
    pread, bounced through the pinned buffer, copied by h2d_copy.  The
    bytes on the card equal the direct run's; bounce_bytes equals
    degraded_bytes."""
    import torch
    from nvme_strom_tpu_torch.ops.bridge import DeviceStream, h2d_copy
    off0, n = HEALTH_RATE_SPAN
    out, ref = {}, None
    for label in ("direct", "degraded"):
        with _res_engine(dev, {"STROM_DEGRADED_PROBE_S": "3600",
                               "STROM_FLIGHT_DIR": fdir}) as eng:
            chunk = eng.config.chunk_bytes
            ranges = [(off0 + o, chunk) for o in range(0, n, chunk)]
            if label == "degraded":
                sup = eng.supervisor   # every ring trips, then the device
                for _ in range(sup.cfg.device_errors):
                    sup.note_error(ring=0, err=5)
                if not sup.degraded():
                    raise AssertionError("health (d): not degraded")
            ctr = Counters(eng, HEALTH_COUNTERS)
            fh = eng.open(stream_path)
            h0 = h2d_copy.launches
            torch.cuda.synchronize()
            t0 = time.monotonic()
            got = [t.clone() for t in DeviceStream(eng, device=dev)
                   .stream_ranges(fh, ranges)]
            torch.cuda.synchronize()
            secs = time.monotonic() - t0
            eng.close(fh)
            st = ctr.delta()
        out[label] = {"seconds": secs, "gib_per_s": n / secs / 2**30,
                      "h2d_launches": h2d_copy.launches - h0, "stats": st}
        if ref is None:
            ref = got
        elif any(not torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError("health (d): degraded bytes differ")
        del got
    st = out["degraded"]["stats"]
    if not (st["degraded_bytes"] == n == st["bounce_bytes"]
            and st["degraded_reads"] == len(ranges)
            and out["degraded"]["h2d_launches"] == len(ranges)):
        raise AssertionError(f"health (d): {out}")
    return out


def health_phase(dev, cfg, ckdir, params, shared, stream_path):
    """Failure domains on the card: (a) a wedged ring under the weights
    load, (b) an EIO storm under both servers' prefix-store restores,
    (c) the flight dumps they left under a temporary directory
    (``TMPDIR``, /tmp by default), (d) the degraded path's rate to the
    card.  Every check raises."""
    import shutil
    import tempfile
    t0 = time.monotonic()
    fdir = tempfile.mkdtemp(prefix="strom_flight_")
    try:
        rep = {"card": card_line(),
               "weights": _health_weights(dev, ckdir, fdir)}
        w = rep["weights"]
        log(f"health (a) weights load ({rep['card']}): clean "
            f"{w['clean']['load_s']:.4f} s, ring 1 stalled "
            f"{w['stalled']['load_s']:.4f} s; tensors bitwise; stalled "
            f"{w['stalled']['stats']}, rings {w['stalled']['ring_states']}")
        rep["store"] = _health_store(dev, cfg, params, shared, fdir)
        dumped = (sum(w[k]["stats"]["flight_dumps"] for k in w)
                  + sum(r["stats"]["flight_dumps"]
                        for r in rep["store"].values()))
        rep["dumps"] = _health_dumps(fdir, dumped)
        log(f"health (c) flight dumps: {rep['dumps']}")
        rep["degraded_rate"] = _health_degraded_rate(dev, stream_path,
                                                     fdir)
        d = rep["degraded_rate"]
        log(f"health (d) {HEALTH_RATE_SPAN[1]} B to the card: direct "
            f"{d['direct']['gib_per_s']:.3f} GiB/s, degraded "
            f"{d['degraded']['gib_per_s']:.3f} GiB/s; degraded stats "
            f"{d['degraded']['stats']}")
    finally:
        shutil.rmtree(fdir, ignore_errors=True)
    rep["seconds"] = time.monotonic() - t0
    return rep


#: the cold start's warm payload: the stream file's first COLDSTART_WARM
#: bytes and the prefix store's pages (``warm_pages``)
COLDSTART_WARM = 256 << 20
#: the read pad of the cold-start arms (ms, the C engine's
#: STROM_FAULT_READ_DELAY_MS, as the reference's bench_coldstart sets it)
COLDSTART_PAD_MS = "2"
#: the arms' order: two trials each, in turns
COLDSTART_ORDER = ("off", "on", "on", "off")
#: the chaos drill: ring 1 parks every dispatch after its first N
COLDSTART_STALL_AFTER = 6
#: the chaos drill's bulk lane: a restore-class read is neither retried
#: nor hedged, so the read the ring's restart cancels fails its claim
#: and the demand lane re-claims the tensor at decode class
COLDSTART_DRILL_RESTORE = {"max_retries": 0, "hedging": False}
COLDSTART_COUNTERS = ("bytes_direct", "bytes_fallback", "bounce_bytes",
                      "coldstart_faults", "coldstart_fault_bytes",
                      "coldstart_bulk_tensors", "coldstart_warm_spans",
                      "coldstart_warm_pages", "coldstart_brownouts",
                      "breaker_trips", "ring_restarts", "extents_requeued",
                      "degraded_reads", "hedges_issued",
                      "resilient_retries")


def _coldstart_warm(eng, stream_path, store, klass):
    """The warm payload: the stream file's first COLDSTART_WARM bytes in
    batches of 8 chunks at ``klass``, then the store's warm_pages; the
    bytes read."""
    from nvme_strom_tpu_torch.io.plan import plan_and_submit
    chunk = eng.config.chunk_bytes
    fh = eng.open(stream_path)
    try:
        off = 0
        while off < COLDSTART_WARM:
            exts = []
            while off < COLDSTART_WARM and len(exts) < 8:
                exts.append((fh, off, min(chunk, COLDSTART_WARM - off)))
                off += exts[-1][2]
            for pieces in plan_and_submit(eng, exts, klass=klass):
                for p in pieces:
                    p.wait()
                    p.release()
    finally:
        eng.close(fh)
    return COLDSTART_WARM + store.warm_pages() * store.page_bytes


def _coldstart_arm(dev, cfg, wpath, stream_path, pre, arm, env,
                   restore_policy=None):
    """One boot of the serving replica, timed from before its engine is
    made to its first token (``ttft_boot_s``) and to the steady phase,
    its warm state resident (``steady_s``; the off arm's is its TTFT),
    then the request run to its end.  ``off``:
    the eager load, the warm payload at restore class, the server.
    ``on``: the coordinator, a FaultingCheckpoint and the server on it at
    once, the warm payload a warm-up thunk at prefetch class.
    ``restore_policy``: ResilientConfig fields of the restore class."""
    import dataclasses

    import torch
    from nvme_strom_tpu_torch.io.coldstart import ColdStartCoordinator
    from nvme_strom_tpu_torch.models.kv_offload import PrefixStore
    from nvme_strom_tpu_torch.models.serving import DecodeServer
    from nvme_strom_tpu_torch.ops.bridge import h2d_copy
    from nvme_strom_tpu_torch.parallel.weights import (FaultingCheckpoint,
                                                       LazyCheckpoint)
    rid, ids = pre["requests"][0]
    h0 = h2d_copy.launches
    t0 = time.monotonic()
    eng = _res_engine(dev, {"STROM_RESILIENT": "1",
                            "STROM_FAULT_READ_DELAY_MS": COLDSTART_PAD_MS,
                            **env})
    if restore_policy:
        eng.class_configs["restore"] = dataclasses.replace(
            eng.config_for("restore"), **restore_policy)
    marks = {"engine_s": time.monotonic() - t0}
    ctr = Counters(eng, COLDSTART_COUNTERS)
    store = PrefixStore(cfg, eng, pre["store"], PREFIX_PAGE_TOKENS,
                        PREFIX_STORE_BYTES)
    warm = {}
    fck = coord = None
    try:
        if arm == "off":
            params = LazyCheckpoint(wpath).load(eng, device=dev)
            marks["weights_s"] = time.monotonic() - t0
            weights_read = ctr.delta()["bytes_read"]
            warm["bytes"] = _coldstart_warm(eng, stream_path, store,
                                            "restore")
            marks["warm_s"] = time.monotonic() - t0
            srv = DecodeServer(params, cfg, PREFIX_REQUESTS, 2048,
                               device=dev)
        else:
            coord = ColdStartCoordinator(eng)
            coord.add_warmup(lambda: warm.update(bytes=_coldstart_warm(
                eng, stream_path, store, "prefetch")))
            fck = FaultingCheckpoint(wpath, device=dev, engine=eng,
                                     coordinator=coord)
            srv = DecodeServer(fck, cfg, PREFIX_REQUESTS, 2048, device=dev)
        t_submit = time.monotonic()
        srv.submit(rid, ids, PREFIX_NEW_TOKENS)
        toks = srv.run(lookahead=8)[rid]
        torch.cuda.synchronize()
        ttft = t_submit - t0 + srv.request_metrics[rid]["ttft_ms"] / 1e3
        if coord is not None:
            if not coord.wait_steady(600):
                raise AssertionError("coldstart: never steady")
            fck.join_bulk(600)
            # the coordinator's clock starts after the engine is made
            ph = coord.phase_times()
            marks["weights_s"] = marks["engine_s"] + ph["warming"]
            marks["warm_s"] = marks["engine_s"] + ph["steady"]
        # time to steady: the on arm's boot to its steady phase; the off
        # arm is steady before it serves (the reference's definition)
        steady = marks["warm_s"] if coord is not None else ttft
        st = ctr.delta()
        phase = coord.phase if coord is not None else None
        bulk_errors = dict(fck.bulk_errors) if fck is not None else {}
        faulted = fck.fault_names() if fck is not None else []
        if arm == "on":
            weights_read = st["bytes_read"] - warm["bytes"]
    finally:
        if fck is not None:
            fck.close()
        store.close()
        eng.close_all()
    return {"ttft_boot_s": ttft, "steady_s": steady, "tokens": toks,
            "marks_s": marks, "boot_phase": phase,
            "weights_bytes_read": weights_read,
            "warm_bytes": warm.get("bytes"), "bulk_errors": bulk_errors,
            "reclaimed": sorted(n for n in bulk_errors if n in faulted),
            "h2d_launches": h2d_copy.launches - h0, "stats": st}


def coldstart_phase(dev, cfg, ckdir, shared, stream_path):
    """Serve-while-restoring at flagship width with the serving
    checkpoint, after the reference's bench_coldstart: the off and on
    arms, two trials each in turns (COLDSTART_ORDER), every read
    padded COLDSTART_PAD_MS; greedy tokens identical across every trial,
    and every tensor read from NVMe once (the weights' bytes read equal
    the file's tensor bytes); every on trial demand-faults at least one
    tensor and bulk-loads at least one.  Then the chaos drill: the on
    arm with ring 1 wedged after COLDSTART_STALL_AFTER dispatches and
    the bulk lane's reads best-effort (COLDSTART_DRILL_RESTORE): the
    ring tripped and restarted, at least one bulk claim failed, every
    failed claim re-claimed at decode class, no consumer error, the
    same tokens.  Every check raises."""
    from nvme_strom_tpu_torch.formats.safetensors import SafetensorsFile
    t0 = time.monotonic()
    pre = shared["prefix"]
    wpath = os.path.join(ckdir, "model.safetensors")
    tensor_bytes = sum(info["nbytes"] for info in
                       SafetensorsFile(wpath).tensors.values())
    runs = {"off": [], "on": []}
    for arm in COLDSTART_ORDER:
        r = _coldstart_arm(dev, cfg, wpath, stream_path, pre, arm, {})
        runs[arm].append(r)
        log(f"coldstart {arm} (trial {len(runs[arm])}): ttft_boot_s "
            f"{r['ttft_boot_s']:.4f}, steady_s {r['steady_s']:.4f}, "
            f"phase {r['boot_phase']}, from boot (s) {r['marks_s']}, "
            f"weights read "
            f"{r['weights_bytes_read']} of {tensor_bytes} B, warm "
            f"{r['warm_bytes']} B, h2d_copy launches {r['h2d_launches']}; "
            f"{r['stats']}")
    want = runs["off"][0]["tokens"]
    for arm, rs in runs.items():
        for r in rs:
            if r["tokens"] != want:
                raise AssertionError(f"coldstart {arm}: tokens differ "
                                     f"from the eager arm's")
            if r["weights_bytes_read"] != tensor_bytes:
                raise AssertionError(
                    f"coldstart {arm}: read {r['weights_bytes_read']} B of "
                    f"weights for {tensor_bytes} B of tensors")
            if r["stats"]["bounce_bytes"] or r["stats"]["bytes_fallback"]:
                raise AssertionError(f"coldstart {arm}: {r['stats']}")
        if arm == "on" and any(
                r["boot_phase"] != "steady" or r["bulk_errors"]
                or r["stats"]["coldstart_faults"] < 1
                or r["stats"]["coldstart_bulk_tensors"] < 1 for r in rs):
            raise AssertionError(f"coldstart on: {rs}")
    chaos = _coldstart_arm(dev, cfg, wpath, stream_path, pre, "on", {
        **HEALTH_BREAKER, "STROM_FAULT_RING_STALL_RING": "1",
        "STROM_FAULT_RING_STALL_AFTER": COLDSTART_STALL_AFTER},
        restore_policy=COLDSTART_DRILL_RESTORE)
    log(f"coldstart chaos drill (ring 1 stalled after "
        f"{COLDSTART_STALL_AFTER} dispatches, restore class "
        f"{COLDSTART_DRILL_RESTORE}): ttft_boot_s "
        f"{chaos['ttft_boot_s']:.4f}, steady_s {chaos['steady_s']:.4f}, "
        f"failed bulk claims {sorted(chaos['bulk_errors'])}, re-claimed "
        f"at decode {chaos['reclaimed']}, {chaos['stats']}")
    st = chaos["stats"]
    if chaos["tokens"] != want or chaos["boot_phase"] != "steady" or \
            st["breaker_trips"] < 1 or st["ring_restarts"] < 1 or \
            not chaos["bulk_errors"] or \
            chaos["reclaimed"] != sorted(chaos["bulk_errors"]) or \
            chaos["weights_bytes_read"] < tensor_bytes:
        raise AssertionError(f"coldstart chaos drill: {chaos}")

    def med(arm, key):
        xs = sorted(r[key] for r in runs[arm])
        return xs[len(xs) // 2]
    return {"card": card_line(), "tensor_bytes": tensor_bytes,
            "trials": {a: [{k: v for k, v in r.items() if k != "tokens"}
                           for r in rs] for a, rs in runs.items()},
            "ttft_boot_s": {a: med(a, "ttft_boot_s") for a in runs},
            "steady_s": {a: med(a, "steady_s") for a in runs},
            "chaos": {k: v for k, v in chaos.items() if k != "tokens"},
            "tokens_identical": True, "seconds": time.monotonic() - t0}


#: the supervisor-cost runs' order: three of each setting, in turns
SUPERVISOR_COST_ORDER = ("none", "default", "default", "none", "none",
                         "default")


def supervisor_cost_phase(dev, cfg, params, shared, stream_path, want):
    """The default supervisor and flight recorder against none
    (``STROM_BREAKER=0 STROM_FLIGHT=0``), in turns
    (SUPERVISOR_COST_ORDER): a first pass of the 2 GiB stream on a fresh engine,
    then the prefix store's requests through the dense and the paged
    server over it (the supervision tick in every admission poll, a
    flight record a read).  Tokens equal the prefix phase's hit."""
    from nvme_strom_tpu_torch.models.kv_offload import PrefixStore
    from nvme_strom_tpu_torch.models.serving import (DecodeServer,
                                                     PagedDecodeServer)
    from nvme_strom_tpu_torch.ops.bridge import DeviceStream
    pre = shared["prefix"]
    modes = {"none": {"STROM_BREAKER": "0", "STROM_FLIGHT": "0"},
             "default": {}}
    out = {m: {"stream_gib_per_s": [], "dense_tok_per_s": [],
               "paged_tok_per_s": []} for m in modes}
    for mode in SUPERVISOR_COST_ORDER:
        with _res_engine(dev, modes[mode]) as eng:
            if (eng.supervisor is None) != (mode == "none") or \
                    (eng.flight is None) != (mode == "none"):
                raise AssertionError(f"supervisor cost: {mode} engine")
            dt, _ = stream_once(DeviceStream(eng, device=dev), stream_path,
                                dev, want)
            out[mode]["stream_gib_per_s"].append(STREAM_BYTES / dt / 2**30)
            store = PrefixStore(cfg, eng, pre["store"], PREFIX_PAGE_TOKENS,
                                PREFIX_STORE_BYTES)
            for name, srv in (
                    ("dense", DecodeServer(params, cfg, PREFIX_REQUESTS,
                                           2048, device=dev,
                                           kv_store=store)),
                    ("paged", PagedDecodeServer(
                        params, cfg, PREFIX_REQUESTS, 2048,
                        total_blocks=128, block_len=PREFIX_PAGE_TOKENS,
                        device=dev, kv_store=store))):
                toks, rep = store_run(f"supervisor {mode} {name}", srv,
                                      pre["requests"], eng, store)
                if toks != pre["hit_tokens"]:
                    raise AssertionError(f"supervisor cost {mode} {name}: "
                                         "tokens differ")
                out[mode][f"{name}_tok_per_s"].append(rep["tok_per_s"])
                del srv
            store.close()
    out["card"] = card_line()
    log(f"supervisor cost ({out['card']}), in turns "
        f"{SUPERVISOR_COST_ORDER}: {out}")
    return out


# -- drain and warm handoff -----------------------------------------------------

#: the handoff requests: the serve phase's prompt lengths, the long ones
#: first, so the sessions in flight at the drain hold store pages
HANDOFF_LENGTHS = (1500, 1000, 400, 16, 1250, 700, 250, 100)
HANDOFF_NEW = 32
#: slots a replica serves: 4 decode, 4 wait in the queue
HANDOFF_SLOTS = 4
#: the retiring replica's steps before the drain, and the drain's
#: deadline: short enough that slots are still decoding and requests
#: still queued when it passes
HANDOFF_STEPS = 8
HANDOFF_DEADLINE_S = 0.01
#: each replacement boots after a retirement of its own, from the bundle
#: or with it deleted (a brown-out), in turns
HANDOFF_ORDER = ("bundle", "brownout", "brownout", "bundle")
HANDOFF_COUNTERS = ("bytes_direct", "bytes_fallback", "bounce_bytes",
                    "kv_pages_restored", "kv_prefix_hits",
                    "kv_pages_written", "coldstart_faults",
                    "coldstart_bulk_tensors", "handoff_drains",
                    "handoff_deferred", "handoff_sessions_exported",
                    "handoff_sessions_restored", "handoff_bundles",
                    "handoff_bundle_bytes", "handoff_brownouts",
                    "handoff_stall_dumps")


def _handoff_server(kind, params, cfg, dev, store=None):
    from nvme_strom_tpu_torch.models.serving import (DecodeServer,
                                                     PagedDecodeServer)
    if kind == "paged":
        return PagedDecodeServer(params, cfg, HANDOFF_SLOTS, 2048,
                                 total_blocks=128,
                                 block_len=PREFIX_PAGE_TOKENS, device=dev,
                                 kv_store=store)
    return DecodeServer(params, cfg, HANDOFF_SLOTS, 2048, device=dev,
                        kv_store=store)


def _handoff_retire(kind, p32, cfg32, dev, store_path, requests):
    """The retiring replica: the requests on a fresh store, HANDOFF_STEPS
    steps, then ``DrainCoordinator.drain`` under HANDOFF_DEADLINE_S.
    Returns (tokens it delivered, its report)."""
    import torch
    from nvme_strom_tpu_torch.io.handoff import (DrainCoordinator,
                                                 load_handoff_bundle)
    from nvme_strom_tpu_torch.models.kv_offload import PrefixStore
    for p in (store_path, store_path + ".kvman.json",
              store_path + ".handoff.json"):
        if os.path.exists(p):
            os.remove(p)
    eng = _res_engine(dev, {})
    ctr = Counters(eng, HANDOFF_COUNTERS)
    store = PrefixStore(cfg32, eng, store_path, PREFIX_PAGE_TOKENS,
                        PREFIX_STORE_BYTES)
    try:
        srv = _handoff_server(kind, p32, cfg32, dev, store)
        for rid, ids in requests:
            srv.submit(rid, ids, HANDOFF_NEW)
        done = {}
        for _ in range(HANDOFF_STEPS):
            done.update(srv.step_many(1))
        coord = DrainCoordinator(eng, server=srv)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        res = coord.drain(lookahead=4, deadline_s=HANDOFF_DEADLINE_S)
        drain_s = time.monotonic() - t0
        done.update(res["results"])
        doc = load_handoff_bundle(store_path)
        st = ctr.delta()
        idle = srv.idle
        store.close()
    finally:
        eng.close_all()
    if doc is None or not idle or coord.phase != "retired":
        raise AssertionError(f"handoff {kind}: no bundle or not idle "
                             f"({coord.phase}, {res})")
    sessions = doc["sessions"]
    decoding = [s for s in sessions if s["emitted"]]
    queued = [s for s in sessions if not s["emitted"]]
    if len(decoding) < 2 or len(queued) < 1:
        raise AssertionError(f"handoff {kind}: the deadline left "
                             f"{len(decoding)} decoding, {len(queued)} "
                             f"queued")
    return done, {"drain_s": drain_s,
                  "bundle_bytes": os.path.getsize(res["bundle"]),
                  "exported_decoding": len(decoding),
                  "exported_queued": len(queued),
                  "finished_before_export": len(done),
                  "kv_keys": sum(len(s["kv_keys"]) for s in sessions),
                  "hot_tensors": len(doc["hot_tensors"]), "stats": st}


def _handoff_boot(kind, cfg32, dev, wpath, store_path, requests, done):
    """The replacement: engine, coordinator, FaultingCheckpoint, store
    and server, then ``consume_handoff``; with no usable bundle the
    client re-sends what it has not received.  Returns (every request's
    tokens, the report)."""
    import torch
    from nvme_strom_tpu_torch.io.coldstart import ColdStartCoordinator
    from nvme_strom_tpu_torch.models.kv_offload import PrefixStore
    from nvme_strom_tpu_torch.ops.bridge import h2d_copy
    from nvme_strom_tpu_torch.parallel.weights import FaultingCheckpoint
    h0 = h2d_copy.launches
    t_boot = time.monotonic()
    eng = _res_engine(dev, {})
    ctr = Counters(eng, HANDOFF_COUNTERS)
    coord = ColdStartCoordinator(eng)
    fck = FaultingCheckpoint(wpath, device=dev, engine=eng,
                             coordinator=coord)
    store = PrefixStore(cfg32, eng, store_path, PREFIX_PAGE_TOKENS,
                        PREFIX_STORE_BYTES)
    consumed = None
    try:
        srv = _handoff_server(kind, fck, cfg32, dev, store)
        # TTFT from boot: to here, then each request's own from submit
        t_submit = time.monotonic()
        consumed = coord.consume_handoff(store_path, server=srv,
                                         checkpoint=fck)
        if consumed is None:
            # the brown-out: the client re-sends from scratch
            for rid, ids in requests:
                if rid not in done:
                    srv.submit(rid, ids, HANDOFF_NEW)
        cont = srv.run(lookahead=8)
        torch.cuda.synchronize()
        complete_s = time.monotonic() - t_boot
        final = dict(done)
        for rid, toks in cont.items():
            emitted = consumed["sessions"][rid] if consumed else []
            final[rid] = list(emitted) + list(toks)
        ttft = [t_submit - t_boot + srv.request_metrics[r]["ttft_ms"] / 1e3
                for r in cont]
        if consumed and consumed.get("prefault_thread"):
            consumed["prefault_thread"].join(600)
        fck.join_bulk(600)
        st = ctr.delta()
        store.close()
    finally:
        fck.close()
        eng.close_all()
    return final, {"readmitted": len(cont), "complete_s": complete_s,
                   "ttft_boot_s_avg": sum(ttft) / len(ttft),
                   "ttft_boot_s_max": max(ttft),
                   "h2d_launches": h2d_copy.launches - h0, "stats": st}


def _handoff_sigterm(dev, cfg32, p32, sdir, requests):
    """``install_drain_signals`` then SIGTERM to this process: the
    handler drains, publishes a bundle with the exported sessions and
    retires; the uninstall puts the previous handler back."""
    import signal
    from nvme_strom_tpu_torch.io.handoff import (DrainCoordinator,
                                                 install_drain_signals,
                                                 load_handoff_bundle,
                                                 uninstall_drain_signals)
    from nvme_strom_tpu_torch.models.kv_offload import PrefixStore
    path = os.path.join(sdir, "sigterm.kvstore")
    for p in (path, path + ".kvman.json", path + ".handoff.json"):
        if os.path.exists(p):
            os.remove(p)
    eng = _res_engine(dev, {})
    store = PrefixStore(cfg32, eng, path, PREFIX_PAGE_TOKENS,
                        PREFIX_STORE_BYTES)
    before = signal.getsignal(signal.SIGTERM)
    try:
        srv = _handoff_server("dense", p32, cfg32, dev, store)
        for rid, ids in requests[:2]:
            srv.submit(rid, ids, HANDOFF_NEW)
        srv.step_many(1)
        with _env(STROM_DRAIN_ON_SIGTERM=1, STROM_DRAIN_DEADLINE_S=0):
            coord = DrainCoordinator(eng, server=srv)
        prev = install_drain_signals(coord, chain=False)
        if prev is None:
            raise AssertionError("handoff: drain signals not installed")
        try:
            os.kill(os.getpid(), signal.SIGTERM)
            for _ in range(500):      # the handler runs at a bytecode
                if coord.phase == "retired":     # boundary of this thread
                    break
                time.sleep(0.01)
        finally:
            uninstall_drain_signals(prev)
        doc = load_handoff_bundle(path)
        store.close()
    finally:
        eng.close_all()
    restored = signal.getsignal(signal.SIGTERM) is before
    if coord.phase != "retired" or doc is None or \
            len(doc["sessions"]) != 2 or not restored:
        raise AssertionError(f"handoff SIGTERM: phase {coord.phase}, "
                             f"bundle {doc is not None}, handler restored "
                             f"{restored}")
    return {"phase": coord.phase, "sessions": len(doc["sessions"]),
            "handler_restored": restored}


def _handoff_bf16(dev, cfg, params, sdir, requests):
    """One bundle trial on the dense server in bf16, the serving dtype:
    none dropped, and a count, not a failure, of the requests whose
    tokens differ from the undisturbed bf16 run's (a re-admitted
    session's delivered tokens are prefilled in one block step, where
    the undisturbed run decoded them one at a time)."""
    from nvme_strom_tpu_torch.parallel.weights import save_checkpoint
    wpath = os.path.join(sdir, "model_bf16.safetensors")
    save_checkpoint(wpath, params)
    srv = _handoff_server("dense", params, cfg, dev)
    for rid, ids in requests:
        srv.submit(rid, ids, HANDOFF_NEW)
    want = srv.run(lookahead=8)
    del srv
    store_path = os.path.join(sdir, "bf16.kvstore")
    done, retire = _handoff_retire("dense", params, cfg, dev, store_path,
                                   requests)
    got, boot = _handoff_boot("dense", cfg, dev, wpath, store_path,
                              requests, done)
    if set(got) != set(want) or any(len(got[r]) != HANDOFF_NEW
                                    for r in want):
        raise AssertionError(f"handoff bf16: requests dropped or cut: "
                             f"{ {r: len(v) for r, v in got.items()} }")
    exported = sorted(set(want) - set(done))
    differ = sorted(r for r in want if got[r] != want[r])
    first = {r: next(i for i, (a, b) in enumerate(zip(got[r], want[r]))
                     if a != b) for r in differ}
    rep = {"requests": len(want), "exported": exported,
           "readmitted": boot["readmitted"], "differ": differ,
           "first_differing_token": first,
           "handoff_sessions_restored":
               boot["stats"]["handoff_sessions_restored"]}
    log(f"handoff dense bf16: {len(differ)} of {len(exported)} exported "
        f"requests ({len(want)} in all) differ from the undisturbed bf16 "
        f"run: {rep}")
    return rep


def handoff_phase(dev, cfg, params):
    """Drain and warm handoff at flagship width, in float32 (the
    re-admitted suffix prefills in a block step where the undisturbed
    run decoded it token by token: bitwise only in float32, as
    prefix_store_f32_phase found), ``STROM_HANDOFF=1`` and
    ``STROM_COLDSTART=1``, the prefix store under DATA_DIR, for each
    server: an undisturbed run of the 8 requests (HANDOFF_LENGTHS,
    HANDOFF_NEW new tokens, greedy); a retiring replica on the same
    submissions that drains after HANDOFF_STEPS steps under
    HANDOFF_DEADLINE_S, exports its live sessions and publishes the
    bundle; a replacement booted on a FaultingCheckpoint of the float32
    weights that consumes the bundle, or, the bundle deleted, browns out
    (exactly one ``handoff_brownouts``) and serves the client's re-sent
    requests (two trials each, HANDOFF_ORDER).  Every request's delivered
    tokens must equal the undisturbed run's both ways, none dropped;
    sessions exported == restored >= 3; the exported sessions' pages
    restored from the store through h2d_copy with ``bounce_bytes`` 0.
    Then one bundle trial in bf16 that counts the requests whose tokens
    differ (``_handoff_bf16``), and the SIGTERM hook."""
    import dataclasses
    import shutil
    import numpy as np
    import torch
    from nvme_strom_tpu_torch.parallel.weights import save_checkpoint
    t0 = time.monotonic()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = {k: v.float() for k, v in params.items()}
    sdir = os.path.join(DATA_DIR, "handoff")
    shutil.rmtree(sdir, ignore_errors=True)
    os.makedirs(sdir)
    wpath = os.path.join(sdir, "model_f32.safetensors")
    save_checkpoint(wpath, p32)
    rng = np.random.default_rng(SEED + 21)
    requests = [(f"h{i}", rng.integers(0, cfg.vocab, n).tolist())
                for i, n in enumerate(HANDOFF_LENGTHS)]
    report = {"card": card_line()}
    with _env(STROM_HANDOFF=1, STROM_COLDSTART=1):
        for kind in ("dense", "paged"):
            srv = _handoff_server(kind, p32, cfg32, dev)
            for rid, ids in requests:
                srv.submit(rid, ids, HANDOFF_NEW)
            want = srv.run(lookahead=8)
            del srv
            store_path = os.path.join(sdir, f"{kind}.kvstore")
            trials = {"bundle": [], "brownout": []}
            for mode in HANDOFF_ORDER:
                done, retire = _handoff_retire(kind, p32, cfg32, dev,
                                               store_path, requests)
                if mode == "brownout":
                    os.remove(store_path + ".handoff.json")
                got, boot = _handoff_boot(kind, cfg32, dev, wpath,
                                          store_path, requests, done)
                st = boot["stats"]
                log(f"handoff {kind} {mode} (trial "
                    f"{len(trials[mode]) + 1}): drain "
                    f"{retire['drain_s']:.4f} s, bundle "
                    f"{retire['bundle_bytes']} B, exported "
                    f"{retire['exported_decoding']} decoding + "
                    f"{retire['exported_queued']} queued "
                    f"({retire['finished_before_export']} finished first, "
                    f"{retire['kv_keys']} page keys); replacement TTFT "
                    f"from boot avg {boot['ttft_boot_s_avg']:.4f} s max "
                    f"{boot['ttft_boot_s_max']:.4f} s, every request done "
                    f"{boot['complete_s']:.4f} s from boot, h2d_copy "
                    f"launches {boot['h2d_launches']}; retire "
                    f"{retire['stats']}; boot {st}")
                if set(got) != set(want) or any(got[r] != want[r]
                                                for r in want):
                    diff = sorted(r for r in want if got.get(r) != want[r])
                    raise AssertionError(f"handoff {kind} {mode}: tokens "
                                         f"differ or dropped for {diff}")
                exported = retire["stats"]["handoff_sessions_exported"]
                if st["bounce_bytes"] or st["bytes_fallback"] or \
                        boot["h2d_launches"] < 1:
                    raise AssertionError(f"handoff {kind} {mode}: {boot}")
                if mode == "bundle" and (
                        exported < 3 or st["handoff_brownouts"] != 0
                        or st["handoff_sessions_restored"] != exported
                        or st["kv_pages_restored"] < 1):
                    raise AssertionError(f"handoff {kind}: {retire}, {boot}")
                if mode == "brownout" and (
                        st["handoff_brownouts"] != 1
                        or st["handoff_sessions_restored"] != 0):
                    raise AssertionError(f"handoff {kind} brown-out: {boot}")
                trials[mode].append({"retire": retire, "boot": boot})
            report[kind] = {"trials": trials, "tokens_identical": True}
            for key in ("ttft_boot_s_avg", "complete_s"):
                report[kind][key] = {
                    m: statistics.median(t["boot"][key] for t in ts)
                    for m, ts in trials.items()}
            log(f"handoff {kind}: medians, bundle against brown-out: TTFT "
                f"from boot avg {report[kind]['ttft_boot_s_avg']}, every "
                f"request done {report[kind]['complete_s']} s")
        report["bf16"] = _handoff_bf16(dev, cfg, params, sdir, requests)
        report["sigterm"] = _handoff_sigterm(dev, cfg32, p32, sdir, requests)
    log(f"handoff SIGTERM: {report['sigterm']}")
    del p32
    torch.cuda.empty_cache()
    report["seconds"] = time.monotonic() - t0
    return report


# -- mixture of experts and weight-only quantization ----------------------------

#: mistralai/Mixtral-8x7B-v0.1 config.json, cut from 32 to 2 layers; every
#: layer MoE, capacity factor E / k = 4.0 (dropless routing, as Mixtral's)
MIXTRAL_8X7B_2L = dict(vocab=32000, d_model=4096, n_layers=2, n_heads=32,
                       n_kv_heads=8, d_ff=14336, max_seq=4096,
                       rope_theta=1e6, norm_eps=1e-5, n_experts=8,
                       expert_top_k=2, moe_every=1, capacity_factor=4.0)
#: the flagship with 8 experts (layers 1 and 3), saved and streamed back
MOE_FLAGSHIP = dict(n_experts=8, expert_top_k=2)
#: first-step logits' max-abs relative error against bf16: the JAX
#: tests' rails (tests/test_quant.py: int8 0.05, int8 MoE 0.08, int4
#: 0.25)
QUANT_RAILS = {"int8": 0.05, "int8_moe": 0.08, "int4": 0.25}
#: decode tok/s runs: 8 prompts of 128 tokens admitted in one untimed
#: step, then the rest of QUANT_NEW new tokens each timed apart from the
#: prefills, the modes in turns
QUANT_PROMPT = 128
QUANT_NEW = 256
QUANT_ORDER = {"llama": ("bf16", "int8", "int4", "int4", "int8", "bf16"),
               "mixtral": ("bf16", "int8", "int8", "bf16")}


def _first_logits(params, cfg, ids, dev):
    import torch
    from nvme_strom_tpu_torch.models import decode as dec
    cache = dec.init_cache(cfg, 1, len(ids), device=dev)
    logits, _ = dec.prefill(params, torch.tensor([ids], device=dev), cfg,
                            cache)
    return logits.float()


def _quant_tok_s(params, cfg, dev, requests):
    """Decode tok/s of a DecodeServer: the requests admitted and
    prefilled in one step, timed apart (the time to every request's
    first token: a quantized mode's prefill takes the dequant route),
    then the rest of their QUANT_NEW tokens timed from a synchronised
    start (a quantized mode's steps take the GEMV).  Returns (tok/s, the
    tokens, the prefill step's ms)."""
    import torch
    from nvme_strom_tpu_torch.models.serving import DecodeServer
    srv = DecodeServer(params, cfg, len(requests), 1024, device=dev)
    for rid, ids in requests:
        srv.submit(rid, ids, QUANT_NEW)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    srv.step_many(1)
    torch.cuda.synchronize()
    prefill_ms = (time.monotonic() - t0) * 1e3
    if srv.queue or any(s is None for s in srv.slots):
        raise AssertionError("quant: the requests did not all admit in "
                             "one step")
    before = sum(len(s.out) for s in srv.slots)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = srv.run(lookahead=8)
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    return (sum(len(v) for v in out.values()) - before) / secs, out, \
        prefill_ms


def _quant_modes(name, cfg, full, modes, dev, rail_int8):
    """Each mode's params (quantized on the card), its bytes against
    bf16, its first-step logits against bf16 within the rail, then
    decode tok/s of the modes in QUANT_ORDER's turns: the ratio of the
    medians against bf16, and its spread (the lowest turn over bf16's
    highest, the highest over bf16's lowest)."""
    import numpy as np
    from nvme_strom_tpu_torch.models.quant import (quantize_weights_int4,
                                                   quantize_weights_int8,
                                                   quantized_nbytes)
    make = {"bf16": lambda: full,
            "int8": lambda: quantize_weights_int8(full),
            "int4": lambda: quantize_weights_int4(full)}
    rng = np.random.default_rng(SEED + 23)
    ids = rng.integers(0, cfg.vocab, 64).tolist()
    ref = _first_logits(full, cfg, ids, dev)
    params, rep = {}, {}
    for mode in modes:
        params[mode] = make[mode]()
        if mode == "bf16":
            continue
        q, fp = quantized_nbytes(params[mode])
        rel = ((_first_logits(params[mode], cfg, ids, dev) - ref).abs().max()
               / ref.abs().max()).item()
        rail = rail_int8 if mode == "int8" else QUANT_RAILS["int4"]
        rep[mode] = {"quantized_bytes": q, "bf16_bytes": fp // 2,
                     "logits_max_rel": rel, "rail": rail}
        log(f"quant {name} {mode}: {q} B quantized against {fp // 2} B in "
            f"bf16 ({q / (fp // 2):.3f}); first-step logits max-abs rel "
            f"{rel:.4g} (rail {rail})")
        if not rel < rail:
            raise AssertionError(f"quant {name} {mode}: logits {rel} past "
                                 f"the rail {rail}")
    requests = [(f"q{i}", rng.integers(0, cfg.vocab,
                                       QUANT_PROMPT).tolist())
                for i in range(8)]
    tps = {m: [] for m in modes}
    ttft = {m: [] for m in modes}
    for mode in QUANT_ORDER[name]:
        rate, _, prefill_ms = _quant_tok_s(params[mode], cfg, dev, requests)
        tps[mode].append(rate)
        ttft[mode].append(prefill_ms)
    for mode in modes:
        rep.setdefault(mode, {})["tok_per_s"] = tps[mode]
        rep[mode]["prefill_ms"] = ttft[mode]
    med = {m: statistics.median(v) for m, v in tps.items()}
    rep["tok_s_ratio"] = {m: med[m] / med["bf16"] for m in modes}
    rep["prefill_ms_median"] = {m: statistics.median(v)
                                for m, v in ttft.items()}
    log(f"quant {name}: prefill step ({len(requests)} x {QUANT_PROMPT} "
        f"tokens, every request's first token) in turns {ttft} ms")
    rep["tok_s_ratio_spread"] = {
        m: (min(tps[m]) / max(tps["bf16"]), max(tps[m]) / min(tps["bf16"]))
        for m in modes}
    log(f"quant {name}: decode tok/s ({len(requests)} x {QUANT_PROMPT} "
        f"prompts, {QUANT_NEW} new, prefills untimed) in turns {tps}; "
        f"against bf16 {rep['tok_s_ratio']}, spread "
        f"{rep['tok_s_ratio_spread']}")
    return rep


def _moe_stream(dev, cfg):
    """The flagship with 8 experts: seeded on the card, saved with
    save_checkpoint, streamed back with LazyCheckpoint.load; every
    tensor, the 3-D expert ones included, bitwise, ``bounce_bytes`` 0."""
    import dataclasses
    import torch
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.parallel.weights import (LazyCheckpoint,
                                                       save_checkpoint)
    mcfg = dataclasses.replace(cfg, **MOE_FLAGSHIP)
    params = _card_params(mcfg, SEED + 24, dev)
    path = os.path.join(DATA_DIR, "moe_flagship.safetensors")
    save_checkpoint(path, params)
    with StromEngine() as eng:
        ctr = Counters(eng)
        t0 = time.monotonic()
        got = LazyCheckpoint(path).load(eng, device=dev)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        st = ctr.delta()
    os.remove(path)
    experts = [n for n in params if params[n].dim() == 3]
    bad = [n for n in params if not torch.equal(got[n], params[n])]
    nbytes = sum(t.numel() * t.element_size() for t in params.values())
    log(f"moe stream: {len(params)} tensors ({len(experts)} 3-D expert "
        f"tensors), {nbytes} B in {secs:.3f} s; {st}")
    if bad or not experts or st["bounce_bytes"] or \
            st["bytes_to_device"] < nbytes:
        raise AssertionError(f"moe stream: differ {bad}, {st}")
    return {"tensors": len(params), "expert_tensors": len(experts),
            "bytes": nbytes, "load_s": secs, "stats": st}


def moe_quant_phase(dev, cfg):
    """(1) Mixtral-8x7B's widths cut to 2 layers (MIXTRAL_8X7B_2L, ~3.2 G
    parameters in bf16, seeded on the card): the 8 serve-phase requests
    (prompts 16-1500, 32 new tokens) through both servers, tokens equal,
    then the dense run again under torch.profiler;
    (2) the flagship with 8 experts through save and the stream
    (``_moe_stream``); (3) int8 and int4 of LLAMA3_8B_2L and int8 of (1):
    bytes against bf16, first-step logits within QUANT_RAILS, decode
    tok/s against bf16 in turns."""
    import numpy as np
    import torch
    from nvme_strom_tpu_torch.models.serving import (DecodeServer,
                                                     PagedDecodeServer)
    from nvme_strom_tpu_torch.models.transformer import TransformerConfig
    from nvme_strom_tpu_torch.ops import quant_matmul as qmm
    t0 = time.monotonic()
    report = {"card": card_line()}
    torch_dequants = qmm.dequant_plain.device_calls
    mcfg = TransformerConfig(**MIXTRAL_8X7B_2L)
    full = _card_params(mcfg, SEED + 22, dev)
    n_params = sum(t.numel() for t in full.values())
    rng = np.random.default_rng(SEED)
    lengths = [16, 100, 250, 400, 700, 1000, 1250, 1500]
    requests = [(f"m{i}", rng.integers(0, mcfg.vocab, n).tolist())
                for i, n in enumerate(lengths)]
    outs = {}
    # the first run meets every GEMM shape for the first time: reported
    # apart, as serve_phase's dense_cold
    for label in ("dense_cold", "dense", "paged"):
        srv = (DecodeServer(full, mcfg, 8, 2048, device=dev)
               if label != "paged" else
               PagedDecodeServer(full, mcfg, 8, 2048, total_blocks=128,
                                 block_len=128, device=dev))
        out, secs = serve(srv, requests)
        s = srv.stats()
        toks = sum(len(v) for v in out.values())
        outs[label] = out
        report[f"mixtral_{label}"] = {
            "tokens": toks, "seconds": secs, "tok_per_s": toks / secs,
            "ttft_ms_avg": s["ttft_ms_avg"], "ttft_ms_max": s["ttft_ms_max"]}
        log(f"moe Mixtral-8x7B widths, 2 layers ({n_params} parameters) "
            f"{label}: {toks} tokens in {secs:.3f} s = {toks / secs:.1f} "
            f"tok/s, TTFT avg {s['ttft_ms_avg']} ms max {s['ttft_ms_max']} "
            f"ms")
        del srv
    if outs["dense"] != outs["paged"] or outs["dense_cold"] != \
            outs["dense"] or any(len(v) != 32 for v in outs["dense"].values()):
        diff = [r for r in outs["dense"]
                if outs["dense"][r] != outs["paged"].get(r)]
        raise AssertionError(f"moe Mixtral: dense and paged tokens differ "
                             f"for {diff}")
    # where a serve run's device time goes: the experts' batched
    # products against the dispatch and combine einsums
    report["mixtral_profile"] = profile_run(
        lambda done: serve(DecodeServer(full, mcfg, 8, 2048, device=dev),
                           requests), "Mixtral dense serve")
    report["mixtral_params"] = n_params
    report["mixtral_quant"] = _quant_modes(
        "mixtral", mcfg, full, ("bf16", "int8"), dev,
        QUANT_RAILS["int8_moe"])
    del full
    torch.cuda.empty_cache()
    report["moe_stream"] = _moe_stream(dev, cfg)
    torch.cuda.empty_cache()
    lcfg = TransformerConfig(**LLAMA3_8B_2L)
    full = _card_params(lcfg, SEED + 11, dev)
    report["llama_quant"] = _quant_modes(
        "llama", lcfg, full, ("bf16", "int8", "int4"), dev,
        QUANT_RAILS["int8"])
    del full
    torch.cuda.empty_cache()
    report["quant_launches"] = {"quant_gemv": qmm.quant_gemv.launches,
                                "dequant": qmm.dequant.launches}
    if qmm.dequant_plain.device_calls != torch_dequants:
        raise AssertionError("moe quant: a CUDA leaf was dequantized by "
                             "torch ops")
    log(f"moe quant: quantized products through quant_gemv "
        f"{qmm.quant_gemv.launches} and dequant {qmm.dequant.launches} "
        f"launches, no CUDA leaf dequantized by torch ops")
    report["seconds"] = time.monotonic() - t0
    return report


# -- the weight-only int8 / int4 matmul (ops/quant_matmul.py) ---------------

#: quant_gemv against quant_matmul_plain on the card: max |kernel - plain|
#: over max |plain|.  Both round the weight alike and sum in float32 in
#: another order; bf16 / fp16 then round the output once (one ulp of an
#: element apart at most), float32 does not (TF32 off)
QUANT_KERNEL_TOL = {"bfloat16": 1e-2, "float16": 1e-2, "float32": 1e-5}
#: Llama-3-8B's products (d_in, d_out) at the issue's widths
QUANT_LLAMA = {"w_gate": (4096, 14336), "w_down": (14336, 4096),
               "wq": (4096, 4096), "wk": (4096, 1024),
               "lm_head": (4096, 32000)}
#: rows of x the checks take; the crossover sweep's
QUANT_CHECK_M = (1, 3, 8, 16)
QUANT_CROSSOVER_M = (1, 2, 4, 8, 16, 32, 64)
#: the rows the timed table is taken at (a decode step of 8 slots)
QUANT_TIMED_M = 8
#: the headline entry of the kernels line: Llama-3-8B's w_gate in int8
QUANT_HEADLINE = ("w_gate", "int8")
#: the weight-only kernels' names in the counters and the kernels line
QUANT_KERNELS = ("quant_gemv", "dequant")


def _quant_leaf(kind, shape, dev, seed):
    """A leaf quantized on the card from a seeded weight: ``int8`` or
    ``int4_g<group>`` (the group exact: it must divide d_in).  Returns
    (leaf, the weight in bf16)."""
    import torch
    from nvme_strom_tpu_torch.models import quant as q
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(shape, generator=g, device=dev) * 0.02
    if kind == "int8":
        leaf = q.quantize_weights_int8({"w": w}, suffixes=("w",))["w"]
    else:
        group = int(kind.split("_g")[1])
        leaf = q.quantize_weights_int4({"w": w}, suffixes=("w",),
                                       group=group)["w"]
        if leaf["scale4"].shape[-3] * group != shape[-2]:
            raise AssertionError(f"{kind} {shape}: group {group} not exact")
    return leaf, w.to(torch.bfloat16)


def _leaf_bytes(leaf):
    return sum(t.numel() * t.element_size() for t in leaf.values())


def _quant_bound(leaf, M, K, N, E, itemsize, gemv):
    """(ms, bound_by): quant_gemv reads the quantized bytes, the scales
    and x and writes out; dequant reads the quantized bytes and the
    scales and writes the weight.  Operations: the GEMV's 2·M·K·N at the
    dtype's tensor-core rate (bf16 / fp16) or float32's."""
    if gemv:
        nbytes = _leaf_bytes(leaf) + E * M * (K + N) * itemsize
        flops = 2.0 * E * M * K * N
        rate = F32_FLOPS_PER_S if itemsize == 4 else BF16_FLOPS_PER_S
        return bound(nbytes, HBM_BYTES_PER_S, flops, rate)
    return bound(_leaf_bytes(leaf) + E * K * N * itemsize, HBM_BYTES_PER_S)


def _int_pack_library(kind, leaf, x2, plain):
    """A PyTorch call that computes the same product, where the installed
    torch has one on CUDA: ``torch._weight_int8pack_mm`` (int8) or
    ``torch._weight_int4pack_mm`` (int4, bf16 x), its layout converted
    here, outside any clock.  Returns (callable, max rel err against the
    plain product) or (None, the reason)."""
    import torch
    try:
        if kind == "int8":
            w = leaf["q8"].t().contiguous()
            sc = leaf["scale"].reshape(-1).to(x2.dtype)
            fns = [lambda: torch._weight_int8pack_mm(x2, w, sc)]
        else:
            if x2.dtype != torch.bfloat16:
                return None, "int4pack takes bf16"
            q4 = leaf["q4"]
            lo, hi = (q4 & 0xF).t(), (q4 >> 4).t()      # (N, K/2) each
            K = 2 * q4.shape[-2]
            g = K // leaf["scale4"].shape[-3]
            sz = torch.stack([leaf["scale4"][:, 0, :],
                              torch.zeros_like(leaf["scale4"][:, 0, :])],
                             dim=-1).to(torch.bfloat16).contiguous()
            # the packed layout's nibble order differs between releases:
            # both are tried, and the one that computes the product kept
            fns = [(lambda packed: lambda: torch._weight_int4pack_mm(
                x2, packed, g, sz))(torch._convert_weight_to_int4pack(
                    b.contiguous(), 8))
                for b in ((lo << 4) | hi, (hi << 4) | lo)]
        best = None
        for f in fns:
            out = f()
            torch.cuda.synchronize()
            rel = ((out.float() - plain.float()).abs().max()
                   / plain.float().abs().max()).item()
            if best is None or rel < best[1]:
                best = (f, rel)
    except (RuntimeError, NotImplementedError, AttributeError,
            TypeError) as e:
        return None, f"none ({type(e).__name__}: {str(e)[:120]})"
    return best


def _quant_correct(dev, gen):
    """quant_gemv against quant_matmul_plain and dequant against
    dequant_plain (bitwise), each called twice (bitwise equal), over the
    cases of check_quant's docstring.  Returns the worst relative error
    by dtype, the worst absolute error in bf16 and the cases run."""
    import torch
    from nvme_strom_tpu_torch.ops import quant_matmul as qmm
    dts = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}
    cases = []      # (label, kind, shape, ms, dtypes)
    for name in ("w_gate", "w_down"):
        for kind in ("int8", "int4_g128"):
            cases.append((f"Llama-3-8B {name} {kind}", kind,
                          QUANT_LLAMA[name], QUANT_CHECK_M
                          + (2 * qmm.QUANT_GEMV_MAX_ROWS,), tuple(dts)))
    cases += [
        ("Mixtral-8x7B experts w_gate int8", "int8", (8, 4096, 14336),
         (2, 8), ("bfloat16",)),
        ("Mixtral-8x7B experts w_down int8", "int8", (8, 14336, 4096),
         (2, 8), ("bfloat16",)),
        ("int4 g24", "int4_g24", (4032, 1000), (1, 8), tuple(dts)),
        ("int8 d_out 1000", "int8", (4096, 1000), (1, 8), tuple(dts)),
        ("int8 d_out 1003 (ragged)", "int8", (4096, 1003), (3,),
         tuple(dts)),
        ("lm_head int8", "int8", QUANT_LLAMA["lm_head"], (1, 8),
         ("bfloat16", "float32")),
    ]
    worst, worst_abs = {d: 0.0 for d in dts}, 0.0
    for i, (label, kind, shape, ms, dnames) in enumerate(cases):
        leaf, _ = _quant_leaf(kind, shape, dev, SEED + 40 + i)
        E = shape[0] if len(shape) == 3 else 1
        K = shape[-2]
        for dn in dnames:
            dt = dts[dn]
            w = qmm.dequant(leaf, dt)
            if not torch.equal(w, qmm.dequant_plain(leaf, dt)):
                raise AssertionError(f"dequant {label} {dn}: not bitwise "
                                     "the torch ops")
            _repeatable(f"dequant {label} {dn}", qmm.dequant, (leaf, dt))
            del w
            for m in ms:
                x = torch.randn(E, m, K, generator=gen, device=dev).to(dt)
                got = qmm.quant_gemv(x, leaf)
                want = qmm.quant_matmul_plain(x if E > 1 else x[0], leaf)
                want = want if E > 1 else want[None]
                rel = ((got.float() - want.float()).abs().max()
                       / want.float().abs().max()).item()
                if not (torch.isfinite(got).all() and
                        rel <= QUANT_KERNEL_TOL[dn]):
                    raise AssertionError(f"quant_gemv {label} {dn} M {m}: "
                                         f"max rel {rel}")
                _repeatable(f"quant_gemv {label} {dn} M {m}",
                            qmm.quant_gemv, (x, leaf))
                if m > qmm.QUANT_GEMV_MAX_ROWS:
                    xm = x if E > 1 else x[0]
                    if not torch.equal(qmm.quant_matmul(xm, leaf),
                                       xm @ qmm.dequant(leaf, dt)):
                        raise AssertionError(f"quant_matmul {label} M {m}: "
                                             "not the dequant route")
                worst[dn] = max(worst[dn], rel)
                if dn == "bfloat16":
                    worst_abs = max(worst_abs, (got.float() - want.float())
                                    .abs().max().item())
        log(f"quant check {label} {tuple(shape)}: dequant bitwise and "
            f"quant_gemv at M {ms} within {[QUANT_KERNEL_TOL[d] for d in dnames]}"
            f" in {dnames}, two calls bitwise equal")
        del leaf
    torch.cuda.empty_cache()
    return worst, worst_abs, [c[0] for c in cases]


def _quant_times(dev, gen, name, kind, M):
    """Times at one Llama-3-8B weight and M rows in bf16, inputs in
    rotation past the L2: the GEMV (and its device time), its plain
    version (wmat's torch ops + torch.matmul, today's route), the dequant
    kernel (and device time) and dequant + torch.matmul, dequant_plain,
    the bf16 matmul on the unquantized weight, the library call."""
    import torch
    from nvme_strom_tpu_torch.ops import quant_matmul as qmm
    K, N = QUANT_LLAMA[name]
    probe, _ = _quant_leaf(kind, (K, N), dev, SEED + 60)
    nb = _leaf_bytes(probe)
    sets = _rotating(lambda: (
        _quant_leaf(kind, (K, N), dev, SEED + 61)[0],
        torch.randn(1, M, K, generator=gen, device=dev).to(torch.bfloat16)),
        nb)
    wsets = _rotating(lambda: (
        (torch.randn(K, N, generator=gen, device=dev) * 0.02).to(
            torch.bfloat16),
        torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)),
        K * N * 2)
    gemv = Rotor(lambda leaf, x: qmm.quant_gemv(x, leaf), sets)
    deq = Rotor(lambda leaf, x: qmm.dequant(leaf, torch.bfloat16), sets)
    deq_mm = Rotor(lambda leaf, x: x[0] @ qmm.dequant(leaf, torch.bfloat16),
                   sets)
    plain = Rotor(lambda leaf, x: qmm.quant_matmul_plain(x[0], leaf), sets)
    plain_deq = Rotor(lambda leaf, x: qmm.dequant_plain(leaf,
                                                        torch.bfloat16),
                      sets)
    bf16 = Rotor(lambda w, x: x @ w, wsets)
    it = 50 if nb < (64 << 20) else 20
    lib = [_int_pack_library(kind.split("_")[0], leaf, x[0],
                             qmm.quant_matmul_plain(x[0], leaf))
           for leaf, x in sets]
    lib_ms, lib_note = None, lib[0][1]
    if lib[0][0] is not None:
        worst = max(rel for _, rel in lib)
        if worst <= QUANT_KERNEL_TOL["bfloat16"]:
            lib_ms = time_ms(Rotor(lambda f: f(), [(f,) for f, _ in lib]),
                             it)
            lib_note = (f"torch._weight_{kind.split('_')[0]}pack_mm, max "
                        f"rel {worst:.3g} against plain")
        else:
            lib_note = f"none (max rel {worst:.3g} against plain: layout)"
    gb, gby = _quant_bound(probe, M, K, N, 1, 2, True)
    db, dby = _quant_bound(probe, M, K, N, 1, 2, False)
    r = {"weight": name, "kind": kind, "M": M, "K": K, "N": N,
         "quant_bytes": nb,
         "gemv_ms": time_ms(gemv, it), "gemv_device_ms": device_ms(gemv, it),
         "gemv_bound_ms": gb, "gemv_bound_by": gby,
         "dequant_ms": time_ms(deq, it), "dequant_device_ms":
         device_ms(deq, it), "dequant_bound_ms": db, "dequant_bound_by": dby,
         "dequant_matmul_ms": time_ms(deq_mm, it),
         "wmat_matmul_ms": time_ms(plain, it),
         "dequant_plain_ms": time_ms(plain_deq, it),
         "bf16_matmul_ms": time_ms(bf16, it),
         "library_ms": lib_ms, "library": lib_note}
    del sets, wsets, probe
    torch.cuda.empty_cache()
    return r


def _quant_crossover(dev, gen):
    """quant_gemv against dequant + torch.matmul at QUANT_CROSSOVER_M rows
    for the Llama-3-8B MLP weights, int8 and int4 (g 128), bf16, inputs
    in rotation; the crossover is the first M where the GEMV is slower."""
    import torch
    from nvme_strom_tpu_torch.ops import quant_matmul as qmm
    out = {}
    for name in ("w_gate", "w_down"):
        K, N = QUANT_LLAMA[name]
        for kind in ("int8", "int4_g128"):
            def make():
                x = torch.randn(1, max(QUANT_CROSSOVER_M), K, generator=gen,
                                device=dev).to(torch.bfloat16)
                return (_quant_leaf(kind, (K, N), dev, SEED + 70)[0],
                        {m: x[:, :m].contiguous() for m in QUANT_CROSSOVER_M})
            sets = _rotating(make, K * N // (1 if kind == "int8" else 2))
            row = {}
            for m in QUANT_CROSSOVER_M:
                gemv = Rotor(lambda leaf, xs: qmm.quant_gemv(xs[m], leaf),
                             sets)
                dm = Rotor(lambda leaf, xs: xs[m][0] @ qmm.dequant(
                    leaf, torch.bfloat16), sets)
                row[m] = (time_ms(gemv, 20), time_ms(dm, 20))
            cross = next((m for m in QUANT_CROSSOVER_M
                          if row[m][0] > row[m][1]), None)
            out[f"{name} {kind}"] = {"gemv_ms": [row[m][0] for m in row],
                                     "dequant_matmul_ms": [row[m][1]
                                                           for m in row],
                                     "first_m_gemv_slower": cross}
            log(f"quant crossover {name} {kind} (M {QUANT_CROSSOVER_M}): "
                f"gemv {[round(row[m][0], 4) for m in row]} ms, dequant + "
                f"matmul {[round(row[m][1], 4) for m in row]} ms; the GEMV "
                f"first slower at M {cross}")
            del sets
            torch.cuda.empty_cache()
    return out


def check_quant(dev, results):
    """The weight-only kernels (csrc/quant_matmul.cu) on the card:
    quant_gemv against quant_matmul_plain (QUANT_KERNEL_TOL) and dequant
    against dequant_plain bitwise, in bf16 / fp16 / fp32, two calls of
    each bitwise equal, at Llama-3-8B's MLP shapes at M 1, 3, 8, 16 and
    one M past QUANT_GEMV_MAX_ROWS (also through quant_matmul's dequant
    route), Mixtral-8x7B's expert leaves in int8, int4 in groups of 128
    and of 24, d_out 1000 and 1003, the lm_head in int8; then each kernel
    timed at every Llama-3-8B weight at M 8 in bf16 (int8; int4 but the
    lm_head) with its bound, its plain version, today's ``wmat`` +
    ``torch.matmul``, the bf16 matmul and the library call, and the
    crossover of the GEMV against dequant + matmul."""
    import torch
    from nvme_strom_tpu_torch.ops import quant_matmul as qmm
    t0 = time.monotonic()
    old_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gen = torch.Generator(device=dev).manual_seed(SEED)
        worst, worst_abs, cases = _quant_correct(dev, gen)
        table = [_quant_times(dev, gen, name, kind, QUANT_TIMED_M)
                 for name in QUANT_LLAMA
                 for kind in (("int8",) if name == "lm_head"
                              else ("int8", "int4_g128"))]
        crossover = _quant_crossover(dev, gen)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old_tf32
    for r in table:
        log(f"quant {r['weight']} {r['kind']} M {r['M']} ({r['K']} x "
            f"{r['N']}, {r['quant_bytes']} B): gemv {r['gemv_ms']:.4f} ms "
            f"({r['gemv_device_ms']:.4f} on the device; bound "
            f"{r['gemv_bound_ms']:.4f}, {r['gemv_bound_by']}); dequant "
            f"{r['dequant_ms']:.4f} ms ({r['dequant_device_ms']:.4f}; bound "
            f"{r['dequant_bound_ms']:.4f}), + matmul "
            f"{r['dequant_matmul_ms']:.4f}; wmat + matmul (torch ops) "
            f"{r['wmat_matmul_ms']:.4f}; dequant_plain "
            f"{r['dequant_plain_ms']:.4f}; bf16 matmul "
            f"{r['bf16_matmul_ms']:.4f}; library {r['library_ms']} "
            f"({r['library']})")
    head = next(r for r in table if (r["weight"], r["kind"])
                == QUANT_HEADLINE)
    shape = (f"Llama-3-8B {head['weight']} {head['kind']} ({head['K']} x "
             f"{head['N']}), x ({head['M']}, {head['K']}) bf16")
    common = dict(route="cuda",
                  source="nvme_strom_tpu_torch/csrc/quant_matmul.cu",
                  replaces="nvme_strom_tpu/models/transformer.py:220 "
                  "(wmat, fused by XLA)", shape=shape, ok=True,
                  table=table, cases=cases)
    results["quant_gemv"] = dict(
        name="quant_gemv", max_abs_err=worst_abs,
        max_rel_err=worst, ms=head["gemv_ms"],
        device_ms=head["gemv_device_ms"], plain_ms=head["wmat_matmul_ms"],
        bound_ms=head["gemv_bound_ms"], bound_by=head["gemv_bound_by"],
        library_ms=head["library_ms"], library=head["library"],
        bf16_matmul_ms=head["bf16_matmul_ms"],
        max_rows=qmm.QUANT_GEMV_MAX_ROWS, crossover=crossover, **common)
    results["dequant"] = dict(
        name="dequant", max_abs_err=0.0, ms=head["dequant_ms"],
        device_ms=head["dequant_device_ms"],
        plain_ms=head["dequant_plain_ms"],
        bound_ms=head["dequant_bound_ms"],
        bound_by=head["dequant_bound_by"], library_ms=None,
        dequant_matmul_ms=head["dequant_matmul_ms"],
        wmat_matmul_ms=head["wmat_matmul_ms"],
        bf16_matmul_ms=head["bf16_matmul_ms"], **common)
    # the kernels line keeps one copy of the table and the cases
    del results["dequant"]["table"], results["dequant"]["cases"]
    log(f"check_quant: {time.monotonic() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()


# -- training beyond device memory ---------------------------------------------

#: the remat sweep: the flagship's widths at 16 layers, so that full
#: remat's one (b, s, d) input a layer (16 MiB) outweighs the noise
REMAT_LAYERS = 16
REMAT_POLICIES = ("none", "full", "dots", "nvme")
REMAT_TOL = (1e-4, 1e-5)
REMAT_TIMED = 3
OPT_STEPS = 10
OPT_GROUP_BYTES = 64 << 20
OPT_TOL = (1e-5, 1e-6)
QLORA_BATCH = 2
QLORA_STEPS = 6
QLORA_RANK = 16
QLORA_TOL = (3e-2, 3e-2)
QLORA_TIMED = 3


def _step_peak(fn):
    """(fn's result, device bytes it allocated above the start at its
    peak, seconds), synchronised."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base, \
        time.monotonic() - t0


def _remat_sweep(dev, flagship, toks, attn):
    """One step under each remat policy from the same init and batch:
    loss and gradients against ``none``'s, the activation peak, the
    median ms of the timed steps, and nvme's store traffic."""
    import dataclasses
    import torch
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.models import transformer as ttr
    from nvme_strom_tpu_torch.parallel.act_offload import ActivationStore
    cfg = dataclasses.replace(flagship, n_layers=REMAT_LAYERS,
                              xent_chunks=8)
    params = _card_params(dataclasses.replace(cfg, dtype=torch.float32),
                          SEED, dev)
    params = {n: p.requires_grad_() for n, p in params.items()}
    report: dict = {}
    ref = None
    with StromEngine() as eng, ActivationStore(
            os.path.join(DATA_DIR, "acts", "acts.bin"), cfg.n_layers,
            engine=eng) as store:
        for policy in REMAT_POLICIES:
            c = dataclasses.replace(cfg, remat_policy=policy)
            st = store if policy == "nvme" else None

            def step():
                return ttr.value_and_grad(params, toks, c, attn,
                                          act_store=st)
            eng.sync_stats()
            before = eng.stats.snapshot()
            w0, r0 = store.writes, store.reads
            (loss, grads), peak, _ = _step_peak(step)
            eng.sync_stats()
            after = eng.stats.snapshot()
            d = {k: after[k] - before[k] for k in (
                "bytes_direct", "bytes_fallback", "bytes_written_direct",
                "bounce_bytes")}
            if ref is None:
                ref = (loss, grads)
                worst, bitwise = 0.0, True
            else:
                worst, bitwise = 0.0, bool(torch.equal(loss, ref[0]))
                torch.testing.assert_close(loss, ref[0], rtol=REMAT_TOL[0],
                                           atol=REMAT_TOL[1])
                for n, g in grads.items():
                    torch.testing.assert_close(
                        g, ref[1][n], rtol=REMAT_TOL[0], atol=REMAT_TOL[1],
                        msg=f"remat {policy}: gradient of {n}")
                    worst = max(worst, float((g - ref[1][n]).abs().max()))
                    bitwise = bitwise and bool(torch.equal(g, ref[1][n]))
            del grads
            ms = []
            for _ in range(REMAT_TIMED):
                _, _, secs = _step_peak(lambda: step()[0].item())
                ms.append(secs * 1e3)
            entry = {"peak_bytes": peak, "loss": loss.item(),
                     "max_abs_grad_diff": worst, "bitwise": bitwise,
                     "ms_median": statistics.median(ms), "ms": ms}
            if policy == "nvme":
                steps = 1 + REMAT_TIMED
                entry.update(writes=store.writes - w0,
                             reads=store.reads - r0, step_stats=d,
                             prefetch_hits=store.prefetch_hits)
                if entry["writes"] != entry["reads"] or \
                        entry["writes"] != steps * cfg.n_layers:
                    raise AssertionError(f"remat nvme: store counted "
                                         f"{entry['writes']} writes, "
                                         f"{entry['reads']} reads")
                slot = toks.numel() * cfg.d_model * 2
                if d["bytes_written_direct"] < cfg.n_layers * slot:
                    raise AssertionError(f"remat nvme: {d} wrote less "
                                         "than the layer inputs O_DIRECT")
                if d["bounce_bytes"] or d["bytes_fallback"]:
                    raise AssertionError(f"remat nvme: reads bounced {d}")
            report[policy] = entry
            log(f"remat {policy} ({cfg.n_layers} layers, seq "
                f"{toks.shape[1]}, batch {toks.shape[0]}, flash, bf16): "
                f"activation peak {peak / 2**20:.1f} MiB, median step "
                f"{entry['ms_median']:.2f} ms {[round(x, 2) for x in ms]}, "
                f"loss {entry['loss']:.6f}, largest gradient difference "
                f"from none {worst:.3e}, bitwise {bitwise}"
                + (f"; store {entry['writes']} writes, {entry['reads']} "
                   f"reads, {entry['prefetch_hits']} prefetch hits, first "
                   f"step {d}" if policy == "nvme" else ""))
            del loss
            torch.cuda.empty_cache()
    p = {k: v["peak_bytes"] for k, v in report.items()}
    if not p["nvme"] < p["full"] <= p["dots"] <= p["none"]:
        raise AssertionError(f"remat peaks out of order: {p}")
    return report


def _opt_offload(dev, flagship, batches, attn):
    """``OffloadedAdam`` against the in-HBM AdamW over the same steps."""
    import json as _json
    import shutil
    import torch
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.models import transformer as ttr
    from nvme_strom_tpu_torch.parallel.opt_offload import OffloadedAdam
    odir = os.path.join(DATA_DIR, "opt_moments")
    shutil.rmtree(odir, ignore_errors=True)
    init = _card_params(flagship, SEED, dev)
    init = {n: p.float() for n, p in init.items()}

    def fresh():
        return {n: p.clone().requires_grad_() for n, p in init.items()}
    lr = 3e-4
    hbm = fresh()
    opt = ttr.adamw(hbm, lr)
    ms_hbm = []
    # in bf16 two optimizers that round differently drift apart within
    # a few steps (a flipped bf16 rounding of a weight changes the next
    # gradient), so the offloaded run applies the gradients recorded
    # here: the optimizer is then the only difference between the runs
    recorded = []
    for toks in batches:
        t0 = time.monotonic()
        loss, grads = ttr.value_and_grad(hbm, toks, flagship, attn)
        ttr.apply_gradients(opt, hbm, grads)
        torch.cuda.synchronize()
        ms_hbm.append((time.monotonic() - t0) * 1e3)
        recorded.append(grads)
    hbm_moments = sum(t.numel() * t.element_size()
                      for s in opt.state.values() for k, t in s.items()
                      if k != "step")
    off = fresh()
    report = {}
    with StromEngine() as eng, OffloadedAdam(
            odir, off, lr=lr, weight_decay=1e-4,
            group_bytes=OPT_GROUP_BYTES, engine=eng) as offl:
        ms, upd_s, peaks = [], [], []
        eng.sync_stats()
        s0 = eng.stats.snapshot()
        for toks, grads in zip(batches, recorded):
            t0 = time.monotonic()
            loss, own = ttr.value_and_grad(off, toks, flagship, attn)
            del own
            _, peak, secs = _step_peak(lambda: offl.update(off, grads))
            ms.append((time.monotonic() - t0) * 1e3)
            upd_s.append(secs)
            peaks.append(peak)
        del recorded, grads
        eng.sync_stats()
        s1 = eng.stats.snapshot()
        d = {k: s1[k] - s0[k] for k in ("bytes_direct", "bytes_fallback",
                                         "bytes_written_direct",
                                         "bounce_bytes")}
        mb = offl.moment_bytes()
        worst = max(float((off[n] - hbm[n]).detach().abs().max())
                    for n in hbm)
        for n in hbm:
            torch.testing.assert_close(off[n], hbm[n], rtol=OPT_TOL[0],
                                       atol=OPT_TOL[1],
                                       msg=f"offloaded AdamW: {n}")
        if max(peaks) > 2 * offl.peak_group_bytes():
            raise AssertionError(f"offloaded moments took {max(peaks)} B "
                                 f"of device memory, over twice "
                                 f"{offl.peak_group_bytes()}")
        if d["bytes_written_direct"] < len(batches) * mb or d["bounce_bytes"]:
            raise AssertionError(f"moment traffic {d} for {len(batches)} "
                                 f"steps of {mb} B")
        # what the file holds, read back on the card by a resumed one
        groups = [offl._read_group(g) for g in offl._groups]
        report.update(
            moment_bytes=mb, groups=offl.num_groups(),
            peak_group_bytes=offl.peak_group_bytes(),
            update_peak_bytes=max(peaks), hbm_moment_bytes=hbm_moments,
            ms_median=statistics.median(ms[1:]),
            hbm_ms_median=statistics.median(ms_hbm[1:]),
            update_ms_median=statistics.median(upd_s[1:]) * 1e3,
            read_gib_s=(d["bytes_direct"] + d["bytes_fallback"])
            / sum(upd_s) / 2**30,
            write_gib_s=d["bytes_written_direct"] / sum(upd_s) / 2**30,
            max_abs_param_diff=worst, stats=d)
    with StromEngine() as eng, OffloadedAdam(
            odir, fresh(), lr=lr, weight_decay=1e-4,
            group_bytes=OPT_GROUP_BYTES, engine=eng) as again:
        if again.step != len(batches):
            raise AssertionError(f"resumed at step {again.step}")
        for g, (ms_, vs_) in zip(again._groups, groups):
            m2, v2 = again._read_group(g)
            for a, b in zip(ms_ + vs_, m2 + v2):
                if not torch.equal(a, b):
                    raise AssertionError("resumed moments differ")
        mpath = again.manifest_path
    good = open(mpath).read()
    m = _json.loads(good)
    m["dirty"] = True
    with open(mpath, "w") as f:
        _json.dump(m, f)
    try:
        OffloadedAdam(odir, fresh(), lr=lr, group_bytes=OPT_GROUP_BYTES)
    except ValueError as e:
        if "dirty" not in str(e):
            raise
    else:
        raise AssertionError("a dirty moment manifest was not refused")
    finally:
        with open(mpath, "w") as f:
            f.write(good)
    log(f"offload-opt (flagship, {len(batches)} steps, seq "
        f"{batches[0].shape[1]}, batch {batches[0].shape[0]}, flash): "
        f"{report['moment_bytes']} B of moments in {report['groups']} "
        f"groups on NVMe, peak {report['update_peak_bytes']} B on the "
        f"card during an update (2 x peak group {report['peak_group_bytes']}"
        f"; in-HBM AdamW holds {hbm_moments} B); median step "
        f"{report['ms_median']:.2f} ms (update {report['update_ms_median']:.2f}"
        f" ms) against in-HBM {report['hbm_ms_median']:.2f} ms; moments "
        f"{report['read_gib_s']:.3f} GiB/s in, {report['write_gib_s']:.3f} "
        f"GiB/s out; params after {len(batches)} steps within "
        f"{report['max_abs_param_diff']:.3e} of in-HBM AdamW; resumed at "
        f"step {len(batches)} with moments bitwise; a dirty manifest "
        f"refused; {d}")
    return report


def _qlora(dev, toks):
    """LoRA rank 16 over Llama-3-8B widths (2 layers): the int4 base
    against a bf16 base, in turns; t=0 logits, falling loss, a base
    left alone and an adapter checkpoint resumed bitwise."""
    import dataclasses
    import shutil
    import torch
    from nvme_strom_tpu_torch.checkpoint.manager import CheckpointManager
    from nvme_strom_tpu_torch.models import lora
    from nvme_strom_tpu_torch.models import transformer as ttr
    from nvme_strom_tpu_torch.models.quant import (quantize_weights_int4,
                                                   quantized_nbytes)
    from nvme_strom_tpu_torch.ops.flash_attention import make_flash_attn
    from nvme_strom_tpu_torch.train import optimizer_state, restore_state
    cfg = dataclasses.replace(ttr.TransformerConfig(**LLAMA3_8B_2L),
                              max_seq=toks.shape[1], xent_chunks=8)
    attn = make_flash_attn()
    bf16 = {n: p.requires_grad_(False)
            for n, p in _card_params(cfg, SEED, dev).items()}
    int4 = quantize_weights_int4(bf16)
    sched = ttr.lr_schedule(1e-3, "cosine", 2, QLORA_STEPS)
    q_before = {n: {k: t.clone() for k, t in w.items()}
                for n, w in int4.items() if isinstance(w, dict)}
    alpha = float(QLORA_RANK)

    def setup(base):
        ad = lora.lora_init(torch.Generator().manual_seed(1), base,
                            QLORA_RANK, device=dev)
        leaves = lora.adapter_leaves(ad)
        opt = ttr.adamw(list(leaves.values()), 1e-3)
        step = lora.make_lora_train_step(cfg, opt, alpha=alpha,
                                         attn_fn=attn, lr=sched,
                                         grad_clip=1.0)
        return ad, leaves, opt, step

    ad, leaves, opt, step = setup(int4)
    # t=0: B is zero, so the adapted model is the base up to the merge's
    # one bfloat16 rounding of each dequantized target.  Compared in
    # float32 compute, where that rounding is the only difference (in
    # bf16 compute the two paths also round their activations apart)
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    t0_err = {}
    with torch.no_grad():
        for name, c in (("float32", f32), ("bfloat16", cfg)):
            l0 = ttr.forward(lora.merge_lora(int4, ad, alpha), toks, c,
                             attn)
            lb = ttr.forward(int4, toks, c, attn)
            t0_err[name] = float((l0 - lb).abs().max())
            if name == "float32":
                torch.testing.assert_close(l0, lb, rtol=QLORA_TOL[0],
                                           atol=QLORA_TOL[1])
            del l0, lb
    losses = [step(ad, int4, toks).item() for _ in range(QLORA_STEPS)]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"QLoRA loss did not fall: {losses}")
    for n, w in q_before.items():
        for k, t in w.items():
            if not torch.equal(int4[n][k], t):
                raise AssertionError(f"QLoRA changed the base's {n}.{k}")
    for n, w in int4.items():
        for t in (w.values() if isinstance(w, dict) else [w]):
            if t.grad is not None or t.requires_grad:
                raise AssertionError(f"base tensor {n} has a gradient")
    cdir = os.path.join(DATA_DIR, "qlora_ckpt")
    shutil.rmtree(cdir, ignore_errors=True)
    mgr = CheckpointManager(cdir)
    try:
        path = mgr.save(QLORA_STEPS, (leaves, optimizer_state(opt, leaves)))
        ck_bytes = sum(os.path.getsize(os.path.join(path, f))
                       for f in os.listdir(path))
        ad2, leaves2, opt2, _ = setup(int4)
        restore_state(mgr, QLORA_STEPS, leaves2, opt2, dev)
    finally:
        mgr.close()
    for n, t in leaves.items():
        if not torch.equal(t, leaves2[n]):
            raise AssertionError(f"adapter {n} did not resume bitwise")
    s1, s2 = optimizer_state(opt, leaves), optimizer_state(opt2, leaves2)
    for key in s1:
        for n in s1[key]:
            if not torch.equal(s1[key][n].cpu(), s2[key][n].cpu()):
                raise AssertionError(f"optimizer {key} of {n} differs")
    # ms a step and peak memory, int4 base against bf16, in turns
    turns = {"int4": [], "bf16": []}
    peaks = {"int4": 0, "bf16": 0}
    for kind in ("int4", "bf16", "bf16", "int4"):
        base = int4 if kind == "int4" else bf16
        a, _, _, st = setup(base)
        st(a, base, toks)                       # warm
        for _ in range(QLORA_TIMED):
            _, peak, secs = _step_peak(lambda: st(a, base, toks).item())
            turns[kind].append(secs * 1e3)
            peaks[kind] = max(peaks[kind], peak)
    med = {k: statistics.median(v) for k, v in turns.items()}
    report = {"adapter_params": lora.count_params(ad),
              "base_params": lora.count_params(bf16),
              "base_bytes": quantized_nbytes(int4),
              "checkpoint_bytes": ck_bytes, "t0_max_abs_err": t0_err,
              "losses": losses, "ms": turns, "ms_median": med,
              "peak_bytes": peaks, "int4_over_bf16": med["int4"]
              / med["bf16"]}
    log(f"qlora (Llama-3-8B widths, 2 layers, rank {QLORA_RANK}, seq "
        f"{toks.shape[1]}, batch {toks.shape[0]}, flash): "
        f"{report['adapter_params']} adapter parameters over "
        f"{report['base_params']} base (int4 base bytes "
        f"{report['base_bytes']}); t=0 logits' largest difference from "
        f"the base {t0_err}; losses {[round(x, 4) for x in losses]}; adapter "
        f"checkpoint {ck_bytes} B resumed bitwise; ms a step int4 "
        f"{med['int4']:.2f} {[round(x, 2) for x in turns['int4']]}, bf16 "
        f"{med['bf16']:.2f} {[round(x, 2) for x in turns['bf16']]} = "
        f"{report['int4_over_bf16']:.3f}x; step peak int4 "
        f"{peaks['int4'] / 2**20:.1f} MiB, bf16 {peaks['bf16'] / 2**20:.1f}"
        " MiB")
    return report


def _train_lm_triad(dev):
    """``python -m nvme_strom_tpu_torch.train_lm`` with the moments and
    the layer inputs on NVMe over a 3:1 mixture, warmup + cosine and a
    clip, 2 steps, then resumed to 3."""
    import shutil
    from nvme_strom_tpu_torch.train_lm import synthesize_shards
    root = os.path.join(DATA_DIR, "triad")
    shutil.rmtree(root, ignore_errors=True)
    for i, name in enumerate("AB"):
        os.makedirs(os.path.join(root, name))
        synthesize_shards(os.path.join(root, name), 32000, 2048,
                          n_shards=2, per_shard=16, seed=SEED + i)
    args = [sys.executable, "-m", "nvme_strom_tpu_torch.train_lm",
            "--flash", "--save-every", "2",
            "--mix", f"{root}/A:3,{root}/B:1",
            "--offload-opt", f"{root}/opt", "--remat", "nvme",
            "--offload-acts", f"{root}/acts", "--lr-schedule", "cosine",
            "--warmup-steps", "2", "--grad-clip", "1.0",
            "--ckpt-dir", f"{root}/ckpt"]
    out = {}
    for steps in (2, 3):
        t0 = time.monotonic()
        r = subprocess.run(args + ["--steps", str(steps)], cwd=ROOT,
                           capture_output=True, text=True, timeout=600)
        secs = time.monotonic() - t0
        if r.returncode != 0:
            raise AssertionError(f"train_lm --steps {steps} exited "
                                 f"{r.returncode}: {r.stderr[-3000:]}")
        lines = [x for x in r.stdout.splitlines()
                 if x.startswith(("offload", "resumed", "engine stats"))
                 or " steps in " in x]
        out[steps] = {"seconds": secs, "lines": lines}
        log(f"train_lm triad --steps {steps}: {secs:.1f} s; {lines}")
    if not any("resumed from step 2" in x for x in out[3]["lines"]):
        raise AssertionError(f"the rerun did not resume: {out[3]}")
    return out


def train_offload_phase(dev):
    """Training beyond device memory at flagship widths: the remat sweep
    at 16 layers, ``OffloadedAdam`` against in-HBM AdamW, QLoRA at
    Llama-3-8B widths, and the train_lm triad."""
    import numpy as np
    import torch
    from nvme_strom_tpu_torch.models.transformer import flagship_config
    from nvme_strom_tpu_torch.ops.flash_attention import make_flash_attn
    t0 = time.monotonic()
    flagship = flagship_config()
    rng = np.random.default_rng(SEED)

    def tokens(b, vocab):
        return torch.from_numpy(rng.integers(
            0, vocab, (b, TRAIN_SEQ), dtype=np.int64)).to(dev)
    attn = make_flash_attn()
    report = {"remat": _remat_sweep(dev, flagship,
                                    tokens(TRAIN_BATCH, flagship.vocab),
                                    attn)}
    torch.cuda.empty_cache()
    report["offload_opt"] = _opt_offload(
        dev, flagship, [tokens(TRAIN_BATCH, flagship.vocab)
                        for _ in range(OPT_STEPS)], attn)
    torch.cuda.empty_cache()
    report["qlora"] = _qlora(dev, tokens(QLORA_BATCH, 32000))
    torch.cuda.empty_cache()
    report["triad"] = _train_lm_triad(dev)
    report["seconds"] = time.monotonic() - t0
    return report


# -- the zero-copy data formats, mixtures and the prefetch --------------------

FORMAT_SAMPLES = 8192           # 8 KiB int32 samples: 64 MiB
FORMAT_SHARDS = 8
MIX_DRAWS = 256


def _format_epoch(shards, fmt, eng, dev, decode=None):
    """One unshuffled epoch at batch 8: (batches joined on the card, GiB/s,
    host CPU s, counter deltas, h2d launches, pieces)."""
    import torch
    from nvme_strom_tpu_torch.data.loader import ShardedLoader
    from nvme_strom_tpu_torch.ops.bridge import h2d_copy
    eng.sync_stats()
    s0 = eng.stats.snapshot()
    h0 = h2d_copy.launches
    c0, t0 = time.process_time(), time.monotonic()
    with ShardedLoader(shards, TRAIN_BATCH, fmt=fmt, decode=decode,
                       engine=eng, device=dev) as ld:
        out = [b.reshape(TRAIN_BATCH, -1).view(torch.int32).clone()
               for b in ld]
        pieces = ld.pieces_copied
    torch.cuda.synchronize()
    secs, cpu = time.monotonic() - t0, time.process_time() - c0
    eng.sync_stats()
    s1 = eng.stats.snapshot()
    d = {k: s1[k] - s0[k] for k in ("bytes_direct", "bytes_fallback",
                                    "bounce_bytes", "bytes_to_device")}
    got = torch.cat(out)
    return got, {"gib_s": got.numel() * 4 / secs / 2**30, "seconds": secs,
                 "cpu_s": cpu, "stats": d,
                 "h2d_launches": h2d_copy.launches - h0, "pieces": pieces}


def data_formats_phase(dev, training):
    """64 MiB of seeded token samples at seq 2048 as wds, tfrecord and
    fixedrec shards (wds_raw reads the wds shards: one member a sample,
    a constant stride); one epoch of each, batches bitwise the wds
    path's; the mixture's draws; the overlapping prefetch."""
    import shutil
    import numpy as np
    import torch
    from nvme_strom_tpu_torch.data.loader import ShardedLoader
    from nvme_strom_tpu_torch.data.mixture import MixtureLoader
    from nvme_strom_tpu_torch.data.prefetch import prefetch_to_device
    from nvme_strom_tpu_torch.formats.fixedrec import write_fixedrec
    from nvme_strom_tpu_torch.formats.tfrecord import write_tfrecords
    from nvme_strom_tpu_torch.formats.wds import write_wds_shard
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.ops.bridge import h2d_copy, side_stream
    root = os.path.join(DATA_DIR, "formats")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    rows = np.random.default_rng(SEED).integers(
        0, 32000, (FORMAT_SAMPLES, TRAIN_SEQ), dtype=np.int32)
    per = FORMAT_SAMPLES // FORMAT_SHARDS
    paths = {"wds": [], "tfrecord": [], "fixedrec": []}
    t0 = time.monotonic()
    for s in range(FORMAT_SHARDS):
        part = rows[s * per:(s + 1) * per]
        p = os.path.join(root, f"s{s:02d}")
        write_wds_shard(p + ".tar", [{"bin": r.tobytes()} for r in part])
        write_tfrecords(p + ".tfrecord", (r.tobytes() for r in part))
        write_fixedrec(p + ".sfr", part)
        paths["wds"].append(p + ".tar")
        paths["tfrecord"].append(p + ".tfrecord")
        paths["fixedrec"].append(p + ".sfr")
    write_s = time.monotonic() - t0

    def decode(parts):
        (payload,) = parts.values()
        return np.frombuffer(payload, dtype=np.int32)
    report = {"write_s": write_s, "bytes": rows.nbytes}
    with StromEngine() as eng:
        ref, report["wds"] = _format_epoch(paths["wds"], "wds", eng, dev,
                                           decode)
        if not torch.equal(ref.cpu(), torch.from_numpy(rows)):
            raise AssertionError("the wds epoch is not the data")
        for name, fmt, shards, dec in (
                ("tfrecord", "tfrecord", paths["tfrecord"], decode),
                ("fixedrec", "fixedrec", paths["fixedrec"], None),
                ("wds_raw", "wds_raw", paths["wds"], None)):
            got, r = _format_epoch(shards, fmt, eng, dev, dec)
            if not torch.equal(got, ref):
                raise AssertionError(f"{name} batches differ from wds's")
            if dec is None:
                st = r["stats"]
                if r["h2d_launches"] != r["pieces"]:
                    raise AssertionError(f"{name}: {r['h2d_launches']} "
                                         f"h2d launches for "
                                         f"{r['pieces']} pieces")
                if st["bytes_fallback"] == 0 and st["bounce_bytes"]:
                    raise AssertionError(f"{name}: direct reads bounced "
                                         f"{st}")
            report[name] = r
            del got
        for name in ("wds", "tfrecord", "fixedrec", "wds_raw"):
            r = report[name]
            log(f"formats {name}: one epoch ({rows.nbytes} B, batch "
                f"{TRAIN_BATCH}) {r['gib_s']:.3f} GiB/s in "
                f"{r['seconds']:.2f} s, host CPU {r['cpu_s']:.2f} s, "
                f"h2d launches {r['h2d_launches']}, pieces "
                f"{r['pieces']}, {r['stats']}")
        # the mixture: sources 3:1 over the fixedrec shards' two halves
        half = FORMAT_SHARDS // 2
        with ShardedLoader(paths["fixedrec"][:half], TRAIN_BATCH,
                           fmt="fixedrec", engine=eng, device=dev) as a, \
                ShardedLoader(paths["fixedrec"][half:], TRAIN_BATCH,
                              fmt="fixedrec", engine=eng,
                              device=dev) as b:
            mix = MixtureLoader([(a, 3.0), (b, 1.0)], seed=0)
            it = iter(mix)
            seq = [next(it)[1] for _ in range(MIX_DRAWS)]
            it.close()
        want = [int(np.random.default_rng((0, t)).choice(
            2, p=[0.75, 0.25])) for t in range(MIX_DRAWS)]
        if seq != want or mix.counts != [want.count(0), want.count(1)]:
            raise AssertionError(f"mixture draws {seq[:16]}... != "
                                 f"{want[:16]}...")
        report["mixture"] = {"counts": mix.counts, "draws": MIX_DRAWS}
        log(f"formats mixture: {MIX_DRAWS} draws at 3:1 equal numpy's "
            f"default_rng((0, step)); counts {mix.counts}")
    # the prefetch: host batches copied on the side stream while the
    # consumer's stream is held, bitwise the loader's
    host = [rows[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH] for i in range(64)]
    for _ in prefetch_to_device(iter(host[:4]), size=2, device=dev):
        pass
    torch.cuda.synchronize()
    cur, side = torch.cuda.current_stream(dev), side_stream(dev)
    torch.cuda._sleep(1 << 28)
    h0 = h2d_copy.launches
    it = prefetch_to_device(iter(host), size=2, device=dev)
    first = next(it)
    side.synchronize()
    # the first pull keeps two batches ahead after the one it yields
    on_side = h2d_copy.launches - h0 == 3 and not cur.query()
    got = torch.cat([first] + list(it))
    torch.cuda.synchronize()
    if not on_side:
        raise AssertionError("the prefetch copies did not run beside the "
                             "consumer's stream")
    if not torch.equal(got, ref[:64 * TRAIN_BATCH]):
        raise AssertionError("prefetched batches differ from the loader's")
    busy = training["profile"]["device_busy_share"]
    report["prefetch"] = {"batches": 64, "on_side_stream": on_side}
    report["train_device_busy_share"] = busy
    log(f"formats prefetch: 64 host batches copied on the side stream "
        f"while the consumer's stream spun, bitwise the loader's; train "
        f"steps 11-12 device busy {busy:.4f}")
    shutil.rmtree(root, ignore_errors=True)
    return report


# -- speculative decoding, the ViT trainer, eval_ppl, attribution ------------

SPEC_PROMPT = 128
SPEC_NEW = 64
SPEC_K = 4
#: bf16 tok/s turns: speculative (flagship draft, kernel 2) against the
#: target's own decode on kernel 2
SPEC_ORDER = ("spec", "plain", "plain", "spec")


def _spec_run(draft, target, prompt, cfg, dcfg, cache_attn):
    """One greedy speculative decode: (tokens, SpecStats, seconds)."""
    import torch
    from nvme_strom_tpu_torch.models.speculative import (SpecStats,
                                                         speculative_generate)
    st = SpecStats()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = speculative_generate(draft, target, prompt, cfg, SPEC_NEW,
                               k=SPEC_K, draft_cfg=dcfg, stats=st,
                               cache_attn=cache_attn)
    torch.cuda.synchronize()
    return out, st, time.monotonic() - t0


def _spec_report(st, secs):
    return {"target_forwards": st.target_forwards, "drafted": st.drafted,
            "accepted": st.accepted, "accept_rate": st.accept_rate,
            "seconds": secs, "tok_per_s": SPEC_NEW / secs}


def speculative_phase(dev, flagship):
    """Greedy speculative decoding with the draft's steps on kernel 2
    (``cache_attn=decode_attention``): the target is Llama-3-8B's widths
    at 2 layers (``LLAMA3_8B_2L``), the draft the flagship (same 32000
    vocabulary), a SPEC_PROMPT-token prompt, SPEC_NEW new tokens, k
    SPEC_K, batch 1, seeded random weights made on the card.
    1. float32, TF32 off: the tokens must equal the target's own greedy
       ``decode.generate`` on the dense path, for the flagship draft and
       for a self draft, whose acceptance must be >= 0.9 with at most
       ceil((SPEC_NEW - 1) / SPEC_K) + 1 target forwards (a near-tie the
       draft's kernel and the dense verify order differently costs a
       round, never a token);
    2. bf16: speculative against ``decode.generate`` on kernel 2, in
       turns (SPEC_ORDER), tok/s of each and the tokens that differ
       (the k+1-row verify and one-row steps may round apart in bf16)."""
    import dataclasses
    import math
    import numpy as np
    import torch
    from nvme_strom_tpu_torch.models import decode as dec
    from nvme_strom_tpu_torch.models.transformer import TransformerConfig
    from nvme_strom_tpu_torch.ops.decode_attention import decode_attention
    t_phase = time.monotonic()
    tcfg = TransformerConfig(**LLAMA3_8B_2L)
    prompt = torch.from_numpy(np.random.default_rng(SEED + 16).integers(
        0, tcfg.vocab, (1, SPEC_PROMPT)).astype(np.int32)).to(dev)
    report = {"f32": {}, "bf16": {}}
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t32 = dataclasses.replace(tcfg, dtype=torch.float32)
        d32 = dataclasses.replace(flagship, dtype=torch.float32)
        target = _card_params(t32, SEED + 16, dev)
        draft = _card_params(d32, SEED + 17, dev)
        want = dec.generate(target, prompt, t32, SPEC_NEW)
        for label, dp, dc in (("flagship draft", draft, d32),
                              ("self draft", target, t32)):
            got, st, secs = _spec_run(dp, target, prompt, t32, dc,
                                      decode_attention)
            differ = int((got != want).sum())
            report["f32"][label] = dict(_spec_report(st, secs),
                                        tokens_differ=differ)
            log(f"speculative f32 {label}: {report['f32'][label]}")
            if differ:
                raise AssertionError(f"speculative f32 {label}: {differ} "
                                     "tokens differ from decode.generate")
        selfd = report["f32"]["self draft"]
        bound = math.ceil((SPEC_NEW - 1) / SPEC_K) + 1
        if selfd["accept_rate"] < 0.9 or selfd["target_forwards"] > bound:
            raise AssertionError(f"speculative self draft: {selfd} (want "
                                 f"accept >= 0.9, forwards <= {bound})")
        del target, draft, want
        torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    target = _card_params(tcfg, SEED + 16, dev)
    draft = _card_params(flagship, SEED + 17, dev)
    # warm both paths (cuBLAS handles, the allocator) once, untimed
    _spec_run(draft, target, prompt, tcfg, flagship, decode_attention)
    dec.generate(target, prompt, tcfg, SPEC_NEW, cache_attn=decode_attention)
    tps = {"spec": [], "plain": []}
    outs = {}
    for mode in SPEC_ORDER:
        if mode == "spec":
            outs[mode], st, secs = _spec_run(draft, target, prompt, tcfg,
                                             flagship, decode_attention)
            report["bf16"]["spec_stats"] = _spec_report(st, secs)
        else:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            outs[mode] = dec.generate(target, prompt, tcfg, SPEC_NEW,
                                      cache_attn=decode_attention)
            torch.cuda.synchronize()
            secs = time.monotonic() - t0
        tps[mode].append(SPEC_NEW / secs)
    differ = int((outs["spec"] != outs["plain"]).sum())
    ratio = float(np.median(tps["spec"]) / np.median(tps["plain"]))
    report["bf16"].update(tok_per_s=tps, tokens_differ=differ,
                          spec_over_plain=ratio)
    report["seconds"] = time.monotonic() - t_phase
    log(f"speculative bf16 (turns {SPEC_ORDER}): tok/s {tps}, spec / plain "
        f"{ratio:.3f}, {differ} of {SPEC_NEW} tokens differ; stats "
        f"{report['bf16']['spec_stats']}; phase {report['seconds']:.1f} s")
    return report


VIT_BATCH = 64
VIT_STEPS = 20
VIT_SHARDS = 4
#: the card's float32 logits against the CPU's float32 forward, over the
#: first VIT_CPU_ROWS images of the first batch
VIT_F32_TOL = (1e-3, 1e-3)
VIT_BF16_TOL = (2e-2, 2e-2)
VIT_CPU_ROWS = 8


def vit_phase(dev):
    """The reference ViT's default widths (224², patch 16, d 384, 6
    layers, 6 heads, d_ff 1536, 1000 classes, bf16) on fixedrec shards
    of 150,532-byte records (image ++ int32 label) under DATA_DIR/vit,
    through the loader's zero-copy path:
    1. one epoch of the loader alone: GiB/s, one h2d_copy a piece,
       ``bounce_bytes`` 0;
    2. the first batch decoded on the card: float32 logits (TF32 off)
       within VIT_F32_TOL of a float32 CPU forward of the same params on
       its first VIT_CPU_ROWS images; the bf16 logits' error against it
       reported, with the count past VIT_BF16_TOL;
    3. VIT_STEPS AdamW steps of batch VIT_BATCH, decode on the card:
       img/s, every loss finite, launches = pieces;
    4. two more steps under torch.profiler: the device-busy share."""
    import dataclasses
    import shutil
    import numpy as np
    import torch
    from nvme_strom_tpu_torch import train_vit
    from nvme_strom_tpu_torch.data.loader import ShardedLoader
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.models.transformer import (adamw,
                                                         trainable_params)
    from nvme_strom_tpu_torch.models.vit import (ViTConfig, init_vit_params,
                                                 make_vit_train_step,
                                                 vit_forward)
    from nvme_strom_tpu_torch.ops.bridge import h2d_copy
    t_phase = time.monotonic()
    cfg = ViTConfig()
    img_bytes = cfg.channels * cfg.image_size ** 2
    if img_bytes + 4 != 150532:
        raise AssertionError(f"record bytes {img_bytes + 4}")
    vdir = os.path.join(DATA_DIR, "vit")
    shutil.rmtree(vdir, ignore_errors=True)
    os.makedirs(vdir)
    t0 = time.monotonic()
    shards = train_vit.synthesize_shards(
        vdir, img_bytes, cfg.n_classes, VIT_SHARDS,
        VIT_BATCH * VIT_STEPS // VIT_SHARDS, seed=SEED)
    report = {"write_s": time.monotonic() - t0,
              "record_bytes": img_bytes + 4}
    np_params = init_vit_params(SEED, cfg)
    with StromEngine() as eng:
        eng.cuda_mapping(dev.index)

        def epoch(consume):
            eng.sync_stats()
            b0, h0 = eng.stats.bounce_bytes, h2d_copy.launches
            t0 = time.monotonic()
            with ShardedLoader(shards, VIT_BATCH, fmt="fixedrec",
                               engine=eng, device=dev) as ld:
                n = 0
                for rec in ld:
                    consume(n, rec)
                    n += 1
                torch.cuda.synchronize()
                pieces = ld.pieces_copied
            secs = time.monotonic() - t0
            eng.sync_stats()
            launches = h2d_copy.launches - h0
            bounce = eng.stats.bounce_bytes - b0
            if launches != pieces or bounce or n != VIT_STEPS:
                raise AssertionError(f"vit epoch: {n} batches, {launches} "
                                     f"h2d_copy launches for {pieces} "
                                     f"pieces, bounce {bounce}")
            return {"batches": n, "seconds": secs, "pieces": pieces,
                    "h2d_launches": launches, "bounce_bytes": bounce}

        first = []
        report["loader"] = epoch(
            lambda i, rec: first.append(rec.clone()) if i == 0 else None)
        report["loader"]["gib_per_s"] = (
            VIT_STEPS * VIT_BATCH * (img_bytes + 4)
            / report["loader"]["seconds"] / 2**30)
        # 2. logits of the first batch against the CPU
        imgs, _ = train_vit.decode_records(first[0], cfg)
        c32 = dataclasses.replace(cfg, dtype=torch.float32)
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            params = trainable_params(np_params, dev)
            with torch.no_grad():
                x = imgs[:VIT_CPU_ROWS].float()
                card32 = vit_forward(params, x, c32).cpu()
                card16 = vit_forward(params, imgs[:VIT_CPU_ROWS],
                                     cfg).cpu()
                cpu32 = vit_forward(
                    trainable_params(np_params, torch.device("cpu")),
                    x.cpu(), c32)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        rtol, atol = VIT_BF16_TOL
        err16 = (card16 - cpu32).abs()
        report["logits"] = {
            "f32_max_abs_err": float((card32 - cpu32).abs().max()),
            "bf16_max_abs_err": float(err16.max()),
            "bf16_past_tol": int((err16 > atol + rtol * cpu32.abs()).sum()),
            "n": int(cpu32.numel())}
        torch.testing.assert_close(card32, cpu32, rtol=VIT_F32_TOL[0],
                                   atol=VIT_F32_TOL[1])
        # 3. the training steps
        step = make_vit_train_step(cfg, adamw(params, 1e-3))
        losses = []
        report["train"] = epoch(lambda i, rec: losses.append(
            step(params, *train_vit.decode_records(rec, cfg))))
        losses = [float(x) for x in losses]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"vit losses {losses}")
        secs = report["train"]["seconds"]
        report["train"].update(losses=losses,
                               img_per_s=VIT_STEPS * VIT_BATCH / secs)
        # 4. two steps profiled
        batches = first * 2

        def run(done):
            for rec in batches:
                step(params, *train_vit.decode_records(rec, cfg))
            done()
        prof = profile_run(run, "vit, 2 steps")
        report["busy_share"] = prof["device_busy_share"]
        report["top_kernels"] = prof["top_kernels"]
    report["seconds"] = time.monotonic() - t_phase
    log(f"vit: loader {report['loader']['gib_per_s']:.3f} GiB/s "
        f"({report['loader']}); logits {report['logits']}; train "
        f"{report['train']['img_per_s']:.1f} img/s, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; busy "
        f"{report['busy_share']:.3f}; phase {report['seconds']:.1f} s")
    return report


EVAL_ROWS = 16
EVAL_SEQ = 1024
EVAL_BATCH = 4
EVAL_BATCHES = 2
EVAL_CE_RTOL = 1e-3


def _eval_main(args):
    """``eval_ppl.main(args)`` with its output captured: (cross-entropy,
    perplexity, bounce bytes, output)."""
    import contextlib
    import io
    import re
    from nvme_strom_tpu_torch import eval_ppl
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = eval_ppl.main(args)
    out = buf.getvalue()
    if rc != 0:
        raise AssertionError(f"eval_ppl {args}: rc {rc}\n{out}")
    ce = float(re.search(r"cross-entropy: ([\d.]+)", out).group(1))
    ppl = float(re.search(r"perplexity: ([\d.]+)", out).group(1))
    bounce = int(re.search(r"bounce=(\d+)", out).group(1))
    return ce, ppl, bounce, out


def eval_ppl_phase(dev, ckdir):
    """``python -m nvme_strom_tpu_torch.eval_ppl --npy`` in process over
    the flagship's serving weights (``ckdir``) and EVAL_ROWS rows of
    EVAL_SEQ seeded token ids, EVAL_BATCHES batches of EVAL_BATCH rows,
    each batch streamed NVMe → h2d_copy: in float32 on the card (TF32
    off) and on the CPU, whose cross-entropies must agree within
    EVAL_CE_RTOL relative; then bf16, --int8 and --int4 on the card.
    Every card run's ``bounce_bytes`` is 0."""
    import numpy as np
    import torch
    t_phase = time.monotonic()
    edir = os.path.join(DATA_DIR, "eval")
    os.makedirs(edir, exist_ok=True)
    path = os.path.join(edir, "tokens.npy")
    np.save(path, np.random.default_rng(SEED + 18).integers(
        0, 32000, (EVAL_ROWS, EVAL_SEQ)).astype(np.int32))
    base = ["--weights", ckdir, "--npy", path, "--batch", str(EVAL_BATCH),
            "--batches", str(EVAL_BATCHES)]
    runs = {"card f32": ["--dtype", "float32", "--device", "cuda:0"],
            "cpu f32": ["--dtype", "float32", "--device", "cpu"],
            "card bf16": ["--device", "cuda:0"],
            "card int8": ["--int8", "--device", "cuda:0"],
            "card int4": ["--int4", "--device", "cuda:0"]}
    report = {}
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for label, extra in runs.items():
            t0 = time.monotonic()
            ce, ppl, bounce, _ = _eval_main(base + extra)
            report[label] = {"cross_entropy": ce, "perplexity": ppl,
                             "bounce_bytes": bounce,
                             "seconds": time.monotonic() - t0}
            log(f"eval_ppl {label}: {report[label]}")
            if label.startswith("card") and bounce:
                raise AssertionError(f"eval_ppl {label}: bounce {bounce}")
            if not math.isfinite(ce):
                raise AssertionError(f"eval_ppl {label}: ce {ce}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    a, b = report["card f32"]["cross_entropy"], \
        report["cpu f32"]["cross_entropy"]
    report["f32_rel_diff"] = abs(a - b) / abs(b)
    if report["f32_rel_diff"] > EVAL_CE_RTOL:
        raise AssertionError(f"eval_ppl: card {a} against cpu {b}")
    report["seconds"] = time.monotonic() - t_phase
    log(f"eval_ppl: card / cpu float32 cross-entropy {a} / {b} (rel "
        f"{report['f32_rel_diff']:.2e}); phase {report['seconds']:.1f} s")
    return report


#: tok/s turns with attribution on and off (the collector a sink of the
#: store engine's tracer, or detached)
ATTRIB_ORDER = ("on", "off", "off", "on")
ATTRIB_ROUTES = ("/", "/metrics", "/attrib", "/ledger", "/flight",
                 "/health", "/locks")


def attrib_phase(dev, cfg, params, shared):
    """Critical-path attribution and the debug server on the prefix
    store's NVMe hit (a copy of prefix_store_phase's cold store), both
    servers, under STROM_ATTRIB=1 and STROM_DEBUG_PORT=0:
    1. attribution on and off in turns (ATTRIB_ORDER) on each server:
       tokens equal the prefix store's NVMe-hit tokens either way; every
       request retired with it on folds, with coverage + unattributed
       within 1% of its wall; ``nvme_read`` and ``bridge`` nonzero over
       the decode class; ``attrib_spans_dropped`` reported; tok/s of
       each mode;
    2. every debug route answers 200 and parses, ``/health`` with the
       ``boot_phase`` and ``drain_phase`` keys;
    3. a flight dump carries ``attrib``."""
    import urllib.request
    import numpy as np
    import torch
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.models.kv_offload import PrefixStore
    from nvme_strom_tpu_torch.models.serving import (DecodeServer,
                                                     PagedDecodeServer)
    from nvme_strom_tpu_torch.obs import attrib, debugsrv
    from nvme_strom_tpu_torch.utils.trace import Tracer
    t_phase = time.monotonic()
    pre = shared["prefix"]
    requests, hit = pre["requests"], pre["hit_tokens"]
    P = PREFIX_PAGE_TOKENS
    path = os.path.join(DATA_DIR, "kv_store", "attrib.kvstore")
    _copy_store(pre["store"], path, 1 << 20)
    saved = {k: os.environ.get(k) for k in ("STROM_ATTRIB",
                                            "STROM_DEBUG_PORT")}
    os.environ.update(STROM_ATTRIB="1", STROM_DEBUG_PORT="0")
    attrib.reset()
    debugsrv.reset()
    tracer = Tracer()
    report = {"runs": {}}
    try:
        with StromEngine(tracer=tracer) as eng:
            eng.cuda_mapping(dev.index)
            col = attrib.get_collector()
            if col is None or eng._attrib is not col or \
                    eng._debug_srv is None:
                raise AssertionError("STROM_ATTRIB / STROM_DEBUG_PORT "
                                     "did not attach")
            st = PrefixStore(cfg, eng, path, P, PREFIX_STORE_BYTES)
            makers = {
                "dense": lambda: DecodeServer(params, cfg, PREFIX_REQUESTS,
                                              2048, device=dev, kv_store=st),
                "paged": lambda: PagedDecodeServer(
                    params, cfg, PREFIX_REQUESTS, 2048, total_blocks=128,
                    block_len=P, device=dev, kv_store=st)}
            tps = {f"{k} {m}": [] for k in makers for m in ("on", "off")}
            for trial, mode in enumerate(ATTRIB_ORDER):
                for kind, make in makers.items():
                    if mode == "on":
                        tracer.add_sink(col.sink)
                    else:
                        tracer.remove_sink(col.sink)
                    n0 = col.requests
                    toks, rep = store_run(f"attrib {kind} {mode} (trial "
                                          f"{trial})", make(), requests, eng,
                                          st)
                    if toks != hit:
                        raise AssertionError(f"attrib {kind} {mode}: tokens "
                                             "differ from the NVMe hit's")
                    folds = list(col._recent)[-(col.requests - n0):] \
                        if col.requests > n0 else []
                    want = len(requests) if mode == "on" else 0
                    if len(folds) != want:
                        raise AssertionError(f"attrib {kind} {mode}: "
                                             f"{len(folds)} folds, want "
                                             f"{want}")
                    for f in folds:
                        if abs(f["coverage_us"] + f["unattributed_us"]
                               - f["wall_us"]) > 0.01 * f["wall_us"]:
                            raise AssertionError(f"attrib fold {f}")
                    tps[f"{kind} {mode}"].append(rep["tok_per_s"])
                    if mode == "on":
                        report["runs"].setdefault(kind, []).append({
                            "wall_us": [f["wall_us"] for f in folds],
                            "components": {c: sum(f["components"][c]
                                                  for f in folds)
                                           for c in attrib.COMPONENTS},
                            "unattributed_us": sum(f["unattributed_us"]
                                                   for f in folds)})
            tracer.add_sink(col.sink)
            prof = col.profiles()
            comps = prof["classes"]["decode"]["components"]
            if not (comps["nvme_read"]["total_us"] > 0
                    and comps["bridge"]["total_us"] > 0):
                raise AssertionError(f"attrib: no nvme_read / bridge time "
                                     f"{comps}")
            eng.sync_stats()
            report["profiles"] = prof
            report["attrib_spans_dropped"] = eng.stats.attrib_spans_dropped
            report["tok_per_s"] = tps
            report["on_over_off"] = {
                k: float(np.median(tps[f"{k} on"])
                         / np.median(tps[f"{k} off"])) for k in makers}
            # 2. the debug routes on the live engine
            port = eng._debug_srv.port
            routes = {}
            for route in ATTRIB_ROUTES:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}{route}", timeout=10) as r:
                    body = r.read().decode()
                    if r.status != 200:
                        raise AssertionError(f"{route}: {r.status}")
                if route == "/metrics":
                    if not body.rstrip().endswith("# EOF"):
                        raise AssertionError("/metrics: no # EOF")
                    routes[route] = len(body)
                    continue
                doc = json.loads(body)
                if "error" in doc:
                    raise AssertionError(f"{route}: {doc}")
                routes[route] = sorted(doc)[:12]
            health = json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{port}/health", timeout=10).read())
            if "boot_phase" not in health or "drain_phase" not in health:
                raise AssertionError(f"/health: {health}")
            report["routes"] = routes
            # 3. a flight dump with the attribution summary
            dump = eng.flight.dump("attrib_check", force=True)
            with open(dump) as f:
                doc = json.load(f)
            if "attrib" not in doc or not doc["attrib"]["requests"]:
                raise AssertionError(f"flight dump without attrib: "
                                     f"{sorted(doc)}")
            report["flight_dump"] = {"path": os.path.basename(dump),
                                     "attrib_requests":
                                         doc["attrib"]["requests"]}
            st.close()
            torch.cuda.synchronize()
    finally:
        tracer._sinks.clear()
        attrib.reset()
        debugsrv.reset()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    shares = {c: v["share"] for c, v in comps.items()}
    report["shares"] = shares
    report["seconds"] = time.monotonic() - t_phase
    log(f"attrib: decode shares {shares}; spans dropped "
        f"{report['attrib_spans_dropped']}; tok/s {tps}; on / off "
        f"{report['on_over_off']}; routes {report['routes']}; phase "
        f"{report['seconds']:.1f} s")
    return report


# -- strom-lint and the lock-order witness on the serving path --------------

#: the phase's wall-clock budget (s), and the host tier's MiB in (b)
LINT_BUDGET_S = 40
LINT_TIER_MB = 256
#: the kernels (b)'s serving path launches
LINT_KERNELS = ("h2d_copy", "decode_attention", "paged_attention")


def _exported_entry_points(path):
    """The ``strom_*`` functions a built library exports (``nm -D``)."""
    import subprocess
    out = subprocess.run(["nm", "-D", "--defined-only", str(path)],
                         capture_output=True, text=True, check=True).stdout
    names = set()
    for ln in out.splitlines():
        f = ln.split()
        if len(f) >= 3 and f[1] in "TtWw" and f[2].startswith("strom_"):
            names.add(f[2])
    return names


def lint_phase(dev, cfg, params):
    """(a) ``python -m nvme_strom_tpu_torch.tools.strom_lint`` over the
    checkout exits 0, once the kernel library has built, and every entry
    point the ABI pass reads from ``nvme_strom_tpu_torch/csrc/*.cu`` is a
    function the built ``libstrom_torch_kernels.so`` exports, with no
    ``strom_*`` export left over;
    (b) under the lock-order witness in strict mode
    (``STROM_LOCK_WITNESS=strict``, armed for the part): the default
    engine (its rings and the QoS scheduler) with a host tier of
    LINT_TIER_MB, the prefix store's chat traffic through
    ``PagedDecodeServer`` cold, then its NVMe hit (pages restored through
    ``h2d_copy``), then ``DecodeServer``'s NVMe hit; both hits' tokens
    equal.  Every lock built in the part is witnessed and a cycle raises
    where it closes.  Reports the witness's edges, its cycles (0) and the
    debug server's ``/locks`` answer."""
    import io
    import urllib.request
    from contextlib import redirect_stdout
    from pathlib import Path
    import torch
    from nvme_strom_tpu_torch import _build
    from nvme_strom_tpu_torch.analysis.cabi import parse_kernel_sources
    from nvme_strom_tpu_torch.analysis.driver import default_kernel_sources
    from nvme_strom_tpu_torch.io import hostcache
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.models.kv_offload import PrefixStore
    from nvme_strom_tpu_torch.models.serving import (DecodeServer,
                                                     PagedDecodeServer)
    from nvme_strom_tpu_torch.obs import debugsrv
    from nvme_strom_tpu_torch.tools import strom_lint
    from nvme_strom_tpu_torch.utils import lockwitness
    from nvme_strom_tpu_torch.utils.config import HostCacheConfig
    t_phase = time.monotonic()
    report = {}
    # (a) the static passes, and the ABI pass against the built library
    _build.kernel_library()
    buf = io.StringIO()
    t0 = time.monotonic()
    with redirect_stdout(buf):
        rc = strom_lint.main(["--json"])
    lint = json.loads(buf.getvalue())
    report["lint_s"] = time.monotonic() - t0
    if rc != 0 or lint["n_active"]:
        raise AssertionError(f"strom_lint exit {rc}: " + "; ".join(
            f"{v['file']}:{v['line']}: [{v['check']}] {v['message']}"
            for v in lint["violations"] if not v["waived"]))
    parsed = set(parse_kernel_sources(
        default_kernel_sources(Path(ROOT))).funcs)
    exported = _exported_entry_points(
        _build.BUILD_DIR / "libstrom_torch_kernels.so")
    if parsed != exported:
        raise AssertionError(f"kernel entry points: parsed but not "
                             f"exported {sorted(parsed - exported)}; "
                             f"exported but not parsed "
                             f"{sorted(exported - parsed)}")
    report["a"] = {"exit": rc, "checks": lint["checks_run"],
                   "waived": lint["n_waived"],
                   "entry_points": len(parsed)}
    log(f"lint (a): strom_lint exit {rc} in {report['lint_s']:.2f} s "
        f"({lint['n_waived']} waived); {len(parsed)} kernel entry points "
        f"parsed, all exported by the built library, none left over")
    # (b) the serving path under the witness, strict
    requests = prefix_requests(cfg.vocab)
    path = os.path.join(DATA_DIR, "kv_store", "lint.kvstore")
    for p in (path, path + ".kvman.json"):
        if os.path.exists(p):
            os.remove(p)
    P = PREFIX_PAGE_TOKENS
    with _env(STROM_LOCK_WITNESS="strict"), \
            lockwitness.armed_scope() as w:
        with StromEngine() as eng:
            srv_http = None
            try:
                if eng.scheduler is None:
                    raise AssertionError("lint (b): the default engine has no "
                                         "QoS scheduler")
                cache = hostcache.configure(
                    HostCacheConfig(budget_mb=LINT_TIER_MB), engine=eng)
                eng.cuda_mapping(dev.index)
                cache.arena.cuda.mapping(dev.index)
                st = PrefixStore(cfg, eng, path, P, PREFIX_STORE_BYTES)
                _, rep_cold = store_run(
                    "lint paged cold", PagedDecodeServer(
                        params, cfg, PREFIX_REQUESTS, 2048, total_blocks=128,
                        block_len=P, device=dev, kv_store=st),
                    requests, eng, st)
                st.close()
                st = PrefixStore(cfg, eng, path, P, PREFIX_STORE_BYTES)
                paged_hit, rep_hit = store_run(
                    "lint paged NVMe hit", PagedDecodeServer(
                        params, cfg, PREFIX_REQUESTS, 2048, total_blocks=128,
                        block_len=P, device=dev, kv_store=st),
                    requests, eng, st)
                dense_hit, rep_dense = store_run(
                    "lint dense hit", DecodeServer(
                        params, cfg, PREFIX_REQUESTS, 2048, device=dev,
                        kv_store=st),
                    requests, eng, st)
                if paged_hit != dense_hit:
                    raise AssertionError("lint (b): the paged and dense hits' "
                                         "tokens differ")
                if not rep_hit["stats"]["kv_pages_restored"]:
                    raise AssertionError(f"lint (b): no page restored "
                                         f"{rep_hit['stats']}")
                st.close()
                torch.cuda.synchronize()
                srv_http = debugsrv.DebugServer(eng.stats, port=0)
                srv_http.attach_engine(eng)
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{srv_http.port}/locks",
                        timeout=10) as r:
                    locks = json.loads(r.read().decode())
            finally:
                if srv_http is not None:
                    srv_http.close()
                hostcache.reset()
        edges = w.snapshot_edges()
        cycles = list(w.violations)
    n_edges = sum(len(v) for v in edges.values())
    if cycles:
        raise AssertionError(f"lint (b): the witness recorded {cycles}")
    if not (locks.get("armed") and locks.get("mode") == "strict"
            and locks.get("violations") == []
            and sum(len(v) for v in locks.get("edges", {}).values())):
        raise AssertionError(f"lint (b): /locks answered {locks}")
    report["b"] = {"edges": n_edges, "locks": sorted(edges),
                   "edge_list": edges, "cycles": len(cycles),
                   "locks_route": {"armed": locks["armed"],
                                   "mode": locks["mode"],
                                   "edges": sum(len(v) for v in
                                                locks["edges"].values()),
                                   "violations": locks["violations"]},
                   "restored_pages": rep_hit["stats"]["kv_pages_restored"],
                   "h2d_launches": rep_cold["h2d_launches"]
                   + rep_hit["h2d_launches"] + rep_dense["h2d_launches"]}
    report["seconds"] = time.monotonic() - t_phase
    log(f"lint (b): witness strict, {n_edges} edges over {len(edges)} held "
        f"locks, {len(cycles)} cycles; edges {edges}; /locks "
        f"{report['b']['locks_route']}; pages restored "
        f"{report['b']['restored_pages']}")
    log(f"lint: {report['seconds']:.1f} s (budget {LINT_BUDGET_S} s)")
    if report["seconds"] > LINT_BUDGET_S:
        raise AssertionError(f"lint: {report['seconds']:.1f} s, past its "
                             f"{LINT_BUDGET_S} s budget")
    return report


# -- Direct SQL: Parquet and Arrow scanned and aggregated on the card -------

#: the phase's wall-clock budget (s), the tables' writing included, and
#: its tables (rows): (a) the GROUP BY scan (BASELINE.json config 5 at 4x
#: bench_suite's 256 MiB), (b) the dictionary string key, (c) GZIP, (d)
#: pushdown and top-k, (e) the star join, (f) nulls, (h) Arrow (bytes),
#: (i) the multi-file union (files x rows), whose files (j) reuses
SQL_BUDGET_S = 75
SQL_A_ROWS, SQL_A_GROUPS, SQL_A_RGS = 1 << 27, 64, 16
SQL_B_ROWS, SQL_B_RGS = 1 << 25, 8
SQL_C_ROWS = 1 << 24
SQL_D_ROWS, SQL_D_RGS = 1 << 25, 32
SQL_E_ROWS, SQL_E_KEYS, SQL_E_ATTRS = 1 << 24, 1024, 16
SQL_F_ROWS, SQL_F_NULL = 1 << 22, 0.10
SQL_H_BYTES, SQL_H_BATCHES = 256 << 20, 16
SQL_I_FILES, SQL_I_ROWS = 4, 1 << 23
SQL_WINDOWS = (0, 64 << 20)
#: the windows' table: (a)'s columns in row groups of 8 MiB, so that a
#: 64 MiB window folds 8 of them at once (rows, rows a row group, trials)
SQL_W_ROWS, SQL_W_RG_ROWS, SQL_W_TRIALS = 1 << 25, 1 << 20, 3
SQL_CITIES = ("tokyo", "osaka", "kyoto", "nagoya", "sapporo", "fukuoka",
              "sendai", "kobe")
#: a group's f32 SUM against float64 numpy: |err| <= SQL_SUM_RTOL x the
#: group's sum of |v|.  Sound folds on an H100 read at most 1.7e-8 of it
#: (scatter's f32 atomics, 2^17 rows a group and fold) and 1.9e-9 (the
#: matmul); TF32 in the one-hot product rounds each value to 11 bits, a
#: random error of ~2e-7 of it at 2^21 rows a group, which (g)'s control
#: must show failing this limit
SQL_SUM_RTOL = 5e-8


def _sql_dir():
    d = os.path.join(DATA_DIR, "sql")
    os.makedirs(d, exist_ok=True)
    return d


def _sql_sum_ratio(got_sum, ref_sum, ref_abs):
    """The largest group's SUM error over its limit (1 = at the limit)."""
    import numpy as np
    err = np.abs(np.asarray(got_sum, np.float64) - ref_sum)
    lim = SQL_SUM_RTOL * np.maximum(ref_abs, 1.0)
    return float((err / lim).max()) if len(err) else 0.0


def _sql_sums_ok(name, got_sum, ref_sum, ref_abs):
    ratio = _sql_sum_ratio(got_sum, ref_sum, ref_abs)
    if ratio > 1.0:
        raise AssertionError(f"sql {name}: SUM {ratio:.3f}x its limit "
                             f"({SQL_SUM_RTOL} of the group's sum of |v|)")
    return ratio


class _tf32_on:
    """The control's context in place of ``groupby.full_fp32``: TF32
    allowed in the one-hot product."""

    def __enter__(self):
        import torch
        self.prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True

    def __exit__(self, *exc):
        import torch
        torch.backends.cuda.matmul.allow_tf32 = self.prev


def _sql_no_host_path(scanner):
    """The phase's scans must stay on the direct path: the host path of
    this scanner raises."""
    def refuse(*a, **k):
        raise AssertionError(f"sql: {scanner.path} fell back to the host "
                             "path")
    scanner.iter_row_groups = refuse
    return scanner


def sql_multi_files(dev):
    """(i)'s four files (written once) and the union's answer by numpy
    (float64) and by ``multi_groupby`` on ``dev``: the reference (j)'s
    ranks are held to."""
    import numpy as np
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.sql import ParquetScanner, multi_groupby
    from nvme_strom_tpu_torch.sql.pqwrite import write_parquet
    d = _sql_dir()
    paths = [os.path.join(d, f"multi{i}.parquet")
             for i in range(SQL_I_FILES)]
    count = np.zeros(SQL_A_GROUPS, np.int64)
    sums = np.zeros(SQL_A_GROUPS)
    abss = np.zeros(SQL_A_GROUPS)
    for i, p in enumerate(paths):
        rng = np.random.default_rng(SEED + 500 + i)
        k = rng.integers(0, SQL_A_GROUPS, SQL_I_ROWS, dtype=np.int32)
        v = rng.standard_normal(SQL_I_ROWS, dtype=np.float32)
        if not os.path.exists(p):
            write_parquet(p, {"k": k, "v": v},
                          row_group_size=SQL_I_ROWS // 4)
        count += np.bincount(k, minlength=SQL_A_GROUPS)
        sums += np.bincount(k, weights=v, minlength=SQL_A_GROUPS)
        abss += np.bincount(k, weights=np.abs(v), minlength=SQL_A_GROUPS)
    with StromEngine() as eng:
        scs = [_sql_no_host_path(ParquetScanner(p, eng)) for p in paths]
        t0 = time.monotonic()
        res = multi_groupby(scs, "k", "v", SQL_A_GROUPS,
                            aggs=("count", "sum"), device=dev)
        secs = time.monotonic() - t0
    got_c = res["count"].cpu().numpy()
    got_s = res["sum"].cpu().numpy()
    if not np.array_equal(got_c, count):
        raise AssertionError("sql (i): multi_groupby's counts differ from "
                             "the union's")
    ratio = _sql_sums_ok("(i)", got_s, sums, abss)
    np.savez(os.path.join(d, "multi_answer.npz"), count=got_c, sum=got_s,
             ref_sum=sums, ref_abs=abss)
    return {"paths": paths, "seconds": secs, "sum_ratio": ratio,
            "rows": SQL_I_FILES * SQL_I_ROWS}


def sql_phase(dev):
    """Direct SQL on the card through the port's entry points, every
    table written by the port's writers from the seed, every answer held
    against numpy: (a) GROUP BY over 1 GiB (2^27 rows, 16 row groups of
    1 MiB PLAIN pages) by ``sql_query``, bounce 0, at both fold methods
    and windows 0 and 64 MiB, beside an engine-only read, then the two
    windows on 2^25 rows in 8 MiB row groups; (b) a string
    key of 8 RLE_DICTIONARY labels, each chunk's indices decoded on the
    card equal to numpy's, bounce within the raw index bytes; (c) GZIP
    level 1 on the direct path, bounce = the decompressed page bytes;
    (d) a 1/8 BETWEEN over an ascending int64 with ORDER BY ... LIMIT
    10, >= 27 of 32 groups skipped by the zone maps; (e) the star join;
    (f) nulls under ``nulls="mask"`` and SUM / COUNT skipping them; (g)
    (a)'s columns cached in a ``DeviceTable``, the query again with 0
    NVMe bytes, and once with TF32 let into the one-hot product, which
    must fail the SUM limit; (h) 256 MiB of Arrow IPC bitwise with bounce 0; (i)
    ``multi_groupby`` over 4 files against their union."""
    import numpy as np
    import torch
    from nvme_strom_tpu_torch.formats.arrow import (ArrowFileReader,
                                                    write_arrow_file)
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.ops import bitunpack
    from nvme_strom_tpu_torch.ops.bridge import h2d_copy
    from nvme_strom_tpu_torch.sql import (DeviceTable, ParquetScanner,
                                          pq_direct, sql_query,
                                          sql_scalar_agg)
    from nvme_strom_tpu_torch.sql import groupby as gb
    from nvme_strom_tpu_torch.sql.pqwrite import write_parquet
    t_phase = time.monotonic()
    d = _sql_dir()
    rep: dict = {}
    timing: dict = {}

    def stats_of(eng):
        eng.sync_stats()
        s = eng.stats.snapshot()
        return {k: s[k] for k in ("bytes_direct", "bytes_fallback",
                                  "bounce_bytes", "bytes_to_device")}

    def delta(a, b):
        return {k: b[k] - a[k] for k in a}

    # (a) the GROUP BY scan
    t0 = time.monotonic()
    rng = np.random.default_rng(SEED + 300)
    ka = rng.integers(0, SQL_A_GROUPS, SQL_A_ROWS, dtype=np.int32)
    va = rng.standard_normal(SQL_A_ROWS, dtype=np.float32)
    pa_path = os.path.join(d, "groupby.parquet")
    write_parquet(pa_path, {"k": ka, "v": va},
                  row_group_size=SQL_A_ROWS // SQL_A_RGS)
    ref_c = np.bincount(ka, minlength=SQL_A_GROUPS)
    ref_s = np.bincount(ka, weights=va, minlength=SQL_A_GROUPS)
    ref_abs = np.bincount(ka, weights=np.abs(va), minlength=SQL_A_GROUPS)
    del ka, va
    timing["write_a"] = time.monotonic() - t0
    payload = SQL_A_ROWS * 8
    q_a = "SELECT k, COUNT(*), SUM(v), MEAN(v) FROM t GROUP BY k"
    with StromEngine() as eng:
        sc = _sql_no_host_path(ParquetScanner(pa_path, eng))
        if any(sc.direct_reasons(["k", "v"]).values()):
            raise AssertionError(f"sql (a): not direct: "
                                 f"{sc.direct_reasons(['k', 'v'])}")
        plans = pq_direct.plan_columns(sc, ["k", "v"])
        spans = sum(len(p.spans) for c in plans for p in plans[c])
        pieces = sum(len(pq_direct._plan_window_ranges(
            sc, ["k", "v"], plans, [rg])[0])
            for rg in range(sc.num_row_groups))
        # the engine alone over the same file: NVMe -> staging, no copy
        fh = eng.open(pa_path)
        size = eng.file_size(fh)
        chunk = eng.config.chunk_bytes
        t0 = time.monotonic()
        pend = []
        for off in range(0, size, chunk):
            pend.extend(eng.submit_readv([(fh, off, min(chunk,
                                                        size - off))]))
            while len(pend) > 3:
                p = pend.pop(0)
                p.wait()
                p.release()
        for p in pend:
            p.wait()
            p.release()
        engine_s = time.monotonic() - t0
        eng.close(fh)
        rep["a"] = {"rows": SQL_A_ROWS, "payload_bytes": payload,
                    "file_bytes": size, "spans": spans, "pieces": pieces,
                    "engine_only_gib_per_s": size / engine_s / 2**30,
                    "runs": []}
        # one untimed query first (the fold's first CUDA calls), then
        # each (method, window) twice, the second pass in reverse order
        sql_query(q_a, {"t": sc}, engine=eng, device=dev)
        answer = None
        arms = [(m, w) for m in ("matmul", "scatter") for w in SQL_WINDOWS]
        for trial, (method, window) in enumerate(arms + arms[::-1]):
            os.environ["STROM_SQL_WINDOW_BYTES"] = str(window)
            pre, l0 = stats_of(eng), h2d_copy.launches
            f0 = dict(gb.FOLDS)
            t0 = time.monotonic()
            out = sql_query(q_a, {"t": sc}, engine=eng, device=dev,
                            method=method)
            secs = time.monotonic() - t0
            st, launches = delta(pre, stats_of(eng)), \
                h2d_copy.launches - l0
            os.environ.pop("STROM_SQL_WINDOW_BYTES", None)
            if not np.array_equal(out["count(*)"], ref_c):
                raise AssertionError(f"sql (a) {method} window "
                                     f"{window}: counts differ")
            ratio = _sql_sums_ok(f"(a) {method}", out["sum(v)"],
                                 ref_s, ref_abs)
            if st["bounce_bytes"] != 0:
                raise AssertionError(f"sql (a): bounce "
                                     f"{st['bounce_bytes']} != 0")
            if st["bytes_direct"] < payload:
                raise AssertionError(f"sql (a): bytes_direct "
                                     f"{st['bytes_direct']} < payload "
                                     f"{payload}")
            if launches < pieces:
                raise AssertionError(f"sql (a): {launches} h2d_copy "
                                     f"launches < {pieces} pieces")
            run = {"method": method, "window": window, "s": secs,
                   "trial": trial // len(arms),
                   "gib_per_s": payload / secs / 2**30,
                   "sum_ratio": ratio, "launches": launches,
                   "folds": gb.FOLDS[method] - f0[method], **st}
            rep["a"]["runs"].append(run)
            log(f"sql (a) GROUP BY k over {SQL_A_ROWS} rows, {method}, "
                f"window {window >> 20} MiB, trial {run['trial']}: "
                f"{secs:.3f} s = "
                f"{run['gib_per_s']:.3f} GiB/s (engine alone "
                f"{rep['a']['engine_only_gib_per_s']:.3f}); bounce "
                f"{st['bounce_bytes']}, direct {st['bytes_direct']}, "
                f"h2d_copy {launches} (pieces {pieces}, spans {spans}), "
                f"{run['folds']} folds; SUM at {ratio:.4f} of its limit")
            answer = out
        # the windows on row groups smaller than a window: (a)'s shape in
        # 8 MiB row groups, window 0 (a fold a row group) against 64 MiB
        # (8 row groups a fold), in turns
        t0 = time.monotonic()
        rng = np.random.default_rng(SEED + 307)
        kw = rng.integers(0, SQL_A_GROUPS, SQL_W_ROWS, dtype=np.int32)
        vw = rng.standard_normal(SQL_W_ROWS, dtype=np.float32)
        pw = os.path.join(d, "windows.parquet")
        write_parquet(pw, {"k": kw, "v": vw}, row_group_size=SQL_W_RG_ROWS)
        ref_wc = np.bincount(kw, minlength=SQL_A_GROUPS)
        ref_ws = np.bincount(kw, weights=vw, minlength=SQL_A_GROUPS)
        ref_wa = np.bincount(kw, weights=np.abs(vw), minlength=SQL_A_GROUPS)
        del kw, vw
        timing["write_w"] = time.monotonic() - t0
        scw = _sql_no_host_path(ParquetScanner(pw, eng))
        sql_query(q_a, {"t": scw}, engine=eng, device=dev)
        w_runs = {w: [] for w in SQL_WINDOWS}
        for trial in range(SQL_W_TRIALS):
            for window in (SQL_WINDOWS if trial % 2 == 0
                           else SQL_WINDOWS[::-1]):
                os.environ["STROM_SQL_WINDOW_BYTES"] = str(window)
                f0 = gb.FOLDS["matmul"]
                t0 = time.monotonic()
                out = sql_query(q_a, {"t": scw}, engine=eng, device=dev)
                secs = time.monotonic() - t0
                os.environ.pop("STROM_SQL_WINDOW_BYTES", None)
                if not np.array_equal(out["count(*)"], ref_wc):
                    raise AssertionError(f"sql (a) windows: window {window}"
                                         ": counts differ")
                _sql_sums_ok(f"(a) windows, window {window}",
                             out["sum(v)"], ref_ws, ref_wa)
                w_runs[window].append({"s": secs,
                                       "folds": gb.FOLDS["matmul"] - f0})
        rep["a"]["windows"] = {
            "rows": SQL_W_ROWS, "row_group_bytes": SQL_W_RG_ROWS * 8,
            "runs": {str(w): r for w, r in w_runs.items()},
            "median_s": {str(w): statistics.median(x["s"] for x in r)
                         for w, r in w_runs.items()}}
        log(f"sql (a) windows on {SQL_W_ROWS} rows in "
            f"{SQL_W_ROWS // SQL_W_RG_ROWS} row groups of "
            f"{SQL_W_RG_ROWS * 8 >> 20} MiB, matmul, {SQL_W_TRIALS} trials "
            f"in turns: " + "; ".join(
                f"window {w >> 20} MiB {r[0]['folds']} folds, s "
                f"{[round(x['s'], 4) for x in r]}, median "
                f"{statistics.median(x['s'] for x in r):.4f} s = "
                f"{SQL_W_ROWS * 8 / statistics.median(x['s'] for x in r) / 2**30:.3f}"
                f" GiB/s" for w, r in w_runs.items()))

        # the fold alone on the card: one 64 MiB window's k, v
        kk = torch.randint(0, SQL_A_GROUPS, (1 << 23,), device=dev,
                           dtype=torch.int32)
        vv = torch.randn(1 << 23, device=dev)
        rep["a"]["fold_ms_64mib"] = {
            m: time_ms(lambda m=m: gb.groupby_aggregate(
                kk, vv, SQL_A_GROUPS, aggs=("count", "sum"), method=m,
                empty_as_nan=False), 10) for m in ("matmul", "scatter")}
        del kk, vv
        log(f"sql (a) the fold alone, 2^23 rows (a 64 MiB window): "
            f"{rep['a']['fold_ms_64mib']} ms")

        # (g) the same columns cached, the query again
        t0 = time.monotonic()
        table = DeviceTable(sc, ["k", "v"], device=dev)
        cache_s = time.monotonic() - t0
        pre = stats_of(eng)
        t0 = time.monotonic()
        res = table.groupby("k", "v", SQL_A_GROUPS, aggs=("count", "sum"))
        got_c = res["count"].cpu().numpy()
        cached_s = time.monotonic() - t0
        st = delta(pre, stats_of(eng))
        nvme = st["bytes_direct"] + st["bytes_fallback"]
        if nvme != 0:
            raise AssertionError(f"sql (g): cached query read {nvme} B")
        if not np.array_equal(got_c, answer["count(*)"]):
            raise AssertionError("sql (g): cached counts differ from (a)'s")
        g_ratio = _sql_sums_ok("(g)", res["sum"].cpu().numpy(), ref_s,
                               ref_abs)
        # the control: the same fold with TF32 let into the one-hot
        # product must fail the SUM limit, or the check could not see it
        full_fp32 = gb.full_fp32
        gb.full_fp32 = _tf32_on
        try:
            bad = table.groupby("k", "v", SQL_A_GROUPS,
                                aggs=("count", "sum"), method="matmul")
        finally:
            gb.full_fp32 = full_fp32
        tf32_ratio = _sql_sum_ratio(bad["sum"].cpu().numpy(), ref_s,
                                    ref_abs)
        if tf32_ratio <= 1.0:
            raise AssertionError(
                f"sql (g): the fold with TF32 on reads {tf32_ratio:.4f} of "
                "the SUM limit: the check cannot see TF32")
        log(f"sql (g) control: the cached fold with TF32 on reads "
            f"{tf32_ratio:.3f}x the SUM limit (full fp32 {g_ratio:.4f}x)")
        del bad
        streamed_s = min(r["s"] for r in rep["a"]["runs"])
        rep["g"] = {"cache_s": cache_s, "cached_query_s": cached_s,
                    "streamed_query_s": streamed_s, "nvme_bytes": nvme,
                    "sum_ratio": g_ratio, "tf32_control_ratio": tf32_ratio,
                    "resident_bytes": table.nbytes()}
        log(f"sql (g) DeviceTable of (a)'s k, v ({table.nbytes()} B, "
            f"{cache_s:.3f} s to cache): the GROUP BY {cached_s:.4f} s, "
            f"0 NVMe bytes, against {streamed_s:.3f} s streamed")
        del table, res

        # (b) the dictionary string key
        t0 = time.monotonic()
        rng = np.random.default_rng(SEED + 301)
        codes = rng.integers(0, len(SQL_CITIES), SQL_B_ROWS)
        vb = rng.standard_normal(SQL_B_ROWS, dtype=np.float32)
        pb = os.path.join(d, "dict.parquet")
        write_parquet(pb, {"city": (np.array(SQL_CITIES), codes), "v": vb},
                      row_group_size=SQL_B_ROWS // SQL_B_RGS,
                      dictionary=["city"])
        ref_bc = np.bincount(codes, minlength=len(SQL_CITIES))
        ref_bs = np.bincount(codes, weights=vb, minlength=len(SQL_CITIES))
        ref_ba = np.bincount(codes, weights=np.abs(vb),
                             minlength=len(SQL_CITIES))
        del codes, vb
        timing["write_b"] = time.monotonic() - t0
        scb = _sql_no_host_path(ParquetScanner(pb, eng))
        ci = {scb.metadata.schema.column(i).name: i
              for i in range(scb.metadata.num_columns)}["city"]
        idx_raw = 0
        with open(pb, "rb") as f:
            def raw_read(off, ln):
                return os.pread(f.fileno(), ln, off)
            chunks = [pq_direct.plan_dict_code_chunk(scb.metadata, rg, ci,
                                                     raw_read)
                      for rg in range(scb.num_row_groups)]
            fh = eng.open(pb)
            try:
                for ch in chunks:
                    on_card = pq_direct._indices_to_device(
                        eng, fh, ch.parts, ch.dict_count, dev)
                    want = np.concatenate([pq_direct.decode_rle_hybrid(
                        raw_read(*p.span), p.bit_width, p.valid_count)
                        for p in ch.parts])
                    if not np.array_equal(on_card.cpu().numpy(), want):
                        raise AssertionError("sql (b): a chunk's indices "
                                             "decoded on the card differ "
                                             "from numpy's")
                    idx_raw += sum(p.span[1] for p in ch.parts)
            finally:
                eng.close(fh)
            # the device decode alone: one row group's index streams
            table = bitunpack.RunTable()
            raw = []
            for p in chunks[0].parts:
                buf = raw_read(*p.span)
                if table.add(buf, p.bit_width, p.valid_count):
                    raw.append(buf)
            u8 = torch.from_numpy(np.frombuffer(b"".join(raw) + bytes(4),
                                                np.uint8).copy()).to(dev)
            meta = torch.from_numpy(np.array(table.rows, np.int64).T
                                    .copy()).to(dev)
            decode_ms = time_ms(lambda: bitunpack._batch_decode(
                u8, meta, table.total), 10)
            del u8, meta
        pre, dec0 = stats_of(eng), dict(bitunpack.DECODES)
        t0 = time.monotonic()
        out = sql_query("SELECT city, COUNT(*), SUM(v) FROM d GROUP BY city",
                        {"d": scb}, engine=eng, device=dev)
        secs = time.monotonic() - t0
        st = delta(pre, stats_of(eng))
        labels = [x.decode() for x in out["city"]]
        order = [SQL_CITIES.index(x) for x in labels]
        if not np.array_equal(out["count(*)"], ref_bc[order]):
            raise AssertionError("sql (b): counts differ")
        ratio = _sql_sums_ok("(b)", out["sum(v)"], ref_bs[order],
                             ref_ba[order])
        if st["bounce_bytes"] > idx_raw:
            raise AssertionError(f"sql (b): bounce {st['bounce_bytes']} > "
                                 f"raw index bytes {idx_raw}")
        rep["b"] = {"rows": SQL_B_ROWS, "s": secs, "idx_raw": idx_raw,
                    "bounce_vs_idx_raw": st["bounce_bytes"] / idx_raw,
                    "decodes": {k: bitunpack.DECODES[k] - dec0[k]
                                for k in dec0}, "sum_ratio": ratio,
                    "decode_ms_row_group": decode_ms,
                    "values_row_group": table.total, **st}
        log(f"sql (b) GROUP BY city (8 labels, {SQL_B_ROWS} rows): "
            f"{secs:.3f} s; bounce {st['bounce_bytes']} = "
            f"{rep['b']['bounce_vs_idx_raw']:.4f} of the raw index bytes "
            f"{idx_raw}; card decodes {rep['b']['decodes']}, "
            f"{decode_ms:.4f} ms for a row group's {table.total} indices; "
            "every chunk's indices equal numpy's")

        # (c) GZIP level 1
        t0 = time.monotonic()
        rng = np.random.default_rng(SEED + 302)
        kc = rng.integers(0, SQL_A_GROUPS, SQL_C_ROWS, dtype=np.int32)
        vc = rng.standard_normal(SQL_C_ROWS, dtype=np.float32)
        pc = os.path.join(d, "gzip.parquet")
        write_parquet(pc, {"k": kc, "v": vc}, row_group_size=SQL_C_ROWS // 4,
                      compression="gzip", compression_level=1)
        ref_cc = np.bincount(kc, minlength=SQL_A_GROUPS)
        ref_cs = np.bincount(kc, weights=vc, minlength=SQL_A_GROUPS)
        ref_ca = np.bincount(kc, weights=np.abs(vc), minlength=SQL_A_GROUPS)
        del kc, vc
        timing["write_c"] = time.monotonic() - t0
        scc = _sql_no_host_path(ParquetScanner(pc, eng))
        if any(scc.direct_reasons(["k", "v"]).values()):
            raise AssertionError("sql (c): GZIP not direct")
        cplans = pq_direct.plan_columns(scc, ["k", "v"])
        decomp = sum(p.uncompressed_len for c in cplans for pl in cplans[c]
                     for p in pl.parts)
        pre = stats_of(eng)
        t0 = time.monotonic()
        out = sql_query(q_a, {"t": scc}, engine=eng, device=dev)
        secs = time.monotonic() - t0
        st = delta(pre, stats_of(eng))
        if not np.array_equal(out["count(*)"], ref_cc):
            raise AssertionError("sql (c): counts differ")
        ratio = _sql_sums_ok("(c)", out["sum(v)"], ref_cs, ref_ca)
        if st["bounce_bytes"] != decomp:
            raise AssertionError(f"sql (c): bounce {st['bounce_bytes']} != "
                                 f"decompressed page bytes {decomp}")
        rep["c"] = {"rows": SQL_C_ROWS, "s": secs, "decompressed": decomp,
                    "file_bytes": os.path.getsize(pc), "sum_ratio": ratio,
                    **st}
        log(f"sql (c) GZIP level 1 ({os.path.getsize(pc)} B for "
            f"{decomp} B of values): {secs:.3f} s, bounce "
            f"{st['bounce_bytes']} = the decompressed page bytes, direct "
            f"{st['bytes_direct']}")

        # (d) pushdown and top-k
        t0 = time.monotonic()
        rng = np.random.default_rng(SEED + 303)
        ts = np.arange(SQL_D_ROWS, dtype=np.int64)
        vd = rng.standard_normal(SQL_D_ROWS, dtype=np.float32)
        pd = os.path.join(d, "topk.parquet")
        write_parquet(pd, {"ts": ts, "v": vd},
                      row_group_size=SQL_D_ROWS // SQL_D_RGS)
        timing["write_d"] = time.monotonic() - t0
        lo = 3 * (SQL_D_ROWS // 8)
        hi = lo + SQL_D_ROWS // 8 - 1
        sel = np.nonzero((ts >= lo) & (ts <= hi))[0]
        top = sel[np.argsort(-vd[sel], kind="stable")[:10]]
        scd = _sql_no_host_path(ParquetScanner(pd, eng))
        kept = scd.prune_row_groups([("ts", lo, hi)])
        col_bytes = sum(scd.metadata.row_group(rg).column(c)
                        .total_compressed_size
                        for rg in range(scd.num_row_groups)
                        for c in range(2))
        pre = stats_of(eng)
        t0 = time.monotonic()
        out = sql_query(f"SELECT v, ts FROM s WHERE ts BETWEEN {lo} AND "
                        f"{hi} ORDER BY v DESC LIMIT 10", {"s": scd},
                        engine=eng, device=dev)
        secs = time.monotonic() - t0
        st = delta(pre, stats_of(eng))
        nvme = st["bytes_direct"] + st["bytes_fallback"]
        skipped = SQL_D_RGS - len(kept)
        if skipped < 27:
            raise AssertionError(f"sql (d): zone maps skipped {skipped} "
                                 "< 27 of 32 groups")
        if nvme > 5 * col_bytes // 32:
            raise AssertionError(f"sql (d): {nvme} NVMe bytes > 5/32 of "
                                 f"{col_bytes}")
        if not (np.array_equal(out["ts"], ts[top])
                and np.array_equal(out["v"], vd[top])):
            raise AssertionError("sql (d): the top 10 differ from numpy's")
        del ts, vd
        rep["d"] = {"rows": SQL_D_ROWS, "s": secs, "skipped": skipped,
                    "limit_skipped": int(out["_skipped_row_groups"]),
                    "nvme_bytes": nvme, "column_bytes": col_bytes, **st}
        log(f"sql (d) WHERE ts BETWEEN (1/8 of {SQL_D_ROWS}) ORDER BY v "
            f"DESC LIMIT 10: {secs:.3f} s; zone maps skip {skipped} of "
            f"{SQL_D_RGS} groups, NVMe {nvme} B = "
            f"{nvme / col_bytes:.4f} of the columns (limit 5/32); rows "
            "equal numpy's")

        # (e) the star join
        t0 = time.monotonic()
        rng = np.random.default_rng(SEED + 304)
        fk = rng.integers(0, SQL_E_KEYS, SQL_E_ROWS, dtype=np.int32)
        ve = rng.standard_normal(SQL_E_ROWS, dtype=np.float32)
        dkey = rng.permutation(SQL_E_KEYS).astype(np.int32)
        dattr = rng.integers(0, SQL_E_ATTRS, SQL_E_KEYS, dtype=np.int32)
        pf, pdim = os.path.join(d, "fact.parquet"), os.path.join(d,
                                                                "dim.parquet")
        write_parquet(pf, {"fk": fk, "v": ve},
                      row_group_size=SQL_E_ROWS // 4)
        write_parquet(pdim, {"key": dkey, "attr": dattr})
        attr_of = np.zeros(SQL_E_KEYS, np.int64)
        attr_of[dkey] = dattr
        ref_es = np.bincount(attr_of[fk], weights=ve, minlength=SQL_E_ATTRS)
        ref_ea = np.bincount(attr_of[fk], weights=np.abs(ve),
                             minlength=SQL_E_ATTRS)
        del fk, ve
        timing["write_e"] = time.monotonic() - t0
        pre = stats_of(eng)
        t0 = time.monotonic()
        out = sql_query("SELECT d.attr, SUM(f.v) FROM f JOIN d ON "
                        "f.fk = d.key GROUP BY d.attr",
                        {"f": _sql_no_host_path(ParquetScanner(pf, eng)),
                         "d": _sql_no_host_path(ParquetScanner(pdim, eng))},
                        engine=eng, device=dev)
        secs = time.monotonic() - t0
        st = delta(pre, stats_of(eng))
        ratio = _sql_sums_ok("(e)", out["sum(f.v)"], ref_es, ref_ea)
        rep["e"] = {"rows": SQL_E_ROWS, "s": secs, "sum_ratio": ratio, **st}
        log(f"sql (e) star join ({SQL_E_ROWS} fact rows, {SQL_E_KEYS} "
            f"keys, {SQL_E_ATTRS} attrs): {secs:.3f} s, SUM at "
            f"{ratio:.4f} of its limit, bounce {st['bounce_bytes']}")

        # (f) nulls
        t0 = time.monotonic()
        rng = np.random.default_rng(SEED + 305)
        xf = rng.standard_normal(SQL_F_ROWS, dtype=np.float32)
        valid = rng.random(SQL_F_ROWS) >= SQL_F_NULL
        pn = os.path.join(d, "nulls.parquet")
        write_parquet(pn, {"x": xf}, nulls={"x": valid},
                      row_group_size=SQL_F_ROWS // 4,
                      data_page_version="2.0")
        timing["write_f"] = time.monotonic() - t0
        scn = _sql_no_host_path(ParquetScanner(pn, eng))
        t0 = time.monotonic()
        v, m = scn.read_columns_to_device(["x"], device=dev,
                                          direct="always",
                                          nulls="mask")["x"]
        vh, mh = v.cpu().numpy(), m.cpu().numpy()
        if not (np.array_equal(mh, valid)
                and np.array_equal(vh[valid], xf[valid])
                and not vh[~valid].any()):
            raise AssertionError("sql (f): values or mask differ")
        agg = sql_scalar_agg(scn, "x", aggs=("count", "sum"), nulls="skip",
                             device=dev)
        secs = time.monotonic() - t0
        if int(agg["count"]) != int(valid.sum()):
            raise AssertionError("sql (f): COUNT counted nulls")
        ratio = _sql_sums_ok("(f)", [float(agg["sum"])],
                             np.array([xf[valid].astype(np.float64).sum()]),
                             np.array([np.abs(xf[valid]).sum()]))
        rep["f"] = {"rows": SQL_F_ROWS, "nulls": int((~valid).sum()),
                    "s": secs, "sum_ratio": ratio}
        log(f"sql (f) {SQL_F_ROWS} rows, {rep['f']['nulls']} nulls, v2 "
            f"pages: values and mask equal numpy's; COUNT {int(agg['count'])}"
            f" and SUM skip the nulls; {secs:.3f} s")
        del xf, valid, v, m

        # (h) Arrow IPC
        t0 = time.monotonic()
        rng = np.random.default_rng(SEED + 306)
        rows_h = SQL_H_BYTES // 12
        cols_h = {"a": rng.integers(-2**31, 2**31 - 1, rows_h,
                                    dtype=np.int32),
                  "b": rng.standard_normal(rows_h, dtype=np.float32),
                  "c": rng.integers(0, 1 << 20, rows_h, dtype=np.int32)}
        ph = os.path.join(d, "cols.arrow")
        write_arrow_file(ph, cols_h,
                         batch_rows=-(-rows_h // SQL_H_BATCHES))
        timing["write_h"] = time.monotonic() - t0
        rd = ArrowFileReader(ph)
        pre = stats_of(eng)
        t0 = time.monotonic()
        got = rd.read_columns_to_device(eng, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        secs = time.monotonic() - t0
        st = delta(pre, stats_of(eng))
        for n, a in cols_h.items():
            if not torch.equal(got[n], torch.from_numpy(a).to(dev)):
                raise AssertionError(f"sql (h): column {n} not bitwise")
        if st["bounce_bytes"] != 0:
            raise AssertionError(f"sql (h): bounce {st['bounce_bytes']}")
        nbytes = sum(a.nbytes for a in cols_h.values())
        rep["h"] = {"bytes": nbytes, "batches": rd.num_batches, "s": secs,
                    "gib_per_s": nbytes / secs / 2**30, **st}
        log(f"sql (h) Arrow IPC {nbytes} B in {rd.num_batches} record "
            f"batches: {rep['h']['gib_per_s']:.3f} GiB/s, bitwise, bounce 0")
        del got, cols_h

    # (i) the multi-file union
    t0 = time.monotonic()
    rep["i"] = sql_multi_files(dev)
    timing["i"] = time.monotonic() - t0
    log(f"sql (i) multi_groupby over {SQL_I_FILES} files of {SQL_I_ROWS} "
        f"rows: {rep['i']['seconds']:.3f} s, the union's counts, SUM at "
        f"{rep['i']['sum_ratio']:.4f} of its limit")
    rep["timing"] = timing
    rep["seconds"] = time.monotonic() - t_phase
    log(f"sql: {rep['seconds']:.1f} s (budget {SQL_BUDGET_S} s; writing "
        f"{ {k: round(v, 1) for k, v in timing.items()} })")
    return rep


def _sql_dist_part(rank, world, dev):
    """(j): ``dist_groupby`` with rank r scanning (i)'s files r, r+world,
    ...; every rank must hold (i)'s answer (counts exact, SUM within the
    f32 limit of the union's float64 sum)."""
    import numpy as np
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.sql import ParquetScanner, dist_groupby
    d = _sql_dir()
    ans = np.load(os.path.join(d, "multi_answer.npz"))
    mine = [os.path.join(d, f"multi{i}.parquet")
            for i in range(rank, SQL_I_FILES, world)]
    with StromEngine() as eng:
        t0 = time.monotonic()
        res = dist_groupby([_sql_no_host_path(ParquetScanner(p, eng))
                            for p in mine], "k", "v", SQL_A_GROUPS,
                           aggs=("count", "sum"), device=dev)
        secs = time.monotonic() - t0
        eng.sync_stats()
        bounce = eng.stats.snapshot()["bounce_bytes"]
    if not np.array_equal(res["count"], ans["count"]):
        raise AssertionError(f"sql (j): rank {rank}'s counts differ from "
                             "(i)'s")
    ratio = _sql_sums_ok("(j)", res["sum"], ans["ref_sum"], ans["ref_abs"])
    return {"files": len(mine), "seconds": secs, "sum_ratio": ratio,
            "max_sum_diff_vs_i": float(np.abs(res["sum"]
                                              - ans["sum"]).max()),
            "bounce_bytes": bounce}


# -- multi-GPU: data and tensor parallel, one process a rank ------------------

#: the phase's wall-clock budget (s) and its parts' shapes: (a) parity at
#: the flagship's widths in float32, (c) sharded generate, (f) a bf16
#: step at Llama-3-8B's widths (2 layers) with the flash kernels
MG_BUDGET_S = 90
MG_PARITY_SEQ = 512
MG_PARITY_BATCH = 4
MG_STEPS = 3
MG_GEN_PROMPT = 32
MG_GEN_NEW = 16
MG_F_SEQ = 2048
MG_F_STEPS = 4
#: the one-card run's two ranks share cuda:0 over gloo; a rank's join
#: limit (s), then every rank is killed and the phase fails
MG_JOIN_S = 420
#: parity (a): each step's loss, and every parameter after the last
#: step, against the one-rank run; step-1 gradients at the same
#: tolerance.  Adam's first update is lr·g/(|g|+eps), a whole lr·sign(g)
#: step whatever |g|: where a step-1 gradient is below MG_NOISE_G of its
#: tensor's rms the float summation order alone decides that sign, so
#: those elements are counted, not held to the parameter tolerance; more
#: of them on a rank than MG_EXEMPT_MAX of its elements fails (a card
#: run exempts about 1e-6 of them)
MG_LOSS_RTOL = 1e-4
MG_PARAM_TOL = (1e-4, 1e-5)
MG_NOISE_G = 1e-3
MG_EXEMPT_MAX = 1e-5
#: NVLink 4 per direction between two H100 SXM cards (NVIDIA data sheet)
NVLINK_BYTES_PER_S = 450e9


def _mg_cfg(dtype):
    import dataclasses
    import torch
    from nvme_strom_tpu_torch.models.transformer import flagship_config
    return dataclasses.replace(flagship_config(), dtype=dtype,
                               max_seq=max(MG_PARITY_SEQ,
                                           MG_GEN_PROMPT + MG_GEN_NEW))


def _mg_tokens(cfg):
    import numpy as np
    rng = np.random.default_rng(SEED + 17)
    return (rng.integers(0, cfg.vocab, (MG_PARITY_BATCH, MG_PARITY_SEQ))
            .astype(np.int64),
            rng.integers(0, cfg.vocab, (4, MG_GEN_PROMPT)).astype(np.int64))


#: NCCL kernels by the collective they run, matched in their names
_NCCL_KINDS = (("all_reduce", "allreduce"), ("send_recv", "sendrecv"),
               ("send_recv", "send"), ("send_recv", "recv"),
               ("all_gather", "allgather"),
               ("reduce_scatter", "reducescatter"),
               ("broadcast", "broadcast"), ("all_to_all", "alltoall"))


def _device_split(prof, steps):
    """(device-busy ms, NCCL ms, {collective: NCCL ms}) a step of a
    torch.profiler run over ``steps`` steps.  A rank that reaches a
    collective before its peers waits inside the NCCL kernel, so a
    kind's ms holds that wait as well as the transfer.  Device time is
    kernels and copies only (``profile_report.device_events``)."""
    from nvme_strom_tpu_torch.tools.profile_report import device_events
    ev = device_events(prof)
    busy = sum(e.self_device_time_total for e in ev) / 1e3 / steps
    kinds: dict = {}
    for e in ev:
        key = e.key.lower()
        if "nccl" not in key:
            continue
        kind = next((k for k, mark in _NCCL_KINDS if mark in key), "other")
        kinds[kind] = (kinds.get(kind, 0.0)
                       + e.self_device_time_total / 1e3 / steps)
    return busy, sum(kinds.values()), kinds


def _llama_step(dev, mesh, tokens, iters, profile_steps=0, attn_fn=None,
                xent_chunks=0, warmup=2):
    """Median ms of a bf16 train step at Llama-3-8B's widths (2 layers,
    the flash kernels or ``attn_fn``) on this rank's slices and span (one
    rank: the whole model), the step's peak device memory, and, with
    ``profile_steps``, the collectives' share of the device time of that
    many more steps (torch.profiler)."""
    import dataclasses
    import statistics
    import torch
    from nvme_strom_tpu_torch.models import transformer as ttr
    from nvme_strom_tpu_torch.ops.flash_attention import make_flash_attn
    from nvme_strom_tpu_torch.parallel.shardings import (param_shardings,
                                                         shard_params)
    seq = tokens.shape[1] * (mesh.shape.get("sp", 1) if mesh else 1)
    cfg = ttr.TransformerConfig(**dict(LLAMA3_8B_2L,
                                       max_seq=max(MG_F_SEQ, seq),
                                       xent_chunks=xent_chunks),
                                dtype=torch.bfloat16)
    t_in = time.monotonic()
    full = _card_params(cfg, SEED + 23, dev)
    sh = None
    if mesh is not None:
        sh = param_shardings(cfg, mesh)
        full = shard_params(full, cfg, mesh, shardings=sh)
    params = ttr.trainable_params(full, dev)
    del full
    torch.cuda.empty_cache()
    step = ttr.make_train_step(cfg, ttr.adamw(params, 1e-4),
                               attn_fn=attn_fn or make_flash_attn(),
                               mesh=mesh, shardings=sh)
    for _ in range(warmup):
        step(params, tokens)
    setup_s = time.monotonic() - t_in
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(iters):
        torch.cuda.synchronize(dev)
        t0 = time.monotonic()
        loss = float(step(params, tokens))
        times.append((time.monotonic() - t0) * 1e3)
    out = {"step_ms": statistics.median(times), "loss": loss,
           "step_ms_all": times, "setup_s": setup_s,
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
    if profile_steps:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(profile_steps):
                step(params, tokens)
            torch.cuda.synchronize(dev)
        busy, coll, kinds = _device_split(prof, profile_steps)
        out["collective_share"] = coll / busy if busy else None
        out["device_busy_ms"] = busy
        out["compute_ms"] = busy - coll
        out["collective_ms"] = kinds
    del params, step
    torch.cuda.empty_cache()
    return out


def _mg_gather_whole(local, sharding, shape, mesh):
    """The whole tensor from every rank's slice (all-gathered)."""
    import torch
    from nvme_strom_tpu_torch.parallel import collectives as coll
    out = torch.empty(shape, dtype=local.dtype, device=local.device)
    parts = coll.all_gather(local.contiguous(), coll.world_group())
    for r, part in enumerate(parts):
        coords = mesh.devices_coords()[r]
        b = sharding.bounds(shape, coords)
        out[tuple(slice(a, c) for a, c in b)] = part
    return out


def _mg_close(name, got, want, tol, g1=None):
    """(elements outside (rtol, atol), of them the ones a near-zero
    step-1 gradient exempts, worst |err| / limit among the rest)."""
    import torch
    rtol, atol = tol
    err = (got.float() - want.float()).abs()
    lim = atol + rtol * want.float().abs()
    bad = err > lim
    n_bad = int(bad.sum())
    exempt = 0
    if n_bad and g1 is not None:
        rms = g1.float().square().mean().sqrt()
        quiet = g1.float().abs() < MG_NOISE_G * rms
        exempt = int((bad & quiet).sum())
        bad = bad & ~quiet
    worst = float((err / lim)[bad].max()) if bool(bad.any()) else 0.0
    if bool(bad.any()):
        raise AssertionError(f"multigpu: {name}: {int(bad.sum())} elements "
                             f"outside (rtol {rtol}, atol {atol}), worst "
                             f"{worst:.3f}x the limit")
    return n_bad, exempt


def multigpu_worker(rank: int, world: int, workdir: str, backend: str,
                    ckdir: str) -> None:
    """One rank of ``multigpu_phase``: parts (a)-(f) and (j) under the mesh;
    writes its report and kernel launches to ``workdir``."""
    import numpy as np
    import torch
    from nvme_strom_tpu_torch.checkpoint.manager import CheckpointManager
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.models import decode as tdec
    from nvme_strom_tpu_torch.models import transformer as ttr
    from nvme_strom_tpu_torch.ops import flash_attention as fa
    from nvme_strom_tpu_torch.ops.bridge import h2d_copy
    from nvme_strom_tpu_torch.ops.decode_attention import decode_attention
    from nvme_strom_tpu_torch.ops.ici import (ProcessExchange, ici_ring_gather,
                                              ici_unit_bytes)
    from nvme_strom_tpu_torch.parallel import collectives as coll
    from nvme_strom_tpu_torch.parallel.mesh import (
        barrier, init_distributed, make_mesh, shutdown_distributed)
    from nvme_strom_tpu_torch.parallel.shardings import (
        Shard, local_slice, param_shardings, shard_params)
    from nvme_strom_tpu_torch.parallel.weights import LazyCheckpoint
    from nvme_strom_tpu_torch.train import Trainer
    kernels = {"h2d_copy": h2d_copy, "decode_attention": decode_attention,
               "flash_fwd": fa.flash_fwd, "flash_bwd_dq": fa.flash_bwd_dq,
               "flash_bwd_dkv": fa.flash_bwd_dkv,
               "ici_ring_gather": ici_ring_gather}
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    init_distributed("file://" + os.path.join(workdir, "store"), world,
                     rank, backend=backend, device=dev, timeout_s=180)
    for fn in kernels.values():
        fn.launches = 0
    rep: dict = {"rank": rank}
    t0 = time.monotonic()
    ref = torch.load(os.path.join(workdir, "ref.pt"), map_location=dev)
    cfg32 = _mg_cfg(torch.float32)
    shapes = ttr.param_shapes(cfg32)
    tp_mesh = make_mesh({"dp": world // 2, "tp": 2})
    dp_mesh = make_mesh({"dp": world})
    sh = param_shardings(cfg32, tp_mesh)
    tokens = ref["tokens"].to(dev)
    mine = local_slice(tokens, tp_mesh)
    eng = StromEngine()

    # (a) parity: step-1 gradients, 3 AdamW steps, the flash kernels
    ckpt = os.path.join(workdir, "ckpt")
    losses = []
    attn = fa.make_flash_attn()
    tr = Trainer(cfg32, mesh=tp_mesh, attn_fn=attn, device=dev,
                 ckpt_dir=ckpt, engine=eng, seed=SEED,
                 hooks=[lambda s, l, dt: losses.append(l)])
    with coll.use_mesh(tp_mesh):
        _, grads = ttr.value_and_grad(tr.params, mine, cfg32, attn)
    g = list(grads.values())
    coll.dp_mean_(g, tp_mesh.group("dp"))
    n_g = 0
    for (name, gr) in zip(grads, g):
        b = sh[name].local_bounds(shapes[name])
        want = ref["grads"][name][tuple(slice(x, y) for x, y in b)]
        n_g += _mg_close(f"step-1 gradient {name}", gr, want,
                         MG_PARAM_TOL)[0]
    torch.cuda.synchronize(dev)
    ta = time.monotonic()
    tr.fit(iter([mine] * MG_STEPS), steps=MG_STEPS)
    torch.cuda.synchronize(dev)
    fit_s = time.monotonic() - ta
    for got, want in zip(losses, ref["losses"]):
        if abs(got - want) > MG_LOSS_RTOL * abs(want):
            raise AssertionError(f"multigpu (a): losses {losses} against "
                                 f"the one-rank run's {ref['losses']}")
    outside = exempt = 0
    for name, p in tr.params.items():
        b = sh[name].local_bounds(shapes[name])
        cut = tuple(slice(x, y) for x, y in b)
        o, e = _mg_close(f"parameter {name} after step {MG_STEPS}",
                         p.detach(), ref["params"][name][cut],
                         MG_PARAM_TOL, ref["grads"][name][cut])
        outside += o
        exempt += e
    n_params = sum(p.numel() for p in tr.params.values())
    if exempt > MG_EXEMPT_MAX * n_params:
        raise AssertionError(f"multigpu (a): {exempt} of {n_params} "
                             "parameter elements outside the tolerance "
                             "under a near-zero step-1 gradient, above "
                             f"the limit {MG_EXEMPT_MAX * n_params:.0f}")
    rep["a"] = {"losses": losses, "ref_losses": ref["losses"],
                "grad_outside": n_g, "param_outside": outside,
                "param_exempt_near_zero_grad": exempt,
                "param_exempt_limit": MG_EXEMPT_MAX * n_params,
                "params": n_params, "fit_s": fit_s}
    # (d) the state of (a), saved by every rank
    tr.save()
    state_params = {n: p.detach().clone() for n, p in tr.params.items()}
    state_mu = {n: tr.optimizer.state[p]["exp_avg"].clone()
                for n, p in tr.params.items()}
    tr.close()
    whole = {n: _mg_gather_whole(state_params[n], sh[n], shapes[n],
                                 tp_mesh) for n in shapes}
    whole_mu = {n: _mg_gather_whole(state_mu[n], sh[n], shapes[n], tp_mesh)
                for n in shapes}
    if rank == 0:
        flat = CheckpointManager(ckpt, engine=eng).restore(step=MG_STEPS,
                                                           device=dev)
        for n in shapes:
            if not (torch.equal(flat[f"0|{n}"], whole[n]) and
                    torch.equal(flat[f"1|exp_avg|{n}"], whole_mu[n])):
                raise AssertionError(f"multigpu (d): one-rank restore of "
                                     f"{n} differs")
        del flat
    with Trainer(cfg32, mesh=dp_mesh, device=dev, ckpt_dir=ckpt,
                 engine=eng) as tr2:
        if tr2.resumed_from != MG_STEPS:
            raise AssertionError(f"multigpu (d): resumed from "
                                 f"{tr2.resumed_from}")
        for n, p in tr2.params.items():
            if not (torch.equal(p.detach(), whole[n]) and torch.equal(
                    tr2.optimizer.state[p]["exp_avg"], whole_mu[n])):
                raise AssertionError(f"multigpu (d): {n} restored under "
                                     "dp differs")
    rep["d"] = {"restored_one_rank": rank == 0, "restored_dp": True,
                "tensors": len(shapes)}

    # (e) the read-once restore across processes, kernel 7 over IPC
    if backend == "nccl":
        ex = ProcessExchange(stats=eng.stats)
        eng.sync_stats()
        before = eng.stats.snapshot()
        target = {f"0|{n}": Shard(torch.empty_like(state_params[n]), sh[n],
                                  shapes[n]) for n in shapes}
        mgr = CheckpointManager(ckpt, engine=eng)
        with _env(STROM_ICI_SCATTER=1):
            got = mgr.restore(target, step=MG_STEPS, fallback=False)
        eng.sync_stats()
        after = eng.stats.snapshot()
        for n in shapes:
            if not torch.equal(got[f"0|{n}"], state_params[n]):
                raise AssertionError(f"multigpu (e): scattered {n} differs")
        files = [os.path.join(mgr.step_dir(MG_STEPS), f) for f in
                 os.listdir(mgr.step_dir(MG_STEPS))
                 if f.endswith(".safetensors")]
        payload = sum(os.path.getsize(f) for f in files)
        share = after["ici_bytes_read"] - before["ici_bytes_read"]
        fallbacks = after["ici_fallbacks"] - before["ici_fallbacks"]
        # the partition (io/scatter.py partition_files, the reference's
        # rule) balances each file within one unit: one file a rank here
        slack = len(files) * ici_unit_bytes()
        if fallbacks or share > payload / world + slack:
            raise AssertionError(f"multigpu (e): share {share} of {payload} "
                                 f"B (slack {slack}), {fallbacks} "
                                 "fallbacks")
        width = -(-payload // world // 4096) * 4096
        rows = ex.host_rows(width)
        rows[rank] = rank + 1
        kms, walls = [], []
        with _uncounted(kernels):
            for _ in range(3):
                g_rows = ex.all_gather(rows)
                if not all(bool((g_rows[r] == r + 1).all())
                           for r in range(world)):
                    raise AssertionError("multigpu (e): the exchange "
                                         "differs")
            for _ in range(5):
                tw = time.monotonic()
                ex.all_gather(rows)
                walls.append((time.monotonic() - tw) * 1e3)
                kms.append(ex.last_kernel_ms)
        inp = torch.full((width,), rank, dtype=torch.uint8, device=dev)
        out = torch.empty(world * width, dtype=torch.uint8, device=dev)
        nccl = []
        for i in range(7):
            barrier()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            torch.distributed.all_gather_into_tensor(out, inp)
            e1.record()
            torch.cuda.synchronize(dev)
            if i >= 2:
                nccl.append(e0.elapsed_time(e1))
        ex.close()
        rep["e"] = {"payload_bytes": payload, "share_bytes": share,
                    "files": len(files),
                    "received_bytes": after["ici_bytes_received"]
                    - before["ici_bytes_received"],
                    "fallbacks": fallbacks, "row_bytes": width,
                    "kernel_ms": sorted(kms)[len(kms) // 2],
                    "call_wall_ms": sorted(walls)[len(walls) // 2],
                    "nccl_all_gather_ms": sorted(nccl)[len(nccl) // 2],
                    "bound_ms": (world - 1) * width
                    / NVLINK_BYTES_PER_S * 1e3}
    del state_params, state_mu, whole, whole_mu
    torch.cuda.empty_cache()

    # (b) the serving weights through load_sharded (bf16 flagship)
    cfg16 = _mg_cfg(torch.bfloat16)
    sh16 = param_shardings(cfg16, tp_mesh)
    with StromEngine() as e1:
        tb = time.monotonic()
        part = LazyCheckpoint(ckdir).load_sharded(sh16, engine=e1,
                                                  device=dev)
        load_s = time.monotonic() - tb
        e1.sync_stats()
        st = e1.stats.snapshot()
    with StromEngine() as e2, _uncounted(kernels):
        whole16 = LazyCheckpoint(ckdir).load(e2, device=dev)
    for n, t in part.items():
        b = sh16[n].local_bounds(tuple(whole16[n].shape))
        if not torch.equal(t, whole16[n][tuple(slice(x, y)
                                               for x, y in b)]):
            raise AssertionError(f"multigpu (b): {n} differs from a whole "
                                 "load sliced")
    if st["bounce_bytes"]:
        raise AssertionError(f"multigpu (b): bounce_bytes "
                             f"{st['bounce_bytes']}")
    rep["b"] = {"nvme_bytes": st["bytes_direct"] + st["bytes_fallback"],
                "bytes_direct": st["bytes_direct"],
                "bounce_bytes": st["bounce_bytes"],
                "slice_bytes": sum(t.numel() * t.element_size()
                                   for t in part.values()),
                "load_s": load_s}
    del part, whole16

    # (c) sharded generate, kernel 2 on the local heads, float32
    full = shard_params(ttr.init_params(SEED, cfg32), cfg32, tp_mesh,
                        device=dev)
    prompt = local_slice(ref["prompt"].to(dev), tp_mesh)
    with coll.use_mesh(tp_mesh), torch.no_grad():
        toks = tdec.generate(full, prompt, cfg32, MG_GEN_NEW,
                             cache_attn=decode_attention)
    want = local_slice(ref["gen"].to(dev), tp_mesh)
    if not torch.equal(toks, want):
        raise AssertionError("multigpu (c): sharded tokens differ from the "
                             "one-rank run's")
    rep["c"] = {"rows": int(toks.shape[0]), "new_tokens": MG_GEN_NEW}
    del full
    torch.cuda.empty_cache()

    # (f) throughput at Llama-3-8B's widths, dp × tp over the ranks
    ftoks = ref["f_tokens"].to(dev)
    # every rank runs the profiled steps: their collectives need them all
    rep["f"] = _llama_step(dev, tp_mesh, local_slice(ftoks, tp_mesh),
                           MG_F_STEPS,
                           profile_steps=2 if backend == "nccl" else 0)
    # (j) Direct SQL across processes: each rank scans its share of (i)'s
    # files, the partials fold over torch.distributed.  Its launches are
    # kept apart, so that the rank's kernel-1 check stays (b)'s and (d)'s
    with _uncounted(kernels):
        pre_j = {n: fn.launches for n, fn in kernels.items()}
        rep["j"] = _sql_dist_part(rank, world, dev)
        rep["j"]["launches"] = {n: fn.launches - pre_j[n]
                                for n, fn in kernels.items()}
    rep["seconds"] = time.monotonic() - t0
    rep["launches"] = {n: fn.launches for n, fn in kernels.items()}
    eng.close_all()
    barrier()
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(rep, f)
    shutdown_distributed()


def _run_ranks(route, world, workdir, args, join_s, what):
    """Start ``world`` ranks as ``chip_smoke.py route RANK WORLD *args``
    (logs ``rank<r>.log`` in ``workdir``) and wait at most ``join_s`` s
    for all of them: a rank outliving that is killed with every other,
    and any rank's failure prints the logs' tails and raises.  Returns
    every rank's report, ``rank<r>.json`` in ``workdir``."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = []
    for r in range(world):
        logf = open(os.path.join(workdir, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), route, str(r),
             str(world)] + [str(a) for a in args], env=env,
            stdout=logf, stderr=subprocess.STDOUT, cwd=ROOT), logf))
    deadline = time.monotonic() + join_s
    failed = []
    try:
        for r, (p, _) in enumerate(procs):
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.01))
            except subprocess.TimeoutExpired:
                failed.append(f"rank {r} outlived the {join_s} s limit")
                break
    finally:
        for p, logf in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            logf.close()
    failed += [f"rank {r} exited {p.returncode}"
               for r, (p, _) in enumerate(procs)
               if p.returncode not in (0, None) and not any(
                   f.startswith(f"rank {r} ") for f in failed)]
    if failed:
        for r in range(world):
            with open(os.path.join(workdir, f"rank{r}.log")) as f:
                log(f"{what} rank {r} log:\n" + f.read()[-4000:])
        raise AssertionError(f"{what}: " + "; ".join(failed))
    reps = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            reps.append(json.load(f))
    return reps


def multigpu_phase(dev, ckdir, counters):
    """Data and tensor parallel across processes, one rank a process:
    one rank a card over NCCL on 2-4 cards, else two ranks on cuda:0
    over gloo (a one-card correctness run).  The one-rank references
    run here first; each rank then checks (a) a float32 flagship
    Trainer's step-1 gradients, 3 AdamW steps' losses and parameters
    (flash kernels) against them; (d) that state saved by every rank and
    restored bitwise on one rank and under dp; (e) with 2+ cards the
    read-once restore over kernel 7 across processes; (b) the serving
    weights through ``load_sharded``, bitwise a whole load sliced, with
    no bounce; (c) sharded ``generate`` on kernel 2, tokens equal the
    one-rank run's; (f) a bf16 step at Llama-3-8B's widths; (j)
    ``dist_groupby`` over (i)'s Parquet files, each rank its share, every
    rank (i)'s answer.  Their launches are added to ``counters``, but
    (j)'s, which each rank reports apart."""
    import shutil
    import numpy as np
    import torch
    from nvme_strom_tpu_torch.models import decode as tdec
    from nvme_strom_tpu_torch.models import transformer as ttr
    from nvme_strom_tpu_torch.ops.flash_attention import make_flash_attn
    from nvme_strom_tpu_torch.train import Trainer
    t0 = time.monotonic()
    cards = torch.cuda.device_count()
    world = 2 if cards < 4 else 4
    backend = "nccl" if cards >= 2 else "gloo"
    workdir = os.path.join(DATA_DIR, "multigpu")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)

    # the one-rank references, on cuda:0 (their launches are not the
    # path's: every count restarts at 0 before the ranks start)
    cfg32 = _mg_cfg(torch.float32)
    tokens, prompt = _mg_tokens(cfg32)
    attn = make_flash_attn()
    losses = []
    with Trainer(cfg32, attn_fn=attn, device=dev, seed=SEED,
                 hooks=[lambda s, l, dt: losses.append(l)]) as tr:
        tt = torch.from_numpy(tokens).to(dev)
        _, grads = ttr.value_and_grad(tr.params, tt, cfg32, attn)
        grads = {n: g.detach() for n, g in grads.items()}
        ta = time.monotonic()
        tr.fit(iter([tt] * MG_STEPS), steps=MG_STEPS)
        torch.cuda.synchronize(dev)
        one_fit_s = time.monotonic() - ta
        params = {n: p.detach().clone() for n, p in tr.params.items()}
    full = {n: torch.from_numpy(a).to(dev)
            for n, a in ttr.init_params(SEED, cfg32).items()}
    with torch.no_grad():
        gen = tdec.generate(full, torch.from_numpy(prompt).to(dev), cfg32,
                            MG_GEN_NEW).cpu().numpy()
    del full
    f_batch = world // 2
    f_tokens = np.random.default_rng(SEED + 29).integers(
        0, LLAMA3_8B_2L["vocab"], (f_batch, MG_F_SEQ)).astype(np.int64)
    one = _llama_step(dev, None, torch.from_numpy(f_tokens[:1]).to(dev),
                      MG_F_STEPS, profile_steps=0)
    torch.save({"tokens": torch.from_numpy(tokens),
                "prompt": torch.from_numpy(prompt),
                "gen": torch.from_numpy(gen), "losses": losses,
                "grads": grads, "params": params,
                "f_tokens": torch.from_numpy(f_tokens)},
               os.path.join(workdir, "ref.pt"))
    del grads, params
    gc.collect()
    torch.cuda.empty_cache()
    if not os.path.exists(os.path.join(_sql_dir(), "multi_answer.npz")):
        sql_multi_files(dev)          # (j)'s files, when run alone
    t_ref = time.monotonic() - t0
    for fn in counters.values():
        fn.launches = 0

    reps = _run_ranks("--multigpu-worker", world, workdir,
                      [workdir, backend, ckdir], MG_JOIN_S, "multigpu")
    # the counts are the ranks' own: every rank launches every kernel of
    # the path (kernel 7 only across cards)
    need = ("h2d_copy", "decode_attention", "flash_fwd", "flash_bwd_dq",
            "flash_bwd_dkv") + (("ici_ring_gather",) if backend == "nccl"
                                else ())
    for rep in reps:
        for n in need:
            if rep["launches"][n] <= 0:
                raise AssertionError(f"multigpu: rank {rep['rank']} never "
                                     f"launched {n}")
        # (j)'s scans go through kernel 1 on every rank, counted apart
        if rep["j"]["launches"]["h2d_copy"] <= 0:
            raise AssertionError(f"multigpu (j): rank {rep['rank']} never "
                                 "launched h2d_copy")
        for n, c in rep["launches"].items():
            counters[n].launches += c
    seconds = time.monotonic() - t0
    label = ("one-card correctness run (2 ranks on cuda:0, gloo)"
             if backend == "gloo" else f"{world} cards, NCCL")
    a = reps[0]["a"]
    log(f"multigpu (a) {label}: tp 2 x dp {world // 2}, flagship float32 "
        f"seq {MG_PARITY_SEQ} batch {MG_PARITY_BATCH}, flash: losses "
        f"{a['losses']} against one rank's {losses}; step-1 gradients and "
        f"{sum(r['a']['params'] for r in reps)} parameter elements within "
        f"(1e-4, 1e-5) but {sum(r['a']['param_exempt_near_zero_grad'] for r in reps)} "
        f"whose step-1 gradient is below {MG_NOISE_G} of its tensor's rms "
        f"(limit {MG_EXEMPT_MAX} of a rank's elements: "
        f"{[round(r['a']['param_exempt_limit']) for r in reps]}); "
        f"3 steps {max(r['a']['fit_s'] for r in reps):.3f} s against one "
        f"rank's {one_fit_s:.3f} s")
    log(f"multigpu (b) serving weights through load_sharded: per-rank NVMe "
        f"bytes {[r['b']['nvme_bytes'] for r in reps]}, slice bytes "
        f"{[r['b']['slice_bytes'] for r in reps]}, bounce "
        f"{[r['b']['bounce_bytes'] for r in reps]}, load s "
        f"{[round(r['b']['load_s'], 4) for r in reps]}; bitwise a whole "
        "load sliced")
    log(f"multigpu (c) generate dp x tp, kernel 2 on local heads: tokens "
        f"equal the one-rank run's ({MG_GEN_NEW} new, rows "
        f"{[r['c']['rows'] for r in reps]})")
    log(f"multigpu (d) checkpoint of (a) saved by {world} ranks: restored "
        "bitwise on one rank and under dp")
    if backend == "nccl":
        e = reps[0]["e"]
        log(f"multigpu (e) read-once restore across processes: shares "
            f"{[r['e']['share_bytes'] for r in reps]} of {e['payload_bytes']}"
            f" B, fallbacks 0, bitwise; kernel 7 over IPC "
            f"{[round(r['e']['kernel_ms'], 4) for r in reps]} ms (a whole "
            f"call {[round(r['e']['call_wall_ms'], 2) for r in reps]} ms "
            "on the host's clock), "
            f"nccl.all_gather {[round(r['e']['nccl_all_gather_ms'], 4) for r in reps]} "
            f"ms, NVLink bound {e['bound_ms']:.4f} ms ({e['row_bytes']} B "
            "rows)")
    else:
        log("multigpu (e) read-once restore across processes: not run "
            "(1 card)")
    f = reps[0]["f"]
    share = ("not run (1 card)" if backend == "gloo"
             else f"{f.get('collective_share'):.4f}")
    tok_card = (world // 2) * MG_F_SEQ / (f["step_ms"] / 1e3) / max(
        1, min(cards, world))
    log(f"multigpu (f) Llama-3-8B widths 2 layers bf16 seq {MG_F_SEQ}, "
        f"flash: {label}: step {f['step_ms']:.2f} ms, "
        f"{tok_card:.0f} tokens/s a card, collectives' share of device "
        f"time {share}; one rank alone: step {one['step_ms']:.2f} ms, "
        f"{MG_F_SEQ / (one['step_ms'] / 1e3):.0f} tokens/s")
    log(f"multigpu (j) dist_groupby over (i)'s {SQL_I_FILES} files, "
        f"{[r['j']['files'] for r in reps]} a rank: every rank (i)'s counts,"
        f" SUM at {[round(r['j']['sum_ratio'], 4) for r in reps]} of its "
        f"limit, {[round(r['j']['seconds'], 3) for r in reps]} s, h2d_copy "
        f"{[r['j']['launches']['h2d_copy'] for r in reps]} launches")
    log(f"multigpu: {seconds:.1f} s (references {t_ref:.1f} s), budget "
        f"{MG_BUDGET_S} s; rank seconds "
        f"{[round(r['seconds'], 1) for r in reps]}; rank launches "
        f"{[r['launches'] for r in reps]} (without (j)'s)")
    return {"label": label, "world": world, "backend": backend,
            "cards": cards, "seconds": seconds, "ref_seconds": t_ref,
            "one_rank": {"fit_s": one_fit_s, "losses": losses,
                         "llama_step_ms": one["step_ms"]},
            "tokens_per_s_card": tok_card, "ranks": reps}


# -- sequence and pipeline parallel, one process a rank ----------------------

#: the phase's wall-clock budget (s) and its parts' shapes: (a) the ring
#: and (b) Ulysses at LONG_GQA's heads at batch 1 (b, heads, kv heads,
#: d, seq); (c) sp and (d) pp parity at the flagship's widths in
#: float32; (e) the loader's seq_axis over seeded token shards (shards,
#: rows a shard, tokens a row); (f) bf16 steps at Llama-3-8B's widths
#: (2 layers), the ring at 16384 tokens and the pipeline at 2048
SP_BUDGET_S = 90
SP_ATTN = (1, 32, 8, 128, 16384)
SP_TRAIN_SEQ, SP_TRAIN_BATCH = 2048, 4
PP_SEQ, PP_BATCH, PP_MB = 512, 8, 4
SP_STEPS = 3
SP_LR = 3e-4
SP_LOADER = (8, 16, 2048)
SP_LOADER_BATCH = 8
SP_F_SEQ = 16384
#: the lm_head and cross-entropy in 8 chunks: one rank's float32 logits
#: at 16384 × 32000 would be 2.1 GB
SP_F_CHUNKS = 8
PP_F_SEQ, PP_F_BATCH, PP_F_MB = 2048, 4, 4
SP_F_STEPS = 3
SP_JOIN_S = 420
#: (a), (b): each rank's span is held to its own floor, one rank's bf16
#: flash output's (or gradient's) distance from a float32 run over that
#: span (the JAX test's self-calibrated bound, per rank).  The output
#: may be at most SP_OUT_RATIO × the floor from one rank's bf16 output,
#: and as far from float32 (the JAX test's second band).  The ring rounds
#: each block's output to bf16 before its float32 merge and the merged
#: value once more; both outputs lie on the bf16 grid, so they differ by
#: whole ulps: one ulp at the span's largest outputs reads 2.0-2.2x a
#: floor just under half an ulp, two read 4x or more.  A gradient at
#: most 2 × ranks × its floor from one rank's (one more from float32):
#: a block's dQ or dK/dV is the bf16 sum of at most one bf16 product a
#: rank, each product and each sum half an ulp off at most, against one
#: rounding on one rank
SP_OUT_RATIO = 3.0


def _sp_attn_inputs(dev):
    """Seeded q, k, v and the output's cotangent at SP_ATTN in bf16, K/V
    drawn at the kv heads and expanded; every rank draws the same."""
    import torch
    b, h, hkv, d, s = SP_ATTN
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)

    def draw(heads):
        return torch.randn((b, heads, s, d), generator=gen, device=dev
                           ).to(torch.bfloat16)
    q = draw(h)
    k = draw(hkv).repeat_interleave(h // hkv, dim=1)
    v = draw(hkv).repeat_interleave(h // hkv, dim=1)
    return q, k, v, draw(h)


def _sp_attn_check(name, run, q, k, v, do, ref, cut, kernels, iters=3):
    """``run(q, k, v)`` on this rank's span ``cut``: its launches, its
    distance from one rank's bf16 output and gradients against their
    own distance from float32, and its forward / forward+backward ms
    (host clock, ranks in step)."""
    import torch
    from nvme_strom_tpu_torch.parallel.mesh import barrier
    qs, ks, vs = (t[:, :, cut].detach().clone().requires_grad_()
                  for t in (q, k, v))
    before = {n: fn.launches for n, fn in kernels.items()}
    o = run(qs, ks, vs)
    o.backward(do[:, :, cut])
    torch.cuda.synchronize()
    rep = {"launches": {n: fn.launches - before[n]
                        for n, fn in kernels.items()}}
    for label, got, i in (("out", o, 0), ("dq", qs.grad, 1),
                          ("dk", ks.grad, 2), ("dv", vs.grad, 3)):
        r16, r32 = ref["bf16"][i][:, :, cut], ref["f32"][i][:, :, cut]
        rep[label] = {"dist": float((got.float() - r16.float()).abs().max()),
                      "dist_f32": float((got.float() - r32).abs().max()),
                      "floor": float((r16.float() - r32).abs().max())}
    del o
    fwd, both = [], []
    with _uncounted(kernels):
        for _ in range(iters):
            barrier()
            t0 = time.monotonic()
            o = run(qs, ks, vs)
            torch.cuda.synchronize()
            t1 = time.monotonic()
            o.backward(do[:, :, cut])
            torch.cuda.synchronize()
            fwd.append((t1 - t0) * 1e3)
            both.append((time.monotonic() - t0) * 1e3)
    rep["fwd_ms"] = statistics.median(fwd)
    rep["fwd_bwd_ms"] = statistics.median(both)
    log(f"sp_pp {name}: {rep}")
    return rep


def _attn_ref(q, k, v, do):
    """out, dq, dk, dv of the flash kernels over the whole sequence on
    one rank, in bf16 and on the same values in float32."""
    import torch
    from nvme_strom_tpu_torch.ops.flash_attention import flash_attention
    out = {}
    for label, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        qq, kk, vv = (t.detach().to(dt).clone().requires_grad_()
                      for t in (q, k, v))
        o = flash_attention(qq, kk, vv, causal=True)
        o.backward(do.to(dt))
        out[label] = [o.detach(), qq.grad, kk.grad, vv.grad]
    return out


def _llama_pp_step(dev, mesh, tokens, n_mb, iters, profile_steps=0,
                   warmup=1):
    """Median ms and peak memory of a bf16 pipelined train step at
    Llama-3-8B's widths (2 layers, ``make_pp_train_step``) on this
    rank's stage and rows, and with ``profile_steps`` the device-busy ms
    a step (torch.profiler), the device-idle share and the share of the
    step the stage is not computing (idle or in a collective: the
    bubble)."""
    import torch
    from nvme_strom_tpu_torch.models import transformer as ttr
    from nvme_strom_tpu_torch.parallel import pipeline as tpp
    t_in = time.monotonic()
    cfg = ttr.TransformerConfig(**dict(LLAMA3_8B_2L, max_seq=PP_F_SEQ),
                                dtype=torch.bfloat16)
    full = _card_params(cfg, SEED + 23, dev)
    stack, rest = tpp.split_layer_stack(full, cfg)
    stack = tpp.shard_stack(stack, mesh, cfg, device=dev)
    del full
    stack = tpp.from_leaves(stack, {
        n: t.float().requires_grad_() for n, t in tpp.named_leaves(stack)})
    rest = ttr.trainable_params(rest, dev)
    torch.cuda.empty_cache()
    step = tpp.make_pp_train_step(
        cfg, ttr.adamw(tpp.pp_parameters(stack, rest), 1e-4), mesh, n_mb)
    for _ in range(warmup):
        step(stack, rest, tokens)
    setup_s = time.monotonic() - t_in
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(iters):
        torch.cuda.synchronize(dev)
        t0 = time.monotonic()
        loss = float(step(stack, rest, tokens))
        times.append((time.monotonic() - t0) * 1e3)
    out = {"step_ms": statistics.median(times), "loss": loss,
           "step_ms_all": times, "setup_s": setup_s,
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "stage": mesh.coords.get("pp", 0)}
    if profile_steps:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize(dev)
            t0 = time.monotonic()
            for _ in range(profile_steps):
                step(stack, rest, tokens)
            torch.cuda.synchronize(dev)
            wall = (time.monotonic() - t0) * 1e3
        busy, coll, kinds = _device_split(prof, profile_steps)
        wall /= profile_steps
        out["device_busy_ms"] = busy
        out["compute_ms"] = busy - coll
        out["collective_ms"] = kinds
        out["idle_share"] = 1.0 - busy / wall if wall > 0 else None
        # a stage waiting for its neighbour sits in an NCCL receive
        # kernel: the device is busy, the stage is not computing
        out["compute_idle_share"] = (1.0 - (busy - coll) / wall
                                     if wall > 0 else None)
        out["collective_share"] = coll / busy if busy else None
    del stack, rest, step
    torch.cuda.empty_cache()
    return out


def sp_pp_worker(rank: int, world: int, workdir: str, backend: str) -> None:
    """One rank of ``sp_pp_phase``: parts (a)-(f); writes its report and
    kernel launches to ``workdir``."""
    import dataclasses
    import tarfile
    import numpy as np
    import torch
    from nvme_strom_tpu_torch.data.loader import ShardedLoader
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.models import transformer as ttr
    from nvme_strom_tpu_torch.ops import flash_attention as fa
    from nvme_strom_tpu_torch.ops.bridge import h2d_copy
    from nvme_strom_tpu_torch.parallel import collectives as coll
    from nvme_strom_tpu_torch.parallel import pipeline as tpp
    from nvme_strom_tpu_torch.parallel.mesh import (
        barrier, init_distributed, make_mesh, shutdown_distributed)
    from nvme_strom_tpu_torch.parallel.ring_attention import make_ring_attn
    from nvme_strom_tpu_torch.parallel.shardings import (local_slice,
                                                         param_shardings)
    from nvme_strom_tpu_torch.parallel.ulysses import make_ulysses_attn
    from nvme_strom_tpu_torch.train import Trainer
    kernels = {"h2d_copy": h2d_copy, "flash_fwd": fa.flash_fwd,
               "flash_bwd_dq": fa.flash_bwd_dq,
               "flash_bwd_dkv": fa.flash_bwd_dkv}
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    entry = time.time()
    init_distributed("file://" + os.path.join(workdir, "store"), world,
                     rank, backend=backend, device=dev, timeout_s=180)
    for fn in kernels.values():
        fn.launches = 0
    # wall-clock marks, for where the phase's seconds go: the rank's
    # entry (after its imports), each part's end, and the time spent
    # making meshes (their process groups), each made once
    rep: dict = {"rank": rank, "entry_wall": entry, "t0_wall": time.time()}
    t0 = time.monotonic()
    marks: dict = {}
    made: dict = {}
    mesh_s = [0.0]

    def mark(part):
        marks[part] = time.monotonic() - t0

    def mesh(axes):
        key = tuple(axes.items())
        if key not in made:
            ta = time.monotonic()
            made[key] = make_mesh(axes)
            mesh_s[0] += time.monotonic() - ta
        return made[key]

    sp_mesh = mesh({"sp": world})
    # on one card the ranks are time-sliced and their collectives cross
    # the host, so no time counts there: one call or step drives each
    # path, unwarmed, unprofiled
    timed = backend == "nccl"
    steps = SP_F_STEPS if timed else 1

    # (a) the ring on the flash kernels, (b) Ulysses on them
    q, k, v, do = _sp_attn_inputs(dev)
    with _uncounted(kernels):
        ref = _attn_ref(q, k, v, do)
    mark("a_ref")
    w = SP_ATTN[4] // world
    cut = slice(rank * w, (rank + 1) * w)
    rep["a"] = _sp_attn_check("(a) ring", make_ring_attn(sp_mesh,
                                                         inner="flash"),
                              q, k, v, do, ref, cut, kernels,
                              iters=3 if timed else 1)
    mark("a")
    rep["b"] = _sp_attn_check("(b) ulysses", make_ulysses_attn(
        sp_mesh, attn=fa.make_flash_attn()), q, k, v, do, ref, cut, kernels,
        iters=3 if timed else 1)
    mark("b")
    if rank == 0:
        # one rank's flash forward / forward+backward on the whole
        # sequence, the others waiting
        with _uncounted(kernels):
            qq, kk, vv = (t.detach().clone().requires_grad_()
                          for t in (q, k, v))
            fwd, both = [], []
            for _ in range(3):
                t1 = time.monotonic()
                o = fa.flash_attention(qq, kk, vv)
                torch.cuda.synchronize()
                t2 = time.monotonic()
                o.backward(do)
                torch.cuda.synchronize()
                fwd.append((t2 - t1) * 1e3)
                both.append((time.monotonic() - t1) * 1e3)
        rep["one_rank_attn"] = {"fwd_ms": statistics.median(fwd),
                                "fwd_bwd_ms": statistics.median(both)}
        del qq, kk, vv, o
    barrier()
    del q, k, v, do, ref
    torch.cuda.empty_cache()
    mark("ab")

    refs = torch.load(os.path.join(workdir, "ref.pt"), map_location=dev)
    mark("refs_load")
    # (c) sp train parity: the float32 flagship through Trainer, the ring
    # on the flash kernels
    cfg32 = dataclasses.replace(_mg_cfg(torch.float32),
                                max_seq=SP_TRAIN_SEQ)
    shapes = ttr.param_shapes(cfg32)
    meshes = [sp_mesh] + ([mesh({"dp": 2, "sp": 2}),
                           mesh({"tp": 2, "sp": 2})]
                          if world == 4 else [])
    rep["c"] = []
    for m in meshes:
        attn = make_ring_attn(m, inner="flash")
        sh = param_shardings(cfg32, m)
        mine = local_slice(refs["sp_tokens"], m, seq_axis="sp")
        losses = []
        with Trainer(cfg32, mesh=m, attn_fn=attn, device=dev, seed=SEED,
                     lr=SP_LR,
                     hooks=[lambda s, l, dt: losses.append(l)]) as tr:
            with coll.use_mesh(m):
                _, grads = ttr.value_and_grad(tr.params, mine, cfg32, attn)
            g = list(grads.values())
            coll.mesh_mean_(g, m)
            n_g = 0
            for name, gr in zip(grads, g):
                b = sh[name].local_bounds(shapes[name])
                n_g += _mg_close(
                    f"sp (c) {m.shape} step-1 gradient {name}", gr,
                    refs["sp_grads"][name][tuple(slice(x, y)
                                                 for x, y in b)],
                    MG_PARAM_TOL)[0]
            torch.cuda.synchronize(dev)
            ta = time.monotonic()
            tr.fit(iter([mine] * SP_STEPS), steps=SP_STEPS)
            torch.cuda.synchronize(dev)
            fit_s = time.monotonic() - ta
            for got, want in zip(losses, refs["sp_losses"]):
                if abs(got - want) > MG_LOSS_RTOL * abs(want):
                    raise AssertionError(
                        f"sp_pp (c) {m.shape}: losses {losses} against "
                        f"one rank's {refs['sp_losses']}")
            outside = exempt = 0
            for name, p in tr.params.items():
                b = sh[name].local_bounds(shapes[name])
                c = tuple(slice(x, y) for x, y in b)
                o, e = _mg_close(f"sp (c) {m.shape} parameter {name}",
                                 p.detach(), refs["sp_params"][name][c],
                                 MG_PARAM_TOL, refs["sp_grads"][name][c])
                outside += o
                exempt += e
            n_params = sum(p.numel() for p in tr.params.values())
        if exempt > MG_EXEMPT_MAX * n_params:
            raise AssertionError(f"sp_pp (c) {m.shape}: {exempt} of "
                                 f"{n_params} elements exempt, above "
                                 f"{MG_EXEMPT_MAX * n_params:.0f}")
        rep["c"].append({"mesh": dict(m.shape), "losses": losses,
                         "grad_outside": n_g, "param_outside": outside,
                         "param_exempt_near_zero_grad": exempt,
                         "params": n_params, "fit_s": fit_s})
    torch.cuda.empty_cache()
    mark("c")

    # (d) pp train parity: the float32 flagship through
    # make_pp_train_step, 4 microbatches
    cfgpp = dataclasses.replace(_mg_cfg(torch.float32), max_seq=PP_SEQ)
    meshes = ([mesh({"dp": 1, "pp": 2})] if world == 2 else
              [mesh({"pp": 2, "tp": 2}), mesh({"dp": 2, "pp": 2})])
    want_stack, want_rest = tpp.split_layer_stack(refs["pp_grads"], cfgpp)
    want_stack = dict(tpp.named_leaves(want_stack))
    rep["d"] = []
    for m in meshes:
        stack, rest = tpp.split_layer_stack(ttr.init_params(SEED, cfgpp),
                                            cfgpp)
        shs = dict(tpp.named_leaves(tpp.stacked_shardings(m, cfgpp)))
        stack = tpp.shard_stack(stack, m, cfgpp, device=dev)
        stack = tpp.from_leaves(stack, {n: t.requires_grad_() for n, t in
                                        tpp.named_leaves(stack)})
        rest = ttr.trainable_params(rest, dev)
        mine = local_slice(refs["pp_tokens"], m)
        _, g_stack, g_rest = tpp.make_pp_value_and_grad(
            cfgpp, m, PP_MB)(stack, rest, mine)
        n_g = 0
        for name, gr in tpp.named_leaves(g_stack):
            want = want_stack[name]
            b = shs[name].local_bounds(tuple(want.shape))
            n_g += _mg_close(f"pp (d) {m.shape} step-1 gradient {name}",
                             gr, want[tuple(slice(x, y) for x, y in b)],
                             MG_PARAM_TOL)[0]
        for name, gr in g_rest.items():
            n_g += _mg_close(f"pp (d) {m.shape} step-1 gradient {name}",
                             gr, want_rest[name], MG_PARAM_TOL)[0]
        del g_stack, g_rest
        step = tpp.make_pp_train_step(
            cfgpp, ttr.adamw(tpp.pp_parameters(stack, rest), SP_LR), m,
            PP_MB)
        torch.cuda.synchronize(dev)
        ta = time.monotonic()
        losses = [float(step(stack, rest, mine)) for _ in range(SP_STEPS)]
        torch.cuda.synchronize(dev)
        fit_s = time.monotonic() - ta
        for got, want in zip(losses, refs["pp_losses"]):
            if abs(got - want) > MG_LOSS_RTOL * abs(want):
                raise AssertionError(
                    f"sp_pp (d) {m.shape}: losses {losses} against one "
                    f"rank's {refs['pp_losses']}")
        rep["d"].append({"mesh": dict(m.shape), "losses": losses,
                         "grad_outside": n_g, "fit_s": fit_s})
        del stack, rest, step
    del refs["sp_grads"], refs["sp_params"], refs["pp_grads"]
    torch.cuda.empty_cache()
    mark("d")

    # (e) the loader's seq_axis: sp peers read the same shards, each
    # keeps its span, which reaches the card through h2d_copy
    lmesh = mesh({"dp": world // 2, "sp": 2})

    def decode(parts):
        (payload,) = parts.values()
        return np.frombuffer(payload, dtype=np.int32)

    with StromEngine() as eng:
        h0 = h2d_copy.launches
        te = time.monotonic()
        with ShardedLoader(refs["shards"], SP_LOADER_BATCH, decode=decode,
                           engine=eng, device=dev, mesh=lmesh,
                           seq_axis="sp") as ld:
            got = [b.cpu() for b in ld]
            mine_shards = list(ld.local_shards)
            local_batch = ld.local_batch
        load_s = time.monotonic() - te
        eng.sync_stats()
        st = eng.stats.snapshot()
    rows = []
    for path in mine_shards:
        with tarfile.open(path) as tf:
            rows += [np.frombuffer(tf.extractfile(m).read(), np.int32)
                     for m in tf.getmembers()]
    span = SP_LOADER[2] // 2
    i = lmesh.coords["sp"]
    want = [np.stack(rows[j:j + local_batch])[:, i * span:(i + 1) * span]
            for j in range(0, len(rows) - local_batch + 1, local_batch)]
    if len(got) != len(want) or not all(
            np.array_equal(g.numpy(), w) for g, w in zip(got, want)):
        raise AssertionError(f"sp_pp (e): rank {rank}'s batches are not "
                             "its span of its group's rows")
    rep["e"] = {"dp": lmesh.coords["dp"], "batches": len(got),
                "batch_shape": list(got[0].shape),
                "shards": [os.path.basename(p) for p in mine_shards],
                "nvme_bytes": st["bytes_direct"] + st["bytes_fallback"],
                "bytes_direct": st["bytes_direct"],
                "bounce_bytes": st["bounce_bytes"],
                "h2d_copy_launches": h2d_copy.launches - h0,
                "load_s": load_s}
    log(f"sp_pp (e): {rep['e']}")
    mark("e")

    # (f) throughput at Llama-3-8B's widths: the ring at SP_F_SEQ over
    # every rank, and a pp 2 step (one layer a stage)
    ftoks = refs["f_tokens"]
    rep["f_sp"] = _llama_step(
        dev, sp_mesh, local_slice(ftoks, sp_mesh, seq_axis="sp"),
        steps, profile_steps=2 if timed else 0,
        attn_fn=make_ring_attn(sp_mesh, inner="flash"),
        xent_chunks=SP_F_CHUNKS, warmup=int(timed))
    mark("f_sp")
    pmesh = mesh({"dp": world // 2, "pp": 2})
    rep["f_pp"] = _llama_pp_step(dev, pmesh, local_slice(
        refs["f_pp_tokens"], pmesh), PP_F_MB, steps,
        profile_steps=int(timed), warmup=int(timed))
    mark("f_pp")
    rep["marks_s"] = marks
    rep["mesh_s"] = mesh_s[0]
    rep["seconds"] = time.monotonic() - t0
    rep["launches"] = {n: fn.launches for n, fn in kernels.items()}
    barrier()
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(rep, f)
    shutdown_distributed()


def sp_pp_phase(dev, counters):
    """Sequence and pipeline parallelism across processes, one rank a
    process: one a card over NCCL on 2-4 cards, else two on cuda:0 over
    gloo (a one-card correctness run).  The one-rank references run here
    first; each rank then checks (a) the ring on the flash kernels and
    (b) Ulysses on them against one rank's flash over the whole sequence
    (self-calibrated against float32), counting the ring's launches;
    (c) a float32 flagship Trainer under sp (the ring on the flash
    kernels) and (d) a pipelined one, against one rank's losses,
    gradients and parameters; (e) the loader's seq_axis; (f) bf16 steps
    at Llama-3-8B's widths.  Their launches are added to ``counters``."""
    import dataclasses
    import shutil
    import numpy as np
    import torch
    from nvme_strom_tpu_torch.models import transformer as ttr
    from nvme_strom_tpu_torch.ops.flash_attention import make_flash_attn
    from nvme_strom_tpu_torch.parallel.mesh import make_mesh
    from nvme_strom_tpu_torch.train import Trainer
    from nvme_strom_tpu_torch.train_lm import synthesize_shards
    t0 = time.monotonic()
    cards = torch.cuda.device_count()
    world = 2 if cards < 4 else 4
    backend = "nccl" if cards >= 2 else "gloo"
    workdir = os.path.join(DATA_DIR, "sp_pp")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)

    # the one-rank references, on cuda:0 (every count restarts at 0
    # before the ranks start)
    rng = np.random.default_rng(SEED + 43)
    cfg32 = dataclasses.replace(_mg_cfg(torch.float32), max_seq=SP_TRAIN_SEQ)
    sp_tokens = torch.from_numpy(rng.integers(
        0, cfg32.vocab, (SP_TRAIN_BATCH, SP_TRAIN_SEQ))).to(dev)
    sp_losses = []
    with Trainer(cfg32, attn_fn=make_flash_attn(), device=dev, seed=SEED,
                 lr=SP_LR, hooks=[lambda s, l, dt: sp_losses.append(l)]
                 ) as tr:
        _, sp_grads = ttr.value_and_grad(tr.params, sp_tokens, cfg32,
                                         make_flash_attn())
        ta = time.monotonic()
        tr.fit(iter([sp_tokens] * SP_STEPS), steps=SP_STEPS)
        torch.cuda.synchronize(dev)
        sp_fit_s = time.monotonic() - ta
        sp_params = {n: p.detach().clone() for n, p in tr.params.items()}
    cfgpp = dataclasses.replace(_mg_cfg(torch.float32), max_seq=PP_SEQ)
    pp_tokens = torch.from_numpy(rng.integers(
        0, cfgpp.vocab, (PP_BATCH, PP_SEQ))).to(dev)
    params = ttr.trainable_params(ttr.init_params(SEED, cfgpp), dev)
    _, pp_grads = ttr.value_and_grad(params, pp_tokens, cfgpp)
    step = ttr.make_train_step(cfgpp, ttr.adamw(params, SP_LR))
    ta = time.monotonic()
    pp_losses = [float(step(params, pp_tokens)) for _ in range(SP_STEPS)]
    pp_fit_s = time.monotonic() - ta
    del params, step
    ref_marks = {"trainers": time.monotonic() - t0}
    f_tokens = torch.from_numpy(rng.integers(
        0, LLAMA3_8B_2L["vocab"], (1, SP_F_SEQ)))
    f_pp_tokens = torch.from_numpy(rng.integers(
        0, LLAMA3_8B_2L["vocab"], (PP_F_BATCH * (world // 2), PP_F_SEQ)))
    one_sp = _llama_step(dev, None, f_tokens.to(dev), SP_F_STEPS,
                         xent_chunks=SP_F_CHUNKS, warmup=1)
    ref_marks["llama_sp"] = time.monotonic() - t0
    one_pp = _llama_pp_step(dev, make_mesh({"pp": 1}, world_size=1),
                            f_pp_tokens[:PP_F_BATCH].to(dev), PP_F_MB,
                            SP_F_STEPS, profile_steps=1)
    ref_marks["llama_pp"] = time.monotonic() - t0
    shard_dir = os.path.join(workdir, "shards")
    os.makedirs(shard_dir)
    n_shards, per_shard, seq = SP_LOADER
    shards = synthesize_shards(shard_dir, LLAMA3_8B_2L["vocab"], seq,
                               n_shards=n_shards, per_shard=per_shard,
                               seed=SEED + 47)
    ts = time.monotonic()
    torch.save({"sp_tokens": sp_tokens, "sp_losses": sp_losses,
                "sp_grads": sp_grads, "sp_params": sp_params,
                "pp_tokens": pp_tokens, "pp_losses": pp_losses,
                "pp_grads": pp_grads, "f_tokens": f_tokens,
                "f_pp_tokens": f_pp_tokens, "shards": shards},
               os.path.join(workdir, "ref.pt"))
    save_s = time.monotonic() - ts
    del sp_grads, sp_params, pp_grads
    gc.collect()
    torch.cuda.empty_cache()
    t_ref = time.monotonic() - t0
    for fn in counters.values():
        fn.launches = 0

    spawn = time.time()
    reps = _run_ranks("--sp-pp-worker", world, workdir, [workdir, backend],
                      SP_JOIN_S, "sp_pp")
    t_ranks = time.time() - spawn
    need = ("h2d_copy", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    for rep in reps:
        for n in need:
            if rep["launches"][n] <= 0:
                raise AssertionError(f"sp_pp: rank {rep['rank']} never "
                                     f"launched {n}")
        for n, c in rep["launches"].items():
            counters[n].launches += c
    # a ring call launches each flash kernel n(n+1)/2 times over n
    # ranks; Ulysses once a rank
    tri = world * (world + 1) // 2
    for part, want in (("a", tri), ("b", world)):
        for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            got = sum(r[part]["launches"][n] for r in reps)
            if got != want:
                raise AssertionError(f"sp_pp ({part}): {n} launched {got} "
                                     f"times over {world} ranks, not {want}")
    # (e): sp peers (one dp coordinate) read the same shards in the same
    # order, and as many NVMe bytes; the dp groups share the shards out
    groups: dict = {}
    for rep in reps:
        groups.setdefault(rep["e"]["dp"], []).append(rep["e"])
    for dp, peers in groups.items():
        if any((p["shards"], p["nvme_bytes"]) != (peers[0]["shards"],
                                                  peers[0]["nvme_bytes"])
               for p in peers):
            raise AssertionError(
                f"sp_pp (e): the sp peers at dp {dp} read different shards "
                f"or bytes: {[(p['shards'], p['nvme_bytes']) for p in peers]}")
    read = sorted(x for peers in groups.values() for x in peers[0]["shards"])
    if read != sorted(os.path.basename(p) for p in shards):
        raise AssertionError(f"sp_pp (e): the dp groups read {read}, not "
                             "each shard once")
    # (a), (b): every rank against its own span's floor, so that no
    # rank's bound is set by another's larger outputs
    errs = {}
    for part in ("a", "b"):
        errs[part] = {}
        for t in ("out", "dq", "dk", "dv"):
            limit = SP_OUT_RATIO if t == "out" else 2.0 * world
            limit32 = SP_OUT_RATIO if t == "out" else limit + 1.0
            xs = [r[part][t] for r in reps]
            errs[part][t] = {
                "ratio": [x["dist"] / x["floor"] if x["floor"] > 0
                          else float("inf") for x in xs],
                "ratio_f32": [x["dist_f32"] / x["floor"] if x["floor"] > 0
                              else float("inf") for x in xs],
                "floor": [x["floor"] for x in xs],
                "limit": limit, "limit_f32": limit32}
    log(f"sp_pp (a), (b) by rank: {json.dumps(errs)}")
    for part, by_t in errs.items():
        for t, e in by_t.items():
            for rank, (x, x32) in enumerate(zip(e["ratio"],
                                                e["ratio_f32"])):
                if not (x <= e["limit"] and x32 <= e["limit_f32"]):
                    raise AssertionError(
                        f"sp_pp ({part}) {t}, rank {rank}: {x}x its span's "
                        f"floor from one rank's bf16 and {x32}x from "
                        f"float32 (limits {e['limit']}x, "
                        f"{e['limit_f32']}x)")
    seconds = time.monotonic() - t0
    label = ("one-card correctness run (2 ranks on cuda:0, gloo)"
             if backend == "gloo" else f"{world} cards, NCCL")
    ring_ms = [r["a"]["fwd_ms"] for r in reps]
    one_attn = reps[0]["one_rank_attn"]
    b, h, hkv, d, s = SP_ATTN

    def by_rank(part):
        return "; ".join(
            f"{t} {[round(x, 3) for x in errs[part][t]['ratio']]} / "
            f"{[round(x, 3) for x in errs[part][t]['ratio_f32']]}"
            for t in ("out", "dq", "dk", "dv"))

    log(f"sp_pp (a) {label}: ring on the flash kernels, b {b}, {h} heads "
        f"(GQA from {hkv}), d {d}, seq {s} over sp {world}, bf16, causal: "
        f"flash launches a call {tri} each (fwd, dq, dkv); by rank, the "
        f"distance from one rank's bf16 / from float32 over its span's "
        f"floor: {by_rank('a')} (limits out {SP_OUT_RATIO} / "
        f"{SP_OUT_RATIO}, grads {2 * world} / {2 * world + 1}); forward "
        f"{[round(x, 2) for x in ring_ms]} ms, forward+backward "
        f"{[round(r['a']['fwd_bwd_ms'], 2) for r in reps]} ms a rank; one "
        f"rank's flash {one_attn['fwd_ms']:.2f} / "
        f"{one_attn['fwd_bwd_ms']:.2f} ms")
    log(f"sp_pp (b) Ulysses, flash inner, by rank: {by_rank('b')}; "
        f"forward {[round(r['b']['fwd_ms'], 2) for r in reps]} ms, "
        f"forward+backward {[round(r['b']['fwd_bwd_ms'], 2) for r in reps]}"
        " ms a rank")
    for i, c in enumerate(reps[0]["c"]):
        log(f"sp_pp (c) sp train {c['mesh']}, flagship float32 seq "
            f"{SP_TRAIN_SEQ} batch {SP_TRAIN_BATCH}, ring flash: losses "
            f"{c['losses']} against one rank's {sp_losses}; step-1 "
            "gradients and parameters within (1e-4, 1e-5) but "
            f"{sum(r['c'][i]['param_exempt_near_zero_grad'] for r in reps)}"
            f" elements under a near-zero step-1 gradient; {SP_STEPS} steps "
            f"{max(r['c'][i]['fit_s'] for r in reps):.3f} s against one "
            f"rank's {sp_fit_s:.3f} s")
    for i, c in enumerate(reps[0]["d"]):
        log(f"sp_pp (d) pp train {c['mesh']}, flagship float32 seq {PP_SEQ} "
            f"batch {PP_BATCH}, {PP_MB} microbatches: losses {c['losses']} "
            f"against one rank's {pp_losses}; step-1 gradients within "
            f"(1e-4, 1e-5); {SP_STEPS} steps "
            f"{max(r['d'][i]['fit_s'] for r in reps):.3f} s against one "
            f"rank's {pp_fit_s:.3f} s")
    log(f"sp_pp (e) loader seq_axis (dp {world // 2} x sp 2, batch "
        f"{SP_LOADER_BATCH} of {SP_LOADER[2]} tokens): per-rank NVMe bytes "
        f"{[r['e']['nvme_bytes'] for r in reps]}, shards "
        f"{[r['e']['shards'] for r in reps]}, batch "
        f"{reps[0]['e']['batch_shape']}, h2d_copy launches "
        f"{[r['e']['h2d_copy_launches'] for r in reps]}, bounce "
        f"{[r['e']['bounce_bytes'] for r in reps]}; every batch bitwise "
        "its span, sp peers' shards and bytes equal")
    fs = [r["f_sp"] for r in reps]
    fp = [r["f_pp"] for r in reps]
    n_cards = max(1, min(cards, world))
    sp_tok = SP_F_SEQ / (max(f["step_ms"] for f in fs) / 1e3) / n_cards
    pp_tok = (PP_F_BATCH * (world // 2) * PP_F_SEQ
              / (max(f["step_ms"] for f in fp) / 1e3) / n_cards)

    def split(f):
        return (f"compute {f['compute_ms']:.2f} ms, NCCL "
                + ", ".join(f"{k} {v:.2f}" for k, v in
                            sorted(f["collective_ms"].items())))

    unmeasured = "not measured (one card: gloo through host memory)"
    share = (unmeasured if backend == "gloo"
             else f"{[round(f.get('collective_share') or 0.0, 4) for f in fs]}"
             f" (by rank, a step: {'; '.join(split(f) for f in fs)})")
    bubble = (unmeasured if backend == "gloo" else
              f"by stage device idle "
              f"{[(f['stage'], round(f['idle_share'], 4)) for f in fp]} and "
              f"not computing "
              f"{[(f['stage'], round(f['compute_idle_share'], 4)) for f in fp]}"
              f" (by rank, a step: {'; '.join(split(f) for f in fp)})")
    steps = ("one unwarmed step" if backend == "gloo"
             else f"median of {SP_F_STEPS}")
    log(f"sp_pp (f) Llama-3-8B widths 2 layers bf16, {label}: sp {world} "
        f"seq {SP_F_SEQ} batch 1 ring flash: step ({steps}) "
        f"{[round(f['step_ms'], 2) for f in fs]} ms, {sp_tok:.0f} tokens/s "
        f"a card, peak {[round(f['peak_gib'], 2) for f in fs]} GiB, "
        f"collectives' share {share}; one rank: step "
        f"{one_sp['step_ms']:.2f} ms, {SP_F_SEQ / one_sp['step_ms'] * 1e3:.0f}"
        f" tokens/s, peak {one_sp['peak_gib']:.2f} GiB")
    log(f"sp_pp (f) pp 2 x dp {world // 2}, seq {PP_F_SEQ}, batch "
        f"{PP_F_BATCH} a dp rank, {PP_F_MB} microbatches: step ({steps}) "
        f"{[round(f['step_ms'], 2) for f in fp]} ms, {pp_tok:.0f} tokens/s a "
        f"card, peak {[round(f['peak_gib'], 2) for f in fp]} GiB, {bubble}"
        f"; one rank (pp 1): step {one_pp['step_ms']:.2f} ms, "
        f"{PP_F_BATCH * PP_F_SEQ / one_pp['step_ms'] * 1e3:.0f} tokens/s, "
        f"peak {one_pp['peak_gib']:.2f} GiB, idle {one_pp['idle_share']:.4f}")
    log(f"sp_pp: {seconds:.1f} s (references {t_ref:.1f} s, their parts' "
        f"ends {({k: round(v, 1) for k, v in ref_marks.items()})} s, of them "
        f"{save_s:.1f} s saving {os.path.getsize(os.path.join(workdir, 'ref.pt'))}"
        f" B for the ranks; the ranks "
        f"{t_ranks:.1f} s), budget {SP_BUDGET_S} s; by rank: from the spawn "
        f"to its entry {[round(r['entry_wall'] - spawn, 1) for r in reps]} s"
        f", init_distributed "
        f"{[round(r['t0_wall'] - r['entry_wall'], 1) for r in reps]} s, "
        f"parts' ends {[{k: round(v, 1) for k, v in r['marks_s'].items()} for r in reps]}"
        f" s, making meshes {[round(r['mesh_s'], 1) for r in reps]} s, "
        f"(f)'s set-up (weights, optimizer, warm-up) "
        f"{[(round(r['f_sp']['setup_s'], 1), round(r['f_pp']['setup_s'], 1)) for r in reps]}"
        f" s; "
        f"rank launches {[r['launches'] for r in reps]}")
    return {"label": label, "world": world, "backend": backend,
            "cards": cards, "seconds": seconds, "ref_seconds": t_ref,
            "ranks_seconds": t_ranks,
            "errors": errs, "ring_launches_a_call": tri,
            "one_rank": {"sp_fit_s": sp_fit_s, "sp_losses": sp_losses,
                         "pp_fit_s": pp_fit_s, "pp_losses": pp_losses,
                         "llama_sp": one_sp, "llama_pp": one_pp},
            "tokens_per_s_card": {"sp": sp_tok, "pp": pp_tok},
            "ranks": reps}


# -- the operator tools on the card ---------------------------------------------

TOOLS_BUDGET_S = 90
#: ssd2gpu_test's chunk and depth (the tool's defaults) and trials
TOOLS_CHUNK = 8 << 20
TOOLS_DEPTH = 8
TOOLS_TRIALS = 3
#: stream_probe's file (the JAX probe's default size)
TOOLS_PROBE_BYTES = 512 << 20
#: LLAMA3_8B_2L's widths as an HF Llama-3.1 checkpoint: llama3 rope
#: scaling of Llama-3.1-8B's config, 2 layers, the 32000 vocab
TOOLS_HF_CONFIG = dict(
    architectures=["LlamaForCausalLM"], vocab_size=32000, hidden_size=4096,
    intermediate_size=14336, num_hidden_layers=2, num_attention_heads=32,
    num_key_value_heads=8, max_position_embeddings=131072,
    rms_norm_eps=1e-5, rope_theta=500000.0, hidden_act="silu",
    tie_word_embeddings=False, torch_dtype="bfloat16",
    rope_scaling={"rope_type": "llama3", "factor": 8.0,
                  "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                  "original_max_position_embeddings": 8192})
TOOLS_GEN_NEW = 16


def _tool_out(fn, argv):
    """(exit code, standard output) of a tool's ``main(argv)`` run in
    this process."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


def _tools_headline(dev, stream_path):
    """(a) ssd2gpu_test --ceilings --verify on the 2 GiB stream file."""
    from nvme_strom_tpu_torch.tools import ssd2gpu_test
    rc, out = _tool_out(ssd2gpu_test.main, [
        stream_path, "--ceilings", "--verify", "--trials",
        str(TOOLS_TRIALS), "--chunk-bytes", str(TOOLS_CHUNK), "--depth",
        str(TOOLS_DEPTH), "--device", str(dev)])
    res = json.loads(out.strip().splitlines()[-1])
    for k, t in enumerate(res["trials"]):
        s = t["stream"]
        log(f"tools (a) trial {k + 1}: raw SSD {t['ssd']['gib_per_s']:.3f} "
            f"GiB/s, h2d_copy from one pinned buffer "
            f"{t['h2d']['gib_per_s']:.3f}, the stream "
            f"{s['gib_per_s']:.3f} ({s['chunks']} chunks, "
            f"{s['chunks_verified']} read back and equal to pread, "
            f"{s['h2d_copy_launches']} h2d_copy launches, bounce "
            f"{s['bounce_bytes']}, direct {s['bytes_direct']}, fallback "
            f"{s['bytes_fallback']})")
        if s["verify"] != "ok" or s["chunks_verified"] != s["chunks"]:
            raise AssertionError(f"tools (a): a chunk read back from the "
                                 f"card differs from pread: {s}")
        if s["h2d_copy_launches"] != s["chunks"]:
            raise AssertionError(f"tools (a): {s['h2d_copy_launches']} "
                                 f"h2d_copy launches for {s['chunks']} "
                                 "chunks")
        if s["bytes_fallback"] == 0 and s["bounce_bytes"] != 0:
            raise AssertionError(f"tools (a): O_DIRECT reads bounced "
                                 f"{s['bounce_bytes']} bytes")
    if rc != 0:
        raise AssertionError(f"tools (a): ssd2gpu_test exited {rc}")
    med = res["median_gib_per_s"]
    log(f"tools (a) medians of {TOOLS_TRIALS} trials in turns "
        f"(chunk {TOOLS_CHUNK >> 20} MiB, depth {TOOLS_DEPTH}): raw SSD "
        f"{med['ssd']:.3f} GiB/s, host→device {med['h2d']:.3f}, stream "
        f"{med['stream']:.3f}; the stream is "
        f"{res['stream_share_of_lower_ceiling']:.4f} of the lower ceiling "
        f"({res['lower_ceiling']})")
    return res


def _tools_probes(dev, tdir):
    """(b) transfer_diag, (c) stream_probe, (d) kernel_probe."""
    import torch
    from nvme_strom_tpu_torch.tools import (kernel_probe, ssd2gpu_test,
                                            stream_probe, transfer_diag)
    diag = transfer_diag.run(4 << 20, repeats=5, device=dev)
    log("tools (b) transfer_diag " + json.dumps(diag))
    if not (diag["view_in_pool"] and diag["view_registered"]):
        raise AssertionError(f"tools (b): the view does not alias the "
                             f"registered staging pool: {diag}")
    if diag["bounce_staging"] != 0 or diag["bounce_heap"] != diag["bytes"]:
        raise AssertionError(f"tools (b): bounce staging "
                             f"{diag['bounce_staging']}, heap "
                             f"{diag['bounce_heap']}")
    path = os.path.join(tdir, "probe.bin")
    ssd2gpu_test.make_test_file(path, TOOLS_PROBE_BYTES)
    try:
        probes = stream_probe.run(
            path, dev, emit=lambda r: log("tools (c) " + json.dumps(r)))
    finally:
        os.remove(path)
    for r in probes:
        if r["probe"] == "boundary":
            continue
        if r["h2d_copy_launches"] <= 0 or (r["bytes_fallback"] == 0
                                           and r["bounce_bytes"] != 0):
            raise AssertionError(f"tools (c): {r}")
    kernels = []
    for name, shape in kernel_probe.SHAPES.items():
        for r in kernel_probe.probe_attention(dev, *shape):
            log(f"tools (d) {name} " + json.dumps(r))
            kernels.append(r)
            if r["impl"] == "flash" and not r["within_tol"]:
                raise AssertionError(f"tools (d): flash at {name} outside "
                                     f"the bf16 tolerance: {r}")
        torch.cuda.empty_cache()
    roof = kernel_probe.probe_matmul_roof(dev)
    for r in roof:
        log("tools (d) " + json.dumps(r))
    return {"transfer_diag": diag, "stream_probe": probes,
            "kernel_probe": kernels, "matmul_roof": roof}


def _tools_stats(dev, export, stream_path):
    """(f) strom_stat over the phase's $STROM_STATS_EXPORT."""
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.tools import strom_stat
    from nvme_strom_tpu_torch.utils.stats import COUNTERS
    after_a = strom_stat.load(export)
    if not after_a.get("lat_read_p99_us", 0) > 0:
        raise AssertionError(f"tools (f): lat_read_p99_us after (a): "
                             f"{after_a.get('lat_read_p99_us')}")
    stamps = []
    with StromEngine() as eng:
        fh = eng.open(stream_path)
        for k in range(3):
            p = eng.submit_read(fh, k * (4 << 20), 4 << 20)
            p.wait()
            p.release()
            eng.sync_stats()
            doc = strom_stat.load(export)
            stamps.append((doc["_exported_at"], doc["bytes_direct"]
                           + doc["bytes_fallback"]))
        eng.close(fh)
    if [b for _, b in stamps] != [(k + 1) * (4 << 20) for k in range(3)] \
            or not stamps[0][0] < stamps[1][0] < stamps[2][0]:
        raise AssertionError(f"tools (f): not written at every sync_stats: "
                             f"{stamps}")
    every = {n: k + 1 for k, n in enumerate(COUNTERS)}
    text = strom_stat.render(every)
    missing = [n for n in COUNTERS if n not in text]
    rc_j, js = _tool_out(strom_stat.main, [export, "--json"])
    rc_p, prom = _tool_out(strom_stat.main, [export, "--prom"])
    doc = json.loads(js)
    samples = [ln.rsplit(" ", 1) for ln in prom.splitlines()
               if ln and not ln.startswith("#")]
    values = {k: float(v) for k, v in samples}
    if missing or rc_j or rc_p or not prom.rstrip().endswith("# EOF") \
            or any(n not in doc or f"strom_{n}_total" not in values
                   for n in COUNTERS):
        raise AssertionError(f"tools (f): missing {missing}, rc {rc_j} "
                             f"{rc_p}")
    log(f"tools (f) strom_stat: written at each of 3 sync_stats "
        f"{stamps}; after (a) lat_read_p50_us "
        f"{after_a.get('lat_read_p50_us')} lat_read_p99_us "
        f"{after_a['lat_read_p99_us']}; render names all "
        f"{len(COUNTERS)} counters; --json {len(doc)} keys, --prom "
        f"{len(values)} samples parse")
    log("tools (f) table of the last export:\n" + strom_stat.render(doc))
    return {"stamps": stamps, "lat_read_p50_us":
            after_a.get("lat_read_p50_us"),
            "lat_read_p99_us": after_a["lat_read_p99_us"],
            "prom_samples": len(values)}


def _tools_kv_store(dev, tdir):
    """The prefix store directory to scrub: the prefix store phase's, or
    (``--tools`` alone) four seeded flagship pages written here."""
    import torch
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.models.kv_offload import PrefixStore
    from nvme_strom_tpu_torch.models.transformer import flagship_config
    sdir = os.path.join(DATA_DIR, "kv_store")
    if os.path.isdir(sdir) and any(n.endswith(".kvman.json")
                                   for n in os.listdir(sdir)):
        return sdir
    sdir = os.path.join(tdir, "kv_store")
    os.makedirs(sdir, exist_ok=True)
    cfg = flagship_config()
    gen = torch.Generator().manual_seed(SEED + 61)
    shape = (cfg.n_layers, cfg.n_kv_heads, PREFIX_PAGE_TOKENS, cfg.head_dim)
    with StromEngine() as eng:
        st = PrefixStore(cfg, eng, os.path.join(sdir, "tools.kvstore"),
                         PREFIX_PAGE_TOKENS, 64 << 20)
        keys = st.chain_keys(list(range(4 * PREFIX_PAGE_TOKENS + 1)))
        for key in keys:
            page = torch.randn(shape, generator=gen).to(cfg.dtype)
            st.put([(key, page, page)])
        st.flush()
        st.close()
    return sdir


def _tools_scrub(dev, tdir, ckdir):
    """(g) strom_scrub: clean on the weights checkpoint and the prefix
    store directory; one flipped byte in a copy; --gc of a planted
    staging directory."""
    import shutil
    from nvme_strom_tpu_torch.tools import strom_scrub
    out = {}
    for label, path in (("checkpoint", ckdir),
                        ("kv_store", _tools_kv_store(dev, tdir))):
        rc, js = _tool_out(strom_scrub.main, [path, "--json"])
        rep = json.loads(js)
        out[label] = {"rc": rc, "files_scanned": rep["files_scanned"],
                      "bytes_verified": rep["bytes_verified"]}
        if rc != 0 or rep["files_scanned"] < 1:
            raise AssertionError(f"tools (g): scrub of {path}: rc {rc}, "
                                 f"{rep}")
    cdir = os.path.join(tdir, "scrub_copy")
    shutil.rmtree(cdir, ignore_errors=True)
    os.makedirs(cdir)
    bad = os.path.join(cdir, "model.safetensors")
    shutil.copyfile(os.path.join(ckdir, "model.safetensors"), bad)
    _flip_byte(bad, os.path.getsize(bad) - 1000)
    debris = os.path.join(cdir, ".tmp_step_00000001")
    os.makedirs(debris)
    with open(os.path.join(debris, "state-00000.safetensors"), "wb") as f:
        f.write(b"torn")
    old = time.time() - 7200
    for p in (os.path.join(debris, "state-00000.safetensors"), debris):
        os.utime(p, (old, old))
    rc, js = _tool_out(strom_scrub.main, [cdir, "--gc", "--json"])
    rep = json.loads(js)
    out["flipped"] = {"rc": rc, "damage": rep["damage"],
                      "tmp_dirs_removed": rep["tmp_dirs_removed"]}
    if rc != 1 or [d["file"] for d in rep["damage"]] != [bad]:
        raise AssertionError(f"tools (g): the flipped copy: rc {rc}, "
                             f"{rep['damage']}")
    if rep["tmp_dirs_removed"] != [debris] or os.path.exists(debris):
        raise AssertionError(f"tools (g): --gc left {debris}: {rep}")
    shutil.rmtree(cdir, ignore_errors=True)
    log("tools (g) strom_scrub " + json.dumps(out))
    return out


def _tools_write_hf(dev, hf):
    """LLAMA3_8B_2L's widths as HF-named bf16 safetensors in two files
    with an index, drawn from the seed on the card."""
    import torch
    from nvme_strom_tpu_torch.formats.safetensors import write_safetensors
    c = TOOLS_HF_CONFIG
    os.makedirs(hf, exist_ok=True)
    with open(os.path.join(hf, "config.json"), "w") as f:
        json.dump(c, f, indent=1)
    gen = torch.Generator(device=dev).manual_seed(SEED + 60)
    dm, ff, v = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    kv = c["num_key_value_heads"] * dm // c["num_attention_heads"]

    def w(*shape, scale=0.02, base=0.0):
        t = torch.randn(shape, generator=gen, device=dev) * scale + base
        return t.to(torch.bfloat16).cpu()
    files = [{"model.embed_tokens.weight": w(v, dm, scale=1.0)}, {}]
    for i in range(c["num_hidden_layers"]):
        p = f"model.layers.{i}."
        files[i].update({
            p + "self_attn.q_proj.weight": w(dm, dm),
            p + "self_attn.k_proj.weight": w(kv, dm),
            p + "self_attn.v_proj.weight": w(kv, dm),
            p + "self_attn.o_proj.weight": w(dm, dm),
            p + "mlp.gate_proj.weight": w(ff, dm),
            p + "mlp.up_proj.weight": w(ff, dm),
            p + "mlp.down_proj.weight": w(dm, ff),
            p + "input_layernorm.weight": w(dm, scale=0.1, base=1.0),
            p + "post_attention_layernorm.weight": w(dm, scale=0.1,
                                                     base=1.0)})
    files[1]["model.norm.weight"] = w(dm, scale=0.1, base=1.0)
    files[1]["lm_head.weight"] = w(v, dm)
    weight_map = {}
    nbytes = 0
    for k, tensors in enumerate(files):
        name = f"model-{k + 1:05d}-of-00002.safetensors"
        write_safetensors(os.path.join(hf, name), tensors)
        weight_map.update({n: name for n in tensors})
        nbytes += sum(t.numel() * 2 for t in tensors.values())
    with open(os.path.join(hf, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": nbytes},
                   "weight_map": weight_map}, f)
    return nbytes


def _tools_generate(argv):
    """(output ids, {direct, fallback, bounce}, text) of one
    ``generate.main`` run."""
    import re
    from nvme_strom_tpu_torch import generate as gen_main
    rc, out = _tool_out(gen_main.main, argv)
    if rc != 0:
        raise AssertionError(f"generate {argv} exited {rc}: {out}")
    line = next(x for x in out.splitlines() if x.startswith("output ids:"))
    ids = [int(t) for t in line.split(":", 1)[1].strip().split(",")]
    m = re.search(r"direct=(\d+) fallback=(\d+) bounce=(\d+)", out)
    st = dict(zip(("direct", "fallback", "bounce"), map(int, m.groups())))
    return ids, st, out


def _tools_convert(dev, tdir):
    """(h) convert_llama and generate --from-hf at LLAMA3_8B_2L's widths."""
    import shutil
    import numpy as np
    hf = os.path.join(tdir, "hf_llama")
    conv = os.path.join(tdir, "hf_converted")
    for d in (hf, conv):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.monotonic()
    nbytes = _tools_write_hf(dev, hf)
    write_s = time.monotonic() - t0
    rng = np.random.default_rng(SEED + 62)
    prompt = ",".join(str(t) for t in rng.integers(
        0, TOOLS_HF_CONFIG["vocab_size"], 16))
    common = ["--prompt", prompt, "--new", str(TOOLS_GEN_NEW)]
    card = ["--device", str(dev)]
    t0 = time.monotonic()
    bf16, st_hf, out = _tools_generate(["--from-hf", hf, "--out-dir", conv]
                                       + common + card)
    first_s = time.monotonic() - t0
    if "converted 21 tensors" not in out:
        raise AssertionError(f"tools (h): no conversion: {out}")
    bf16_w, st_w, _ = _tools_generate(["--weights", conv] + common + card)
    f32, st_f32, out = _tools_generate(["--from-hf", hf, "--out-dir", conv,
                                        "--dtype", "float32"] + common
                                       + card)
    if "converted" in out:
        raise AssertionError("tools (h): the conversion was not reused")
    f32_cpu, _, _ = _tools_generate(["--weights", conv, "--dtype",
                                     "float32", "--device", "cpu"] + common)
    rep = {"hf_bytes": nbytes, "write_hf_s": write_s,
           "convert_and_generate_s": first_s, "bf16_tokens": bf16,
           "bf16_equal_weights_run": bf16 == bf16_w,
           "f32_equal_cpu": f32 == f32_cpu, "load_stats": st_hf,
           "load_stats_weights": st_w, "load_stats_f32": st_f32}
    log("tools (h) convert_llama + generate --from-hf " + json.dumps(rep))
    if bf16 != bf16_w or f32 != f32_cpu:
        raise AssertionError(f"tools (h): tokens differ: bf16 {bf16} / "
                             f"{bf16_w}; float32 card {f32} / cpu "
                             f"{f32_cpu}")
    for st in (st_hf, st_w, st_f32):
        if st["fallback"] == 0 and st["bounce"] != 0:
            raise AssertionError(f"tools (h): the weight load bounced: "
                                 f"{st}")
    for d in (hf, conv):
        shutil.rmtree(d, ignore_errors=True)
    return rep


#: kernels the tools path must launch: h2d_copy (the stream, the
#: ceilings, the probes, the weight loads), decode (generate) and flash
TOOLS_KERNELS = ("h2d_copy", "decode_attention", "flash_fwd",
                 "flash_bwd_dq", "flash_bwd_dkv")


def _tools_summary(rep):
    """The tools phase's numbers without the per-record lists."""
    return {"seconds": rep["seconds"],
            "ceilings": {k: rep["a"][k] for k in (
                "median_gib_per_s", "lower_ceiling",
                "stream_share_of_lower_ceiling")},
            "transfer_diag": rep["transfer_diag"],
            "matmul_roof": rep["matmul_roof"],
            "profile": {k: rep["e"][k] for k in (
                "busy_frac", "category_frac", "top_ops_ms")},
            "stat": rep["f"], "scrub": rep["g"], "convert": rep["h"]}


def tools_phase(dev, stream_path, ckdir):
    """The operator tools on the card: (a) ssd2gpu_test's ceilings, (b)
    transfer_diag, (c) stream_probe, (d) kernel_probe, (e)
    profile_report, (f) strom_stat over the phase's $STROM_STATS_EXPORT,
    (g) strom_scrub, (h) convert_llama and generate --from-hf."""
    import shutil
    import torch
    from nvme_strom_tpu_torch.tools import profile_report
    t0 = time.monotonic()
    tdir = os.path.join(DATA_DIR, "tools")
    shutil.rmtree(tdir, ignore_errors=True)
    os.makedirs(tdir)
    export = os.path.join(tdir, "strom_stats.json")
    rep = {}
    with _env(STROM_STATS_EXPORT=export):
        rep["a"] = _tools_headline(dev, stream_path)
        rep["f"] = _tools_stats(dev, export, stream_path)
    rep.update(_tools_probes(dev, tdir))
    prof = profile_report.capture(TRAIN_BATCH, TRAIN_SEQ, "none", "flash",
                                  dev)
    log("tools (e) profile_report " + json.dumps(prof))
    shares = sum(prof["category_frac"].values())
    if abs(shares - prof["busy_frac"]) > 0.01 \
            or not prof["category_ms"].get("attention", 0) > 0:
        raise AssertionError(f"tools (e): class shares {shares} against "
                             f"busy {prof['busy_frac']}: {prof}")
    rep["e"] = prof
    torch.cuda.empty_cache()
    rep["g"] = _tools_scrub(dev, tdir, ckdir)
    rep["h"] = _tools_convert(dev, tdir)
    shutil.rmtree(tdir, ignore_errors=True)
    rep["seconds"] = time.monotonic() - t0
    log(f"tools: {rep['seconds']:.1f} s (budget {TOOLS_BUDGET_S} s)")
    return rep


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "nvme_strom_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository (the "
              "nvme_strom_tpu_torch package is not beside this script)",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    if sys.argv[1:2] == ["--multigpu-worker"]:
        # one rank of multigpu_phase, started by the phase itself
        rank, world, workdir, backend, ckdir = sys.argv[2:7]
        multigpu_worker(int(rank), int(world), workdir, backend, ckdir)
        return 0
    if sys.argv[1:2] == ["--sp-pp-worker"]:
        # one rank of sp_pp_phase, started by the phase itself
        rank, world, workdir, backend = sys.argv[2:6]
        sp_pp_worker(int(rank), int(world), workdir, backend)
        return 0
    # The engine's submit-time residency probe (mincore) sends spans it
    # finds in the page cache down the buffered path.  On filesystems
    # whose mincore reports every page resident (9p mounts, for one) it
    # would route every read there; the engine reads this switch when it
    # is created.
    os.environ.setdefault("STROM_NO_RESIDENCY_PROBE", "1")
    # the flight recorder is on by default: its trigger dumps (an SLO
    # governor's boost, a breaker trip) land inside the checkout
    os.environ.setdefault("STROM_FLIGHT_DIR", os.path.join(DATA_DIR,
                                                           "flight"))
    os.makedirs(os.environ["STROM_FLIGHT_DIR"], exist_ok=True)
    from nvme_strom_tpu_torch import _build
    from nvme_strom_tpu_torch.models.transformer import flagship_config
    from nvme_strom_tpu_torch.ops.bridge import h2d_copy
    from nvme_strom_tpu_torch.ops import flash_attention as fa
    from nvme_strom_tpu_torch.ops.decode_attention import decode_attention
    from nvme_strom_tpu_torch.ops.ici import ici_ring_gather
    from nvme_strom_tpu_torch.ops.paged_attention import paged_attention
    from nvme_strom_tpu_torch.ops.quant_matmul import dequant, quant_gemv

    t_start = time.monotonic()
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    _build.engine_library()
    _build.kernel_library()
    log(f"build seconds: {_build.build_seconds}")
    counters = {"h2d_copy": h2d_copy, "decode_attention": decode_attention,
                "paged_attention": paged_attention,
                "flash_fwd": fa.flash_fwd, "flash_bwd_dq": fa.flash_bwd_dq,
                "flash_bwd_dkv": fa.flash_bwd_dkv,
                "ici_ring_gather": ici_ring_gather,
                "quant_gemv": quant_gemv, "dequant": dequant}
    if sys.argv[1:2] == ["--multigpu"]:
        # main path 4 alone (on a machine with 2-4 cards, the phase's
        # NCCL run without the rest of the script)
        os.makedirs(DATA_DIR, exist_ok=True)
        ckdir = os.path.join(DATA_DIR, "ckpt")
        write_checkpoint(ckdir, flagship_config())
        for fn in counters.values():
            fn.launches = 0
        multigpu = multigpu_phase(dev, ckdir, counters)
        log("multigpu launches: " + json.dumps(
            {n: fn.launches for n, fn in counters.items()}))
        log("multigpu " + json.dumps(multigpu))
        print(card_line())
        return 0
    if sys.argv[1:2] == ["--sql"]:
        # main path 6 alone (Direct SQL); (j) runs in main path 4's ranks
        os.makedirs(DATA_DIR, exist_ok=True)
        for fn in counters.values():
            fn.launches = 0
        sql = sql_phase(dev)
        log("sql launches: " + json.dumps(
            {n: fn.launches for n, fn in counters.items()}))
        if h2d_copy.launches <= 0:
            raise AssertionError("kernel h2d_copy never launched on the "
                                 "sql path")
        log("sql " + json.dumps(sql))
        print(card_line())
        return 0
    if sys.argv[1:2] == ["--tools"]:
        # main path 7 alone (the operator tools), on its own stream file
        # and weights checkpoint
        os.makedirs(DATA_DIR, exist_ok=True)
        stream_path = os.path.join(DATA_DIR, "stream.bin")
        ckdir = os.path.join(DATA_DIR, "ckpt")
        write_stream_file(stream_path)
        write_checkpoint(ckdir, flagship_config())
        for fn in counters.values():
            fn.launches = 0
        tools = tools_phase(dev, stream_path, ckdir)
        counts = {n: fn.launches for n, fn in counters.items()}
        log("tools launches: " + json.dumps(counts))
        for n in TOOLS_KERNELS:
            if counts[n] <= 0:
                raise AssertionError(f"kernel {n} never launched on the "
                                     "tools path")
        log("tools " + json.dumps(_tools_summary(tools)))
        os.remove(stream_path)
        print(card_line())
        return 0
    if sys.argv[1:2] == ["--lint"]:
        # lint_phase alone: strom_lint over the checkout, and the serving
        # path under the strict witness on seeded flagship weights made
        # on the card
        os.makedirs(os.path.join(DATA_DIR, "kv_store"), exist_ok=True)
        cfg = flagship_config()
        params = _card_params(cfg, SEED, dev)
        for fn in counters.values():
            fn.launches = 0
        lint = lint_phase(dev, cfg, params)
        counts = {n: fn.launches for n, fn in counters.items()}
        log("lint launches: " + json.dumps(counts))
        for n in LINT_KERNELS:
            if counts[n] <= 0:
                raise AssertionError(f"kernel {n} never launched on the "
                                     "lint path")
        log("lint " + json.dumps(lint))
        print(card_line())
        return 0
    if sys.argv[1:2] == ["--quant"]:
        # the weight-only kernels alone: check_quant, then moe_quant_phase
        # (main path 1j) with every count at 0
        os.makedirs(DATA_DIR, exist_ok=True)
        results: dict = {}
        check_quant(dev, results)
        for fn in counters.values():
            fn.launches = 0
        moe_quant = moe_quant_phase(dev, flagship_config())
        counts = {n: fn.launches for n, fn in counters.items()}
        log("moe quant launches: " + json.dumps(counts))
        for n in QUANT_KERNELS:
            if counts[n] <= 0:
                raise AssertionError(f"kernel {n} never launched on the "
                                     "moe quant path")
            results[n]["launches"] = counts[n]
        log("moe quant " + json.dumps(moe_quant))
        log("quant kernels " + json.dumps([results[n]
                                           for n in QUANT_KERNELS]))
        print(card_line())
        return 0
    if sys.argv[1:2] == ["--sp-pp"]:
        # main path 5 alone (on a machine with 2-4 cards, the phase's
        # NCCL run without the rest of the script)
        os.makedirs(DATA_DIR, exist_ok=True)
        for fn in counters.values():
            fn.launches = 0
        sp_pp = sp_pp_phase(dev, counters)
        log("sp_pp launches: " + json.dumps(
            {n: fn.launches for n, fn in counters.items()}))
        log("sp_pp " + json.dumps(sp_pp))
        print(card_line())
        return 0

    results: dict = {}
    check_h2d(dev, results)
    check_decode(dev, results)
    check_paged(dev, results)
    host = attention_host_us(dev)
    for n in ("decode", "paged"):
        results[f"{n}_attention"]["host_us"] = host[n]
    flash_split = check_flash(dev, results)
    fp16_times(dev, results)
    check_quant(dev, results)
    # the checks' inputs (GBs at the long shapes) stay in the caching
    # allocator: hand them back before the main paths are timed
    gc.collect()
    torch.cuda.empty_cache()
    for r in results.values():
        if r["name"] in QUANT_KERNELS:
            continue        # check_quant logs its own table
        lib = ("in flash_bwd_dq's" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        rate = (f" = {r['tflops']:.1f} TFLOP/s on {r['units']}"
                if "tflops" in r else
                f" ({r['device_ms']:.4f} ms on the device, library "
                f"{r['library_device_ms']:.4f}; host {r['host_us']:.2f} us "
                f"a call)" if "device_ms" in r else "")
        log(f"{r['name']} ({r['shape']}): kernel {r['ms']:.4f} ms{rate}, "
            f"plain {r['plain_ms']:.4f} ms, library {lib}, "
            f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})")

    os.makedirs(DATA_DIR, exist_ok=True)
    stream_path = os.path.join(DATA_DIR, "stream.bin")
    ckdir = os.path.join(DATA_DIR, "ckpt")
    cfg = flagship_config()
    want = write_stream_file(stream_path)
    cpu_params = write_checkpoint(ckdir, cfg)

    def drive(path, kernels, run):
        """Run one main path with every count at 0; each of ``kernels``
        must have launched in it.  Returns (run's result, counts)."""
        for fn in counters.values():
            fn.launches = 0
        out = run()
        counts = {n: fn.launches for n, fn in counters.items()}
        log(f"{path} launches: {counts}")
        for n in kernels:
            if counts[n] <= 0:
                raise AssertionError(f"kernel {n} never launched on the "
                                     f"{path} path")
        for n in QUANT_KERNELS:       # every path a quantized leaf takes
            if counts[n]:
                results[n]["launches_" + path.replace(" ", "_")] = \
                    counts[n]
        return out, counts

    # main path 1: the stream and serving
    (stream, (params, serving)), counts = drive(
        "stream+serve", ("h2d_copy", "decode_attention", "paged_attention"),
        lambda: (stream_phase(dev, stream_path, want),
                 serve_phase(dev, ckdir, cfg, cpu_params)))
    for n in ("h2d_copy", "decode_attention", "paged_attention"):
        results[n]["launches"] = counts[n]
    f32 = f32_phase(dev, cfg, params)
    # what the prefix store and offload phases leave for the qos phase
    shared: dict = {}
    # main path 1b: the prefix store on both servers, restored through
    # h2d_copy, decoded on kernels 2-3
    prefix, counts = drive(
        "prefix store", ("h2d_copy", "decode_attention", "paged_attention"),
        lambda: prefix_store_phase(dev, cfg, params, shared))
    results["h2d_copy"]["launches_prefix_store"] = counts["h2d_copy"]
    results["decode_attention"]["launches_prefix_store"] = \
        counts["decode_attention"]
    results["paged_attention"]["launches_prefix_store"] = \
        counts["paged_attention"]
    prefix["f32"] = prefix_store_f32_phase(dev, cfg, params)
    torch.cuda.empty_cache()
    # main path 1c: offloaded long-context decode, cold pages streamed
    # back through h2d_copy
    offload, counts = drive("offload", ("h2d_copy",),
                            lambda: offload_phase(dev, cfg, ckdir, params,
                                                  shared))
    results["h2d_copy"]["launches_offload"] = counts["h2d_copy"]
    torch.cuda.empty_cache()
    # main path 1d: both decode-class sources under a prefetch storm, on
    # one ring, on the default ring count with the scheduler, padded,
    # and with the host-DRAM tier
    qos, counts = drive(
        "qos", ("h2d_copy", "decode_attention", "paged_attention"),
        lambda: qos_phase(dev, cfg, params, shared, stream_path))
    for n in ("h2d_copy", "decode_attention", "paged_attention"):
        results[n]["launches_qos"] = counts[n]
    torch.cuda.empty_cache()
    # main path 1e: a bronze aggressor beside a gold victim, both servers
    # over the prefix store, STROM_TENANTS on
    tenant, counts = drive(
        "tenants", ("h2d_copy", "decode_attention", "paged_attention"),
        lambda: tenant_phase(dev, cfg, params, shared))
    for n in ("h2d_copy", "decode_attention", "paged_attention"):
        results[n]["launches_tenant"] = counts[n]
    torch.cuda.empty_cache()
    # main path 1f: the serving paths under injected faults, recovered
    # by the resilient engine: restored reads through h2d_copy, decode
    # steps on kernels 2-3
    resilience, counts = drive(
        "resilience", ("h2d_copy", "decode_attention", "paged_attention"),
        lambda: resilience_phase(dev, cfg, ckdir, params, shared,
                                 stream_path))
    for n in ("h2d_copy", "decode_attention", "paged_attention"):
        results[n]["launches_resilience"] = counts[n]
    torch.cuda.empty_cache()
    # main path 1g: failure domains: a wedged ring under the weights
    # load, an EIO storm under both servers (degraded reads through
    # h2d_copy), the flight dumps, the degraded rate
    health, counts = drive(
        "health", ("h2d_copy", "decode_attention", "paged_attention"),
        lambda: health_phase(dev, cfg, ckdir, params, shared, stream_path))
    for n in ("h2d_copy", "decode_attention", "paged_attention"):
        results[n]["launches_health"] = counts[n]
    # main path 1h: serve-while-restoring cold start, weights faulted in
    # and bulk-restored through h2d_copy, the dense server on kernel 2
    coldstart, counts = drive(
        "coldstart", ("h2d_copy", "decode_attention"),
        lambda: coldstart_phase(dev, cfg, ckdir, shared, stream_path))
    for n in ("h2d_copy", "decode_attention"):
        results[n]["launches_coldstart"] = counts[n]
    # main path 1i: drain and warm handoff on both servers: the exported
    # sessions' pages restored through h2d_copy, decoded on kernels 2-3
    handoff, counts = drive(
        "handoff", ("h2d_copy", "decode_attention", "paged_attention"),
        lambda: handoff_phase(dev, cfg, params))
    for n in ("h2d_copy", "decode_attention", "paged_attention"):
        results[n]["launches_handoff"] = counts[n]
    # main path 1k: critical-path attribution and the debug server on
    # the prefix store's NVMe hit, both servers (kernels 1-3)
    attrib_rep, counts = drive(
        "attrib", ("h2d_copy", "decode_attention", "paged_attention"),
        lambda: attrib_phase(dev, cfg, params, shared))
    for n in ("h2d_copy", "decode_attention", "paged_attention"):
        results[n]["launches_attrib"] = counts[n]
    # main path 1m: strom_lint over the checkout, then the prefix store
    # on both servers with the host tier and the QoS scheduler under the
    # strict lock-order witness (kernels 1-3)
    lint, counts = drive("lint", LINT_KERNELS,
                         lambda: lint_phase(dev, cfg, params))
    for n in LINT_KERNELS:
        results[n]["launches_lint"] = counts[n]
    supervisor_cost = supervisor_cost_phase(dev, cfg, params, shared,
                                            stream_path, want)
    torch.cuda.empty_cache()
    del shared
    del params
    torch.cuda.empty_cache()
    # main path 7: the operator tools: the stream file through
    # ssd2gpu_test's ceilings and the probes (h2d_copy), the flash
    # kernels in kernel_probe and profile_report, generate --from-hf on
    # kernel 2
    tools, counts = drive("tools", TOOLS_KERNELS,
                          lambda: tools_phase(dev, stream_path, ckdir))
    for n in TOOLS_KERNELS:
        results[n]["launches_tools"] = counts[n]
    os.remove(stream_path)
    gc.collect()
    torch.cuda.empty_cache()
    # main path 1l: speculative decoding, the draft's steps on kernel 2
    speculative, counts = drive("speculative", ("decode_attention",),
                                lambda: speculative_phase(dev, cfg))
    results["decode_attention"]["launches_speculative"] = \
        counts["decode_attention"]
    torch.cuda.empty_cache()
    # a group of 7 at head_dim 128 through both servers
    gqa, _ = drive("GQA serve", ("decode_attention", "paged_attention"),
                   lambda: gqa_serve_phase(dev, cfg))
    torch.cuda.empty_cache()
    # main path 1j: Mixtral-8x7B widths (2 layers) on both servers, a MoE
    # flagship streamed through h2d_copy, int8 / int4 serving
    moe_quant, counts = drive(
        "moe quant", ("h2d_copy", "decode_attention", "paged_attention")
        + QUANT_KERNELS, lambda: moe_quant_phase(dev, cfg))
    for n in ("h2d_copy", "decode_attention", "paged_attention"):
        results[n]["launches_moe_quant"] = counts[n]
    for n in QUANT_KERNELS:
        results[n]["launches"] = counts[n]
    torch.cuda.empty_cache()

    # main path 2: training with the flash kernels, batches through h2d
    training, counts = drive(
        "train", ("h2d_copy", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
        lambda: train_phase(dev, ckdir, cfg))
    for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        results[n]["launches"] = counts[n]
    results["h2d_copy"]["launches_train"] = counts["h2d_copy"]
    # main path 2b: STROM_VERIFY on the weights load (then both servers
    # on the verified weights) and on the training loader
    verify, counts = drive(
        "verify", ("h2d_copy", "decode_attention", "paged_attention"),
        lambda: verify_phase(dev, ckdir, cfg))
    for n in ("h2d_copy", "decode_attention", "paged_attention"):
        results[n]["launches_verify"] = counts[n]
    # main path 2c: the loader's shard quarantine on a faulted engine
    resilience["loader"], counts = drive(
        "resilience loader", ("h2d_copy",),
        lambda: resilience_loader_phase(dev, cfg))
    results["h2d_copy"]["launches_resilience_loader"] = counts["h2d_copy"]
    f32_train = f32_train_phase(dev, cfg)
    torch.cuda.empty_cache()
    # main path 2d: training beyond device memory: remat dots and nvme
    # (layer inputs through the engine and h2d_copy), the NVMe-offloaded
    # optimizer (moments streamed through h2d_copy), QLoRA, the train_lm
    # triad; every path on the flash kernels
    train_offload, counts = drive(
        "train offload", ("h2d_copy", "flash_fwd", "flash_bwd_dq",
                          "flash_bwd_dkv"),
        lambda: train_offload_phase(dev))
    for n in ("h2d_copy", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        results[n]["launches_train_offload"] = counts[n]
    torch.cuda.empty_cache()
    # main path 2e: the zero-copy formats, the mixture and the prefetch,
    # every batch through h2d_copy
    data_formats, counts = drive(
        "data formats", ("h2d_copy",),
        lambda: data_formats_phase(dev, training))
    results["h2d_copy"]["launches_data_formats"] = counts["h2d_copy"]
    torch.cuda.empty_cache()
    # main path 2f: the ViT trainer on the zero-copy fixedrec path,
    # records decoded on the card
    vit, counts = drive("vit", ("h2d_copy",), lambda: vit_phase(dev))
    results["h2d_copy"]["launches_vit"] = counts["h2d_copy"]
    torch.cuda.empty_cache()
    # main path 2g: eval_ppl --npy, token batches through h2d_copy
    eval_rep, counts = drive("eval_ppl", ("h2d_copy",),
                             lambda: eval_ppl_phase(dev, ckdir))
    results["h2d_copy"]["launches_eval_ppl"] = counts["h2d_copy"]
    torch.cuda.empty_cache()

    # main path 6: Direct SQL — Parquet and Arrow tables scanned through
    # the engine and h2d_copy, decoded and aggregated on the card
    sql, counts = drive("sql", ("h2d_copy",), lambda: sql_phase(dev))
    results["h2d_copy"]["launches_sql"] = counts["h2d_copy"]
    gc.collect()
    torch.cuda.empty_cache()

    # kernel 7 at the width of the restore below
    from nvme_strom_tpu_torch.checkpoint.manager import CheckpointManager
    from nvme_strom_tpu_torch.checkpoint.scatter import build_restore_manifest
    from nvme_strom_tpu_torch.ops.ici import ici_unit_bytes
    mgr = CheckpointManager(os.path.join(DATA_DIR, "train_ckpt"))
    man = build_restore_manifest(mgr.step_dir(mgr.latest_step()), ICI_RANKS,
                                 ici_unit_bytes())
    check_ici(dev, results, max(man.host_bytes))
    r = results["ici_ring_gather"]
    log(f"ici_ring_gather ({r['shape']}; {r['design']}): kernel "
        f"{r['ms']:.4f} ms back to back, {r['device_ms']:.4f} ms on the "
        f"device (host {r['host_us']:.1f} us a call), plain "
        f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, bound "
        f"{r['bound_ms']:.5f} ms ({r['bound_by']})")

    # main path 3: the read-once restore, shares gathered by kernel 7
    restore, counts = drive(
        "restore", ("h2d_copy", "ici_ring_gather"),
        lambda: restore_phase(dev, ckdir, cpu_params))
    results["ici_ring_gather"]["launches"] = counts["ici_ring_gather"]
    results["h2d_copy"]["launches_restore"] = counts["h2d_copy"]
    gc.collect()
    torch.cuda.empty_cache()
    # main path 4: data and tensor parallel over processes (the weights
    # load, the trainer with the flash kernels, generate on kernel 2,
    # the checkpoint, and with 2+ cards kernel 7 across processes)
    mg_kernels = ("h2d_copy", "decode_attention", "flash_fwd",
                  "flash_bwd_dq", "flash_bwd_dkv")
    if torch.cuda.device_count() >= 2:
        mg_kernels += ("ici_ring_gather",)
    multigpu, counts = drive("multigpu", mg_kernels,
                             lambda: multigpu_phase(dev, ckdir, counters))
    for n in mg_kernels:
        results[n]["launches_multigpu"] = counts[n]
    results["h2d_copy"]["launches_sql_dist"] = sum(
        r["j"]["launches"]["h2d_copy"] for r in multigpu["ranks"])
    if multigpu["backend"] == "nccl":
        e = [r["e"] for r in multigpu["ranks"]]
        results["ici_ring_gather"].update(
            processes_kernel_ms=[x["kernel_ms"] for x in e],
            processes_nccl_ms=[x["nccl_all_gather_ms"] for x in e],
            processes_bound_ms=e[0]["bound_ms"])
    gc.collect()
    torch.cuda.empty_cache()
    # main path 5: sequence and pipeline parallel over processes (the
    # ring and Ulysses on the flash kernels, the sp and pp trainers, the
    # loader's seq_axis through h2d_copy)
    sp_kernels = ("h2d_copy", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    sp_pp, counts = drive("sp_pp", sp_kernels,
                          lambda: sp_pp_phase(dev, counters))
    for n in sp_kernels:
        results[n]["launches_sp_pp"] = counts[n]
    for n in counters:
        results[n]["kernel_ms"] = results[n]["ms"]
    log("resilience " + json.dumps({
        "weights_faulted": resilience["weights"]["faulted_stats"],
        "store_faulted": resilience["store"]["faulted"]["stats"],
        "offload_writes": resilience["offload"]["faulted"]["write_stats"],
        "offload_reads": resilience["offload"]["faulted"]["read_stats"],
        "loader": resilience["loader"]["stats"],
        "governor": resilience["governor"]["governor"]}))
    log("health " + json.dumps({
        "load_s": {k: v["load_s"] for k, v in health["weights"].items()},
        "stalled": health["weights"]["stalled"]["stats"],
        "store": {k: {"stats": v["stats"], "seconds": v["seconds"],
                      "recovered_after_s": v["recovered_after_s"]}
                  for k, v in health["store"].items()},
        "dumps": health["dumps"],
        "degraded_gib_per_s": health["degraded_rate"]["degraded"][
            "gib_per_s"],
        "direct_gib_per_s": health["degraded_rate"]["direct"]["gib_per_s"],
        "supervisor_cost": supervisor_cost}))
    log("coldstart " + json.dumps({
        k: coldstart[k] for k in ("ttft_boot_s", "steady_s", "tensor_bytes",
                                  "tokens_identical", "trials", "chaos")}))
    log("handoff " + json.dumps(handoff))
    log("moe quant " + json.dumps(moe_quant))
    log("train offload " + json.dumps(train_offload))
    log("data formats " + json.dumps(data_formats))
    log("speculative " + json.dumps(speculative))
    log("vit " + json.dumps({k: v for k, v in vit.items()
                             if k != "top_kernels"}))
    log("eval_ppl " + json.dumps(eval_rep))
    log("attrib " + json.dumps({k: v for k, v in attrib_rep.items()
                                if k != "profiles"}))
    log("multigpu " + json.dumps(multigpu))
    log("sp_pp " + json.dumps(sp_pp))
    log("sql " + json.dumps(sql))
    log("tools " + json.dumps(_tools_summary(tools)))
    log("lint " + json.dumps(lint))

    log("summary: " + json.dumps({"stream": stream, "serve": serving,
                                  "gqa_serve": gqa, "prefix_store": prefix,
                                  "offload": offload, "qos": qos,
                                  "tenants": tenant, "verify": verify,
                                  "resilience": resilience,
                                  "health": health, "coldstart": coldstart,
                                  "handoff": handoff, "moe_quant": moe_quant,
                                  "supervisor_cost": supervisor_cost,
                                  "f32_logits_err": f32, "train": training,
                                  "f32_train": f32_train, "restore": restore,
                                  "train_offload": train_offload,
                                  "data_formats": data_formats,
                                  "speculative": speculative, "vit": vit,
                                  "eval_ppl": eval_rep,
                                  "attrib": {k: v for k, v in
                                             attrib_rep.items()
                                             if k != "profiles"},
                                  "multigpu": {k: v for k, v in
                                               multigpu.items()
                                               if k != "ranks"},
                                  "sp_pp": {k: v for k, v in sp_pp.items()
                                            if k != "ranks"},
                                  "sql": {k: sql[k] for k in ("seconds",
                                                              "timing")},
                                  "lint": {"seconds": lint["seconds"],
                                           "edges": lint["b"]["edges"]},
                                  "tools": {"seconds": tools["seconds"],
                                            "ceilings": tools["a"][
                                                "median_gib_per_s"]},
                                  "flash_split": flash_split,
                                  "seconds": time.monotonic() - t_start}))
    print(json.dumps({"kernels": [results[n] for n in counters]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
