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
   two others at 4 MiB and 64 MiB, and ``copy_`` (the probe); the
   split-K decode and paged attention kernels are also checked on GQA
   groups of 7 and 16 and head dims 40, 96 and 256 at positions around
   a split edge, two calls bitwise equal, and timed back to back and by
   device time (``device_ms``) at the flagship shape, at a 16k-context
   GQA shape (``LONG_GQA``) and against SDPA over ``max_len`` (the
   crossover), and their wrappers' host time a call (``host_us``); their
   any-width path (head dims 100 and 576) is checked in bf16 and f32
   and timed at the flagship shape (``any_width``);
3. main path — streams a 2 GiB file of seeded random bytes through
   ``DeviceStream`` onto the card, on both of its paths (copies from the
   staging buffers in place, and through the overlap stage), and checks
   every pass on the device;
4. main path — writes flagship-width weights (seeded) as safetensors,
   streams them onto the card with ``LazyCheckpoint`` and serves the
   same 8 greedy requests with ``DecodeServer`` and
   ``PagedDecodeServer``, whose tokens must agree;
5. checks the kernel path against the plain path at float32 through a
   whole decode step, then serves 4 requests with both servers on a
   2-layer model with a GQA group of 7 at head_dim 128 (``GQA_SERVE``),
   whose tokens must agree;
6. training path — seeded WebDataset shards of flagship-length samples
   through ``ShardedLoader`` and ``prefetch_to_device`` into a
   ``Trainer`` with the flash kernels, warm-started from phase 4's
   weights: 10 steps at seq 2048, batch 8, checkpoints every 5 steps;
   a second ``Trainer`` resumes from step 10 with bitwise-equal
   parameters and AdamW moments and runs to step 12 under the profiler;
7. checks one float32 train step of the flagship through the flash
   kernels against the same step through their plain versions;
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
10. prints one JSON line of per-kernel results, the card again, and the
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

Each path is driven with every launch count set to 0 just before it and
read just after: every kernel of the serving path must have launched in
phases 3-4 and again in the GQA serve run of phase 5, the flash kernels
and ``h2d_copy`` in phase 6, and ``h2d_copy`` and ``ici_ring_gather`` in
phase 9, which must also end with no brown-out (``ici_fallbacks`` 0).
Any failure exits non-zero before the result line; so does a machine
without CUDA, or a directory without the package.
"""

from __future__ import annotations

import gc
import json
import os
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
F32_TOL = (1e-4, 1e-4)
F32_LOGITS_TOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


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
FLASH_F32_TOL = (1e-4, 1e-5)
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
    ]
    worst = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for label, b, h, s, skv, d, dt, causal, with_dlse in cases:
        tol = FLASH_BF16_TOL if dt == torch.bfloat16 else FLASH_F32_TOL
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
        "1e-4*max|plain|; f32 rtol 1e-4 + 1e-5*max|plain|; lse atol 1e-4")
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
    through the overlap stage's pinned slabs.  Passes run direct,
    overlap, overlap, direct, so each path has a pass before and after
    the other's; the first is the headline (the file's first read since
    it was written and dropped from the page cache)."""
    from nvme_strom_tpu_torch.io.engine import StromEngine, check_file
    from nvme_strom_tpu_torch.ops.bridge import DeviceStream, h2d_copy
    from nvme_strom_tpu_torch.utils.config import EngineConfig
    small = EngineConfig(buffer_pool_bytes=8 * EngineConfig().chunk_bytes)
    passes = []
    with StromEngine() as eng_d, StromEngine(small) as eng_o:
        engines = {"direct": eng_d, "overlap": eng_o}
        register_s = {}
        for name, eng in engines.items():
            t0 = time.monotonic()
            eng.cuda_mapping(dev.index)      # page-lock the staging pool
            register_s[name] = time.monotonic() - t0
        streams = {n: DeviceStream(e, device=dev)
                   for n, e in engines.items()}
        if streams["direct"].overlap or not streams["overlap"].overlap:
            raise AssertionError("the pool sizes did not pick the paths")
        for name in ("direct", "overlap", "overlap", "direct"):
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
    log(f"stream: staging pools registered in {register_s} s; engine "
        f"{backend}, O_DIRECT {'yes' if direct else 'no'}; stats "
        f"{stats}; after it, on the same file: {ceilings}")
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
    by_path = {n: [p["gib_per_s"] for p in passes if p["path"] == n]
               for n in engines}
    return {"gib_per_s": passes[0]["gib_per_s"],
            "seconds": passes[0]["seconds"], "passes": passes,
            "gib_per_s_by_path": by_path, "register_s": register_s,
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
    lengthens the wall time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
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
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA"]
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    flash = {e.key[:60]: (e.self_device_time_total / 1e3, e.count)
             for e in events if "flash_" in e.key}
    flash_ms = sum(ms for ms, _ in flash.values())
    out = {"wall_s": secs, "device_busy_s": busy_us / 1e6,
           "device_busy_share": busy_us / 1e6 / secs,
           "top_kernels": [(e.key[:60], e.self_device_time_total / 1e3,
                            e.count) for e in top],
           "flash_kernels": flash, "flash_ms": flash_ms,
           "flash_share": flash_ms * 1e3 / busy_us if busy_us else 0.0}
    log(f"profile ({label}): device busy {busy_us / 1e6:.4f} s of "
        f"{secs:.4f} s wall = {out['device_busy_share']:.3f}; top "
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
    (one a call; the profiler may miss one): the kernel's own time, for
    calls that wait for their kernels and so cannot be queued ahead of
    the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type.name == "CUDA" and name in e.key]
    count = sum(e.count for e in hits)
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
            delta = {k: after[k] - before[k] for k in after}
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
    # The engine's submit-time residency probe (mincore) sends spans it
    # finds in the page cache down the buffered path.  On filesystems
    # whose mincore reports every page resident (9p mounts, for one) it
    # would route every read there; the engine reads this switch when it
    # is created.
    os.environ.setdefault("STROM_NO_RESIDENCY_PROBE", "1")
    from nvme_strom_tpu_torch import _build
    from nvme_strom_tpu_torch.models.transformer import flagship_config
    from nvme_strom_tpu_torch.ops.bridge import h2d_copy
    from nvme_strom_tpu_torch.ops import flash_attention as fa
    from nvme_strom_tpu_torch.ops.decode_attention import decode_attention
    from nvme_strom_tpu_torch.ops.ici import ici_ring_gather
    from nvme_strom_tpu_torch.ops.paged_attention import paged_attention

    t_start = time.monotonic()
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    _build.engine_library()
    _build.kernel_library()
    log(f"build seconds: {_build.build_seconds}")

    results: dict = {}
    check_h2d(dev, results)
    check_decode(dev, results)
    check_paged(dev, results)
    host = attention_host_us(dev)
    for n in ("decode", "paged"):
        results[f"{n}_attention"]["host_us"] = host[n]
    flash_split = check_flash(dev, results)
    # the checks' inputs (GBs at the long shapes) stay in the caching
    # allocator: hand them back before the main paths are timed
    gc.collect()
    torch.cuda.empty_cache()
    for r in results.values():
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

    counters = {"h2d_copy": h2d_copy, "decode_attention": decode_attention,
                "paged_attention": paged_attention,
                "flash_fwd": fa.flash_fwd, "flash_bwd_dq": fa.flash_bwd_dq,
                "flash_bwd_dkv": fa.flash_bwd_dkv,
                "ici_ring_gather": ici_ring_gather}

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
        return out, counts

    # main path 1: the stream and serving
    (stream, (params, serving)), counts = drive(
        "stream+serve", ("h2d_copy", "decode_attention", "paged_attention"),
        lambda: (stream_phase(dev, stream_path, want),
                 serve_phase(dev, ckdir, cfg, cpu_params)))
    for n in ("h2d_copy", "decode_attention", "paged_attention"):
        results[n]["launches"] = counts[n]
    f32 = f32_phase(dev, cfg, params)
    os.remove(stream_path)
    del params
    # a group of 7 at head_dim 128 through both servers
    gqa, _ = drive("GQA serve", ("decode_attention", "paged_attention"),
                   lambda: gqa_serve_phase(dev, cfg))
    torch.cuda.empty_cache()

    # main path 2: training with the flash kernels, batches through h2d
    training, counts = drive(
        "train", ("h2d_copy", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
        lambda: train_phase(dev, ckdir, cfg))
    for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        results[n]["launches"] = counts[n]
    results["h2d_copy"]["launches_train"] = counts["h2d_copy"]
    f32_train = f32_train_phase(dev, cfg)

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
    for n in counters:
        results[n]["kernel_ms"] = results[n]["ms"]

    log("summary: " + json.dumps({"stream": stream, "serve": serving,
                                  "gqa_serve": gqa,
                                  "f32_logits_err": f32, "train": training,
                                  "f32_train": f32_train, "restore": restore,
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
