"""kernel_probe — the flash kernels (4–6) and the card's bf16 matmul
rate, measured.

For each attention shape it times the flash forward (kernel 4) and the
forward plus backward (kernels 4, 5 and 6 through
``flash_attention``'s autograd) against ``scaled_dot_product_attention``
on the same inputs, each beside its least time on the card: the
kernels' ``4·d``, ``6·d`` and ``8·d`` flops a (query, key) pair over the
bf16 tensor-core peak.  Every output and gradient of the kernels is held
against its plain version on the same inputs at the flash kernels'
bf16 tolerance (one bf16 ulp, rtol 2**-7, plus 1e-4 of the largest
magnitude), the forward's lse within 1e-4 of the plain lse, and both
the kernels' and SDPA's distance from SDPA in float32 is reported in
units of that tolerance.  The kernels' tiles are
fixed, so unlike the JAX package's probe
(nvme_strom_tpu/tools/kernel_probe.py) there is no ``(block_q,
block_k)`` sweep.  Shapes: the train step's (b 8, h 8,
s 2048, d 64, bf16, causal) and ``long_gqa`` (b 1, 32 query heads over
8 KV heads expanded, d 128, s 16384, bf16, causal).  Then a chain of
bf16 ``torch.matmul`` measures the rate the card reaches against its
989 TFLOP/s.

    python -m nvme_strom_tpu_torch.tools.kernel_probe [--shapes train,long_gqa]
        [--shape B,H,HKV,S,D] [--roof-n 4096,8192] [--device cpu]

One JSON line a measurement.  Times are CUDA events around ``--iters``
calls after a warm-up (on the CPU, the wall clock).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

#: H100 SXM dense bf16 tensor cores (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12
#: the flash kernels' bf16 tolerance against their plain versions
#: (chip_smoke.py FLASH_BF16_TOL): rtol one bf16 ulp, atol a fraction of
#: max |want|
FLASH_BF16_TOL = (2 ** -7, 1e-4)
#: the forward's lse against its plain version, absolute
#: (chip_smoke.py LSE_ATOL)
LSE_ATOL = 1e-4
SHAPES = {"train": (8, 8, 8, 2048, 64), "long_gqa": (1, 32, 8, 16384, 128)}


def _emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, dev, iters: int = 10, warmup: int = 2) -> float:
    """Mean ms a call: CUDA events around ``iters`` calls on a card,
    the wall clock on the CPU."""
    import torch
    for _ in range(warmup):
        fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _rel_err(got, want, tol) -> float:
    """max |got − want| over the tolerance's allowance (≤ 1 passes)."""
    want = want.float()
    allow = tol[0] * want.abs() + tol[1] * want.abs().max() + 1e-6
    return float(((got.float() - want).abs() / allow).max())


def kernel_grads(q, k, v, do, scale):
    """out, lse, dQ, dK and dV of kernels 4–6 called as the causal
    train step calls them, and the ``delta`` (Σ dO·out) they took."""
    from nvme_strom_tpu_torch.ops import flash_attention as fa
    out, lse = fa.flash_fwd(q, k, v, True, scale)
    delta = (do.float() * out.float()).sum(-1).contiguous()
    args = (q, k, v, do, lse, delta, True, scale)
    dk, dv = fa.flash_bwd_dkv(*args)
    return ({"out": out, "lse": lse, "dq": fa.flash_bwd_dq(*args),
             "dk": dk, "dv": dv}, delta)


def plain_reference(q, k, v, do, delta, scale, budget=1 << 30):
    """out, lse, dQ, dK and dV of the kernels' plain versions: the
    backward on the plain forward's lse and the kernels' ``delta``
    (``check_flash``'s comparison), a few heads at a time so the float32
    scores stay within ``budget`` bytes."""
    import torch
    from nvme_strom_tpu_torch.ops import flash_attention as fa
    b, h, s, _ = q.shape
    step = max(1, budget // (b * s * s * 4))
    parts = []
    for h0 in range(0, h, step):
        sl = slice(h0, min(h, h0 + step))
        out, lse = fa.flash_fwd_plain(q[:, sl], k[:, sl], v[:, sl], True,
                                      scale)
        args = (q[:, sl], k[:, sl], v[:, sl], do[:, sl], lse,
                delta[:, sl], True, scale)
        dk, dv = fa.flash_bwd_dkv_plain(*args)
        parts.append((out, lse, fa.flash_bwd_dq_plain(*args), dk, dv))
    return dict(zip(("out", "lse", "dq", "dk", "dv"),
                    (torch.cat(x, dim=1) for x in zip(*parts))))


def check_errors(got: dict, plain: dict) -> dict:
    """Each output's distance from its plain version over its
    tolerance (≤ 1 passes): out, dQ, dK and dV at the flash bf16
    tolerance, lse at ``LSE_ATOL`` absolute."""
    errs = {n: _rel_err(got[n], plain[n], FLASH_BF16_TOL)
            for n in ("out", "dq", "dk", "dv")}
    errs["lse"] = float((got["lse"].float() - plain["lse"].float()
                         ).abs().max()) / LSE_ATOL
    return errs


def probe_attention(dev, b, h, hkv, s, d, iters: int = 10,
                    dtype=None, seed: int = 0) -> list:
    """Records of the flash kernels and SDPA at one causal shape; K/V
    drawn at ``hkv`` heads and expanded to ``h`` (the model's GQA).

    Correctness is ``check_flash``'s: the kernels' out, lse, dQ, dK and
    dV against their plain versions (:func:`check_errors`;
    ``within_tol``).  Both packages' distance from float32 (SDPA
    computing on the same values in float32) is reported beside it: the
    bf16 rounding of out that enters the backward's ``delta`` moves dQ
    and dK by more than one ulp for any bf16 kernel, SDPA's included."""
    import torch
    import torch.nn.functional as F
    from nvme_strom_tpu_torch.ops import flash_attention as fa
    dtype = dtype or torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(heads):
        return torch.randn((b, heads, s, d), generator=gen, device=dev
                           ).to(dtype)
    q = draw(h)
    k = draw(hkv).repeat_interleave(h // hkv, dim=1)
    v = draw(hkv).repeat_interleave(h // hkv, dim=1)
    do = draw(h)
    scale = d ** -0.5
    shape = f"b{b}h{h}kv{hkv}s{s}d{d}"
    pairs = b * h * s * (s + 1) // 2
    bounds = {"fwd": 4 * d * pairs / BF16_FLOPS_PER_S * 1e3,
              "fwdbwd": (4 + 6 + 8) * d * pairs / BF16_FLOPS_PER_S * 1e3}
    names = ("out", "dq", "dk", "dv")

    launches = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
                fa.flash_bwd_dkv.launches)
    got, delta = kernel_grads(q, k, v, do, scale)
    ran = {"flash_fwd": fa.flash_fwd.launches - launches[0],
           "flash_bwd_dq": fa.flash_bwd_dq.launches - launches[1],
           "flash_bwd_dkv": fa.flash_bwd_dkv.launches - launches[2]}
    errs = check_errors(got, plain_reference(q, k, v, do, delta, scale))
    got = [got[n] for n in names]

    def grads(fn, dt):
        qq, kk, vv = (t.detach().to(dt).requires_grad_() for t in (q, k, v))
        o = fn(qq, kk, vv)
        o.backward(do.to(dt))
        return [o.detach(), qq.grad, kk.grad, vv.grad]

    def flash(qq, kk, vv):
        return fa.flash_attention(qq, kk, vv, causal=True, scale=scale)

    def sdpa(qq, kk, vv):
        return F.scaled_dot_product_attention(qq, kk, vv, is_causal=True,
                                              scale=scale)

    want = grads(sdpa, torch.float32)
    f32_dist = {"flash": {n: _rel_err(g, w, FLASH_BF16_TOL)
                          for n, g, w in zip(names, got, want)},
                "sdpa": {n: _rel_err(g, w, FLASH_BF16_TOL)
                         for n, g, w in zip(names, grads(sdpa, dtype),
                                            want)}}
    del got, want

    def fwdbwd(fn):
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))

        def run():
            fn(qq, kk, vv).backward(do)
            qq.grad = kk.grad = vv.grad = None
        return run

    recs = []
    for impl, fwd_fn, fb in (
            ("flash", lambda: fa.flash_fwd(q, k, v, True, scale),
             fwdbwd(flash)),
            ("sdpa", lambda: sdpa(q, k, v), fwdbwd(sdpa))):
        t_fwd = time_ms(fwd_fn, dev, iters)
        t_fb = time_ms(fb, dev, max(1, iters // 2))
        rec = {"probe": "attn", "shape": shape, "impl": impl,
               "dtype": str(dtype).replace("torch.", ""),
               "fwd_ms": t_fwd, "fwdbwd_ms": t_fb,
               "fwd_tflops": 4 * d * pairs / t_fwd / 1e9,
               "fwdbwd_tflops": 18 * d * pairs / t_fb / 1e9,
               "bound_fwd_ms": bounds["fwd"],
               "bound_fwdbwd_ms": bounds["fwdbwd"],
               "f32_err_over_tol": f32_dist[impl]}
        if impl == "flash":
            rec.update(err_over_tol=errs, launches_checked=ran,
                       within_tol=all(e <= 1.0 for e in errs.values()))
        recs.append(rec)
    return recs


def probe_matmul_roof(dev, sizes=(4096, 8192), chain: int = 8,
                      repeats: int = 3) -> list:
    """bf16 ``x @ w`` chained ``chain`` times (each product scaled by
    1/sqrt(n), so the chain stays finite), median of ``repeats``:
    TFLOP/s against the 989 peak."""
    import statistics
    import torch
    recs = []
    for n in sizes:
        gen = torch.Generator(device=dev).manual_seed(1)
        x = torch.randn((n, n), generator=gen, device=dev).bfloat16()
        w = torch.randn((n, n), generator=gen, device=dev).bfloat16()
        inv = 1.0 / float(n) ** 0.5

        def step(y):
            return torch.matmul(y, w).mul_(inv)

        def run():
            y = x
            for _ in range(chain):
                y = step(y)
            return y
        y = run()
        ts = [time_ms(run, dev, iters=1, warmup=0) / chain
              for _ in range(repeats)]
        t = statistics.median(ts)
        tf = 2 * n ** 3 / t / 1e9
        recs.append({"probe": "matmul_roof", "n": n, "ms": t,
                     "tflops": tf, "peak_tflops": BF16_FLOPS_PER_S / 1e12,
                     "share_of_peak": tf * 1e12 / BF16_FLOPS_PER_S,
                     "finite": bool(torch.isfinite(run()).all())})
        del x, w, y
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kernel_probe",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default="train,long_gqa",
                    help=f"named shapes, of {sorted(SHAPES)}")
    ap.add_argument("--shape", action="append", default=[],
                    metavar="B,H,HKV,S,D", help="another causal shape")
    ap.add_argument("--roof-n", default="4096,8192",
                    help="matmul sizes ('' skips the roof)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda:0",
                    help="the card ('cpu': the plain versions, float32)")
    args = ap.parse_args(argv)
    import torch
    from nvme_strom_tpu_torch.device import resolve_device
    dev = resolve_device(args.device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    shapes = [SHAPES[n] for n in args.shapes.split(",") if n]
    shapes += [tuple(int(x) for x in s.split(",")) for s in args.shape]
    ok = True
    for b, h, hkv, s, d in shapes:
        for rec in probe_attention(dev, b, h, hkv, s, d, args.iters, dtype):
            _emit(rec)
            ok &= rec["impl"] != "flash" or rec["within_tol"]
    sizes = tuple(int(x) for x in args.roof_n.split(",") if x)
    if sizes:
        for rec in probe_matmul_roof(dev, sizes):
            _emit(rec)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
