"""The weight-only int8 / int4 matmul of quantized leaves (models/quant.py)
on the card: two hand-written kernels in csrc/quant_matmul.cu.

The JAX package has no Pallas kernel here: ``x @ wmat(p, name, dtype)``
(nvme_strom_tpu/models/transformer.py:220, ``wmat``) is one program that
XLA fuses, dequantizing inside the matmul's operand read, so the TPU
reads the quantized bytes only.  Written as torch ops, the dequantized
weight is a tensor of its own, written in the compute dtype and read
back by the matmul.  The two kernels replace that program:

* ``quant_gemv`` — the fused product ``x @ W`` for the few rows of x of
  a decode or verify step: up to ``QUANT_GEMV_MAX_ROWS`` rows of bf16 /
  fp16 x, ``FMA_GEMV_MAX_ROWS`` of float32.  It dequantizes each weight
  element in registers as ``wmat`` rounds it and never writes W.  bf16 /
  fp16 x runs on the tensor cores (``mma.sync`` m16n8k16, the weight the
  tall operand), its weight tiles staged by asynchronous copies; bound
  by the quantized bytes over HBM bandwidth at a few rows (at 8 rows it
  runs at 54-55% of that bound in int8, 33-34% in int4), its time
  growing with the rows past ~16 as the products and B fragments add
  up.  float32 x keeps the CUDA-core FMA kernel (a tensor-core product
  would be TF32).  Both write f32 partials of their K splits, which a
  second launch sums in split order; ``quant_gemv_split_plain`` is that
  split and combine in torch.
* ``dequant`` — ``wmat``'s weight in one pass, reading the quantized
  bytes once, bitwise equal to the torch ops (``dequant_plain``).  Bound:
  the quantized bytes read and the weight written.  It serves every
  other product (``quant_matmul`` past the GEMV's rows: prefill, chunked
  prefill), whose matmul then goes to ``torch.matmul`` as the JAX
  package leaves it to XLA, and every ``wmat`` of a CUDA leaf.

A CPU tensor runs the plain version; a CUDA tensor launches a kernel or
raises.  Neither kernel has a backward: a leaf that asks for a gradient
raises, ``quant_gemv`` on an x that needs one raises, and
``quant_matmul`` sends such an x down the dequant route, where
``torch.matmul`` carries x's gradient (QLoRA's frozen quantized base).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from nvme_strom_tpu_torch import _build
from nvme_strom_tpu_torch.device import current_stream, sm_count
from nvme_strom_tpu_torch.ops.decode_attention import workspace

#: element types the kernels take, by their code in csrc/quant_matmul.cu
KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}
#: most rows of bf16 / fp16 x that ``quant_matmul`` sends to the fused
#: GEMV; wider products take ``dequant`` and ``torch.matmul``.  The
#: crossover chip_smoke.py ``check_quant`` measures (NVIDIA H100 80GB
#: HBM3, 700.00 W; PERF.md §6): the tensor-core GEMV is faster up to 128
#: rows at every Llama-3-8B weight (w_gate, w_down, wq, wk, lm_head) and
#: at a Mixtral-8x7B expert leaf (128 rows an expert), in int8 and int4,
#: in bf16 and fp16, and slower at 256 rows in most of them (w_gate int8
#: bf16: 0.089 against 0.132 ms at 128, 0.178 against 0.134 at 256; the
#: expert leaf 0.54 against 0.93 at 128, 1.08 against 0.95 at 256)
QUANT_GEMV_MAX_ROWS = 128
#: most rows of float32 x that go to the CUDA-core GEMV: its crossover
#: as chip_smoke.py ``check_quant`` measured it in bf16 (NVIDIA H100
#: 80GB HBM3, 700.00 W; PERF.md §6), where that kernel was first slower
#: than dequant + matmul at 16 rows
FMA_GEMV_MAX_ROWS = 8
#: output columns a block of the tensor-core GEMV holds (4 warps of 32)
TC_COLS = 128
#: fewest rows a split of the tensor-core GEMV holds: shorter splits only
#: deepen the in-order sum of the partials (Llama-3-8B's wk on an H100:
#: PERF.md §6)
TC_MIN_SPLIT_ROWS = 256
#: blocks of the float32 GEMV's grid the split count aims for, a SM.  8
#: blocks of 4 warps against 4 of 8 warps on the same card: 0.87-1.35x as
#: fast at M 8, 0.89-1.16x at M 1 (PERF.md §6)
BLOCKS_PER_SM = 8
#: fewest rows a split of the float32 GEMV holds (more splits only grow
#: the workspace), and the step split lengths are rounded up to (a k16
#: step of the tensor cores; even, so an int4 split starts on an even row)
MIN_SPLIT_ROWS = 128
SPLIT_ROW_STEP = 16


def row_tile(m: int) -> int:
    """Rows of x a block of the tensor-core GEMV holds over ``m`` rows:
    8, 16 or 32 (one, two or four n8 tiles), else tiles of 64, as
    csrc/quant_matmul.cu ``tc_tiles`` picks them."""
    return next((t for t in (8, 16, 32) if m <= t), 64)


@functools.lru_cache(maxsize=64)
def resident_blocks(device: int, mt: int, bits: int) -> int:
    """Blocks of the tensor-core GEMV at a row tile of ``mt`` rows and
    a weight of ``bits`` that share one SM of CUDA device ``device``, as
    the runtime counts them (csrc/quant_matmul.cu
    ``strom_quant_gemv_blocks``): what the kernel's launch bounds leave
    room for, or fewer where its ring's shared memory runs out."""
    blocks = ctypes.c_int(0)
    _build.check(_build.kernel_library().strom_quant_gemv_blocks(
        mt, bits, device, ctypes.byref(blocks)), "quant_gemv")
    return blocks.value


def _split_rows(K: int, want: int, least: int) -> tuple:
    """(rows a split holds, splits): at most ``want`` splits of at least
    ``least`` rows, a multiple of SPLIT_ROW_STEP, covering d_in."""
    rows = -(-K // max(1, want))
    rows = max(least, -(-rows // SPLIT_ROW_STEP) * SPLIT_ROW_STEP)
    return rows, -(-K // rows)


@functools.lru_cache(maxsize=4096)
def kernel_launch(E: int, M: int, K: int, N: int, sms: int,
                  resident: int) -> tuple:
    """(rows a split holds, splits, f32 workspace elements) of the
    tensor-core GEMV over x (E, M, K) and a (E, K, N) weight on a card of
    ``sms`` SMs that each hold ``resident`` of its blocks
    (``resident_blocks``): row tiles x TC_COLS-column tiles x E blocks a
    split, as many splits of at least TC_MIN_SPLIT_ROWS rows as let every
    block of the grid be resident at once (one wave: a second one would
    stream the weight's tail alone).  The workspace holds every split's
    (E, M, N) partials, 0 for one split."""
    mt = row_tile(M)
    tiles = -(-M // mt) * -(-N // TC_COLS) * E
    rows, n_splits = _split_rows(K, resident * sms // tiles,
                                 TC_MIN_SPLIT_ROWS)
    return rows, n_splits, n_splits * E * M * N if n_splits > 1 else 0


def fma_row_tile(m: int) -> tuple:
    """(rows of x a block holds, columns a lane holds) of the float32
    GEMV over ``m`` rows, as csrc/quant_matmul.cu ``run_fma`` picks
    them."""
    mt = next((t for t in (1, 2, 4, 8) if m <= t), 16)
    return mt, 4 if mt == 16 else 8


@functools.lru_cache(maxsize=4096)
def fma_launch(E: int, M: int, K: int, N: int, sms: int) -> tuple:
    """(rows a split holds, splits, f32 workspace elements) of the
    float32 GEMV: the fewest splits of at least MIN_SPLIT_ROWS rows that
    give the grid BLOCKS_PER_SM blocks a SM; the workspace holds every
    split's (E, M, N) partials, 0 for one split."""
    mt, vec = fma_row_tile(M)
    base = -(-N // (32 * vec)) * E * -(-M // mt)
    rows, n_splits = _split_rows(K, -(-BLOCKS_PER_SM * sms // base),
                                 MIN_SPLIT_ROWS)
    return rows, n_splits, n_splits * E * M * N if n_splits > 1 else 0


def leaf_parts(leaf) -> tuple:
    """(q, scale, bits, E, K, N, group) of a quantized leaf: its byte and
    scale tensors, 8 or 4 bits, the experts (1 for a 2-D weight), the
    logical d_in and d_out, and the rows a scale covers (K for int8).
    Raises on a leaf whose parts do not fit together."""
    if "q8" in leaf:
        q, scale, bits = leaf["q8"], leaf["scale"], 8
        K = int(q.shape[-2])
        want_scale = (*q.shape[:-2], 1, q.shape[-1])
        want_dtype = torch.int8
    else:
        q, scale, bits = leaf["q4"], leaf["scale4"], 4
        K = 2 * int(q.shape[-2])
        want_scale = (*q.shape[:-2], scale.shape[-3] if scale.dim() >= 3
                      else -1, 1, q.shape[-1])
        want_dtype = torch.uint8
    if q.dim() not in (2, 3):
        raise ValueError(f"a quantized leaf is 2-D or 3-D, got "
                         f"{tuple(q.shape)}")
    if q.dtype != want_dtype or scale.dtype != torch.float32:
        raise ValueError(f"quantized leaf of {q.dtype} / {scale.dtype}: "
                         f"expected {want_dtype} / torch.float32")
    if tuple(scale.shape) != tuple(want_scale):
        raise ValueError(f"scale {tuple(scale.shape)} does not fit the "
                         f"bytes {tuple(q.shape)}")
    groups = 1 if bits == 8 else int(scale.shape[-3])
    if K % groups or (bits == 4 and (K // groups) % 2):
        raise ValueError(f"{groups} scale groups do not cut d_in {K} into "
                         "even groups")
    E = int(q.shape[0]) if q.dim() == 3 else 1
    return q, scale, bits, E, K, int(q.shape[-1]), K // groups


def dequant_plain(leaf, dtype: torch.dtype) -> torch.Tensor:
    """``wmat``'s torch ops: int8 ``q8 * scale``; int4 unpacks byte i's
    low nibble to row 2i and its high nibble to row 2i + 1 (each stored
    as q + 8), then scales each group of rows; both in ``dtype``.  A call
    on a CUDA leaf is counted in ``dequant_plain.device_calls``: only a
    check against the kernel makes one."""
    if leaf[next(iter(leaf))].is_cuda:
        dequant_plain.device_calls += 1
    if "q8" in leaf:
        return leaf["q8"].to(dtype) * leaf["scale"].to(dtype)
    pk, sc = leaf["q4"], leaf["scale4"]
    lead = tuple(pk.shape[:-2])
    dhalf, dout = pk.shape[-2], pk.shape[-1]
    lo = (pk & 0xF).to(torch.int8) - 8
    hi = (pk >> 4).to(torch.int8) - 8
    q = torch.stack([lo, hi], dim=-2).reshape(*lead, 2 * dhalf, dout)
    ngroup = sc.shape[-3]
    g = (2 * dhalf) // ngroup
    wf = q.to(dtype).reshape(*lead, ngroup, g, dout) * sc.to(dtype)
    return wf.reshape(*lead, 2 * dhalf, dout)


#: torch-op dequantizations of a CUDA leaf (the checks' own)
dequant_plain.device_calls = 0


def quant_matmul_plain(x: torch.Tensor, leaf) -> torch.Tensor:
    """``x @ wmat(leaf)`` in torch: x (..., K) against a 2-D leaf, or
    (E, M, K) against a 3-D one, in x's dtype."""
    return x @ dequant_plain(leaf, x.dtype)


def quant_gemv_split_plain(x: torch.Tensor, leaf, split_rows: int
                           ) -> torch.Tensor:
    """The GEMV's split and combine in torch: d_in cut into splits of
    ``split_rows`` rows (even for int4), each split's partial product
    ``x[..., k0:k1] @ W[..., k0:k1, :]`` in float32 over W dequantized in
    x's dtype, the partials summed in split order from 0 and rounded
    once to x's dtype."""
    w = dequant_plain(leaf, x.dtype).float()
    if "q4" in leaf and split_rows % 2:
        raise ValueError("an int4 split starts on an even row")
    xf = x.float()
    acc = None
    for k0 in range(0, w.shape[-2], split_rows):
        part = xf[..., k0:k0 + split_rows] @ w[..., k0:k0 + split_rows, :]
        acc = part if acc is None else acc + part
    return acc.to(x.dtype)


def _check_leaf(leaf, device: torch.device, dtype: torch.dtype,
                what: str) -> tuple:
    """Raise on anything the kernels do not take for a product on
    ``device`` in ``dtype``; returns leaf_parts."""
    parts = leaf_parts(leaf)
    q, scale = parts[0], parts[1]
    for t in (q, scale):
        if t.device != device:
            raise ValueError(f"{what}: tensors on {device} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: the kernel takes a contiguous "
                             "quantized leaf")
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"{what}: the kernel takes {list(KERNEL_DTYPES)},"
                         f" got {dtype}")
    if torch.is_grad_enabled() and scale.requires_grad:
        raise RuntimeError(f"{what}: the quantized kernels have no "
                           "backward; a quantized leaf is frozen "
                           "(quantize a trained checkpoint)")
    return parts


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def quant_gemv(x: torch.Tensor, leaf) -> torch.Tensor:
    """x (E, M, K), contiguous, against a quantized leaf (E, K, N) (E = 1
    for a 2-D leaf) → (E, M, N) in x's dtype, W never written.  The
    plain version is ``quant_matmul_plain``."""
    q, scale, bits, E, K, N, group = leaf_parts(leaf)
    if x.dim() != 3 or tuple(x.shape[::2]) != (E, K):
        raise ValueError(f"x {tuple(x.shape)} does not fit a leaf of "
                         f"{E} x ({K}, {N})")
    if x.device.type == "cpu":
        w = quant_matmul_plain(x if q.dim() == 3 else x[0], leaf)
        return w if q.dim() == 3 else w[None]
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("quant_gemv: x must be contiguous")
    if _needs_grad(x):
        raise RuntimeError("quant_gemv has no backward: a product that "
                           "needs x's gradient takes quant_matmul's "
                           "dequant route")
    return _gemv(x, _check_leaf(leaf, x.device, x.dtype, "quant_gemv"))


def _gemv(x: torch.Tensor, parts: tuple) -> torch.Tensor:
    """The GEMV's launch on checked parts (``_check_leaf``): the
    tensor-core kernel for bf16 / fp16 x, the FMA kernel for float32."""
    q, scale, bits, E, K, N, group = parts
    M = int(x.shape[1])
    dev = x.device.index
    stream = current_stream(dev)
    if x.dtype == torch.float32:
        rows, _, n_ws = fma_launch(E, M, K, N, sm_count(dev))
    else:
        rows, _, n_ws = kernel_launch(E, M, K, N, sm_count(dev),
                                      resident_blocks(dev, row_tile(M),
                                                      bits))
    ws = workspace(x.device, stream, n_ws)
    out = torch.empty(E, M, N, dtype=x.dtype, device=x.device)
    _build.check(_build.kernel_library().strom_quant_gemv(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        0 if ws is None else ws.data_ptr(), E, M, K, N, group, bits, rows,
        KERNEL_DTYPES[x.dtype], stream, dev), "quant_gemv")
    quant_gemv.launches += 1
    return out


def max_rows(dtype: torch.dtype) -> int:
    """Most rows of x in ``dtype`` that ``quant_matmul`` sends to the
    fused GEMV."""
    return FMA_GEMV_MAX_ROWS if dtype == torch.float32 \
        else QUANT_GEMV_MAX_ROWS


def dequant(leaf, dtype: torch.dtype) -> torch.Tensor:
    """``wmat``'s dequantized weight (..., K, N) in ``dtype``: the kernel
    for a CUDA leaf, ``dequant_plain`` for a CPU one."""
    q = leaf["q8"] if "q8" in leaf else leaf["q4"]
    if q.device.type == "cpu":
        return dequant_plain(leaf, dtype)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    q, scale, bits, E, K, N, group = _check_leaf(leaf, q.device, dtype,
                                                 "dequant")
    dev = q.device.index
    out = torch.empty(*q.shape[:-2], K, N, dtype=dtype, device=q.device)
    _build.check(_build.kernel_library().strom_dequant(
        q.data_ptr(), scale.data_ptr(), out.data_ptr(), E, K, N, group,
        bits, KERNEL_DTYPES[dtype], sm_count(dev), current_stream(dev),
        dev), "dequant")
    dequant.launches += 1
    return out


def quant_matmul(x: torch.Tensor, leaf) -> torch.Tensor:
    """``x @ wmat(leaf)`` in x's dtype: x (..., K) against a 2-D leaf, or
    (E, M, K) against a 3-D (expert) one.  CPU: ``quant_matmul_plain``.
    CUDA: the fused GEMV where x has at most ``max_rows`` rows (an
    expert's rows for a 3-D leaf), else ``dequant`` and
    ``torch.matmul``, whose autograd also gives x's gradient where it is
    needed (an adapter upstream of a frozen quantized base)."""
    if x.device.type == "cpu":
        return quant_matmul_plain(x, leaf)
    parts = _check_leaf(leaf, x.device, x.dtype, "quant_matmul")
    q, _, _, E, K, N, _ = parts
    if x.shape[-1] != K or (q.dim() == 3 and (x.dim() != 3
                                               or x.shape[0] != E)):
        raise ValueError(f"x {tuple(x.shape)} does not fit a leaf of "
                         f"{E} x ({K}, {N})")
    lead = tuple(x.shape[:-1])
    M = math.prod(lead) // E
    if M == 0:
        return x.new_empty(*lead, N)
    if M > max_rows(x.dtype) or _needs_grad(x):
        return x @ dequant(leaf, x.dtype)
    return _gemv(x.reshape(E, M, K).contiguous(), parts).reshape(*lead, N)


#: launches of each kernel (CUDA only; the GEMV's combine, where it has
#: more than one split, belongs to its launch)
quant_gemv.launches = 0
dequant.launches = 0
