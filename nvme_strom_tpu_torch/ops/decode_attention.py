"""Decode attention: one query token per row against the KV cache
(counterpart of nvme_strom_tpu/ops/decode_attention.py).

``decode_attention`` launches the hand-written CUDA kernel
(csrc/decode_attention.cu, replacing the TPU kernel ``_decode_kernel``)
for CUDA tensors and runs ``decode_attention_plain`` for CPU tensors.
The kernel reads the cache at kv-head width (the GQA group is handled
inside), masks each row by its own position, and keeps the softmax state
in float32.  It is bound by the K/V bytes of the live positions over HBM
bandwidth, and splits each row's keys into ``split_len`` pieces so that
every SM streams: one launch scores the splits, a second combines a
row's splits (csrc/attn_common.cuh).  It takes any GQA group and any
head_dim: a multiple of 8 up to 256 on the built widths, every other
head_dim on the any-width path (three passes a split over runtime d).

``split_partials_plain`` and ``combine_splits_plain`` are the kernel's
split and combine written in torch; the tests hold them against
``decode_attention_plain``.
"""

from __future__ import annotations

import functools
import math
import threading

import torch

from nvme_strom_tpu_torch import _build
from nvme_strom_tpu_torch.device import current_stream, sm_count

#: element types the kernels take, by their code in csrc/attn_common.cuh
KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}
#: head widths the kernels are built for; a head_dim that is a multiple of
#: 8 runs on the next one up, so these take any such head_dim <= 256.
#: Every other head_dim runs on the any-width path.
KERNEL_WIDTHS = (64, 128, 256)
#: most query rows of a GQA group one block holds; a larger group takes
#: ceil(g / 4) blocks of rows (csrc/attn_common.cuh says why not 8)
KERNEL_MAX_ROWS = 4
#: keys a split holds: SPLIT_LEN, or LONG_SPLIT_LEN where the grid at
#: that length still holds two blocks on every SM of the card.  Of 128,
#: 256 and 512, 256 was the fastest at the flagship's 2k positions, 512
#: at 16k (fewer, longer blocks and a smaller combine); PERF.md has the
#: numbers.
SPLIT_LEN = 256
LONG_SPLIT_LEN = 512


def _positions(pos, b: int, device) -> torch.Tensor:
    """``pos`` (int, 0-d or (b,)) as an int32 (b,) tensor on ``device``."""
    if isinstance(pos, torch.Tensor):
        p = pos.to(device=device, dtype=torch.int32)
        if p.dim() == 0:
            return p.expand(b).contiguous()
        if p.shape != (b,):
            raise ValueError(f"pos must be scalar or ({b},), got "
                             f"{tuple(p.shape)}")
        return p.contiguous()
    return torch.full((b,), int(pos), dtype=torch.int32, device=device)


def _check_q(q: torch.Tensor, nkv: int) -> None:
    if q.dim() != 4 or q.shape[2] != 1:
        raise ValueError(f"expected q (b, h, 1, d), got {tuple(q.shape)}")
    if q.shape[1] % nkv:
        raise ValueError(f"{q.shape[1]} query heads not divisible by {nkv} "
                         "kv heads")


def check_kernel_inputs(q: torch.Tensor, *tensors: torch.Tensor) -> int:
    """Raise on anything the attention kernels do not take; returns the
    dtype code."""
    for t in (q,) + tensors:
        if t.device != q.device:
            raise ValueError(f"tensors on {q.device} and {t.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"mixed dtypes {q.dtype} and {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError("the kernel needs 16-byte aligned tensors")
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"the kernel takes {list(KERNEL_DTYPES)}, got "
                         f"{q.dtype}")
    return KERNEL_DTYPES[q.dtype]


def kernel_shape(d: int, g: int):
    """(head width, query rows a block holds) of the kernel that runs
    head_dim ``d`` and GQA group ``g``.  The width is the built one at or
    above ``d`` where ``d`` is a multiple of 8 up to 256, else ``d``
    itself: the any-width path, whose workspace rows are ``d`` floats."""
    width = (next(w for w in KERNEL_WIDTHS if d <= w)
             if d % 8 == 0 and d <= KERNEL_WIDTHS[-1] else d)
    return width, min(KERNEL_MAX_ROWS, 1 << (g - 1).bit_length())


@functools.lru_cache(maxsize=1024)
def kernel_launch(b: int, nh: int, nkv: int, d: int, capacity: int,
                  block_k: int, sms: int):
    """(head width, rows a block holds, keys a split holds, float32
    elements of workspace) of a launch over ``capacity`` keys a row on a
    card of ``sms`` SMs: SPLIT_LEN or LONG_SPLIT_LEN keys a split, cut
    down to whole blocks of ``block_k`` keys where a block is no longer.
    The workspace holds every split's fp32 acc (rows, width), m and l; it
    is 0 where no row can have more than one split."""
    g = nh // nkv
    width, rows = kernel_shape(d, g)
    cells = b * nkv * -(-g // rows)
    split_len = (LONG_SPLIT_LEN if cells * -(-capacity // LONG_SPLIT_LEN)
                 >= 2 * sms else SPLIT_LEN)
    if block_k <= split_len:
        split_len -= split_len % block_k
    n_splits = -(-capacity // split_len)
    ws = cells * n_splits * rows * (width + 2) if n_splits > 1 else 0
    return width, rows, split_len, ws


_workspaces: dict = {}


def workspace(device: torch.device, stream: int, n: int):
    """A float32 workspace of at least ``n`` elements on ``device`` (None
    for 0), kept for the calling thread's launches on ``stream``: those
    run in order, so each reuses it after the last has read it."""
    if not n:
        return None
    key = (threading.get_ident(), device.index, stream)
    ws = _workspaces.get(key)
    if ws is None or ws.numel() < n:
        ws = _workspaces[key] = torch.empty(n, dtype=torch.float32,
                                            device=device)
    return ws


def decode_attention_plain(q, k, v, pos, *, scale=None) -> torch.Tensor:
    """Plain PyTorch version: float32 scores over the whole cache, keys
    past ``pos`` masked with -1e30 and their V rows zeroed (so garbage
    there cannot make 0·NaN), output in q's dtype."""
    b, nh, _, d = q.shape
    _, nkv, S, _ = k.shape
    _check_q(q, nkv)
    g = nh // nkv
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    p = _positions(pos, b, q.device)
    ok = torch.arange(S, device=q.device)[None, :] <= p[:, None].long()
    qg = q.reshape(b, nkv, g, d).float() * scale
    vf = torch.where(ok[:, None, :, None], v.float(), 0.0)
    s = torch.einsum("bngd,bnsd->bngs", qg, k.float())
    s = torch.where(ok[:, None, None, :], s, -1e30)
    o = torch.einsum("bngs,bnsd->bngd", torch.softmax(s, dim=-1), vf)
    return o.reshape(b, nh, 1, d).to(q.dtype)


def split_partials_plain(q, k, v, pos, split_len: int, *, scale=None,
                         present=None):
    """The split kernel's per-split state in float32: the live keys
    [0, pos] of each row cut into splits of ``split_len`` keys and, for
    each split, m (b, nkv, g, n_splits) its largest score (-1e30 where
    the split holds no key), l the sum of exp(s − m) and acc
    (b, nkv, g, n_splits, d) the sum of exp(s − m)·v.  ``present``
    (b, S) bool marks the keys that may be read (the paged kernel skips
    table entries outside the pool).  Splits past pos come out empty."""
    b, nh, _, d = q.shape
    _, nkv, S, _ = k.shape
    _check_q(q, nkv)
    g = nh // nkv
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    p = _positions(pos, b, q.device)
    n = -(-S // split_len)
    pad = n * split_len - S
    live = torch.arange(S, device=q.device)[None, :] <= p[:, None].long()
    if present is not None:
        live = live & present
    live = torch.nn.functional.pad(live, (0, pad))
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    vf = torch.where(live[:, None, :, None], vf, 0.0)
    qg = q.reshape(b, nkv, g, d).float() * scale
    s = torch.einsum("bngd,bnsd->bngs", qg, kf)
    s = torch.where(live[:, None, None, :], s, -math.inf)
    s = s.view(b, nkv, g, n, split_len)
    m = s.amax(-1)
    e = torch.where(torch.isinf(m)[..., None], 0.0,
                    torch.exp(s - m[..., None]))
    acc = torch.einsum("bngcj,bncjd->bngcd", e,
                       vf.view(b, nkv, n, split_len, d))
    return torch.where(torch.isinf(m), -1e30, m), e.sum(-1), acc


def combine_splits_plain(m, l, acc, dtype) -> torch.Tensor:
    """The combine of :func:`split_partials_plain`'s state, as the
    kernel forms it: out = Σ e^(m_i − M)·acc_i / Σ e^(m_i − M)·l_i over
    a row's splits (an empty split adds nothing), 0 where no split holds
    a key; (b, nkv·g, 1, d) in ``dtype``."""
    b, nkv, g, _, d = acc.shape
    w = torch.exp(m - m.amax(-1, keepdim=True))
    den = (w * l).sum(-1, keepdim=True)
    num = (w[..., None] * acc).sum(-2)
    out = torch.where(den > 0, num / den, 0.0)
    return out.reshape(b, nkv * g, 1, d).to(dtype)


def decode_attention(q, k, v, pos, *, scale=None) -> torch.Tensor:
    """q (b, n_heads, 1, d) attends to the kv-width cache k/v
    (b, n_kv_heads, S, d) at positions [0, pos]; ``pos`` is the index of
    the newest entry, an int or a (b,) tensor.  Returns
    (b, n_heads, 1, d) in q's dtype."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (b, h, 1, d) and k/v (b, nkv, S, d),"
                         f" got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, nh, _, d = q.shape
    _, nkv, S, _ = k.shape
    _check_q(q, nkv)
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"cache {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, pos, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    code = check_kernel_inputs(q, k, v)
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    p = _positions(pos, b, q.device)
    out = torch.empty_like(q)
    dev = q.device.index
    width, rows, split_len, n_ws = kernel_launch(b, nh, nkv, d, S, 1,
                                                 sm_count(dev))
    stream = current_stream(dev)
    ws = workspace(q.device, stream, n_ws)
    _build.check(_build.kernel_library().strom_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(),
        out.data_ptr(), 0 if ws is None else ws.data_ptr(), b, nkv,
        nh // nkv, S, d, width, rows, split_len, code, float(scale),
        stream, dev), "decode_attention")
    decode_attention.launches += 1
    return out


#: launches of the decode-attention kernel (one a call: its split kernel
#: and, where a row may hold more than one split, the combine)
decode_attention.launches = 0
