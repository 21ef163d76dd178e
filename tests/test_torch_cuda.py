"""The port's CUDA kernels on the card (marker ``cuda``; skipped where
there is no CUDA device).  This file imports no JAX, so it also runs on
a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same
inputs: h2d_copy exactly, attention in bfloat16 to one bfloat16 ulp of
the output (rtol=2**-7: both sides accumulate in float32 and round once)
plus atol=2e-5 for float32 summation order near zero, and in float32 to
1e-4.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

#: (rtol, atol) of the attention kernels against their plain versions
BF16_TOL = (2 ** -7, 2e-5)
F32_TOL = (1e-4, 1e-4)


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


#: bytes one block of the h2d kernel's shipped design copies in a trip
#: of its grid-stride loop (256 threads, two 16-byte loads each;
#: csrc/h2d_copy.cu `kDesigns[0]`); the grid is sized in these blocks
_BLOCK = 2 * 256 * 16


@pytest.mark.parametrize("n,src_off,dst_off", [
    (1, 0, 0), (15, 1, 0), (4095, 3, 1), ((1 << 20) + 3, 5, 0),
    ((1 << 20) + 3, 0, 9),
    # one block -16 B, +16 B and +3 B; several blocks with an odd tail;
    # aligned, the source misaligned, the destination misaligned, and
    # both misaligned alike (an aligned body after a bytewise head)
    (_BLOCK - 16, 0, 0), (_BLOCK + 16, 0, 0), (_BLOCK + 3, 0, 0),
    (_BLOCK - 16, 4, 0), (_BLOCK + 16, 0, 12), (_BLOCK + 3, 9, 9),
    (5 * _BLOCK + 7, 0, 0), (5 * _BLOCK + 7, 3, 0), (5 * _BLOCK + 7, 0, 1),
    (5 * _BLOCK + 7, 11, 11)])
def test_h2d_copy_bytes(dev, n, src_off, dst_off):
    _check_h2d(dev, n, src_off, dst_off)


@pytest.mark.parametrize("trips,extra,src_off,dst_off", [
    (1, -16, 0, 0), (1, 16, 0, 0), (1, 3, 0, 0), (3, 7, 0, 0),
    (3, 7, 5, 0), (3, 7, 9, 9), (3, 7, 2, 13)])
def test_h2d_copy_bytes_across_grid_trips(dev, trips, extra, src_off,
                                          dst_off):
    """Sizes around whole trips of the full grid (8 blocks an SM), where
    the grid-stride loop goes round more than once."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _check_h2d(dev, trips * sms * 8 * _BLOCK + extra, src_off, dst_off)


def _check_h2d(dev, n, src_off, dst_off):
    """Copy n bytes at the offsets, launch counted once, every byte equal
    and nothing written outside the destination."""
    from nvme_strom_tpu_torch.ops.bridge import h2d_copy, pinned_mapping
    src = torch.empty(n + 32, dtype=torch.uint8, pin_memory=True)
    src.numpy()[:] = np.random.default_rng(n).integers(0, 256, n + 32,
                                                       dtype=np.uint8)
    m = pinned_mapping(src, dev)
    dst = torch.zeros(n + 32, dtype=torch.uint8, device=dev)
    before = h2d_copy.launches
    h2d_copy(src.numpy()[src_off:src_off + n], dst[dst_off:dst_off + n],
             src_ptr=m.dev_base + src_off)
    torch.cuda.synchronize()
    assert h2d_copy.launches == before + 1
    assert torch.equal(dst[dst_off:dst_off + n].cpu(),
                       src[src_off:src_off + n])
    assert not dst[:dst_off].any() and not dst[dst_off + n:].any()


@pytest.mark.parametrize("design", [1, 2])
@pytest.mark.parametrize("n,src_off,dst_off", [
    ((8 << 10) - 16, 0, 0), ((8 << 10) + 16, 0, 0), (5 * (8 << 10) + 7, 0, 0),
    (5 * (8 << 10) + 7, 3, 0), (5 * (8 << 10) + 7, 11, 11),
    ((4 << 20) + 3, 0, 0)])
def test_h2d_probe_designs_copy_bytes(dev, design, n, src_off, dst_off):
    """The probe's other designs (csrc/h2d_copy.cu `kDesigns`: four loads
    unrolled, and bulk copies of 8 KiB pieces) copy byte for byte too,
    across the bulk pieces' edges; launched through the C entry point,
    so they count nowhere."""
    from nvme_strom_tpu_torch import _build
    from nvme_strom_tpu_torch.ops.bridge import h2d_copy, pinned_mapping
    src = torch.empty(n + 32, dtype=torch.uint8, pin_memory=True)
    src.numpy()[:] = np.random.default_rng(n).integers(0, 256, n + 32,
                                                       dtype=np.uint8)
    m = pinned_mapping(src, dev)
    dst = torch.zeros(n + 32, dtype=torch.uint8, device=dev)
    before = h2d_copy.launches
    _build.check(_build.kernel_library().strom_h2d_copy_probe(
        m.dev_base + src_off, dst[dst_off:].data_ptr(), n, design,
        torch.cuda.current_stream(dev).cuda_stream, dev.index),
        "h2d_copy probe")
    torch.cuda.synchronize()
    assert h2d_copy.launches == before
    assert torch.equal(dst[dst_off:dst_off + n].cpu(),
                       src[src_off:src_off + n])
    assert not dst[:dst_off].any() and not dst[dst_off + n:].any()


def test_h2d_copy_of_nothing_launches_nothing(dev):
    from nvme_strom_tpu_torch.ops.bridge import h2d_copy, pinned_mapping
    src = torch.empty(16, dtype=torch.uint8, pin_memory=True)
    m = pinned_mapping(src, dev)
    before = h2d_copy.launches
    h2d_copy(src.numpy()[:0], torch.empty(0, dtype=torch.uint8, device=dev),
             src_ptr=m.dev_base)
    assert h2d_copy.launches == before


def _nan_cache(dev, dtype, b, nh, nkv, S, d, pos, seed):
    """q, k, v with NaN past each row's position."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, nh, 1, d, generator=g, device=dev).to(dtype)
    k = torch.randn(b, nkv, S, d, generator=g, device=dev).to(dtype)
    v = torch.randn(b, nkv, S, d, generator=g, device=dev).to(dtype)
    for i, p in enumerate(pos):
        k[i, :, p + 1:] = float("nan")
        v[i, :, p + 1:] = float("nan")
    return q, k, v


def _pool_of(k, v, bk):
    """The cache cut into pool blocks of ``bk`` keys, one NaN block last;
    the table names each row's blocks, in order."""
    b, nkv, S, d = k.shape
    nb = -(-S // bk)
    kp = torch.full((b * nb + 1, nkv, bk, d), float("nan"), dtype=k.dtype,
                    device=k.device)
    vp = kp.clone()
    for pool, t in ((kp, k), (vp, v)):
        pad = torch.nn.functional.pad(t, (0, 0, 0, nb * bk - S))
        pool[:-1] = pad.view(b, nkv, nb, bk, d).transpose(1, 2).reshape(
            -1, nkv, bk, d)
    table = torch.arange(b * nb, dtype=torch.int32,
                         device=k.device).view(b, nb).clone()
    return kp, vp, table


def _check_attention(q, k, v, pos, tol, bk=64):
    """decode_attention and paged_attention (the same cache in pool
    blocks, padding entries on a NaN block) against their plain versions
    and each other; returns both outputs."""
    from nvme_strom_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_plain)
    from nvme_strom_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_plain)
    got = decode_attention(q, k, v, pos)
    torch.testing.assert_close(got.float(),
                               decode_attention_plain(q, k, v, pos).float(),
                               rtol=tol[0], atol=tol[1])
    kp, vp, table = _pool_of(k, v, bk)
    for i, p in enumerate(pos.tolist()):
        table[i, max(p, 0) // bk + 1:] = kp.shape[0] - 1
    out = paged_attention(q, kp, vp, table, pos)
    torch.testing.assert_close(out.float(), got.float(), rtol=tol[0],
                               atol=tol[1])
    torch.testing.assert_close(
        out.float(), paged_attention_plain(q, kp, vp, table, pos).float(),
        rtol=tol[0], atol=tol[1])
    return got, out


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, BF16_TOL),
                                       (torch.float32, F32_TOL)])
@pytest.mark.parametrize("nh,nkv,d", [
    (8, 8, 64), (32, 8, 128), (4, 2, 64),
    # GQA groups and head dims past the powers of two: a group of 7 (two
    # chunks of 4 rows, one masked), of 16 (four chunks), d 96 and 40 on
    # wider builds
    (7, 1, 96), (28, 4, 128), (16, 1, 256), (4, 4, 40)])
def test_attention_kernels_match_plain(dev, dtype, tol, nh, nkv, d):
    pos = torch.tensor([0, 150, 299], dtype=torch.int32, device=dev)
    q, k, v = _nan_cache(dev, dtype, 3, nh, nkv, 300, d, pos.tolist(), 0)
    _check_attention(q, k, v, pos, tol)


@pytest.mark.parametrize("S,bk", [
    # splits of 256 keys, paged cut to 192 (2 blocks of 96) and to 240
    # (5 blocks of 48); at 4100 keys 512 a split, where the grid at 512
    # still fills the card
    (600, 64), (600, 96), (600, 48), (4100, 128)])
@pytest.mark.parametrize("nh,nkv,d", [(8, 8, 64), (28, 4, 128),
                                      (16, 1, 256), (7, 1, 96)])
def test_attention_kernels_at_split_edges(dev, S, bk, nh, nkv, d):
    """Positions one before, at and one past the first split edge and at
    the second, of both kernels' splits as the wrappers pick them; a row
    with pos < 0 gives 0."""
    from nvme_strom_tpu_torch.device import sm_count
    from nvme_strom_tpu_torch.ops.decode_attention import kernel_launch
    b = 8
    sms = sm_count(dev.index)
    Ld = kernel_launch(b, nh, nkv, d, S, 1, sms)[2]
    Lp = kernel_launch(b, nh, nkv, d, -(-S // bk) * bk, bk, sms)[2]
    pos = torch.tensor([Ld - 1, Ld, Ld + 1, 2 * Ld, Lp - 1, Lp, Lp + 1, -1],
                       dtype=torch.int32, device=dev)
    q, k, v = _nan_cache(dev, torch.bfloat16, b, nh, nkv, S, d,
                         pos.tolist(), Ld + bk)
    got, out = _check_attention(q, k, v, pos, BF16_TOL, bk=bk)
    assert (got[-1] == 0).all() and (out[-1] == 0).all()


@pytest.mark.parametrize("nh,nkv,d", [(8, 8, 64), (28, 4, 128)])
def test_attention_kernels_are_bitwise_repeatable(dev, nh, nkv, d):
    """No floating-point atomics: two calls give the same bits, on rows
    of one split and of many."""
    from nvme_strom_tpu_torch.ops.decode_attention import decode_attention
    from nvme_strom_tpu_torch.ops.paged_attention import paged_attention
    pos = torch.tensor([3, 700, 2047, 1500], dtype=torch.int32, device=dev)
    q, k, v = _nan_cache(dev, torch.bfloat16, 4, nh, nkv, 2048, d,
                         pos.tolist(), 1)
    kp, vp, table = _pool_of(k, v, 128)
    for fn, args in ((decode_attention, (q, k, v, pos)),
                     (paged_attention, (q, kp, vp, table, pos))):
        assert torch.equal(fn(*args), fn(*args))


def test_kernel_wrappers_reject_what_they_do_not_take(dev):
    """Every head_dim runs: 16 on the 64-wide build, 20 and 264 on the
    any-width path, each matching the plain version; fp16 raises."""
    from nvme_strom_tpu_torch.ops.decode_attention import decode_attention
    for d, seed in ((16, 2), (20, 3), (264, 4)):
        pos = torch.tensor([3, 7], dtype=torch.int32, device=dev)
        q, k, v = _nan_cache(dev, torch.float32, 2, 4, 2, 8, d,
                             pos.tolist(), seed)
        _check_attention(q, k, v, pos, F32_TOL, bk=4)
    q = torch.zeros(2, 4, 1, 64, device=dev, dtype=torch.float16)
    k = torch.zeros(2, 2, 8, 64, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="takes"):
        decode_attention(q, k, k, 3)


#: head dims past the built widths: ragged (rows not 16-byte aligned;
#: loads of 4 elements where d is a multiple of 4, else of 1) and wide,
#: up to DeepSeek's 576
_ANY_D = [1, 12, 20, 30, 100, 264, 320, 512, 576]


@pytest.mark.parametrize("d", _ANY_D)
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, BF16_TOL),
                                       (torch.float32, F32_TOL)])
@pytest.mark.parametrize("nh,nkv", [(4, 4), (14, 2)])
def test_attention_kernels_take_any_head_dim(dev, d, dtype, tol, nh, nkv):
    """The any-width path, groups of 1 and 7: both kernels against their
    plain versions and each other, NaN past every row's position, rows
    of one split and of several (at 600 keys, splits of 256; paged cut
    to blocks of 48), pos < 0 giving 0, two calls bitwise equal."""
    from nvme_strom_tpu_torch.ops.decode_attention import (
        decode_attention, kernel_shape)
    from nvme_strom_tpu_torch.ops.paged_attention import paged_attention
    assert kernel_shape(d, nh // nkv)[0] == d
    pos = torch.tensor([0, 255, 256, 599, -1], dtype=torch.int32,
                       device=dev)
    q, k, v = _nan_cache(dev, dtype, 5, nh, nkv, 600, d, pos.tolist(), d)
    got, out = _check_attention(q, k, v, pos, tol, bk=48)
    assert (got[-1] == 0).all() and (out[-1] == 0).all()
    kp, vp, table = _pool_of(k, v, 48)
    for fn, args in ((decode_attention, (q, k, v, pos)),
                     (paged_attention, (q, kp, vp, table, pos))):
        assert torch.equal(fn(*args), fn(*args))


def test_stream_and_weights_on_the_card(dev, tmp_path):
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.ops.bridge import DeviceStream
    from nvme_strom_tpu_torch.parallel.weights import (LazyCheckpoint,
                                                       save_checkpoint)
    from nvme_strom_tpu_torch.utils.config import EngineConfig
    data = np.random.default_rng(0).integers(0, 256, (5 << 20) + 77,
                                             dtype=np.uint8)
    path = tmp_path / "x.bin"
    data.tofile(path)
    # 8 staging buffers take the overlap stage at depth 3, 16 copy in place
    for n_buffers in (8, 16):
        cfg = EngineConfig(chunk_bytes=1 << 20,
                           buffer_pool_bytes=n_buffers << 20)
        with StromEngine(cfg) as eng:
            ds = DeviceStream(eng, device=dev)
            assert ds.overlap == (n_buffers == 8)
            got = ds.read_to_device(path)
            assert got.device == dev
            assert torch.equal(got.cpu(), torch.from_numpy(data))
    with StromEngine(cfg) as eng:
        params = {"a": torch.randn(300, 70), "b": torch.randn(5).bfloat16()}
        save_checkpoint(tmp_path / "m.safetensors", params)
        out = LazyCheckpoint(tmp_path / "m.safetensors").load(eng,
                                                              device=dev)
        for name, t in params.items():
            assert torch.equal(out[name].cpu(), t)
        eng.sync_stats()
        st = eng.stats.snapshot()
    if st["bytes_fallback"] == 0:
        assert st["bounce_bytes"] == 0


@pytest.mark.parametrize("n_buffers", [8, 16])
def test_slow_consumer_on_the_current_stream_sees_every_chunk(
        dev, tmp_path, n_buffers):
    """The consumer's kernels on the current stream lag the stream by
    many chunks; a chunk's memory, once freed, must not take the next
    copy before those kernels have read it."""
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.ops.bridge import DeviceStream
    from nvme_strom_tpu_torch.utils.config import EngineConfig
    mib = 1 << 20
    data = np.random.default_rng(1).integers(0, 256, 16 * mib + 5,
                                             dtype=np.uint8)
    path = tmp_path / "x.bin"
    data.tofile(path)
    cfg = EngineConfig(chunk_bytes=mib, buffer_pool_bytes=n_buffers * mib)
    sums = []
    with StromEngine(cfg) as eng:
        for chunk in DeviceStream(eng, device=dev).stream_file(path):
            torch.cuda._sleep(2_000_000)     # ~1 ms before the read
            sums.append(chunk.to(torch.int64).sum())
    torch.cuda.synchronize()
    want = [int(data[o:o + mib].astype(np.int64).sum())
            for o in range(0, data.size, mib)]
    assert [s.item() for s in sums] == want


def test_dense_and_paged_servers_agree_on_the_card(dev):
    from nvme_strom_tpu_torch.convert import params_from_jax
    from nvme_strom_tpu_torch.models.serving import (DecodeServer,
                                                     PagedDecodeServer)
    from nvme_strom_tpu_torch.models.transformer import (TransformerConfig,
                                                         init_params)
    from nvme_strom_tpu_torch.ops.decode_attention import decode_attention
    from nvme_strom_tpu_torch.ops.paged_attention import paged_attention
    cfg = TransformerConfig(vocab=256, d_model=128, n_layers=2, n_heads=2,
                            n_kv_heads=1, d_ff=256, max_seq=256)
    params = params_from_jax(init_params(0, cfg), cfg, dev)
    rng = np.random.default_rng(0)
    reqs = [(f"r{i}", rng.integers(0, 256, n).tolist(), 12)
            for i, n in enumerate([3, 40, 90, 7, 130])]
    outs = []
    d0, p0 = decode_attention.launches, paged_attention.launches
    for srv in (DecodeServer(params, cfg, 3, 256, device=dev),
                PagedDecodeServer(params, cfg, 3, 256, total_blocks=20,
                                  block_len=32, device=dev)):
        for rid, p, m in reqs:
            srv.submit(rid, p, m)
        outs.append(srv.run(lookahead=4))
    assert outs[0] == outs[1]
    assert decode_attention.launches > d0 and paged_attention.launches > p0
    # float32: the kernel path against the plain path on the card
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = {k: v.float() for k, v in params.items()}
    from nvme_strom_tpu_torch.models import decode as dec
    prompt = torch.tensor([reqs[1][1][:30], reqs[2][1][:30]], device=dev)
    logits = []
    for attn in (None, decode_attention):
        cache = dec.init_cache(cfg32, 2, 64, device=dev)
        _, cache = dec.prefill(p32, prompt, cfg32, cache)
        lg, _ = dec.decode_step(p32, prompt[:, -1], cfg32, cache, attn)
        logits.append(lg)
    torch.testing.assert_close(logits[1], logits[0], atol=1e-3, rtol=1e-3)


def test_engine_unregisters_before_destroy(dev, tmp_path):
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.utils.config import EngineConfig
    eng = StromEngine(EngineConfig(chunk_bytes=1 << 20,
                                   buffer_pool_bytes=8 << 20))
    m = eng.cuda_mapping(dev.index)
    assert m.dev_base and m.nbytes >= 8 << 20
    assert eng.cuda_mapping(dev.index) is m
    eng.close_all()
    assert not eng._mappings
    os.sync()


# -- flash attention (kernels 4-6) --------------------------------------------

#: (rtol, atol as a fraction of max |plain|) of the flash kernels against
#: their plain versions.  Both sides compute in fp32 from the same
#: inputs and round once, so bf16 results may differ by one bf16 ulp
#: (rtol 2**-7); the sums over up to 2048 keys or queries run in another
#: order, which the relative atol covers where a gradient is near zero.
FLASH_BF16 = (2 ** -7, 1e-4)
FLASH_F32 = (1e-4, 1e-5)


def _flash_close(got, want, tol):
    atol = tol[1] * want.float().abs().max().item() + 1e-6
    torch.testing.assert_close(got.float(), want.float(), rtol=tol[0],
                               atol=atol)


def _flash_inputs(dev, b, h, s, skv, d, dtype, seed, projection=False):
    """q, k, v, dout; ``projection`` lays q, v and dout out as the
    model's (b, s, h, d) views so the kernels read strided inputs."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def make(n):
        if projection:
            return torch.randn(b, n, h, d, generator=g, device=dev).to(
                dtype).transpose(1, 2)
        return torch.randn(b, h, n, d, generator=g, device=dev).to(dtype)
    return make(s), make(skv), make(skv), make(s)


#: bf16 rows that cross the tensor-core kernels' tile edges: 128 q rows
#: and 64-key K/V tiles (forward and dQ), 128 keys and 64-row Q/dO tiles
#: (dK/dV)
_EDGE_ROWS = [
    (1, 2, s, s, d, torch.bfloat16, True, s == 2047)
    for d in (64, 128) for s in (63, 64, 65, 127, 128, 129, 2047)
] + [
    (2, 2, 200, skv, d, torch.bfloat16, False, d == 128)
    for d in (64, 128) for skv in (1, 129, 300)
]


@pytest.mark.parametrize("b,h,s,skv,d,dtype,causal,proj", [
    (2, 3, 200, 200, 64, torch.bfloat16, True, True),
    (1, 2, 256, 256, 128, torch.float32, True, False),
    (2, 2, 130, 300, 128, torch.bfloat16, False, True),
    (2, 2, 100, 64, 64, torch.float32, False, False),
] + _EDGE_ROWS)
def test_flash_kernels_match_plain(dev, b, h, s, skv, d, dtype, causal,
                                   proj):
    _check_flash(dev, b, h, s, skv, d, dtype, causal, proj, dlse=None)


@pytest.mark.parametrize("s,d", [(129, 128), (129, 64), (200, 128)])
def test_flash_kernels_match_plain_with_dlse(dev, s, d):
    """A random cotangent on lse, so the per-row delta that dQ and dK/dV
    read differs row by row across the 64-row and 128-row tile edges."""
    _check_flash(dev, 1, 2, s, s, d, torch.bfloat16, True, True,
                 dlse=torch.Generator(device=dev).manual_seed(s + d))


def _check_flash(dev, b, h, s, skv, d, dtype, causal, proj, dlse):
    """Forward and backward kernels against their plain versions; delta
    takes −0.25 for every row, or with ``dlse`` (a generator) a random
    value a row."""
    from nvme_strom_tpu_torch.ops import flash_attention as fa
    tol = FLASH_BF16 if dtype == torch.bfloat16 else FLASH_F32
    q, k, v, do = _flash_inputs(dev, b, h, s, skv, d, dtype, s + skv, proj)
    scale = d ** -0.5
    n0 = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
          fa.flash_bwd_dkv.launches)
    out, lse = fa.flash_fwd(q, k, v, causal, scale)
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, causal, scale)
    _flash_close(out, out_p, tol)
    torch.testing.assert_close(lse, lse_p, rtol=0, atol=1e-4)
    delta = (do.float() * out.float()).sum(-1)
    if dlse is None:
        delta = delta - 0.25
    else:
        delta = (delta - torch.randn(delta.shape, generator=dlse,
                                     device=dev)).contiguous()
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    _flash_close(dq, fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal,
                                           scale), tol)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal,
                                        scale)
    _flash_close(dk, dk_p, tol)
    _flash_close(dv, dv_p, tol)
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == tuple(n + 1 for n in n0)
    # no atomics: the backward is bitwise the same on a second run
    assert torch.equal(dq, fa.flash_bwd_dq(q, k, v, do, lse, delta, causal,
                                           scale))
    dk2, dv2 = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


def test_flash_routes_bf16_to_wgmma_and_fp32_to_fma(dev):
    """bf16 runs the forward, dQ and dK/dV on the tensor cores; fp32
    keeps the fp32 FMA kernels, which hold the fp32 tolerance across the
    tile edges."""
    from nvme_strom_tpu_torch.ops import flash_attention as fa
    assert [fa.flash_route(k, torch.bfloat16) for k in ("fwd", "dq", "dkv")
            ] == ["wgmma", "wgmma", "wgmma"]
    assert [fa.flash_route(k, torch.float32) for k in ("fwd", "dq", "dkv")
            ] == ["fma", "fma", "fma"]
    q, k, v, do = _flash_inputs(dev, 1, 2, 129, 129, 128, torch.float32, 3,
                                projection=True)
    scale = 128 ** -0.5
    out, lse = fa.flash_fwd(q, k, v, True, scale)
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, True, scale)
    _flash_close(out, out_p, FLASH_F32)
    delta = (do * out).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, True, scale)
    _flash_close(dq, fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, True,
                                           scale), FLASH_F32)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, True, scale)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, True, scale)
    _flash_close(dk, dk_p, FLASH_F32)
    _flash_close(dv, dv_p, FLASH_F32)


def test_flash_autograd_with_lse_cotangent(dev):
    """Gradients through (out, lse) on the card equal the plain
    formulas with delta = Σ dO·out − dlse."""
    from nvme_strom_tpu_torch.ops import flash_attention as fa
    q, k, v, do = _flash_inputs(dev, 2, 2, 150, 150, 64, torch.float32, 7)
    dlse = torch.randn(2, 2, 150, device=dev)
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    out, lse = fa.flash_attention_lse(qs, ks, vs, causal=True)
    ((out * do).sum() + (lse * dlse).sum()).backward()
    scale = 64 ** -0.5
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, True, scale)
    delta = (do * out_p).sum(-1) - dlse
    _flash_close(qs.grad, fa.flash_bwd_dq_plain(q, k, v, do, lse_p, delta,
                                                True, scale), FLASH_F32)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta, True,
                                        scale)
    _flash_close(ks.grad, dk_p, FLASH_F32)
    _flash_close(vs.grad, dv_p, FLASH_F32)


def test_flash_wrappers_reject_what_they_do_not_take(dev):
    from nvme_strom_tpu_torch.ops import flash_attention as fa
    x = torch.zeros(1, 2, 64, 32, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(x, x, x)
    x = torch.zeros(1, 2, 64, 64, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="takes"):
        fa.flash_fwd(x, x, x)
    x = torch.zeros(1, 2, 64, 64, device=dev)
    with pytest.raises(ValueError, match="stride"):
        fa.flash_fwd(x.transpose(2, 3), x, x)
    with pytest.raises(ValueError, match="devices|on"):
        fa.flash_fwd(x, x.cpu(), x)
    with pytest.raises(ValueError, match="equal q/kv"):
        fa.flash_fwd(x, x[:, :, :32], x[:, :, :32])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("scale", [-0.125, 0.0])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernels_take_any_scale(dev, dtype, scale, causal):
    """A negative scale and scale 0 (the uniform softmax over the
    unmasked keys): the forward and, through torch.autograd, the
    backward kernels against the plain versions."""
    from nvme_strom_tpu_torch.ops import flash_attention as fa
    tol = FLASH_BF16 if dtype == torch.bfloat16 else FLASH_F32
    s, skv = (200, 200) if causal else (130, 300)
    q, k, v, do = _flash_inputs(dev, 2, 2, s, skv, 64, dtype, 11, True)
    out, lse = fa.flash_fwd(q, k, v, causal, scale)
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, causal, scale)
    _flash_close(out, out_p, tol)
    torch.testing.assert_close(lse, lse_p, rtol=0, atol=1e-4)
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    fa.flash_attention(qs, ks, vs, causal=causal, scale=scale).backward(do)
    delta = (do.float() * out_p.float()).sum(-1)
    args = (q, k, v, do, lse_p, delta, causal, scale)
    _flash_close(qs.grad, fa.flash_bwd_dq_plain(*args), tol)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(*args)
    _flash_close(ks.grad, dk_p, tol)
    _flash_close(vs.grad, dv_p, tol)


def test_trainer_fits_two_steps_with_flash_kernels(dev, tmp_path):
    """Loader → Trainer with the flash kernels on the card: finite
    losses, every flash kernel and h2d_copy launched, a checkpoint that
    resumes bitwise."""
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.models.transformer import TransformerConfig
    from nvme_strom_tpu_torch.ops import flash_attention as fa
    from nvme_strom_tpu_torch.ops.bridge import h2d_copy
    from nvme_strom_tpu_torch.train import Trainer
    from nvme_strom_tpu_torch.train_lm import (synthesize_shards,
                                              token_batches)
    cfg = TransformerConfig(vocab=512, d_model=256, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=512, max_seq=256)
    shards = synthesize_shards(str(tmp_path), cfg.vocab, 256, 2, 8)
    before = {f: f.launches for f in (fa.flash_fwd, fa.flash_bwd_dq,
                                      fa.flash_bwd_dkv, h2d_copy)}
    losses = []
    with StromEngine() as eng:
        with Trainer(cfg, attn_fn=fa.make_flash_attn(), engine=eng,
                     ckpt_dir=tmp_path / "ck", device=dev,
                     hooks=[lambda s, l, dt: losses.append(l)]) as tr:
            res = tr.fit(token_batches(shards, 4, cfg.vocab, eng, dev),
                         steps=2)
            saved = {n: p.detach().clone() for n, p in tr.params.items()}
        with Trainer(cfg, engine=eng, ckpt_dir=tmp_path / "ck",
                     device=dev) as tr2:
            assert tr2.resumed_from == 2
            for n, p in tr2.params.items():
                assert torch.equal(p.detach(), saved[n]), n
    assert res.steps == 2 and len(losses) == 2
    assert all(np.isfinite(losses))
    for f, n in before.items():
        assert f.launches > n, f.__name__


# -- the ring all-gather (kernel 7) and the scatter restore -------------------

def _ring_slots(devs, width, seed):
    """Per-rank (n, width) outputs with each rank's own row primed."""
    n = len(devs)
    g = torch.Generator().manual_seed(seed)
    rows = torch.randint(0, 256, (n, width), generator=g, dtype=torch.uint8)
    slots = []
    for r, d in enumerate(devs):
        s = torch.zeros(n, width, dtype=torch.uint8, device=d)
        s[r] = rows[r].to(d)
        slots.append(s)
    return rows, slots


#: slot widths at the ring's chunk edges, from the chunk's bytes and the
#: B blocks of a rank (known once the group's ring is built on the card):
#: one chunk and one whole round of the blocks' chunks, ± 16 bytes
_RING_EDGES = {
    "chunk - 16": lambda chunk, B: chunk - 16,
    "chunk + 16": lambda chunk, B: chunk + 16,
    "B * chunk - 16": lambda chunk, B: B * chunk - 16,
    "B * chunk + 16": lambda chunk, B: B * chunk + 16,
}


@pytest.mark.parametrize("n", [2, 3, 4, 8])
@pytest.mark.parametrize("width", [16, 4096, 3 * 4096 + 48, 1 << 22,
                                   *_RING_EDGES])
def test_ici_ring_matches_plain_on_one_card(dev, n, width):
    from nvme_strom_tpu_torch.ops.ici import (_Ring, ici_ring_gather,
                                              ici_ring_gather_plain)
    from nvme_strom_tpu_torch.parallel.mesh import exchange_group
    group = exchange_group(devices=[dev] * n)
    if isinstance(width, str):
        group.ring = _Ring(group)
        width = _RING_EDGES[width](group.ring.chunk, group.ring.blocks)
    rows, _ = _ring_slots([dev] * n, width, width + n)
    for call in range(3):              # the flags' epochs carry over
        _, slots = _ring_slots([dev] * n, width, width + n)
        _, plain = _ring_slots([dev] * n, width, width + n)
        before = ici_ring_gather.launches
        ici_ring_gather(slots, group)
        assert ici_ring_gather.launches == before + 1
        ici_ring_gather_plain(plain)
        for s, p in zip(slots, plain):
            assert torch.equal(s, p)
            assert torch.equal(s.cpu(), rows)
    assert group.ring.calls == 3


def test_ici_exchange_ragged_rows_and_repeated_calls(dev):
    from nvme_strom_tpu_torch.ops.ici import IciExchange, ici_ring_gather
    from nvme_strom_tpu_torch.parallel.mesh import exchange_group
    ex = IciExchange(exchange_group(devices=[dev] * 4))
    before = ici_ring_gather.launches
    for nbytes in (1, 4095, 12_345, (1 << 20) + 7, 12_345):
        rows = np.random.default_rng(nbytes).integers(0, 256, (4, nbytes),
                                                      dtype=np.uint8)
        got = ex.all_gather(rows)
        assert got.is_pinned() and got.numpy().tobytes() == rows.tobytes()
    assert ici_ring_gather.launches == before + 5


def test_ici_ring_fault_raises_instead_of_hanging(dev):
    """A ring whose flags disagree with its epoch (a protocol fault) runs
    out of its wait budget, raises, and leaves the group usable."""
    from nvme_strom_tpu_torch.ops.ici import (ici_ring_gather,
                                              ici_ring_gather_plain)
    from nvme_strom_tpu_torch.parallel.mesh import exchange_group
    group = exchange_group(devices=[dev] * 2)
    rows, slots = _ring_slots([dev] * 2, 4096, 0)
    ici_ring_gather(slots, group)
    group.ring.base += 5               # waits for pushes that never come
    with pytest.raises(RuntimeError, match="budget"):
        ici_ring_gather(_ring_slots([dev] * 2, 4096, 0)[1], group)
    assert group.ring.calls == 0
    _, slots = _ring_slots([dev] * 2, 4096, 1)
    _, plain = _ring_slots([dev] * 2, 4096, 1)
    ici_ring_gather(slots, group)
    ici_ring_gather_plain(plain)
    assert all(torch.equal(s, p) for s, p in zip(slots, plain))


def test_ici_ring_across_cards(dev):
    from nvme_strom_tpu_torch.ops.ici import ici_ring_gather
    from nvme_strom_tpu_torch.parallel.mesh import exchange_group
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two or more CUDA devices, have {n}")
    devs = [torch.device("cuda", i) for i in range(n)]
    group = exchange_group()
    for call in range(3):
        rows, slots = _ring_slots(devs, (1 << 20) + 16, call)
        ici_ring_gather(slots, group)
        for s in slots:
            assert torch.equal(s.cpu(), rows)
    from nvme_strom_tpu_torch.ops.ici import IciExchange
    rows = np.random.default_rng(n).integers(0, 256, (n, 12_345),
                                             dtype=np.uint8)
    got = IciExchange(group).all_gather(rows)
    assert got.numpy().tobytes() == rows.tobytes()
    assert torch.cuda.current_device() == 0


def test_scatter_restore_on_one_card(dev, tmp_path, monkeypatch):
    """Restore and weights load with the read-once scatter on 4 ranks of
    one card: bitwise equal to the read-all path, with the ring and
    h2d_copy launched and no brown-out."""
    from nvme_strom_tpu_torch.checkpoint.manager import CheckpointManager
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.ops.bridge import h2d_copy
    from nvme_strom_tpu_torch.ops.ici import ici_ring_gather
    from nvme_strom_tpu_torch.parallel.mesh import exchange_group
    from nvme_strom_tpu_torch.parallel.weights import (LazyCheckpoint,
                                                       save_checkpoint)
    g = torch.Generator().manual_seed(0)
    state = {"w": torch.randn(700, 300, generator=g).bfloat16(),
             "m": {"w": torch.randn(700, 300, generator=g)}, "step": 4}
    group = exchange_group(devices=[dev] * 4)
    with StromEngine() as eng:
        mgr = CheckpointManager(tmp_path / "ck", engine=eng)
        mgr.save(4, state)
        off = mgr.restore(device=dev)
        monkeypatch.setenv("STROM_ICI_SCATTER", "1")
        before = (ici_ring_gather.launches, h2d_copy.launches)
        on = mgr.restore(device=dev, ici_group=group)
        assert ici_ring_gather.launches > before[0]
        assert h2d_copy.launches > before[1]
        assert set(on) == set(off)
        for k in off:
            assert on[k].device == dev and torch.equal(on[k], off[k]), k
        save_checkpoint(tmp_path / "m.safetensors", {"a": state["w"]})
        monkeypatch.delenv("STROM_ICI_SCATTER")
        w_off = LazyCheckpoint(tmp_path / "m.safetensors").load(eng, dev)
        monkeypatch.setenv("STROM_ICI_SCATTER", "1")
        w_on = LazyCheckpoint(tmp_path / "m.safetensors").load(
            eng, dev, ici_group=group)
        assert torch.equal(w_on["a"], w_off["a"])
        eng.sync_stats()
        assert eng.stats.ici_fallbacks == 0 and eng.stats.ici_bytes_read > 0
