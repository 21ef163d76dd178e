"""The port's CUDA kernels on the card (marker ``cuda``; skipped where
there is no CUDA device).  This file imports no JAX, so it also runs on
a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same
inputs: h2d_copy exactly, attention in bfloat16 to one bfloat16 ulp of
the output (rtol=2**-7: both sides accumulate in float32 and round once)
plus atol=2e-5 for float32 summation order near zero, in float16 to one
float16 ulp (rtol=2**-10) plus the same atol, and in float32 to 1e-4.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

#: (rtol, atol) of the attention kernels against their plain versions
BF16_TOL = (2 ** -7, 2e-5)
F16_TOL = (2 ** -10, 2e-5)
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
                                       (torch.float16, F16_TOL),
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
    any-width path, each matching the plain version; a dtype the kernels
    have no case for (float64) raises."""
    from nvme_strom_tpu_torch.ops.decode_attention import decode_attention
    for d, seed in ((16, 2), (20, 3), (264, 4)):
        pos = torch.tensor([3, 7], dtype=torch.int32, device=dev)
        q, k, v = _nan_cache(dev, torch.float32, 2, 4, 2, 8, d,
                             pos.tolist(), seed)
        _check_attention(q, k, v, pos, F32_TOL, bk=4)
    q = torch.zeros(2, 4, 1, 64, device=dev, dtype=torch.float64)
    k = torch.zeros(2, 2, 8, 64, device=dev, dtype=torch.float64)
    with pytest.raises(ValueError, match="takes"):
        decode_attention(q, k, k, 3)


#: head dims past the built widths: ragged (rows not 16-byte aligned;
#: loads of 4 elements where d is a multiple of 4, else of 1) and wide,
#: up to DeepSeek's 576
_ANY_D = [1, 12, 20, 30, 100, 264, 320, 512, 576]


@pytest.mark.parametrize("d", _ANY_D)
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, BF16_TOL),
                                       (torch.float16, F16_TOL),
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


@pytest.mark.parametrize("quant,rail", [(None, 0.0), ("int8", 0.05),
                                        ("int4", 0.25)])
def test_moe_and_quantized_serving_on_the_card(dev, quant, rail):
    """A MoE model (dropless: capacity factor E / k), full precision or
    with weight-only int8 / int4 leaves made on the card: both servers
    give the same tokens, decode and paged attention launch, and the
    quantized first-step logits stay within the JAX tests' rails of the
    full-precision ones."""
    from nvme_strom_tpu_torch.convert import params_from_jax
    from nvme_strom_tpu_torch.models import decode as dec
    from nvme_strom_tpu_torch.models import quant as q
    from nvme_strom_tpu_torch.models.serving import (DecodeServer,
                                                     PagedDecodeServer)
    from nvme_strom_tpu_torch.models.transformer import (TransformerConfig,
                                                         init_params)
    from nvme_strom_tpu_torch.ops.decode_attention import decode_attention
    from nvme_strom_tpu_torch.ops.paged_attention import paged_attention
    cfg = TransformerConfig(vocab=256, d_model=128, n_layers=2, n_heads=2,
                            n_kv_heads=1, d_ff=256, max_seq=256,
                            n_experts=4, expert_top_k=2, capacity_factor=2.0)
    full = params_from_jax(init_params(0, cfg), cfg, dev)
    params = {None: lambda p: p, "int8": q.quantize_weights_int8,
              "int4": lambda p: q.quantize_weights_int4(p, group=32)
              }[quant](full)
    assert params["layers.1.router"].dtype == torch.float32
    if quant:
        assert isinstance(params["layers.1.moe_w_up"], dict)
        assert params["layers.1.moe_w_up"][
            "q8" if quant == "int8" else "q4"].device == dev
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
    if quant:
        prompt = torch.tensor([reqs[2][1]], device=dev)
        lg = []
        for p in (full, params):
            cache = dec.init_cache(cfg, 1, 96, device=dev)
            lg.append(dec.prefill(p, prompt, cfg, cache)[0].float())
        rel = ((lg[1] - lg[0]).abs().max() / lg[0].abs().max()).item()
        assert rel < rail, rel


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_moe_padded_prefill_serving_on_the_card(dev, kind, monkeypatch):
    """A MoE model whose expert capacity binds (capacity factor 1.25,
    below E / k = 2): each prefill is padded as the JAX server pads it
    (``moe.prefill_len``), so pad tokens take expert slots from real
    ones.  In float32 the server's greedy tokens on the card equal its
    tokens on the CPU (where tests/test_torch_quant_moe.py holds them
    against the JAX servers), and its attention kernel launches."""
    from nvme_strom_tpu_torch.convert import params_from_jax
    from nvme_strom_tpu_torch.models.moe import prefill_len
    from nvme_strom_tpu_torch.models.serving import (DecodeServer,
                                                     PagedDecodeServer)
    from nvme_strom_tpu_torch.models.transformer import (TransformerConfig,
                                                         init_params)
    from nvme_strom_tpu_torch.ops.decode_attention import decode_attention
    from nvme_strom_tpu_torch.ops.paged_attention import paged_attention
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = TransformerConfig(vocab=256, d_model=128, n_layers=2, n_heads=2,
                            n_kv_heads=1, d_ff=256, max_seq=256,
                            n_experts=4, expert_top_k=2,
                            capacity_factor=1.25, dtype=torch.float32)
    assert prefill_len(cfg, 40, 64) == 64           # the padded path
    np_params = init_params(0, cfg)
    rng = np.random.default_rng(1)
    reqs = [(f"r{i}", rng.integers(0, 256, n).tolist(), 12)
            for i, n in enumerate([3, 40, 90, 7, 130])]
    kernel = decode_attention if kind == "dense" else paged_attention
    outs = []
    for d in (dev, torch.device("cpu")):
        params = params_from_jax(np_params, cfg, d)
        srv = (DecodeServer(params, cfg, 3, 256, device=d)
               if kind == "dense" else
               PagedDecodeServer(params, cfg, 3, 256, total_blocks=20,
                                 block_len=32, device=d))
        for rid, p, m in reqs:
            srv.submit(rid, p, m)
        n0 = kernel.launches
        outs.append(srv.run(lookahead=4))
        if d.type == "cuda":
            assert kernel.launches > n0
    assert outs[0] == outs[1]


def test_prefix_store_restores_through_h2d_on_the_card(dev, tmp_path):
    """Pages put from the host restore onto the card bitwise, each piece
    copied by h2d_copy from its staging buffer in place (the bridge
    bounces nothing); then a dense and a paged server over the store,
    both restoring the same prefix, give identical tokens."""
    from nvme_strom_tpu_torch.convert import params_from_jax
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.models.kv_offload import PrefixStore
    from nvme_strom_tpu_torch.models.serving import (DecodeServer,
                                                     PagedDecodeServer)
    from nvme_strom_tpu_torch.models.transformer import (TransformerConfig,
                                                         init_params)
    from nvme_strom_tpu_torch.ops.bridge import h2d_copy
    from nvme_strom_tpu_torch.utils.config import EngineConfig
    cfg = TransformerConfig(vocab=256, d_model=128, n_layers=2, n_heads=2,
                            n_kv_heads=1, d_ff=256, max_seq=256)
    P = 16                                  # 8 KiB pages: O_DIRECT-sized
    shape = (cfg.n_layers, cfg.n_kv_heads, P, cfg.head_dim)
    g = torch.Generator().manual_seed(0)
    pages = [(torch.randn(shape, generator=g).bfloat16(),
              torch.randn(shape, generator=g).bfloat16()) for _ in range(5)]
    with StromEngine(EngineConfig(chunk_bytes=1 << 20,
                                  buffer_pool_bytes=16 << 20)) as eng:
        store = PrefixStore(cfg, eng, str(tmp_path / "p.kvstore"), P,
                            1 << 20)
        keys = store.chain_keys(list(range(5 * P + 1)))
        store.put([(kx, k, v) for kx, (k, v) in zip(keys, pages)])
        store.flush()
        before, copies0 = h2d_copy.launches, store.copies
        got = store.restore_many({0: (0, keys), 1: (2, keys[2:4])},
                                 device=dev)
        assert h2d_copy.launches - before == store.copies - copies0 == 5
        assert eng.stats.bounce_bytes == 0      # the bridge's, before
        #                                         the engine's are merged
        for i, (k, v) in enumerate(pages):
            assert got[0][i][0].device == dev
            assert torch.equal(got[0][i][0].cpu(), k)
            assert torch.equal(got[0][i][1].cpu(), v)
        assert got[1][2][0] is got[0][2][0]     # copied once, shared
        eng.sync_stats()
        if eng.stats.bytes_fallback == 0:
            assert eng.stats.bounce_bytes == 0
        store.close()
        params = params_from_jax(init_params(0, cfg), cfg, dev)
        store = PrefixStore(cfg, eng, str(tmp_path / "s.kvstore"), P,
                            1 << 20)
        rng = np.random.default_rng(1)
        sys_prompt = rng.integers(0, 256, 4 * P).tolist()
        reqs = [(f"r{i}", sys_prompt + rng.integers(0, 256, 3 + i).tolist())
                for i in range(3)]
        seed = DecodeServer(params, cfg, 1, 256, device=dev, kv_store=store)
        seed.submit("seed", sys_prompt + [1], 2)
        seed.run()
        outs = []
        for srv in (DecodeServer(params, cfg, 3, 256, device=dev,
                                 kv_store=store),
                    PagedDecodeServer(params, cfg, 3, 256, total_blocks=64,
                                      block_len=P, device=dev,
                                      kv_store=store)):
            for rid, p in reqs:
                srv.submit(rid, p, 8)
            outs.append(srv.run(lookahead=4))
        assert outs[0] == outs[1]
        assert eng.stats.kv_pages_restored >= 2 * 3 * 4
        store.close()


def test_tenant_tagged_restore_through_h2d_on_the_card(dev, tmp_path):
    """Under STROM_TENANTS=1, pages put in a tenant's scope carry its id,
    and their restore onto the card, in the tenant's scope, copies every
    piece with h2d_copy and gives the bytes back bitwise; a tenant-tagged
    server over the store gives the untagged server's tokens."""
    from nvme_strom_tpu_torch.convert import params_from_jax
    from nvme_strom_tpu_torch.io import tenants
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.models.kv_offload import PrefixStore
    from nvme_strom_tpu_torch.models.serving import PagedDecodeServer
    from nvme_strom_tpu_torch.models.transformer import (TransformerConfig,
                                                         init_params)
    from nvme_strom_tpu_torch.ops.bridge import h2d_copy
    from nvme_strom_tpu_torch.utils.config import EngineConfig, TenantConfig
    cfg = TransformerConfig(vocab=256, d_model=128, n_layers=2, n_heads=2,
                            n_kv_heads=1, d_ff=256, max_seq=256)
    P = 16
    shape = (cfg.n_layers, cfg.n_kv_heads, P, cfg.head_dim)
    g = torch.Generator().manual_seed(2)
    pages = [(torch.randn(shape, generator=g).bfloat16(),
              torch.randn(shape, generator=g).bfloat16()) for _ in range(4)]
    reg = tenants.configure(TenantConfig(
        enabled=True, spec="gold_t:tier=gold,quota=0.5"))
    try:
        gold = reg.get("gold_t")
        with StromEngine(EngineConfig(chunk_bytes=1 << 20,
                                      buffer_pool_bytes=16 << 20)) as eng:
            store = PrefixStore(cfg, eng, str(tmp_path / "t.kvstore"), P,
                                1 << 20)
            keys = store.chain_keys(list(range(4 * P + 1)))
            with tenants.tenant_context(gold):
                store.put([(kx, k, v) for kx, (k, v) in zip(keys, pages)])
                store.flush()
                before = h2d_copy.launches
                got = store.restore_many({0: (0, keys)}, device=dev)[0]
            assert h2d_copy.launches - before == 4
            assert {e["tenant"] for e in store._entries.values()} == \
                {"gold_t"}
            for i, (k, v) in enumerate(pages):
                assert torch.equal(got[i][0].cpu(), k)
                assert torch.equal(got[i][1].cpu(), v)
            store.close()
            params = params_from_jax(init_params(0, cfg), cfg, dev)
            rng = np.random.default_rng(3)
            sys_prompt = rng.integers(0, 256, 3 * P).tolist()
            outs = []
            for tag in ("gold_t", None):
                st = PrefixStore(cfg, eng, str(tmp_path / f"{tag}.kvstore"),
                                 P, 1 << 20)
                srv = PagedDecodeServer(params, cfg, 2, 256, total_blocks=64,
                                        block_len=P, device=dev, kv_store=st)
                for i in range(3):
                    srv.submit(f"r{i}", sys_prompt + [i + 1], 4, tenant=tag)
                outs.append(srv.run())
                st.close()
            assert outs[0] == outs[1]
    finally:
        tenants.reset()


@pytest.mark.parametrize("flip", [False, True], ids=["clean", "flipped"])
def test_verified_weights_load_on_the_card(dev, tmp_path, monkeypatch, flip):
    """STROM_VERIFY=full: a clean load onto the card verifies its whole
    payload and is bitwise the unverified load; one flipped payload byte
    raises ChecksumError with one failure counted."""
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.parallel.weights import (LazyCheckpoint,
                                                       save_checkpoint)
    from nvme_strom_tpu_torch.utils.checksum import ChecksumError
    from nvme_strom_tpu_torch.utils.config import EngineConfig
    params = {"a": torch.randn(300, 70), "b": torch.randn(4096).bfloat16()}
    path = tmp_path / "m.safetensors"
    save_checkpoint(path, params)
    payload = sum(t.numel() * t.element_size() for t in params.values())
    if flip:
        with open(path, "r+b") as f:
            f.seek(path.stat().st_size - 9)
            b = f.read(1)
            f.seek(path.stat().st_size - 9)
            f.write(bytes([b[0] ^ 0x01]))
    monkeypatch.setenv("STROM_VERIFY", "full")
    with StromEngine(EngineConfig(chunk_bytes=1 << 20,
                                  buffer_pool_bytes=16 << 20)) as eng:
        if flip:
            with pytest.raises(ChecksumError, match="corrupt weights"):
                LazyCheckpoint(path).load(eng, device=dev)
            assert eng.stats.checksum_failures == 1
            return
        out = LazyCheckpoint(path).load(eng, device=dev)
        assert eng.stats.bytes_verified == payload
        assert eng.stats.checksum_failures == 0
    monkeypatch.delenv("STROM_VERIFY")
    with StromEngine(EngineConfig(chunk_bytes=1 << 20,
                                  buffer_pool_bytes=16 << 20)) as eng:
        plain = LazyCheckpoint(path).load(eng, device=dev)
        assert eng.stats.bytes_verified == 0
    for name, t in params.items():
        assert out[name].device == dev
        assert torch.equal(out[name], plain[name])
        assert torch.equal(out[name].cpu(), t)


@pytest.mark.parametrize("quant,host_pages", [(None, 0), (None, 2),
                                              ("int8", 2)])
def test_offload_attend_through_h2d_on_the_card(dev, tmp_path, quant,
                                                host_pages):
    """The offloaded cache's cold pages come back to the card through
    h2d_copy (from the staging buffers, and from the host tier's
    page-locked buffers) with nothing bounced, and ``attend`` matches a
    dense float32 softmax over the whole history: to one bf16 ulp of the
    output (int8 pages: 3e-2, the quantization).  Then greedy float32
    generation through the cache gives the dense path's tokens."""
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.models import decode as dec
    from nvme_strom_tpu_torch.models.kv_offload import (OffloadConfig,
                                                        PagedKVCache,
                                                        offloaded_generate)
    from nvme_strom_tpu_torch.models.transformer import (TransformerConfig,
                                                         init_params)
    from nvme_strom_tpu_torch.convert import params_from_jax
    from nvme_strom_tpu_torch.ops.bridge import h2d_copy
    from nvme_strom_tpu_torch.utils.config import EngineConfig
    cfg = TransformerConfig(vocab=256, d_model=256, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=256, max_seq=256)
    b, S, P = 2, 150, 16        # 8 KiB bf16 layer sections: O_DIRECT-sized
    g = torch.Generator(device=dev).manual_seed(0)
    shape = (cfg.n_layers, b, cfg.n_kv_heads, S, cfg.head_dim)
    ks = torch.randn(shape, generator=g, device=dev).bfloat16()
    vs = torch.randn(shape, generator=g, device=dev).bfloat16()
    q = torch.randn(b, cfg.n_heads, 1, cfg.head_dim, generator=g,
                    device=dev).bfloat16()
    ocfg = OffloadConfig(path=str(tmp_path / "kv.bin"), page_len=P,
                         window_pages=2, quantize=quant,
                         host_cache_pages=host_pages)
    with StromEngine(EngineConfig(chunk_bytes=1 << 20,
                                  buffer_pool_bytes=64 << 20)) as eng:
        with PagedKVCache(cfg, ocfg, eng, b) as cache:
            assert cache.device == dev
            cache.append(ks, vs)
            assert cache.n_cold >= 7
            before = h2d_copy.launches
            for layer in range(cfg.n_layers):
                got = cache.attend(layer, q)
                grp = cfg.n_heads // cfg.n_kv_heads
                k = ks[layer].float().repeat_interleave(grp, dim=1)
                v = vs[layer].float().repeat_interleave(grp, dim=1)
                p = torch.softmax(q.float() @ k.transpose(-1, -2)
                                  / cfg.head_dim ** 0.5, dim=-1)
                want = p @ v
                rtol, atol = ((2 ** -7, 2e-5) if quant is None
                              else (3e-2, 3e-2))
                torch.testing.assert_close(got.float(), want, rtol=rtol,
                                           atol=atol)
            sections = 2 if quant is None else 4
            assert h2d_copy.launches - before == \
                cfg.n_layers * cache.n_cold * sections
            assert cache.host_cache_hits == cfg.n_layers * host_pages
        assert eng.stats.bounce_bytes == 0      # the bridge's, before the
        #                                         engine's are merged
        eng.sync_stats()
        if eng.stats.bytes_fallback == 0:
            assert eng.stats.bounce_bytes == 0
        if quant is None and host_pages == 0:
            cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
            params = params_from_jax(init_params(0, cfg32), cfg32, dev)
            prompt = torch.randint(0, cfg.vocab, (2, 40), generator=g,
                                   device=dev)
            got = offloaded_generate(params, prompt, cfg32, OffloadConfig(
                path=str(tmp_path / "gen.bin"), page_len=P, window_pages=2),
                eng, 24)
            want = dec.generate(params, prompt, cfg32, 24)
            assert torch.equal(got.long(), want.long())


def test_engine_unregisters_before_destroy(dev, tmp_path):
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.utils.config import EngineConfig
    eng = StromEngine(EngineConfig(chunk_bytes=1 << 20,
                                   buffer_pool_bytes=8 << 20))
    m = eng.cuda_mapping(dev.index)
    assert m.dev_base and m.nbytes >= 8 << 20
    assert eng.cuda_mapping(dev.index) is m
    eng.close_all()
    assert not eng._pool_reg.devices
    os.sync()


# -- the arena, the host tier and the multi-ring engine (kernel 1) -----------

def _h2d_from(dev, mapping, host):
    """h2d_copy of ``host`` read in place through ``mapping``, against
    its plain version."""
    from nvme_strom_tpu_torch.ops.bridge import h2d_copy, h2d_copy_plain
    ptr = mapping.device_ptr(host.ctypes.data, host.nbytes)
    assert ptr is not None
    got = torch.empty(host.nbytes, dtype=torch.uint8, device=dev)
    before = h2d_copy.launches
    h2d_copy(host, got, src_ptr=ptr)
    torch.cuda.synchronize(dev)
    assert h2d_copy.launches == before + 1
    want = h2d_copy_plain(host, torch.empty(host.nbytes, dtype=torch.uint8))
    assert torch.equal(got.cpu(), want)


def test_h2d_copy_from_a_host_tier_line_and_a_bridge_slab(dev):
    """h2d_copy reads a resident line of the host tier, and an arena
    bridge slab, in place (each carve registered on its first copy) and
    equals its plain version byte for byte."""
    from nvme_strom_tpu_torch.io import arena, hostcache
    from nvme_strom_tpu_torch.utils.config import HostCacheConfig
    rng = np.random.default_rng(4)
    hostcache.reset()
    cache = hostcache.configure(HostCacheConfig(budget_mb=8,
                                                line_bytes=1 << 20))
    try:
        fkey = ("f", 1)
        payload = rng.integers(0, 256, 1 << 20, dtype=np.uint8)
        assert cache.fill(fkey, 0, payload, "decode")
        segs, _ = cache.probe_range(fkey, 4096 + 3, (1 << 20) - 4099,
                                    "decode")
        line = segs[0][3]
        view = cache.line_view(line, 4096 + 3, 1 << 20)
        assert not cache.arena.cuda.devices
        _h2d_from(dev, cache.arena.cuda.on(dev.index), view)
        assert cache.arena.cuda.devices == [dev.index]
        cache.unpin(line)
    finally:
        hostcache.reset()
    slab = arena.carve_or_none(4 << 20, "bridge")
    assert slab is not None
    try:
        slab.view[:] = rng.integers(0, 256, slab.nbytes, dtype=np.uint8)
        _h2d_from(dev, slab.cuda.on(dev.index), slab.view[17:(3 << 20) + 5])
    finally:
        slab.release()


def test_carves_register_once_and_unregister_after_their_copies(dev):
    """A carve registers on its first copy and once only (a second
    cudaHostRegister of the range raises); its release waits for the
    copy queued out of it, unregisters (unregistering again raises) and
    frees the range; the host tier refuses to free lines a hit view
    still pins."""
    import ctypes
    from nvme_strom_tpu_torch import _build
    from nvme_strom_tpu_torch.io import arena, hostcache
    from nvme_strom_tpu_torch.ops.bridge import h2d_copy
    from nvme_strom_tpu_torch.utils.config import HostCacheConfig
    klib = _build.kernel_library()
    a = arena.get_arena()
    slab = a.carve(8 << 20, "bridge")
    slab.view[:] = 7
    m = slab.cuda.mapping(dev.index)
    assert slab.cuda.mapping(dev.index) is m
    ptr = ctypes.c_void_p()
    with pytest.raises(RuntimeError, match="cudaHostRegister"):
        _build.check(klib.strom_host_register(slab.addr, slab.nbytes,
                                              dev.index, ctypes.byref(ptr)),
                     "cudaHostRegister")
    out = torch.empty(slab.nbytes, dtype=torch.uint8, device=dev)
    for _ in range(8):        # copies still queued when release starts
        h2d_copy(slab.view, out, src_ptr=m.dev_base)
    addr, offset = slab.addr, slab.offset
    slab.release()            # waits for the copies, then unregisters
    assert torch.all(out == 7).item()
    assert offset not in a._carved
    with pytest.raises(RuntimeError, match="cudaHostUnregister"):
        _build.check(klib.strom_host_unregister(addr, dev.index),
                     "cudaHostUnregister")
    hostcache.reset()
    cache = hostcache.configure(HostCacheConfig(budget_mb=2,
                                                line_bytes=1 << 20))
    cache.fill(("f", 1), 0, np.ones(1 << 20, np.uint8), None)
    segs, _ = cache.probe_range(("f", 1), 0, 1 << 20, None)
    cache.arena.cuda.mapping(dev.index)
    with pytest.raises(RuntimeError, match="pinned"):
        hostcache.reset()
    cache.unpin(segs[0][3])
    hostcache.reset()
    assert a.carves().get("hostcache", 0) == 0


def test_multi_ring_pieces_map_without_a_bounce(dev, tmp_path):
    """Reads of every class over a multi-ring engine land in staging
    buffers of every ring, and each piece's copy reads one in place
    through the pool's one registration: nothing bounces, and the bytes
    are the file's."""
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.io.plan import plan_and_submit
    from nvme_strom_tpu_torch.ops.bridge import host_to_device
    from nvme_strom_tpu_torch.utils.config import EngineConfig
    payload = np.random.default_rng(6).integers(0, 256, 24 << 20,
                                                dtype=np.uint8)
    path = tmp_path / "rings.bin"
    payload.tofile(path)
    with StromEngine(EngineConfig(chunk_bytes=1 << 20, queue_depth=16,
                                  buffer_pool_bytes=32 << 20,
                                  n_rings=4)) as eng:
        assert eng.n_rings == 4 and eng.scheduler is not None
        fh = eng.open(path)
        for klass in ("decode", "restore", "prefetch", "scan", "scrub"):
            for ring in range(eng.n_rings):
                exts = [(fh, (ring * 5 + i) << 20, 1 << 20)
                        for i in range(5)]
                pieces = [p for ps in (plan_and_submit(eng, exts,
                                                       klass=klass)
                                       if ring == 0 else
                                       [eng.submit_readv(exts, ring=ring)])
                          for p in ps]
                outs = [(p, host_to_device(eng, p.wait(), dev))
                        for p in pieces]
                for p, t in outs:
                    t.synchronize()
                    want = payload[p.offset:p.offset + p.length]
                    assert torch.equal(t.tensor.cpu(),
                                       torch.from_numpy(want))
                    p.release()
        eng.close(fh)
        assert all(eng.ring_info(r)["submitted"] > 0 for r in range(4))
        assert eng.stats.bounce_bytes == 0     # the bridge's
        assert eng.stats.class_stats["decode"]["dispatches"] >= 1


# -- flash attention (kernels 4-6) --------------------------------------------

#: (rtol, atol as a fraction of max |plain|) of the flash kernels against
#: their plain versions.  Both sides compute in fp32 from the same
#: inputs and round once, so bf16 results may differ by one bf16 ulp
#: (rtol 2**-7); the sums over up to 2048 keys or queries run in another
#: order, which the relative atol covers where a gradient is near zero.
FLASH_BF16 = (2 ** -7, 1e-4)
FLASH_F16 = (2 ** -10, 1e-4)
FLASH_F32 = (1e-4, 1e-5)
FLASH_TOL = {torch.bfloat16: FLASH_BF16, torch.float16: FLASH_F16,
             torch.float32: FLASH_F32}


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
    # fp16 runs the fp32 FMA kernels and rounds once to fp16
    (2, 3, 200, 200, 64, torch.float16, True, True),
    (2, 2, 130, 300, 128, torch.float16, False, False),
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
    tol = FLASH_TOL[dtype]
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
    (and fp16) keep the fp32 FMA kernels, which hold the fp32 tolerance
    across the tile edges."""
    from nvme_strom_tpu_torch.ops import flash_attention as fa
    assert [fa.flash_route(k, torch.bfloat16) for k in ("fwd", "dq", "dkv")
            ] == ["wgmma", "wgmma", "wgmma"]
    for dt in (torch.float32, torch.float16):
        assert [fa.flash_route(k, dt) for k in ("fwd", "dq", "dkv")
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
    x = torch.zeros(1, 2, 64, 64, device=dev, dtype=torch.float64)
    with pytest.raises(ValueError, match="takes"):
        fa.flash_fwd(x, x, x)
    x = torch.zeros(1, 2, 64, 64, device=dev)
    with pytest.raises(ValueError, match="stride"):
        fa.flash_fwd(x.transpose(2, 3), x, x)
    with pytest.raises(ValueError, match="devices|on"):
        fa.flash_fwd(x, x.cpu(), x)
    with pytest.raises(ValueError, match="equal q/kv"):
        fa.flash_fwd(x, x[:, :, :32], x[:, :, :32])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("scale", [-0.125, 0.0])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernels_take_any_scale(dev, dtype, scale, causal):
    """A negative scale and scale 0 (the uniform softmax over the
    unmasked keys): the forward and, through torch.autograd, the
    backward kernels against the plain versions."""
    from nvme_strom_tpu_torch.ops import flash_attention as fa
    tol = FLASH_TOL[dtype]
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


# -- recovered reads into the card (io/faults.py, io/resilient.py) ----------

#: name → (read plan, ResilientConfig fields, the counter that must move)
_RESILIENT_CASES = {
    "retry": ("eio:every=3", dict(max_retries=4), "resilient_retries"),
    "short": ("short:every=3:frac=0.5", dict(max_retries=4),
              "waste_retry_reread_bytes"),
    # every read delayed, 30 or 120 ms by turns: a primary and its hedge
    # may draw different delays, so hedges win at depth 1 and lose at
    # both depths (at depth 3 every hedge's primary has mostly waited
    # out its delay while the reads before it were consumed)
    "hedge": ("delay:every=2:delay_s=0.03, delay:delay_s=0.12",
              dict(hedging=True, hedge_after_s=0.01, max_retries=2),
              "hedges_issued"),
}


@pytest.mark.parametrize("case", list(_RESILIENT_CASES))
@pytest.mark.parametrize("depth", [1, 3])
def test_resilient_stream_ranges_on_the_card(dev, tmp_path, monkeypatch,
                                             case, depth):
    """Ranges streamed through ``ResilientEngine(FaultyEngine(...))`` into
    ``DeviceStream.stream_ranges``: the device bytes are the file's, the
    bridge copied every recovered read from the staging buffer in place
    (its ``bounce_bytes`` 0), and no staging buffer went back to the
    engine while a copy out of it was still in flight: each copy is
    held ~0.5 ms on the side stream, and every release checks the copy
    events over its buffer."""
    from nvme_strom_tpu_torch.io import (FaultPlan, FaultyEngine,
                                         ResilientEngine, StromEngine)
    from nvme_strom_tpu_torch.io.engine import PendingRead
    from nvme_strom_tpu_torch.ops import bridge
    from nvme_strom_tpu_torch.ops.bridge import DeviceStream
    from nvme_strom_tpu_torch.utils.config import (EngineConfig,
                                                   ResilientConfig)
    monkeypatch.setenv("STROM_NO_RESIDENCY_PROBE", "1")
    plan, rkw, moved = _RESILIENT_CASES[case]
    mib = 1 << 20
    data = np.random.default_rng(3).integers(0, 256, 12 * mib,
                                             dtype=np.uint8)
    path = tmp_path / "x.bin"
    data.tofile(path)
    copies = []                         # (lo, hi, event) of every copy
    real_put, real_release = DeviceStream._put, PendingRead.release

    def put(self, view, dtype, shape):
        t = real_put(self, view, dtype, shape)
        copies.append((view.ctypes.data, view.ctypes.data + view.nbytes,
                       t.event))
        return t

    def release(self):
        v = self._view
        if v is not None and not self._released:
            lo, hi = v.ctypes.data, v.ctypes.data + v.nbytes
            for a, b, ev in copies:
                assert not (a < hi and lo < b) or ev.query(), \
                    "a staging buffer went back under a copy in flight"
        real_release(self)
    real_copy = bridge.h2d_copy

    def slow_copy(*a, **k):
        torch.cuda._sleep(1_000_000)    # on the side stream, first
        return real_copy(*a, **k)
    # the kernel's wrapper counts into the module's h2d_copy: this one
    slow_copy.launches = 0
    monkeypatch.setattr(DeviceStream, "_put", put)
    monkeypatch.setattr(PendingRead, "release", release)
    monkeypatch.setattr(bridge, "h2d_copy", slow_copy)
    base = StromEngine(EngineConfig(chunk_bytes=mib,
                                    buffer_pool_bytes=16 * mib))
    eng = ResilientEngine(FaultyEngine(base, FaultPlan.parse(plan, seed=1)),
                          ResilientConfig(backoff_base_s=0.001, **rkw))
    ranges = [(o, mib - 512 * (i % 3)) for i, o in
              enumerate(range(0, 12 * mib, mib))]
    with eng:
        eng.cuda_mapping(dev.index)
        fh = eng.open(path)
        ds = DeviceStream(eng, device=dev, depth=depth, klass="decode")
        assert not ds.overlap             # copies read staging in place
        got = [t.cpu() for t in ds.stream_ranges(fh, ranges)]
        eng.close(fh)
        assert eng.stats.bounce_bytes == 0      # the bridge's, before
        eng.sync_stats()                        # the engine's counters
        st = eng.stats.snapshot()
        info = base.pool_info()
        assert info["free_buffers"] == info["n_buffers"]
    for (off, ln), t in zip(ranges, got):
        assert torch.equal(t, torch.from_numpy(data[off:off + ln]))
    assert slow_copy.launches == len(ranges)
    assert len(copies) == len(ranges)
    assert st["faults_injected"] >= 1 and st[moved] >= 1, st
    if case == "hedge":
        assert st["hedges_issued"] > st["hedges_won"], st    # some lost
        assert depth > 1 or st["hedges_won"] >= 1, st
    if st["bytes_fallback"] == 0:
        assert st["bounce_bytes"] == 0


@pytest.mark.parametrize("n_buffers", [8, 16])
def test_degraded_reads_reach_the_card_counted_as_bounce(dev, tmp_path,
                                                         monkeypatch,
                                                         n_buffers):
    """With the device breaker open, ``stream_ranges`` serves buffered
    preads (io/health.py ``DegradedRead``): the bytes reach the card
    through ``h2d_copy`` bitwise, in place from the pinned buffer (16
    staging buffers) or through the overlap stage's slabs (8), and
    ``bounce_bytes`` equals ``degraded_bytes``: each byte counted once,
    by the engine's pread."""
    from nvme_strom_tpu_torch.io import StromEngine
    from nvme_strom_tpu_torch.ops import bridge
    from nvme_strom_tpu_torch.ops.bridge import DeviceStream
    from nvme_strom_tpu_torch.utils.config import EngineConfig
    monkeypatch.setenv("STROM_NO_RESIDENCY_PROBE", "1")
    monkeypatch.setenv("STROM_DEGRADED_PROBE_S", "3600")
    monkeypatch.setenv("STROM_FLIGHT_DIR", str(tmp_path))
    mib = 1 << 20
    data = np.random.default_rng(5).integers(0, 256, 6 * mib + 333,
                                             dtype=np.uint8)
    path = tmp_path / "x.bin"
    data.tofile(path)
    ranges = [(0, mib), (mib, mib - 5), (3 * mib + 1, mib),
              (5 * mib, mib + 333)]
    with StromEngine(EngineConfig(chunk_bytes=2 * mib,
                                  buffer_pool_bytes=n_buffers * 2 * mib)
                     ) as eng:
        sup = eng.supervisor
        for _ in range(sup.cfg.device_errors):
            sup.note_error(ring=0, err=5)
        assert sup.degraded()
        fh = eng.open(path)
        before = bridge.h2d_copy.launches
        got = [t.cpu() for t in DeviceStream(eng, device=dev)
               .stream_ranges(fh, ranges)]
        eng.close(fh)
        assert bridge.h2d_copy.launches - before == len(ranges)
        eng.sync_stats()
        st = eng.stats.snapshot()
    for (off, ln), t in zip(ranges, got):
        assert torch.equal(t, torch.from_numpy(data[off:off + ln]))
    total = sum(ln for _, ln in ranges)
    assert st["degraded_reads"] == len(ranges)
    assert st["degraded_bytes"] == st["bounce_bytes"] == total
    assert st["bytes_fallback"] == total


def test_faulting_checkpoint_on_the_card(dev, tmp_path, monkeypatch):
    """A demand fault and the bulk lane land the same tensors on
    ``cuda:0`` as ``LazyCheckpoint.load``; each tensor is read once
    across the lanes, every byte through ``h2d_copy``: a demand fault's
    copies on the bridge's side stream, the bulk lane's on its own."""
    import threading
    from nvme_strom_tpu_torch.io import StromEngine
    from nvme_strom_tpu_torch.io.coldstart import ColdStartCoordinator
    from nvme_strom_tpu_torch.ops import bridge
    from nvme_strom_tpu_torch.parallel.weights import (FaultingCheckpoint,
                                                       LazyCheckpoint,
                                                       save_checkpoint)
    from nvme_strom_tpu_torch.utils.config import EngineConfig
    gen = torch.Generator().manual_seed(7)
    params = {f"w{i}": torch.randn(256 + 64 * i, 384, generator=gen)
              .to(torch.bfloat16) for i in range(12)}
    params["norm"] = torch.randn(384, generator=gen)
    path = tmp_path / "m.safetensors"
    save_checkpoint(path, params)
    cfg = EngineConfig(chunk_bytes=1 << 20, buffer_pool_bytes=32 << 20)
    with StromEngine(cfg) as eng:
        want = LazyCheckpoint(path).load(eng, device=dev)
    with StromEngine(cfg) as eng:
        coord = ColdStartCoordinator(eng)
        fck = FaultingCheckpoint(path, device=dev, engine=eng,
                                 coordinator=coord)
        real = bridge.h2d_copy
        seen = []

        def spy(*a, **kw):
            seen.append((threading.current_thread().name,
                         torch.cuda.current_stream(dev)))
            return real(*a, **kw)
        # the kernel counts its launches on the module's h2d_copy
        spy.launches = before = real.launches
        monkeypatch.setattr(bridge, "h2d_copy", spy)
        coord.note_serving_started()
        first = fck.get("w11")                    # a demand fault
        fck.start_bulk()
        got = fck.materialize()
        fck.join_bulk(60.0)
        torch.cuda.synchronize()
        assert spy.launches - before == len(seen) > 0
        side = bridge.side_stream(dev)
        bulk = [s for n, s in seen if n == "strom-coldstart-bulk"]
        assert all(s == side for n, s in seen
                   if n != "strom-coldstart-bulk")
        assert all(s != side for s in bulk)
        st = eng.stats
        assert bool(bulk) == (st.coldstart_bulk_tensors > 0)
        assert st.coldstart_faults >= 1
        assert st.coldstart_faults + st.coldstart_bulk_tensors == len(params)
        assert fck.resident() and coord.phase == "steady"
        assert torch.equal(first, want["w11"])
        eng.sync_stats()
        snap = eng.stats.snapshot()
        assert snap["bytes_direct"] + snap["bytes_fallback"] == sum(
            t.numel() * t.element_size() for t in params.values())
    for name, t in want.items():
        assert got[name].device == dev
        assert torch.equal(got[name], t), name


# -- training beyond device memory and the zero-copy data path ---------------

@pytest.mark.parametrize("policy", ["dots", "nvme"])
def test_remat_with_flash_equals_none(dev, tmp_path, policy):
    """The flash kernels recompute correctly under selective
    checkpointing and under the NVMe activation store: loss and every
    gradient equal remat none's (float32, 1e-4 relative / 1e-5)."""
    from nvme_strom_tpu_torch.models import transformer as ttr
    from nvme_strom_tpu_torch.ops import flash_attention as fa
    from nvme_strom_tpu_torch.parallel.act_offload import ActivationStore
    cfg = ttr.TransformerConfig(vocab=512, d_model=256, n_layers=3,
                                n_heads=4, n_kv_heads=2, d_ff=512,
                                max_seq=256, dtype=torch.float32)
    params = ttr.trainable_params(ttr.init_params(0, cfg), dev)
    toks = torch.randint(0, cfg.vocab, (2, 256),
                         generator=torch.Generator().manual_seed(1)).to(dev)
    attn = fa.make_flash_attn()
    l0, g0 = ttr.value_and_grad(params, toks, cfg, attn)
    before = fa.flash_fwd.launches
    with ActivationStore(tmp_path / "acts.bin", cfg.n_layers) as st:
        l1, g1 = ttr.value_and_grad(
            params, toks, dataclasses.replace(cfg, remat_policy=policy),
            attn, act_store=st if policy == "nvme" else None)
        if policy == "nvme":
            assert st.writes == st.reads == cfg.n_layers
    # the forward and its recompute both ran the kernel
    assert fa.flash_fwd.launches - before == 2 * cfg.n_layers
    torch.testing.assert_close(l1, l0, rtol=1e-4, atol=1e-5)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=1e-4, atol=1e-5,
                                   msg=n)


def test_fixedrec_zero_copy_batch_through_h2d(dev, tmp_path):
    from nvme_strom_tpu_torch.data.loader import ShardedLoader
    from nvme_strom_tpu_torch.formats.fixedrec import write_fixedrec
    from nvme_strom_tpu_torch.ops.bridge import h2d_copy
    rng = np.random.default_rng(0)
    rec = rng.integers(0, 1 << 30, (64, 2048), dtype=np.int32)
    paths = []
    for s in range(2):
        p = str(tmp_path / f"s{s}.sfr")
        write_fixedrec(p, rec[32 * s:32 * (s + 1)])
        paths.append(p)
    before = h2d_copy.launches
    with ShardedLoader(paths, 8, fmt="fixedrec", device=dev) as ld:
        got = [b.clone() for b in ld]
        pieces = ld.pieces_copied
    torch.cuda.synchronize()
    assert h2d_copy.launches - before == pieces == 8
    assert torch.equal(torch.cat(got).cpu(), torch.from_numpy(rec))


def test_prefetched_batch_copies_on_the_side_stream(dev):
    """The copy of a pulled batch runs on the side stream while the
    consumer's stream is held by a spin kernel; the yielded tensor is
    the batch, read after the consumer's stream waited for it."""
    from nvme_strom_tpu_torch.data.prefetch import prefetch_to_device
    from nvme_strom_tpu_torch.ops.bridge import h2d_copy, side_stream
    batches = [np.full((8, 2048), i, np.int32) for i in range(3)]
    side = side_stream(dev)
    cur = torch.cuda.current_stream(dev)
    # warm the allocators: a first cudaMalloc / cudaHostAlloc may wait
    # for the device
    for _ in prefetch_to_device(iter(batches), size=2, device=dev):
        pass
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)             # ~0.1 s on the consumer
    before = h2d_copy.launches
    it = prefetch_to_device(iter(batches), size=2, device=dev)
    first = next(it)
    side.synchronize()                         # the copies, not the spin
    # the first pull keeps two batches ahead after the one it yields
    assert h2d_copy.launches - before == 3
    assert not cur.query()                     # still spinning
    got = [first.clone()] + [b.clone() for b in it]
    torch.cuda.synchronize()
    for g, b in zip(got, batches):
        assert torch.equal(g.cpu(), torch.from_numpy(b))


# -- speculative decoding, the npy reader, the ViT, the debug server ---------

@pytest.fixture()
def no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def test_speculative_draft_on_kernel_2_equals_generate(dev, no_tf32):
    """Float32 greedy speculation with the draft's steps on the decode
    kernel: the tokens of the target's own dense greedy decode, and the
    kernel launched once a draft step and layer."""
    from nvme_strom_tpu_torch.convert import params_from_jax
    from nvme_strom_tpu_torch.models import decode as dec
    from nvme_strom_tpu_torch.models.speculative import (SpecStats,
                                                         speculative_generate)
    from nvme_strom_tpu_torch.models.transformer import (init_params,
                                                         tiny_config)
    from nvme_strom_tpu_torch.ops.decode_attention import decode_attention
    cfg = dataclasses.replace(tiny_config(), dtype=torch.float32)
    target = params_from_jax(init_params(0, cfg), cfg, dev)
    draft = params_from_jax(init_params(7, cfg), cfg, dev)
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, 8)).astype(np.int32)).to(dev)
    want = dec.generate(target, prompt, cfg, 24)
    for d, k in ((draft, 3), (target, 4)):
        st = SpecStats()
        before = decode_attention.launches
        got = speculative_generate(d, target, prompt, cfg, 24, k=k,
                                   stats=st, cache_attn=decode_attention)
        assert torch.equal(got, want)
        assert decode_attention.launches - before == \
            st.drafted * cfg.n_layers
    assert st.accept_rate >= 0.9


def test_read_npy_to_device_bitwise_without_bounce(dev, tmp_path,
                                                   monkeypatch):
    """.npy and .npz payloads onto the card through h2d_copy, bitwise,
    with no host copy (``bounce_bytes`` 0)."""
    monkeypatch.setenv("STROM_NO_RESIDENCY_PROBE", "1")
    from nvme_strom_tpu_torch.formats import (read_npy_to_device,
                                              read_npz_to_device)
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.ops.bridge import h2d_copy
    from nvme_strom_tpu_torch.utils.config import EngineConfig
    rng = np.random.default_rng(0)
    arrays = {"f32": rng.standard_normal((700, 1100)).astype(np.float32),
              "i64": rng.integers(-2**40, 2**40, (5, 333)),
              "u8": rng.integers(0, 256, 4099, dtype=np.uint8)}
    with StromEngine(EngineConfig(chunk_bytes=1 << 20,
                                  buffer_pool_bytes=16 << 20)) as eng:
        before = h2d_copy.launches
        for name, arr in arrays.items():
            p = str(tmp_path / f"{name}.npy")
            np.save(p, arr)
            got = read_npy_to_device(eng, p, device=dev)
            assert got.device == dev
            np.testing.assert_array_equal(got.cpu().numpy(), arr)
        p = str(tmp_path / "pack.npz")
        np.savez(p, **arrays)
        out = read_npz_to_device(eng, p, device=dev)
        for name, arr in arrays.items():
            np.testing.assert_array_equal(out[name].cpu().numpy(), arr)
        eng.sync_stats()
        assert h2d_copy.launches > before
        assert eng.stats.bounce_bytes == 0


def test_vit_step_on_the_card_against_the_cpu(dev, no_tf32):
    """One float32 ViT train step on the card and on the CPU from the
    same parameters: the loss and every updated parameter agree."""
    from nvme_strom_tpu_torch.models.transformer import adamw, trainable_params
    from nvme_strom_tpu_torch.models.vit import (init_vit_params,
                                                 make_vit_train_step,
                                                 tiny_vit_config)
    cfg = dataclasses.replace(tiny_vit_config(), dtype=torch.float32)
    rng = np.random.default_rng(2)
    images = rng.random((8, cfg.image_size, cfg.image_size, 3),
                        dtype=np.float32)
    labels = rng.integers(0, cfg.n_classes, 8).astype(np.int32)
    np_params = init_vit_params(0, cfg)
    out = {}
    for d in (torch.device("cpu"), dev):
        params = trainable_params(np_params, d)
        step = make_vit_train_step(cfg, adamw(params, 1e-3))
        loss = step(params, torch.from_numpy(images).to(d),
                    torch.from_numpy(labels).to(d))
        out[d.type] = (float(loss), {n: p.detach().cpu()
                                     for n, p in params.items()})
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-5)
    for n, p in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][n], p, rtol=1e-4,
                                   atol=1e-5, msg=n)


def test_debug_server_routes_on_a_live_engine(dev, tmp_path, monkeypatch):
    """With STROM_DEBUG_PORT and STROM_ATTRIB set, an engine streaming
    onto the card serves every route, 200 and parseable."""
    import json
    import urllib.request
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.obs import attrib, debugsrv
    from nvme_strom_tpu_torch.ops.bridge import DeviceStream
    from nvme_strom_tpu_torch.utils.config import EngineConfig
    from nvme_strom_tpu_torch.utils.trace import Tracer
    monkeypatch.setenv("STROM_DEBUG_PORT", "0")
    monkeypatch.setenv("STROM_ATTRIB", "1")
    attrib.reset()
    debugsrv.reset()
    path = tmp_path / "data.bin"
    payload = np.random.default_rng(3).integers(0, 256, 4 << 20,
                                                dtype=np.uint8)
    payload.tofile(path)
    tracer = Tracer()
    try:
        with StromEngine(EngineConfig(chunk_bytes=1 << 20,
                                      buffer_pool_bytes=16 << 20),
                         tracer=tracer) as eng:
            got = DeviceStream(eng, device=dev).read_to_device(str(path))
            assert torch.equal(got.cpu(), torch.from_numpy(payload))
            port = eng._debug_srv.port
            for route in ("/", "/metrics", "/attrib", "/ledger", "/flight",
                          "/health"):
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}{route}", timeout=5) as r:
                    assert r.status == 200
                    body = r.read().decode()
                if route == "/metrics":
                    assert body.rstrip().endswith("# EOF")
                    continue
                doc = json.loads(body)
                assert "error" not in doc, (route, doc)
                if route == "/health":
                    assert "boot_phase" in doc and "drain_phase" in doc
                if route == "/attrib":
                    assert doc["enabled"]
                if route == "/ledger":
                    assert doc["delivered_bytes"] >= payload.nbytes
    finally:
        tracer._sinks.clear()
        attrib.reset()
        debugsrv.reset()


# -- multi-GPU: the exchange across processes, sharded loads ------------------

def _spawn(job, world, tmp, payload, device, backend, exit_codes=None):
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _torch_dist
    h = _torch_dist.start(job, world, tmp, payload, timeout=240,
                          env={"STROM_TEST_DEVICE": device,
                               "STROM_TEST_BACKEND": backend,
                               "STROM_NO_RESIDENCY_PROBE": "1"})
    return _torch_dist.collect(h, exit_codes)


def test_process_exchange_refuses_two_ranks_on_one_card(dev, tmp_path):
    """Two ranks on one card would spin on each other in kernel 7: the
    exchange across processes refuses them with a clear error, and a
    read-once ``load_sharded`` and checkpoint restore fail with it
    rather than brown out."""
    from nvme_strom_tpu_torch.models import transformer as ttr
    from nvme_strom_tpu_torch.parallel.weights import save_checkpoint
    path = str(tmp_path / "w.safetensors")
    save_checkpoint(path, ttr.init_params(0, ttr.tiny_config()))
    res = _spawn("cuda_refuse", 2, tmp_path,
                 {"weights": path, "ckpt": str(tmp_path / "ckpt")},
                 "cuda:0", "gloo")
    for r in res:
        for part in ("exchange", "load_sharded", "restore"):
            assert "share a card" in r[part], res
        assert r["fallbacks"] == 0, res


def test_load_sharded_two_ranks_on_one_card(dev, tmp_path):
    """load_sharded with two ranks on cuda:0 (gloo): bitwise the whole
    load sliced, every byte through h2d_copy with nothing bounced."""
    from nvme_strom_tpu_torch.models import transformer as ttr
    from nvme_strom_tpu_torch.parallel.weights import save_checkpoint
    path = str(tmp_path / "w.safetensors")
    save_checkpoint(path, ttr.init_params(0, ttr.tiny_config()))
    res = _spawn("cuda_load_sharded", 2, tmp_path, {"weights": path},
                 "cuda:0", "gloo")
    for r in res:
        assert r["equal"] and r["bounce"] == 0, r


def _cards(n):
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} cards, the machine has "
                    f"{torch.cuda.device_count()}")


@pytest.mark.parametrize("world", [2, 4])
def test_ici_ring_across_processes(dev, tmp_path, world):
    """Kernel 7 with one rank a process and a card, peers' slots and flags
    mapped through CUDA IPC: rows of 4 widths, ragged included, three
    calls each, bitwise, one launch a call on each rank."""
    _cards(world)
    widths = [16, 4096 + 5, 48 * 1024 * 3 + 17, 9 << 20]
    res = _spawn("cuda_exchange", world, tmp_path, widths, "cuda:RANK",
                 "nccl")
    for r in res:
        assert r["ok"], res
        assert r["launches"] == 3 * len(widths)


def test_scatter_restore_across_processes_on_cards(dev, tmp_path):
    """The read-once restore with one rank a card: bitwise, each rank's
    share at most half the payload plus a unit, no fallback."""
    _cards(2)
    from nvme_strom_tpu_torch.models import transformer as ttr
    from nvme_strom_tpu_torch.parallel.weights import save_checkpoint
    path = str(tmp_path / "w.safetensors")
    save_checkpoint(path, ttr.init_params(0, ttr.tiny_config()))
    res = _spawn("cuda_load_sharded", 2, tmp_path,
                 {"weights": path, "scatter": True,
                  "ckpt": str(tmp_path / "ckpt")}, "cuda:RANK", "nccl")
    payload = sum(os.path.getsize(os.path.join(
        tmp_path, "ckpt", "step_00000001", f))
        for f in os.listdir(tmp_path / "ckpt" / "step_00000001")
        if f.endswith(".safetensors"))
    for r in res:
        assert r["equal"] and r["restored"] and r["fallbacks"] == 0, r
        assert 0 < r["share"] <= payload / 2 + 4096


def _check_seqpar(res, world):
    """Over all ranks a ring call launches each flash kernel
    world(world + 1)/2 times and Ulysses once a rank.  Each rank is held
    to its own span's floor, one rank's bf16 distance from float32 there
    (the self-calibrated bounds of chip_smoke.py's sp_pp_phase): the
    output at most 3x that from one rank's bf16 flash and from float32,
    a gradient at most 2·world x from one rank's bf16 and 2·world + 1 x
    from float32.  The pipelined loss is one rank's."""
    readings, over = [], []
    for name, want in (("ring", world * (world + 1) // 2),
                       ("ulysses", world)):
        assert [sum(r[name]["launches"][i] for r in res)
                for i in range(3)] == [want] * 3, res
        for i, (limit, limit32) in enumerate(
                [(3.0, 3.0)] + [(2.0 * world, 2.0 * world + 1)] * 3):
            for rank, r in enumerate(res):
                dist, dist32, floor = (r[name][k][i]
                                       for k in ("dist", "dist32", "floor"))
                x = (name, ("out", "dq", "dk", "dv")[i], rank, dist, dist32,
                     floor)
                readings.append(x)
                if not (0 < floor and dist <= limit * floor
                        and dist32 <= limit32 * floor):
                    over.append(x)
    # every rank's readings in the message: (part, tensor, rank, from
    # one rank's bf16, from float32, floor)
    assert not over, (over, readings)
    for r in res:
        assert r["pp_loss"] == pytest.approx(r["one_rank_loss"], rel=1e-4)


_SEQPAR = {"shape": (1, 8, 2048, 64),
           "tokens": np.random.default_rng(3).integers(
               0, 128, (8, 16)).astype(np.int32)}


def test_ring_on_flash_two_ranks_on_one_card(dev, tmp_path):
    """Sequence parallelism with two ranks on cuda:0 over gloo (K/V,
    all-to-alls and stage sends through host memory)."""
    _check_seqpar(_spawn("cuda_seqpar", 2, tmp_path, _SEQPAR, "cuda:0",
                         "gloo"), 2)


@pytest.mark.parametrize("world", [2, 4])
def test_ring_on_flash_across_cards(dev, tmp_path, world):
    """The same with one rank a card over NCCL."""
    _cards(world)
    _check_seqpar(_spawn("cuda_seqpar", world, tmp_path, _SEQPAR,
                         "cuda:RANK", "nccl"), world)



# -- Direct SQL on the card (tables written by the port's writers) -----------

def _sql_engine():
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.utils.config import EngineConfig
    return StromEngine(EngineConfig(chunk_bytes=1 << 20,
                                    buffer_pool_bytes=32 << 20))


def test_sql_direct_scan_on_card_against_host_path(dev, tmp_path,
                                                   monkeypatch):
    """PLAIN, dictionary and BYTE_STREAM_SPLIT-free pages of 4- and
    8-byte types onto the card: the direct path equal to the host path
    and to numpy, the PLAIN scan with no host copy (``bounce_bytes`` 0)."""
    monkeypatch.setenv("STROM_NO_RESIDENCY_PROBE", "1")
    from nvme_strom_tpu_torch.ops.bridge import h2d_copy
    from nvme_strom_tpu_torch.sql import ParquetScanner
    from nvme_strom_tpu_torch.sql.pqwrite import write_parquet
    rng = np.random.default_rng(0)
    n = 300_000
    cols = {"k": rng.integers(0, 50, n).astype(np.int32),
            "v": rng.standard_normal(n).astype(np.float32),
            "t": rng.integers(-2**50, 2**50, n),
            "d": rng.standard_normal(n),
            "dv": rng.integers(0, 1000, n).astype(np.int32)}
    p = tmp_path / "t.parquet"
    write_parquet(p, cols, row_group_size=70_000, page_bytes=128 << 10,
                  dictionary=["dv"])
    with _sql_engine() as eng:
        sc = ParquetScanner(p, eng)
        before = h2d_copy.launches
        eng.sync_stats()
        b0 = eng.stats.bounce_bytes
        plain = sc.read_columns_to_device(["k", "v", "t", "d"], device=dev,
                                          direct="always")
        eng.sync_stats()
        assert eng.stats.bounce_bytes == b0
        assert h2d_copy.launches > before
        host = sc.read_columns_to_device(["k", "v", "t", "d", "dv"],
                                         device=dev, direct="never")
        dct = sc.read_columns_to_device(["dv"], device=dev,
                                        direct="always")
        for c in ("k", "v", "t", "d"):
            assert plain[c].device == dev
            assert torch.equal(plain[c], host[c])
            np.testing.assert_array_equal(plain[c].cpu().numpy(), cols[c])
        assert torch.equal(dct["dv"], host["dv"])
        np.testing.assert_array_equal(dct["dv"].cpu().numpy(), cols["dv"])


def test_sql_bitunpack_on_card_against_numpy(dev):
    """The index-stream decode on the card at bit widths 0-24, across
    RLE / bit-packed run edges, equal to the host decoder."""
    from nvme_strom_tpu_torch.ops.bitunpack import rle_hybrid_batch_to_device
    from nvme_strom_tpu_torch.sql.pq_direct import decode_rle_hybrid
    from nvme_strom_tpu_torch.sql.pqwrite import encode_bitpacked
    rng = np.random.default_rng(1)
    for bw in range(25):
        parts = []
        for i in range(4):
            vals = (rng.integers(0, 1 << bw, 1000 + 77 * i) if bw
                    else np.zeros(1000 + 77 * i, np.int64))
            rle = (b"\x46" + (int(vals[0]).to_bytes((bw + 7) // 8, "little")
                              if bw else b""))
            buf = rle + encode_bitpacked(vals, bw)
            parts.append((buf, bw, 35 + len(vals) - 5 * i))
        got = rle_hybrid_batch_to_device(parts, dev)
        want = np.concatenate([decode_rle_hybrid(*q) for q in parts])
        assert got.device == dev
        np.testing.assert_array_equal(got.cpu().numpy(), want, err_msg=bw)


def test_sql_gzip_nulls_and_arrow_on_card(dev, tmp_path, monkeypatch):
    """GZIP pages: bounce equal to the decompressed value bytes; v2 pages
    with nulls: values and mask equal numpy's; Arrow IPC: bitwise with no
    host copy."""
    monkeypatch.setenv("STROM_NO_RESIDENCY_PROBE", "1")
    from nvme_strom_tpu_torch.formats.arrow import (ArrowFileReader,
                                                    write_arrow_file)
    from nvme_strom_tpu_torch.sql import ParquetScanner, pq_direct
    from nvme_strom_tpu_torch.sql.pqwrite import write_parquet
    rng = np.random.default_rng(2)
    n = 200_000
    v = rng.standard_normal(n).astype(np.float32)
    valid = rng.random(n) > 0.1
    pg, pn, pa_ = (tmp_path / "g.parquet", tmp_path / "n.parquet",
                   tmp_path / "c.arrow")
    write_parquet(pg, {"v": v}, row_group_size=50_000, compression="gzip",
                  page_bytes=64 << 10)
    write_parquet(pn, {"x": v}, nulls={"x": valid},
                  data_page_version="2.0", page_bytes=64 << 10)
    cols = {"a": rng.integers(-9, 9, n).astype(np.int32), "b": v}
    write_arrow_file(pa_, cols, batch_rows=30_000)
    with _sql_engine() as eng:
        sc = ParquetScanner(pg, eng)
        decomp = sum(p.uncompressed_len for pl in
                     pq_direct.plan_columns(sc, ["v"])["v"]
                     for p in pl.parts)
        eng.sync_stats()
        b0 = eng.stats.bounce_bytes
        got = sc.read_columns_to_device(["v"], device=dev, direct="always")
        eng.sync_stats()
        assert eng.stats.bounce_bytes - b0 == decomp
        assert torch.equal(got["v"].cpu(), torch.from_numpy(v))
        x, m = ParquetScanner(pn, eng).read_columns_to_device(
            ["x"], device=dev, direct="always", nulls="mask")["x"]
        np.testing.assert_array_equal(m.cpu().numpy(), valid)
        np.testing.assert_array_equal(x.cpu().numpy()[valid], v[valid])
        assert not x.cpu().numpy()[~valid].any()
        eng.sync_stats()
        b0 = eng.stats.bounce_bytes
        out = ArrowFileReader(pa_).read_columns_to_device(eng, device=dev)
        eng.sync_stats()
        assert eng.stats.bounce_bytes == b0
        for c, a in cols.items():
            np.testing.assert_array_equal(out[c].cpu().numpy(), a)


@pytest.mark.parametrize("method", ["matmul", "scatter"])
def test_sql_groupby_on_card_against_numpy(dev, tmp_path, monkeypatch,
                                           method):
    """``sql_query``'s GROUP BY on the card equal to numpy (counts exact,
    sums within 1e-5 of the group's sum of |v|), and keys outside
    [0, num_groups) dropped without a device-side assert."""
    monkeypatch.setenv("STROM_NO_RESIDENCY_PROBE", "1")
    from nvme_strom_tpu_torch.sql import ParquetScanner, sql_query
    from nvme_strom_tpu_torch.sql.groupby import groupby_aggregate
    from nvme_strom_tpu_torch.sql.pqwrite import write_parquet
    rng = np.random.default_rng(3)
    n = 500_000
    k = rng.integers(0, 40, n).astype(np.int32)
    v = rng.standard_normal(n).astype(np.float32)
    p = tmp_path / "g.parquet"
    write_parquet(p, {"k": k, "v": v}, row_group_size=100_000)
    with _sql_engine() as eng:
        out = sql_query("SELECT k, COUNT(*), SUM(v) FROM t GROUP BY k",
                        {"t": ParquetScanner(p, eng)}, engine=eng,
                        device=dev, method=method)
    np.testing.assert_array_equal(out["count(*)"],
                                  np.bincount(k, minlength=40))
    ref = np.bincount(k, weights=v, minlength=40)
    lim = 1e-5 * np.bincount(k, weights=np.abs(v), minlength=40)
    assert (np.abs(out["sum(v)"] - ref) <= lim).all()
    keys = torch.tensor([0, -1, 3, 4, 9, 2], device=dev)
    vals = torch.arange(6, dtype=torch.float32, device=dev)
    r = groupby_aggregate(keys, vals, 4, aggs=("count", "sum", "max"),
                          method=method)
    torch.cuda.synchronize()
    assert r["count"].cpu().tolist() == [1, 0, 1, 1]
    assert r["sum"].cpu().tolist() == [0.0, 0.0, 5.0, 2.0]


@pytest.mark.parametrize("method", ["matmul", "scatter"])
def test_sql_device_table_counts_past_f32_integers(dev, tmp_path,
                                                    monkeypatch, method):
    """A cached table whose group 0 holds 2^24 + 1000 rows, folded in
    one call: COUNT exact (an f32 count stops at 2^24), for GROUP BY and
    the scalar COUNT, SUM within 1e-5 of the group's sum of |v|."""
    monkeypatch.setenv("STROM_NO_RESIDENCY_PROBE", "1")
    from nvme_strom_tpu_torch.sql import DeviceTable, ParquetScanner
    from nvme_strom_tpu_torch.sql.pqwrite import write_parquet
    rng = np.random.default_rng(4)
    n = (1 << 24) + 2000
    k = np.zeros(n, np.int32)
    k[rng.choice(n, 1000, replace=False)] = 1
    v = rng.standard_normal(n).astype(np.float32)
    p = tmp_path / "big.parquet"
    write_parquet(p, {"k": k, "v": v}, row_group_size=1 << 22)
    with _sql_engine() as eng:
        table = DeviceTable(ParquetScanner(p, eng), ["k", "v"], device=dev)
    r = table.groupby("k", "v", 2, aggs=("count", "sum"), method=method)
    assert r["count"].cpu().tolist() == [n - 1000, 1000]
    ref = np.bincount(k, weights=v, minlength=2)
    lim = 1e-5 * np.bincount(k, weights=np.abs(v), minlength=2)
    assert (np.abs(r["sum"].cpu().numpy() - ref) <= lim).all()
    s = table.scalar_agg("v", aggs=("count",))
    assert int(s["count"]) == n


# -- the operator tools on the card -------------------------------------------

def test_ssd2gpu_device_dest_verified_on_card(dev, tmp_path, monkeypatch,
                                              capsys):
    """``ssd2gpu_test --dest device --verify``: every chunk read back
    from the card equals a pread of its range, one h2d_copy launch a
    chunk, and no bounce when the reads were O_DIRECT."""
    import json
    monkeypatch.setenv("STROM_NO_RESIDENCY_PROBE", "1")
    from nvme_strom_tpu_torch.tools import ssd2gpu_test
    path = tmp_path / "payload.bin"
    ssd2gpu_test.make_test_file(str(path), 24 * (1 << 20) + 777)
    rc = ssd2gpu_test.main([str(path), "--dest", "device", "--verify",
                            "--chunk-bytes", str(4 << 20), "--depth", "3"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and res["verify"] == "ok"
    assert res["bytes"] == path.stat().st_size
    assert res["chunks_verified"] == res["chunks"] == 7
    assert res["h2d_copy_launches"] == res["chunks"]
    if res["bytes_fallback"] == 0:
        assert res["bounce_bytes"] == 0


def test_kernel_probe_small_shape_on_card(dev, capsys):
    """``kernel_probe`` at a small GQA shape: kernels 4-6 each launched,
    out, dQ, dK and dV within the flash bf16 tolerance of their plain
    versions and the forward's lse within 1e-4 of the plain lse."""
    import json
    from nvme_strom_tpu_torch.tools import kernel_probe
    assert kernel_probe.main(["--shapes", "", "--shape", "2,8,2,512,128",
                              "--roof-n", "1024", "--iters", "2"]) == 0
    recs = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    flash = recs[0]
    assert flash["impl"] == "flash" and flash["within_tol"]
    assert set(flash["err_over_tol"]) == {"out", "lse", "dq", "dk", "dv"}
    assert all(n > 0 for n in flash["launches_checked"].values())
    assert recs[-1]["probe"] == "matmul_roof" and recs[-1]["finite"]


# -- the weight-only int8 / int4 matmul (ops/quant_matmul.py) ---------------

#: quant_gemv against its plain version: max |kernel - plain| over max
#: |plain|.  Both round the weight alike and sum in float32 (in another
#: order); bf16 / fp16 round the output once, so they may differ by one
#: ulp of an element (2**-7 / 2**-10 of it); float32 only by the order.
QUANT_TOL = {torch.bfloat16: 1e-2, torch.float16: 1e-2, torch.float32: 1e-5}


def _quant_leaf(kind, shape, dev, seed=0):
    """A leaf quantized on the card from a seeded weight of ``shape``
    (E, K, N) or (K, N): ``int8``, or ``int4_g<group>``."""
    from nvme_strom_tpu_torch.models import quant as q
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(shape, generator=g, device=dev) * 0.05
    if kind == "int8":
        return q.quantize_weights_int8({"w": w}, suffixes=("w",))["w"]
    leaf = q.quantize_weights_int4({"w": w}, suffixes=("w",),
                                   group=int(kind.split("_g")[1]))["w"]
    assert leaf["scale4"].shape[-3] == shape[-2] // int(kind.split("_g")[1])
    return leaf


#: (kind, weight shape): aligned and ragged d_out (1000, 1003 columns:
#: not a whole 16-byte copy), int4 groups of 128, 16, 24 and 6 (a k16
#: step of the tensor-core GEMV holds several groups), experts (8 of
#: them, as Mixtral's), d_in not a whole k16 step (520)
QUANT_CASES = [("int8", (512, 1000)), ("int8", (640, 1003)),
               ("int4_g128", (1024, 1003)), ("int4_g24", (768, 520)),
               ("int8", (4, 512, 264)), ("int4_g32", (3, 256, 136)),
               ("int4_g16", (512, 264)), ("int4_g6", (384, 200)),
               ("int8", (520, 136)), ("int8", (8, 512, 1024)),
               ("int4_g16", (8, 256, 264))]


def _gemv_rows(qmm, dtype):
    """Rows of x the GEMV checks take: across the tensor-core kernel's
    row tiles (9, 17, 33, 65 start new ones) and the dtype's most rows
    and one past them."""
    top = qmm.max_rows(dtype)
    return sorted({1, 3, 8, 9, 16, 17, 33, 65, top, top + 1})


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32], ids=["bf16", "f16",
                                                        "f32"])
@pytest.mark.parametrize("kind,shape", QUANT_CASES)
def test_quant_gemv_matches_plain(dev, kind, shape, dtype, monkeypatch):
    """The fused GEMV (tensor cores for bf16 / fp16, the FMA kernel for
    float32) across its row tiles up to the rows ``quant_matmul`` gives
    it and one past, against ``quant_matmul_plain`` on the same card
    tensors, two calls bitwise equal, one launch a call."""
    from nvme_strom_tpu_torch.ops import quant_matmul as qmm
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    leaf = _quant_leaf(kind, shape, dev)
    E = shape[0] if len(shape) == 3 else 1
    g = torch.Generator(device=dev).manual_seed(1)
    for m in _gemv_rows(qmm, dtype):
        x = torch.randn(E, m, shape[-2], generator=g, device=dev).to(dtype)
        n0 = qmm.quant_gemv.launches
        got = qmm.quant_gemv(x, leaf)
        assert qmm.quant_gemv.launches == n0 + 1
        want = qmm.quant_matmul_plain(x if E > 1 else x[0], leaf)
        want = want if E > 1 else want[None]
        assert got.dtype == dtype and got.shape == want.shape
        err = (got.float() - want.float()).abs().max().item()
        assert err <= QUANT_TOL[dtype] * want.float().abs().max().item(), \
            (m, err)
        assert torch.equal(got, qmm.quant_gemv(x, leaf)), m


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32], ids=["bf16", "f16",
                                                        "f32"])
@pytest.mark.parametrize("kind,shape", QUANT_CASES)
def test_dequant_kernel_bitwise(dev, kind, shape, dtype):
    """The dequant kernel writes ``wmat``'s torch-op weight bit for bit,
    also from a leaf whose bytes start off the vector alignment."""
    from nvme_strom_tpu_torch.ops import quant_matmul as qmm
    leaf = _quant_leaf(kind, shape, dev)
    n0 = qmm.dequant.launches
    got = qmm.dequant(leaf, dtype)
    assert qmm.dequant.launches == n0 + 1
    assert torch.equal(got, qmm.dequant_plain(leaf, dtype))
    key = "q8" if "q8" in leaf else "q4"
    raw = torch.empty(leaf[key].numel() + 1, dtype=leaf[key].dtype,
                      device=dev)
    off = {key: raw[1:].view(leaf[key].shape), **{
        k: v for k, v in leaf.items() if k != key}}
    off[key].copy_(leaf[key])
    assert torch.equal(qmm.dequant(off, dtype), got)
    assert torch.equal(qmm.quant_gemv(torch.ones(
        *(leaf[key].shape[:-2] or (1,)), 2, got.shape[-2], dtype=dtype,
        device=dev), off), qmm.quant_gemv(torch.ones(
            *(leaf[key].shape[:-2] or (1,)), 2, got.shape[-2], dtype=dtype,
            device=dev), leaf))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("kind,shape", [("int8", (1024, 1024)),
                                        ("int4_g128", (1024, 1024)),
                                        ("int4_g24", (768, 512))])
def test_quant_gemv_unaligned_leaf(dev, kind, shape, dtype, monkeypatch):
    """A leaf whose bytes start 1, 4 and 8 bytes off a 16-byte boundary
    (the weight copies fall back to 4- and 8-byte or byte loads) gives
    the aligned leaf's output bit for bit, across the row tiles and with
    K splits."""
    from nvme_strom_tpu_torch.ops import quant_matmul as qmm
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    leaf = _quant_leaf(kind, shape, dev)
    key = "q8" if "q8" in leaf else "q4"
    g = torch.Generator(device=dev).manual_seed(3)
    for off in (1, 4, 8):
        raw = torch.empty(leaf[key].numel() + 16, dtype=leaf[key].dtype,
                          device=dev)
        moved = raw[off:off + leaf[key].numel()].view(leaf[key].shape)
        moved.copy_(leaf[key])
        assert moved.data_ptr() % 16 == off
        other = {**leaf, key: moved}
        for m in (1, 8, 17, 65):
            x = torch.randn(1, m, shape[0], generator=g,
                            device=dev).to(dtype)
            assert torch.equal(qmm.quant_gemv(x, other),
                               qmm.quant_gemv(x, leaf)), (off, m)


def test_quant_routes_and_counts(dev):
    """``quant_matmul`` takes the GEMV up to QUANT_GEMV_MAX_ROWS rows of
    bf16 x (FMA_GEMV_MAX_ROWS of float32) and the dequant kernel past
    them; ``wmat`` and ``project`` of a CUDA leaf launch a kernel and
    never dequantize with torch ops."""
    from nvme_strom_tpu_torch.models import transformer as tr
    from nvme_strom_tpu_torch.ops import quant_matmul as qmm
    leaf = _quant_leaf("int8", (256, 64), dev)
    p = {"w": leaf}
    n = qmm.QUANT_GEMV_MAX_ROWS
    counts = lambda: (qmm.quant_gemv.launches, qmm.dequant.launches,
                      qmm.dequant_plain.device_calls)
    c0 = counts()
    x = torch.randn(2, n // 2, 256, device=dev, dtype=torch.bfloat16)
    assert tr.project(x, p, "w").shape == (2, n // 2, 64)
    assert counts() == (c0[0] + 1, c0[1], c0[2])
    x = torch.randn(1, n + 1, 256, device=dev, dtype=torch.bfloat16)
    tr.project(x, p, "w")
    tr.wmat(p, "w", torch.float32)
    assert counts() == (c0[0] + 1, c0[1] + 2, c0[2])
    f = qmm.FMA_GEMV_MAX_ROWS
    tr.project(torch.randn(1, f, 256, device=dev), p, "w")
    assert counts() == (c0[0] + 2, c0[1] + 2, c0[2])
    tr.project(torch.randn(1, f + 1, 256, device=dev), p, "w")
    assert counts() == (c0[0] + 2, c0[1] + 3, c0[2])


def test_quant_gemv_resident_blocks(dev):
    """The runtime's count of the tensor-core GEMV's blocks a SM, which
    its split plan fills in one wave: three (what the launch bounds hold
    the registers to) up to 32 rows and at 64 rows of int8, two at 64
    rows of int4, whose ring takes 104 KiB."""
    from nvme_strom_tpu_torch.ops import quant_matmul as qmm
    for mt in (8, 16, 32):
        for bits in (8, 4):
            assert qmm.resident_blocks(dev.index, mt, bits) == 3, (mt, bits)
    assert qmm.resident_blocks(dev.index, 64, 8) == 3
    assert qmm.resident_blocks(dev.index, 64, 4) == 2


def test_quant_refusals(dev):
    """A non-contiguous leaf, a dtype the kernels do not take, tensors on
    two devices, a leaf that asks for a gradient and the GEMV on an x
    that needs one each raise; ``quant_matmul`` gives such an x its
    gradient through the dequant route."""
    from nvme_strom_tpu_torch.ops import quant_matmul as qmm
    leaf = _quant_leaf("int8", (128, 64), dev)
    x = torch.randn(1, 2, 128, device=dev)
    strided = {"q8": leaf["q8"].t().contiguous().t(),
               "scale": leaf["scale"]}
    with pytest.raises(ValueError, match="contiguous"):
        qmm.quant_matmul(x, strided)
    with pytest.raises(ValueError, match="takes"):
        qmm.quant_matmul(x.double(), leaf)
    with pytest.raises(ValueError, match="tensors on"):
        qmm.quant_gemv(x, {"q8": leaf["q8"], "scale": leaf["scale"].cpu()})
    with pytest.raises(RuntimeError, match="no backward"):
        trainable = leaf["scale"].clone().requires_grad_()
        qmm.quant_matmul(x, {"q8": leaf["q8"], "scale": trainable})
    with pytest.raises(RuntimeError, match="no backward"):
        qmm.quant_gemv(x.requires_grad_(), leaf)
    g0, d0 = qmm.quant_gemv.launches, qmm.dequant.launches
    qmm.quant_matmul(x, leaf).sum().backward()
    assert (qmm.quant_gemv.launches, qmm.dequant.launches) == (g0, d0 + 1)
    want = qmm.dequant_plain(leaf, x.dtype).sum(-1).expand(1, 2, 128)
    torch.testing.assert_close(x.grad, want, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        qmm.quant_matmul(x, leaf)
    assert qmm.quant_gemv.launches == g0 + 1


def test_quant_int8_decode_server_tokens_on_kernel_and_cpu_routes(
        dev, monkeypatch):
    """A float32 int8 model's DecodeServer on the card (every quantized
    product through quant_gemv or dequant) gives the CPU route's tokens
    (torch ops, which tests/test_torch_quant_moe.py holds against the
    JAX servers)."""
    from nvme_strom_tpu_torch.convert import params_from_jax
    from nvme_strom_tpu_torch.models import quant as q
    from nvme_strom_tpu_torch.models.serving import DecodeServer
    from nvme_strom_tpu_torch.models.transformer import (TransformerConfig,
                                                         init_params)
    from nvme_strom_tpu_torch.ops import quant_matmul as qmm
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = TransformerConfig(vocab=256, d_model=128, n_layers=2, n_heads=2,
                            n_kv_heads=1, d_ff=256, max_seq=256,
                            dtype=torch.float32)
    np_params = init_params(0, cfg)
    rng = np.random.default_rng(2)
    reqs = [(f"r{i}", rng.integers(0, 256, n).tolist(), 12)
            for i, n in enumerate([3, 40, 90, 7, 130])]
    outs = []
    for d in (dev, torch.device("cpu")):
        params = q.quantize_weights_int8(params_from_jax(np_params, cfg, d))
        srv = DecodeServer(params, cfg, 3, 256, device=d)
        for rid, p, m in reqs:
            srv.submit(rid, p, m)
        c0 = (qmm.quant_gemv.launches, qmm.dequant.launches,
              qmm.dequant_plain.device_calls)
        outs.append(srv.run(lookahead=4))
        if d.type == "cuda":
            assert qmm.quant_gemv.launches > c0[0]
            assert qmm.dequant.launches > c0[1]
            assert qmm.dequant_plain.device_calls == c0[2]
    assert outs[0] == outs[1]
