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


@pytest.mark.parametrize("n,src_off,dst_off", [
    (1, 0, 0), (15, 1, 0), (4095, 3, 1), ((1 << 20) + 3, 5, 0),
    ((1 << 20) + 3, 0, 9)])
def test_h2d_copy_bytes(dev, n, src_off, dst_off):
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


def test_h2d_copy_of_nothing_launches_nothing(dev):
    from nvme_strom_tpu_torch.ops.bridge import h2d_copy, pinned_mapping
    src = torch.empty(16, dtype=torch.uint8, pin_memory=True)
    m = pinned_mapping(src, dev)
    before = h2d_copy.launches
    h2d_copy(src.numpy()[:0], torch.empty(0, dtype=torch.uint8, device=dev),
             src_ptr=m.dev_base)
    assert h2d_copy.launches == before


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, BF16_TOL),
                                       (torch.float32, F32_TOL)])
@pytest.mark.parametrize("nh,nkv,d", [(8, 8, 64), (32, 8, 128), (4, 2, 64)])
def test_attention_kernels_match_plain(dev, dtype, tol, nh, nkv, d):
    from nvme_strom_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_plain)
    from nvme_strom_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_plain)
    g = torch.Generator(device=dev).manual_seed(0)
    b, S, bk = 3, 300, 64
    pos = torch.tensor([0, 150, 299], dtype=torch.int32, device=dev)
    q = torch.randn(b, nh, 1, d, generator=g, device=dev).to(dtype)
    k = torch.randn(b, nkv, S, d, generator=g, device=dev).to(dtype)
    v = torch.randn(b, nkv, S, d, generator=g, device=dev).to(dtype)
    for i, p in enumerate(pos.tolist()):
        k[i, :, p + 1:] = float("nan")
        v[i, :, p + 1:] = float("nan")
    got = decode_attention(q, k, v, pos)
    torch.testing.assert_close(got.float(),
                               decode_attention_plain(q, k, v, pos).float(),
                               rtol=tol[0], atol=tol[1])
    # the same cache in pool blocks, padding entries on a NaN block
    nb = -(-S // bk)
    kp = torch.full((b * nb + 1, nkv, bk, d), float("nan"), dtype=dtype,
                    device=dev)
    vp = kp.clone()
    kpad = torch.nn.functional.pad(k, (0, 0, 0, nb * bk - S))
    vpad = torch.nn.functional.pad(v, (0, 0, 0, nb * bk - S))
    kp[:-1] = kpad.view(b, nkv, nb, bk, d).transpose(1, 2).reshape(
        -1, nkv, bk, d)
    vp[:-1] = vpad.view(b, nkv, nb, bk, d).transpose(1, 2).reshape(
        -1, nkv, bk, d)
    table = torch.arange(b * nb, dtype=torch.int32,
                         device=dev).view(b, nb).clone()
    table[0, 1:] = b * nb                        # row 0 lives in block 0
    out = paged_attention(q, kp, vp, table, pos)
    torch.testing.assert_close(out.float(), got.float(), rtol=tol[0],
                               atol=tol[1])
    torch.testing.assert_close(
        out.float(), paged_attention_plain(q, kp, vp, table, pos).float(),
        rtol=tol[0], atol=tol[1])


def test_kernel_wrappers_reject_what_they_do_not_take(dev):
    from nvme_strom_tpu_torch.ops.decode_attention import decode_attention
    q = torch.zeros(2, 4, 1, 16, device=dev)
    k = torch.zeros(2, 2, 8, 16, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        decode_attention(q, k, k, 3)
    q = torch.zeros(2, 4, 1, 64, device=dev, dtype=torch.float16)
    k = torch.zeros(2, 2, 8, 64, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="takes"):
        decode_attention(q, k, k, 3)


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
