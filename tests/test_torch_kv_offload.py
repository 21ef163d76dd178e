"""The port's offloaded KV decode (nvme_strom_tpu_torch/models/kv_offload.py
``PagedKVCache`` and its generation functions, ops/bridge.py
``split_ranges`` and the ``stream_ranges`` verify hook) on the CPU, held
against the JAX package's on the same numpy inputs made from a seed.

The cases follow tests/test_kv_offload.py at its sizes (tiny_config in
float32, ``page_len`` 4).  Tolerances: the partial functions 1e-6
(float32 einsums in a different summation order); ``attend`` 1e-5
against the JAX cache and the dense numpy softmax, as the JAX test
allows; logits 1e-5; greedy tokens, page files and session
continuations exactly; int8 pages within 3e-2 of dense, as the JAX test
allows."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from nvme_strom_tpu.io.engine import StromEngine as JaxEngine
from nvme_strom_tpu.models import decode as jdec
from nvme_strom_tpu.models import kv_offload as jk
from nvme_strom_tpu.models import transformer as jtr
from nvme_strom_tpu.ops.bridge import split_ranges as jax_split_ranges
from nvme_strom_tpu.utils.config import EngineConfig as JaxEngineConfig
from nvme_strom_tpu.utils.stats import StromStats as JaxStats
from nvme_strom_tpu_torch import generate as gen_main
from nvme_strom_tpu_torch.convert import params_from_jax
from nvme_strom_tpu_torch.io.engine import StromEngine
from nvme_strom_tpu_torch.models import decode as tdec
from nvme_strom_tpu_torch.models import kv_offload as tk
from nvme_strom_tpu_torch.models import transformer as ttr
from nvme_strom_tpu_torch.ops.bridge import DeviceStream, split_ranges
from nvme_strom_tpu_torch.parallel.weights import save_checkpoint
from nvme_strom_tpu_torch.utils.checksum import ChecksumError
from nvme_strom_tpu_torch.utils.config import EngineConfig

CPU = "cpu"
PART_TOL = dict(atol=1e-6, rtol=1e-6)
ATTEND_TOL = dict(atol=1e-5, rtol=1e-5)


def _cfgs(jdt=jnp.float32, tdt=torch.float32, **over):
    cfg_j = jtr.TransformerConfig(**{**jtr.tiny_config().__dict__,
                                     "dtype": jdt, **over})
    cfg_t = dataclasses.replace(ttr.tiny_config(), dtype=tdt, **over)
    return cfg_j, cfg_t


@pytest.fixture(scope="module")
def model():
    cfg_j, cfg_t = _cfgs()
    pj = jtr.init_params(jax.random.key(0), cfg_j)
    pt = params_from_jax({k: np.asarray(v) for k, v in pj.items()}, cfg_t,
                         CPU)
    return cfg_j, cfg_t, pj, pt


@pytest.fixture
def engine():
    eng = StromEngine()
    yield eng
    eng.close_all()


@pytest.fixture
def jengine():
    eng = JaxEngine(stats=JaxStats())
    yield eng
    eng.close_all()


def _history(seed, cfg, b, S):
    rng = np.random.default_rng(seed)
    L, nkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    ks = rng.standard_normal((L, b, nkv, S, hd)).astype(np.float32)
    vs = rng.standard_normal((L, b, nkv, S, hd)).astype(np.float32)
    q = rng.standard_normal((b, cfg.n_heads, 1, hd)).astype(np.float32)
    return ks, vs, q


def _dense_reference(q, ks, vs):
    """Dense attention of grouped queries over the whole history:
    q (b, nh, 1, hd); ks / vs (b, nkv, S, hd)."""
    b, nh, _, hd = q.shape
    nkv = ks.shape[1]
    qf = q.reshape(b, nkv, nh // nkv, hd).astype(np.float32)
    s = np.einsum("bkgd,bksd->bkgs", qf, ks.astype(np.float32))
    s = s / np.sqrt(np.float32(hd))
    p = np.exp(s - s.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    out = np.einsum("bkgs,bksd->bkgd", p, vs.astype(np.float32))
    return out.reshape(b, nh, 1, hd)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- the partial functions ----------------------------------------------------

def _part_inputs(seed=3, b=2, nkv=2, rows=6, S=5, hd=16):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(q=f(b, nkv, rows, hd), k=f(b, nkv, S, hd),
                v=f(b, nkv, S, hd),
                mask=rng.random((b, nkv, rows, S)) < 0.7)


def _cases():
    """(name, function name, argument builder) of each partial."""
    def partial(d):
        return (d["q"], d["k"], d["v"])

    def masked(d):
        return (d["q"], d["k"], d["v"], d["mask"])

    def page_q(d):
        rng = np.random.default_rng(9)
        kq = rng.integers(-127, 128, d["k"].shape).astype(np.int8)
        vq = rng.integers(-127, 128, d["v"].shape).astype(np.int8)
        sc = rng.random(d["k"].shape[:-1] + (1,)).astype(np.float32) / 50
        return (d["q"], kq, sc, vq, sc * 2)

    def window(count):
        return lambda d: (d["q"], d["k"], d["v"], count)

    def combine(d):
        a = jk._partial_impl(*map(jnp.asarray, partial(d)))
        e = jk._partial_impl(*map(jnp.asarray, masked(d)))
        return tuple(np.asarray(x) for x in (*a, *e))

    def chunk(d):
        return (d["q"], d["k"][:, :, :3], d["v"][:, :, :3], 3)

    def finish(d):
        m, l, acc = jk._partial_impl(*map(jnp.asarray, partial(d)))
        return (np.asarray(m), np.asarray(l), np.asarray(acc))

    return [("partial", "_partial_impl", partial),
            ("partial masked", "_partial_impl", masked),
            ("page partial", "_page_partial", partial),
            ("int8 page partial", "_page_partial_q", page_q),
            ("window count 0", "_window_partial", window(0)),
            ("window count 3", "_window_partial", window(3)),
            ("window full", "_window_partial", window(5)),
            ("combine", "_combine", combine),
            ("chunk causal", "_chunk_causal_partial", chunk),
            ("finish", "_finish", finish)]


@pytest.mark.parametrize("name,fn,build", _cases(),
                         ids=[c[0] for c in _cases()])
def test_partial_matches_jax(name, fn, build):
    args = build(_part_inputs())
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
             for a in args]
    targs = [_t(a) if isinstance(a, np.ndarray) else a for a in args]
    want = getattr(jk, fn)(*jargs)
    got = getattr(tk, fn)(*targs)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), np.asarray(w), **PART_TOL)


def test_hidden_window_partial_combines_to_nothing():
    """A window partial with count 0 (the first prefill chunk's) hides
    every slot with the -1e30 sentinel: merged with a real partial it
    is finite and leaves that partial as it was."""
    d = _part_inputs()
    hidden = tk._window_partial(_t(d["q"]), _t(d["k"]), _t(d["v"]), 0)
    real = tk._partial_impl(_t(d["q"]), _t(d["k"][:, :, :2]),
                            _t(d["v"][:, :, :2]))
    m, l, acc = tk._combine(*hidden, *real)
    for x in (m, l, acc):
        assert torch.isfinite(x).all()
    torch.testing.assert_close(tk._finish(m, l, acc), tk._finish(*real),
                               atol=0, rtol=0)


@pytest.mark.parametrize("shape,seed", [((2, 2, 2, 4, 16), 0),
                                        ((2, 1, 2, 4, 16), 1),
                                        ((1, 8, 1, 4, 64), 2)])
def test_append_evict_and_grouping_match_jax(shape, seed):
    """The window writes, the eviction's shift and the query grouping
    are exact moves: equal to the JAX functions bit for bit."""
    rng = np.random.default_rng(seed)
    L, b, nkv, P, hd = shape
    W = 3 * P
    win = rng.standard_normal((L, b, nkv, W, hd)).astype(np.float32)
    new = rng.standard_normal((L, b, nkv, 2, hd)).astype(np.float32)
    kj, vj = jk._append_block(jnp.asarray(win), jnp.asarray(win * 2),
                              jnp.asarray(new), jnp.asarray(new * 3), 5)
    kt, vt = tk._append_block(_t(win), _t(win * 2), _t(new), _t(new * 3), 5)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    kj, vj = jk._append_layer(kj, vj, jnp.asarray(new[:1]),
                              jnp.asarray(new[1:2] if L > 1 else new[:1]),
                              L - 1, 7)
    tk._append_layer(kt, vt, _t(new[0]), _t(new[1] if L > 1 else new[0]),
                     L - 1, 7)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    out_j = jk._evict_pages(kj, vj, P)
    out_t = tk._evict_pages(kt, vt, P)
    for g, w in zip(out_t, out_j):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # (b, s, nh, hd) projections seen as (b, nh, s, hd), a transposed
    # view as qkv_project returns
    q_bs = rng.standard_normal((b, 3, nkv * 2, hd)).astype(np.float32)
    qt = _t(q_bs).transpose(1, 2)
    assert not qt.is_contiguous()
    want = jk._grouped(jnp.asarray(q_bs.transpose(0, 2, 1, 3)), nkv)
    np.testing.assert_array_equal(tk._grouped(qt, nkv).numpy(),
                                  np.asarray(want))


def test_quantize_page_matches_jax():
    """int8 data and float32 scales equal the JAX function's bit for
    bit (halves round to even in both; the scale is the product with
    the float32 reciprocal of 127, which is what XLA computes for the
    reference's division by the constant)."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 2, 3, 4, 16)) * 3).astype(np.float32)
    x[0, 0, 0, 0] = 0.0                       # an all-zero row: scale 1
    x[1, 1, 1, 1, :4] = [127.0, 63.5, -0.5, 1.5]   # exact halves
    qj, sj = jk._quantize_page(jnp.asarray(x))
    qt, st = tk._quantize_page(_t(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_offload_config_checks_as_jax():
    for mod in (tk, jk):
        with pytest.raises(ValueError, match="quantize"):
            mod.OffloadConfig(path="x", quantize="fp8")
        assert mod.OffloadConfig(path="x", page_len=4,
                                 window_pages=3).window == 12


# -- the cache against the JAX cache -----------------------------------------

@pytest.mark.parametrize("dt,quant", [("f32", None), ("bf16", None),
                                      ("f32", "int8")])
def test_page_file_matches_jax(tmp_path, engine, jengine, dt, quant):
    """After the same appends the port's page file is the JAX cache's
    byte for byte (and so are the counters)."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    cfg_j, cfg_t = _cfgs(jdt, tdt)
    b = 2
    ks, vs, _ = _history(21, cfg_t, b, 30)
    oj = jk.OffloadConfig(path=str(tmp_path / "j.bin"), page_len=4,
                          window_pages=2, quantize=quant)
    ot = tk.OffloadConfig(path=str(tmp_path / "t.bin"), page_len=4,
                          window_pages=2, quantize=quant)
    with jk.PagedKVCache(cfg_j, oj, jengine, b) as cj, \
            tk.PagedKVCache(cfg_t, ot, engine, b, device=CPU) as ct:
        for a, z in ((0, 11), (11, 12), (12, 30)):
            cj.append(jnp.asarray(ks[:, :, :, a:z]).astype(jdt),
                      jnp.asarray(vs[:, :, :, a:z]).astype(jdt))
            ct.append(_t(ks[:, :, :, a:z]).to(tdt),
                      _t(vs[:, :, :, a:z]).to(tdt))
        assert (ct.pos, ct.count, ct.n_cold, ct._page_stride) == \
            (cj.pos, cj.count, cj.n_cold, cj._page_stride)
        assert ct.n_cold >= 5
        cj.flush()
        ct.flush()
        win_j = np.asarray(cj.k_win)
        win_t = ct.k_win
    if dt == "bf16":
        win_j = win_j.view(np.uint16)
        win_t = win_t.view(torch.int16)
    np.testing.assert_array_equal(win_t.numpy().view(win_j.dtype), win_j)
    got = (tmp_path / "t.bin").read_bytes()
    want = (tmp_path / "j.bin").read_bytes()
    assert len(got) == len(want) == ct.n_cold * ct._page_stride
    assert got == want


_ATTEND_CASES = {
    # window 8: 3 cold pages and 3 window slots
    "f32": dict(b=2, S=23, page_len=4, window_pages=2, over={}),
    # a layer's span (8 * 2 * 8 * 16 * 4 B = 8 KiB) is two 4 KiB reads
    "span over chunk": dict(b=8, S=12, page_len=8, window_pages=1, over={},
                            chunk=4096),
    # a GQA group of 4
    "group 4": dict(b=2, S=27, page_len=4, window_pages=2,
                    over={"n_kv_heads": 1}),
}


@pytest.mark.parametrize("case", list(_ATTEND_CASES))
def test_attend_matches_jax_and_dense(tmp_path, case):
    c = _ATTEND_CASES[case]
    cfg_j, cfg_t = _cfgs(**c["over"])
    b, S = c["b"], c["S"]
    ks, vs, q = _history(0, cfg_t, b, S)
    chunk = c.get("chunk", 4 << 20)
    ocfg = dict(page_len=c["page_len"], window_pages=c["window_pages"])
    pb_layer = b * cfg_t.n_kv_heads * c["page_len"] * cfg_t.head_dim * 4
    assert ("chunk" not in c) or pb_layer > chunk
    with JaxEngine(JaxEngineConfig(chunk_bytes=chunk),
                   stats=JaxStats()) as je, \
            StromEngine(EngineConfig(chunk_bytes=chunk)) as te, \
            jk.PagedKVCache(cfg_j, jk.OffloadConfig(
                path=str(tmp_path / "j.bin"), **ocfg), je, b) as cj, \
            tk.PagedKVCache(cfg_t, tk.OffloadConfig(
                path=str(tmp_path / "t.bin"), **ocfg), te, b,
                device=CPU) as ct:
        cj.append(jnp.asarray(ks), jnp.asarray(vs))
        ct.append(_t(ks), _t(vs))
        assert ct.pos == S and ct.n_cold == cj.n_cold >= 1
        for layer in range(cfg_t.n_layers):
            got = ct.attend(layer, _t(q)).numpy()
            want = np.asarray(cj.attend(layer, jnp.asarray(q)))
            np.testing.assert_allclose(got, want, **ATTEND_TOL)
            np.testing.assert_allclose(
                got, _dense_reference(q, ks[layer], vs[layer]),
                **ATTEND_TOL)


def test_window_stays_bounded(tmp_path, model, engine):
    """The window's shape does not depend on the history's length; the
    file grows one page stride per evicted page."""
    _, cfg, _, _ = model
    rng = np.random.default_rng(1)
    ocfg = tk.OffloadConfig(path=str(tmp_path / "kv.bin"), page_len=4,
                            window_pages=2)
    L, nkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    with tk.PagedKVCache(cfg, ocfg, engine, 1, device=CPU) as cache:
        shape0 = cache.k_win.shape
        for _ in range(10):
            blk = _t(rng.standard_normal((L, 1, nkv, 16, hd)
                                         ).astype(np.float32))
            cache.append(blk, blk)
        assert cache.k_win.shape == shape0
        assert cache.pos == 160 and cache.count < ocfg.window
        cache.flush()
        assert os.path.getsize(ocfg.path) == \
            cache.n_cold * cache._page_stride


def test_window_rules_match_jax(tmp_path, model, engine):
    """commit_block past the window and ensure_room's limits raise the
    reference's errors."""
    _, cfg, _, _ = model
    ocfg = tk.OffloadConfig(path=str(tmp_path / "kv.bin"), page_len=4,
                            window_pages=2)
    with tk.PagedKVCache(cfg, ocfg, engine, 1, device=CPU) as cache:
        with pytest.raises(ValueError, match="exceeds window 8"):
            cache.ensure_room(9)
        cache.commit_block(3)
        with pytest.raises(RuntimeError, match="cannot make room"):
            cache.ensure_room(6)
        with pytest.raises(RuntimeError, match="overran the window"):
            cache.commit_block(6)


# -- generation ---------------------------------------------------------------

def test_offload_step_logits_match_jax(tmp_path, model, engine, jengine):
    """One step's logits with most of the history on NVMe equal the JAX
    function's (parameters carried over by params_from_jax) and the
    port's dense decode_step."""
    cfg_j, cfg_t, pj, pt = model
    prompt = np.asarray(jax.random.randint(jax.random.key(3), (2, 12), 0,
                                           cfg_j.vocab))
    b, s = prompt.shape
    dense_j = jdec.init_cache(cfg_j, b, s + 4)
    logits_j, dense_j = jdec.prefill(pj, jnp.asarray(prompt), cfg_j,
                                     dense_j)
    tok = np.asarray(jnp.argmax(logits_j, -1).astype(jnp.int32))
    dense_t = tdec.init_cache(cfg_t, b, s + 4)
    _, dense_t = tdec.prefill(pt, _t(prompt), cfg_t, dense_t)
    kw = dict(page_len=4, window_pages=1)       # window 4 < 12
    with jk.PagedKVCache(cfg_j, jk.OffloadConfig(
            path=str(tmp_path / "j.bin"), **kw), jengine, b) as cj, \
            tk.PagedKVCache(cfg_t, tk.OffloadConfig(
                path=str(tmp_path / "t.bin"), **kw), engine, b,
                device=CPU) as ct:
        cj.append(dense_j["k"][:, :, :, :s], dense_j["v"][:, :, :, :s])
        ct.append(dense_t["k"][..., :s, :], dense_t["v"][..., :s, :])
        assert ct.n_cold >= 2
        want = np.asarray(jk.offload_decode_step(pj, jnp.asarray(tok),
                                                 cfg_j, cj))
        got = tk.offload_decode_step(pt, _t(tok), cfg_t, ct)
        assert got.dtype == torch.float32 and ct.pos == s + 1
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
        dense_logits, _ = tdec.decode_step(pt, _t(tok), cfg_t, dense_t)
        np.testing.assert_allclose(got.numpy(), dense_logits.numpy(),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("chunked,s,n_new", [(False, 8, 20), (True, 19, 12)])
def test_offloaded_generate_matches_jax_and_dense(tmp_path, model, engine,
                                                  jengine, chunked, s,
                                                  n_new):
    """Greedy tokens through the paged cache (evicting mid-decode) equal
    the JAX function's and the port's dense generate."""
    cfg_j, cfg_t, pj, pt = model
    prompt = np.asarray(jax.random.randint(jax.random.key(1 + s), (2, s),
                                           0, cfg_j.vocab))
    kw = dict(page_len=4, window_pages=2)
    want = np.asarray(jk.offloaded_generate(
        pj, jnp.asarray(prompt), cfg_j,
        jk.OffloadConfig(path=str(tmp_path / "j.bin"), **kw), jengine,
        n_new, chunked_prefill=chunked))
    got = tk.offloaded_generate(
        pt, _t(prompt), cfg_t,
        tk.OffloadConfig(path=str(tmp_path / "t.bin"), **kw), engine,
        n_new, chunked_prefill=chunked)
    assert got.dtype == torch.int32 and got.shape == (2, n_new)
    np.testing.assert_array_equal(got.numpy(), want)
    dense = tdec.generate(pt, _t(prompt), cfg_t, n_new)
    np.testing.assert_array_equal(got.numpy(), dense.numpy())


def test_offloaded_generate_eos_pads_as_jax(tmp_path, model, engine,
                                            jengine):
    """After eos a row emits pad_id, as the JAX function does."""
    cfg_j, cfg_t, pj, pt = model
    prompt = np.asarray(jax.random.randint(jax.random.key(40), (2, 8), 0,
                                           cfg_j.vocab))
    free = tk.offloaded_generate(pt, _t(prompt), cfg_t, tk.OffloadConfig(
        path=str(tmp_path / "f.bin"), page_len=4, window_pages=2), engine,
        10)
    eos = int(free[0, 3])
    kw = dict(page_len=4, window_pages=2)
    want = np.asarray(jk.offloaded_generate(
        pj, jnp.asarray(prompt), cfg_j,
        jk.OffloadConfig(path=str(tmp_path / "j.bin"), **kw), jengine, 10,
        eos_id=eos, pad_id=7))
    got = tk.offloaded_generate(
        pt, _t(prompt), cfg_t,
        tk.OffloadConfig(path=str(tmp_path / "t.bin"), **kw), engine, 10,
        eos_id=eos, pad_id=7)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[0, 4:] == 7).all()


def test_chunked_prefill_matches_jax_and_dense(tmp_path, model, engine,
                                               jengine):
    """offloaded_prefill (page-sized chunks, history from NVMe) gives
    the JAX function's last-position logits and the dense prefill's,
    and the next step continues from the chunk-built cache."""
    cfg_j, cfg_t, pj, pt = model
    prompt = np.asarray(jax.random.randint(jax.random.key(9), (2, 27), 0,
                                           cfg_j.vocab))
    b, s = prompt.shape
    kw = dict(page_len=4, window_pages=2)        # window 8 << 27
    dense = tdec.init_cache(cfg_t, b, s + 4)
    want_d, dense = tdec.prefill(pt, _t(prompt), cfg_t, dense)
    with jk.PagedKVCache(cfg_j, jk.OffloadConfig(
            path=str(tmp_path / "j.bin"), **kw), jengine, b) as cj, \
            tk.PagedKVCache(cfg_t, tk.OffloadConfig(
                path=str(tmp_path / "t.bin"), **kw), engine, b,
                device=CPU) as ct:
        want = np.asarray(jk.offloaded_prefill(pj, jnp.asarray(prompt),
                                               cfg_j, cj))
        got = tk.offloaded_prefill(pt, _t(prompt), cfg_t, ct)
        assert ct.pos == s and ct.n_cold >= 4
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got.numpy(), want_d.numpy(), atol=1e-5,
                                   rtol=1e-5)
        tok = got.argmax(-1).to(torch.int32)
        step_t = tk.offload_decode_step(pt, tok, cfg_t, ct)
        step_j = jk.offload_decode_step(pj, jnp.asarray(tok.numpy()),
                                        cfg_j, cj)
        step_d, _ = tdec.decode_step(pt, tok, cfg_t, dense)
        np.testing.assert_allclose(step_t.numpy(), np.asarray(step_j),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(step_t.numpy(), step_d.numpy(),
                                   atol=1e-5, rtol=1e-5)


def test_chunked_prefill_needs_two_window_pages(tmp_path, model, engine):
    _, cfg, _, pt = model
    with tk.PagedKVCache(cfg, tk.OffloadConfig(
            path=str(tmp_path / "t.bin"), page_len=4, window_pages=1),
            engine, 1, device=CPU) as cache:
        with pytest.raises(ValueError, match="window_pages >= 2"):
            tk.offloaded_prefill(pt, torch.zeros(1, 5, dtype=torch.int32),
                                 cfg, cache)
    with pytest.raises(ValueError, match="max_new_tokens"):
        tk.offloaded_generate(pt, torch.zeros(1, 5, dtype=torch.int32), cfg,
                              tk.OffloadConfig(path=str(tmp_path / "g")),
                              engine, 0)


# -- int8 pages and the host tier ---------------------------------------------

def test_int8_attend_close_to_dense(tmp_path, model, engine, jengine):
    """int8 cold pages attend within 3e-2 of the dense softmax, with
    the JAX cache's page stride and file size; the port's result is the
    JAX cache's to 1e-5 (the same int8 bytes and scales)."""
    cfg_j, cfg, _, _ = model
    b, S = 2, 23
    ks, vs, q = _history(11, cfg, b, S)
    kw = dict(page_len=4, window_pages=2, quantize="int8")
    with tk.PagedKVCache(cfg, tk.OffloadConfig(
            path=str(tmp_path / "t.bin"), **kw), engine, b,
            device=CPU) as ct, \
            jk.PagedKVCache(cfg_j, jk.OffloadConfig(
                path=str(tmp_path / "j.bin"), **kw), jengine, b) as cj:
        ct.append(_t(ks), _t(vs))
        cj.append(jnp.asarray(ks), jnp.asarray(vs))
        assert ct.n_cold >= 3 and ct._page_stride == cj._page_stride
        got = ct.attend(0, _t(q)).numpy()
        np.testing.assert_allclose(got, _dense_reference(q, ks[0], vs[0]),
                                   atol=3e-2, rtol=3e-2)
        np.testing.assert_allclose(got, np.asarray(cj.attend(
            0, jnp.asarray(q))), **ATTEND_TOL)
        full = 2 * cfg.n_layers * b * cfg.n_kv_heads * 4 * cfg.head_dim * 4
        assert ct._page_stride == full // 4 + 2 * cfg.n_layers * b * \
            cfg.n_kv_heads * 4 * 4
        ct.flush()
        assert os.path.getsize(tmp_path / "t.bin") == \
            ct.n_cold * ct._page_stride


def test_int8_generate_runs_and_matches_jax(tmp_path, model, engine,
                                            jengine):
    """Quantized offloaded generation: int32 tokens of the right shape,
    equal to the JAX function's on the same lossy cache."""
    cfg_j, cfg_t, pj, pt = model
    prompt = np.asarray(jax.random.randint(jax.random.key(7), (2, 8), 0,
                                           cfg_j.vocab))
    kw = dict(page_len=4, window_pages=2, quantize="int8")
    got = tk.offloaded_generate(pt, _t(prompt), cfg_t, tk.OffloadConfig(
        path=str(tmp_path / "t.bin"), **kw), engine, 12)
    want = np.asarray(jk.offloaded_generate(
        pj, jnp.asarray(prompt), cfg_j,
        jk.OffloadConfig(path=str(tmp_path / "j.bin"), **kw), jengine, 12))
    assert got.shape == (2, 12) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _host_tier_run(tmp_path, cfg_j, cfg_t, ks, vs, q, pages, quant, port):
    b = ks.shape[1]
    kw = dict(page_len=4, window_pages=2, host_cache_pages=pages,
              quantize=quant)
    name = f"{'t' if port else 'j'}{pages}{quant}.bin"
    if port:
        with StromEngine() as eng, tk.PagedKVCache(cfg_t, tk.OffloadConfig(
                path=str(tmp_path / name), **kw), eng, b,
                device=CPU) as cache:
            cache.append(_t(ks), _t(vs))
            got = cache.attend(0, _t(q)).numpy()
            eng.sync_stats()
            read = eng.stats.bytes_direct + eng.stats.bytes_fallback
    else:
        stats = JaxStats()
        with JaxEngine(stats=stats) as eng, jk.PagedKVCache(
                cfg_j, jk.OffloadConfig(path=str(tmp_path / name), **kw),
                eng, b) as cache:
            cache.append(jnp.asarray(ks), jnp.asarray(vs))
            got = np.asarray(cache.attend(0, jnp.asarray(q)))
            eng.sync_stats()
            read = stats.bytes_direct + stats.bytes_fallback
    return (got, read, cache.host_cache_hits, cache.host_cache_misses,
            cache.n_cold)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_host_tier_counts_match_jax(tmp_path, model, quant):
    """The host tier serves its pages without NVMe reads, exactly; its
    hit and miss counts equal the JAX cache's at 0, 2 and every page
    (the first-inserted page leaves first, in both)."""
    cfg_j, cfg_t, _, _ = model
    ks, vs, q = _history(31, cfg_t, 2, 27)
    ref = _dense_reference(q, ks[0], vs[0])
    tol = ATTEND_TOL if quant is None else dict(atol=3e-2, rtol=3e-2)
    runs = {}
    for pages in (0, 2, 5):
        got, read, hits, misses, n_cold = _host_tier_run(
            tmp_path, cfg_j, cfg_t, ks, vs, q, pages, quant, True)
        _, _, jhits, jmisses, _ = _host_tier_run(
            tmp_path, cfg_j, cfg_t, ks, vs, q, pages, quant, False)
        assert n_cold == 5
        assert (hits, misses) == (jhits, jmisses) == \
            (min(pages, n_cold), n_cold - min(pages, n_cold))
        np.testing.assert_allclose(got, ref, **tol)
        runs[pages] = (got, read)
    assert runs[5][1] < runs[2][1] < runs[0][1]
    np.testing.assert_array_equal(runs[5][0], runs[0][0])
    np.testing.assert_array_equal(runs[2][0], runs[0][0])


# -- sessions -----------------------------------------------------------------

def _steps_t(pt, cfg, cache, tok, n):
    out = []
    for _ in range(n):
        tok = tk.offload_decode_step(pt, tok, cfg, cache).argmax(-1).to(
            torch.int32)
        out.append(tok.numpy().copy())
    return out, tok


def _steps_j(pj, cfg, cache, tok, n):
    out = []
    for _ in range(n):
        tok = jnp.argmax(jk.offload_decode_step(pj, tok, cfg, cache),
                         -1).astype(jnp.int32)
        out.append(np.asarray(tok))
    return out, tok


@pytest.mark.parametrize("saver,loader", [("jax", "port"), ("port", "jax"),
                                          ("port", "port")])
def test_session_resumes_across_packages(tmp_path, model, saver, loader):
    """A decode suspended after 5 steps and resumed in a fresh engine,
    by either package, continues with the tokens of the uninterrupted
    run."""
    cfg_j, cfg_t, pj, pt = model
    prompt = np.asarray(jax.random.randint(jax.random.key(13), (2, 10), 0,
                                           cfg_j.vocab))
    dense = tdec.init_cache(cfg_t, 2, 10)
    logits, dense = tdec.prefill(pt, _t(prompt), cfg_t, dense)
    tok0 = logits.argmax(-1).to(torch.int32)
    kw = dict(page_len=4, window_pages=2)
    with StromEngine() as eng, tk.PagedKVCache(cfg_t, tk.OffloadConfig(
            path=str(tmp_path / "ref.bin"), **kw), eng, 2,
            device=CPU) as cache:
        cache.append(dense["k"], dense["v"])
        want, _ = _steps_t(pt, cfg_t, cache, tok0, 10)
    sess = str(tmp_path / "sess")
    ocfg = dict(path=str(tmp_path / "kv.bin"), **kw)
    if saver == "jax":
        with JaxEngine(stats=JaxStats()) as eng, jk.PagedKVCache(
                cfg_j, jk.OffloadConfig(**ocfg), eng, 2) as cache:
            cache.append(jnp.asarray(dense["k"].numpy()),
                         jnp.asarray(dense["v"].numpy()))
            got_a, tok = _steps_j(pj, cfg_j, cache, jnp.asarray(
                tok0.numpy()), 5)
            cache.save_session(sess)
            saved_pos = cache.pos
        tok = np.asarray(tok)
    else:
        with StromEngine() as eng, tk.PagedKVCache(
                cfg_t, tk.OffloadConfig(**ocfg), eng, 2,
                device=CPU) as cache:
            cache.append(dense["k"], dense["v"])
            got_a, tok = _steps_t(pt, cfg_t, cache, tok0, 5)
            cache.save_session(sess)
            saved_pos = cache.pos
        tok = tok.numpy()
    with open(os.path.join(sess, "session.json")) as f:
        meta = json.load(f)
    assert meta["dtype"] == "float32" and meta["n_cold"] >= 2
    if loader == "jax":
        with JaxEngine(stats=JaxStats()) as eng:
            cache = jk.PagedKVCache.load_session(cfg_j, eng, sess)
            try:
                assert cache.pos == saved_pos
                got_b, _ = _steps_j(pj, cfg_j, cache, jnp.asarray(tok), 5)
            finally:
                cache.close()
    else:
        with StromEngine() as eng:
            cache = tk.PagedKVCache.load_session(cfg_t, eng, sess,
                                                 device=CPU)
            try:
                assert cache.pos == saved_pos
                got_b, _ = _steps_t(pt, cfg_t, cache, _t(tok), 5)
            finally:
                cache.close()
    for w, g in zip(want, got_a + got_b):
        np.testing.assert_array_equal(g, w)


def test_session_refuses_another_dtype(tmp_path, model, engine):
    """A session saved in float32 does not load into a bfloat16 model
    (the same check as the JAX cache's)."""
    _, cfg, _, _ = model
    with tk.PagedKVCache(cfg, tk.OffloadConfig(
            path=str(tmp_path / "kv.bin"), page_len=4, window_pages=2),
            engine, 1, device=CPU) as cache:
        cache.save_session(tmp_path / "s")
    with pytest.raises(ValueError, match="dtype float32"):
        tk.PagedKVCache.load_session(
            dataclasses.replace(cfg, dtype=torch.bfloat16), engine,
            tmp_path / "s", device=CPU)


# -- integrity and the bridge -------------------------------------------------

def test_verify_full_detects_flipped_byte(tmp_path, model, monkeypatch):
    """Under STROM_VERIFY=full a clean pass checks every streamed byte
    (bytes_verified > 0); a byte flipped in the page file then raises
    ChecksumError and counts one failure."""
    monkeypatch.setenv("STROM_VERIFY", "full")
    _, cfg, _, _ = model
    page_file = tmp_path / "kv.bin"
    ks, vs, _ = _history(5, cfg, 1, 19)
    q = _t(np.random.default_rng(6).standard_normal(
        (1, cfg.n_heads, 1, cfg.head_dim)).astype(np.float32))
    with StromEngine(EngineConfig(chunk_bytes=1 << 20,
                                  buffer_pool_bytes=16 << 20)) as eng:
        with tk.PagedKVCache(cfg, tk.OffloadConfig(
                path=str(page_file), page_len=4, window_pages=2), eng, 1,
                device=CPU) as cache:
            cache.append(_t(ks), _t(vs))
            cache.flush()
            assert cache.n_cold >= 2
            out = cache.attend(0, q)
            assert torch.isfinite(out).all()
            assert eng.stats.bytes_verified == \
                2 * cache.n_cold * cache._pb_layer
            with open(page_file, "r+b") as f:
                f.seek(100)
                c = f.read(1)
                f.seek(100)
                f.write(bytes([c[0] ^ 0x10]))
            with pytest.raises(ChecksumError, match="corrupt"):
                cache.attend(0, q)
            assert eng.pool_info()["free_buffers"] == eng.n_buffers
        assert eng.stats.checksum_failures == 1


@pytest.mark.parametrize("spans,chunk", [
    ([(0, 10), (4096, 0), (8192, 9000)], 4096),
    ([(100, 4096), (5000, 4097)], 4096),
    ([], 4096),
    ([(0, 1 << 20)], 1 << 18),
])
def test_split_ranges_matches_jax(spans, chunk):
    assert split_ranges(spans, chunk) == jax_split_ranges(spans, chunk)


def _stream_file(tmp_path, n):
    data = np.random.default_rng(8).integers(0, 256, n, dtype=np.uint8)
    path = tmp_path / "stream.bin"
    path.write_bytes(data.tobytes())
    return path, data


def test_stream_ranges_verify_sees_every_range_in_order(tmp_path):
    path, data = _stream_file(tmp_path, 40000)
    ranges, n_sub = split_ranges([(0, 9000), (12000, 100), (20000, 20000)],
                                 4096)
    seen = []
    with StromEngine(EngineConfig(chunk_bytes=4096,
                                  buffer_pool_bytes=64 * 4096)) as eng:
        fh = eng.open(path)
        ds = DeviceStream(eng, device=CPU, depth=4)
        out = list(ds.stream_ranges(
            fh, ranges,
            verify=lambda ri, view: seen.append((ri, view.tobytes()))))
        eng.close(fh)
    assert [ri for ri, _ in seen] == list(range(len(ranges)))
    for (ri, got), (off, ln), t in zip(seen, ranges, out):
        assert got == data[off:off + ln].tobytes() == t.numpy().tobytes()
    assert sum(n_sub) == len(ranges)


@pytest.mark.parametrize("fail_at", [0, 5, 11])
def test_stream_ranges_verify_raise_holds_no_staging(tmp_path, fail_at):
    """A raise from the hook ends the stream with every staging buffer
    back in the pool, wherever the stream was."""
    path, _ = _stream_file(tmp_path, 12 * 4096)
    ranges = [(i * 4096, 4096) for i in range(12)]

    def verify(ri, view):
        if ri == fail_at:
            raise ChecksumError("corrupt range")

    with StromEngine(EngineConfig(chunk_bytes=4096,
                                  buffer_pool_bytes=16 * 4096)) as eng:
        fh = eng.open(path)
        ds = DeviceStream(eng, device=CPU, depth=2)
        got = []
        with pytest.raises(ChecksumError):
            for t in ds.stream_ranges(fh, ranges, verify=verify):
                got.append(t)
        assert len(got) <= fail_at
        assert eng.pool_info()["free_buffers"] == eng.n_buffers
        eng.close(fh)


# -- the entry point ----------------------------------------------------------

@pytest.fixture
def checkpoint(tmp_path, model):
    """A tiny float32 checkpoint written by the port's save_checkpoint."""
    _, cfg, _, pt = model
    ckdir = tmp_path / "ck"
    ckdir.mkdir()
    save_checkpoint(str(ckdir / "model.safetensors"), pt)
    keep = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name not in ("dtype", "n_experts")}
    with open(ckdir / "strom_config.json", "w") as f:
        json.dump(keep, f)
    return ckdir


@pytest.mark.parametrize("extra,api", [
    ([], "dense"),
    (["--offload-window", "8"], "offload"),
    (["--offload-window", "8", "--offload-chunked-prefill"], "chunked"),
    (["--offload-window", "8", "--offload-quant", "int8"], "int8"),
])
def test_generate_main_matches_api(tmp_path, model, checkpoint, capsys,
                                   extra, api):
    """``python -m nvme_strom_tpu_torch.generate`` on the CPU prints the
    ids the API gives (bfloat16 weights, as strom_config.json names no
    dtype)."""
    _, cfg32, _, pt = model
    cfg = dataclasses.replace(cfg32, dtype=torch.bfloat16)
    params = {k: (v if v.dim() == 1 else v.to(torch.bfloat16))
              for k, v in pt.items()}
    ids = list(range(3, 22))
    argv = ["--weights", str(checkpoint), "--prompt",
            ",".join(map(str, ids)), "--new", "9", "--device", "cpu"]
    if api != "dense":
        argv += ["--offload", str(tmp_path / "main.bin")] + extra
    assert gen_main.main(argv) == 0
    out = capsys.readouterr().out
    line = next(x for x in out.splitlines() if x.startswith("output ids:"))
    got = [int(t) for t in line.split(":", 1)[1].strip().split(",")]
    prompt = torch.tensor([ids], dtype=torch.int32)
    if api == "dense":
        want = tdec.generate(params, prompt, cfg, 9)
    else:
        with StromEngine() as eng:
            want = tk.offloaded_generate(
                params, prompt, cfg, tk.OffloadConfig(
                    path=str(tmp_path / "api.bin"), page_len=4,
                    window_pages=2,
                    quantize="int8" if api == "int8" else None),
                eng, 9, chunked_prefill=api == "chunked")
    assert got == want[0].tolist()
    assert "engine stats: direct=" in out


@pytest.mark.parametrize("argv,msg", [
    (["--offload", "x", "--temperature", "0.5"], "greedy"),
    (["--offload", "x", "--offload-window", "4",
      "--offload-chunked-prefill"], "two pages"),
    (["--new", "60"], "max_seq"),
    (["--prompt", "1,500"], "prompt ids"),
])
def test_generate_main_refuses(checkpoint, capsys, argv, msg):
    with pytest.raises(SystemExit):
        gen_main.main(["--weights", str(checkpoint), "--device", "cpu",
                       "--prompt", "1,2,3,4,5,6,7,8"] + argv)
    assert msg in capsys.readouterr().err


def test_offload_engine_accounting(tmp_path, model):
    """Evicted pages reach the page file through engine writes and the
    streamed pages count bytes_to_device and read bytes; on the CPU
    every copy to the device is a host copy (bounce)."""
    _, cfg, _, pt = model
    prompt = _t(np.asarray(jax.random.randint(jax.random.key(5), (1, 8), 0,
                                              cfg.vocab)))
    with StromEngine() as eng:
        tk.offloaded_generate(pt, prompt, cfg, tk.OffloadConfig(
            path=str(tmp_path / "kv.bin"), page_len=4, window_pages=2),
            eng, 12)
        eng.sync_stats()
        st = eng.stats
    pb = cfg.n_kv_heads * 4 * cfg.head_dim * 4 * cfg.n_layers
    assert os.path.getsize(tmp_path / "kv.bin") // (2 * pb) >= 3
    assert st.bytes_to_device > 0
    assert st.bytes_direct + st.bytes_fallback > 0
    assert st.bounce_bytes >= st.bytes_to_device


def test_cache_defaults_to_the_card(tmp_path, model, engine):
    """Without a device the cache goes to cuda:0, and raises where there
    is no card instead of moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, cfg, _, _ = model
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tk.PagedKVCache(cfg, tk.OffloadConfig(path=str(tmp_path / "k")),
                        engine, 1)


def test_bf16_page_bytes_are_the_window_bits(tmp_path, engine):
    """A bfloat16 page holds the window's bits: the first evicted page
    read back from the file equals the first positions appended."""
    _, cfg = _cfgs(jnp.bfloat16, torch.bfloat16)
    ks, vs, _ = _history(12, cfg, 1, 9)
    with tk.PagedKVCache(cfg, tk.OffloadConfig(
            path=str(tmp_path / "kv.bin"), page_len=4, window_pages=2),
            engine, 1, device=CPU) as cache:
        cache.append(_t(ks).bfloat16(), _t(vs).bfloat16())
        cache.flush()
        assert cache.n_cold == 1
    raw = np.fromfile(tmp_path / "kv.bin", dtype=np.uint16)
    k = raw[:raw.size // 2].view(ml_dtypes.bfloat16).reshape(
        cfg.n_layers, 1, cfg.n_kv_heads, 4, cfg.head_dim)
    np.testing.assert_array_equal(
        k.astype(np.float32),
        _t(ks[:, :, :, :4]).bfloat16().float().numpy())
