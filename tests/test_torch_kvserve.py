"""The port's SSD-backed KV prefix store (nvme_strom_tpu_torch/models/
kv_offload.py ``PrefixStore``) and the servers' ``kv_store=`` on the CPU,
held against the JAX package's on the same inputs: chain keys byte for
byte, page files and manifests each package reads from the other, the
JAX ``strom-scrub`` on a store the port wrote, and the servers' greedy
tokens and store counters.  The rest mirrors tests/test_kvserve.py's
store cases.  The model is tiny_config in float32 (bfloat16 where a test
says so); every token comparison is exact, and restored pages are
compared bitwise."""

import dataclasses
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from nvme_strom_tpu.io.engine import StromEngine as JaxEngine
from nvme_strom_tpu.models import decode as jdec
from nvme_strom_tpu.models import transformer as jtr
from nvme_strom_tpu.models.kv_offload import PrefixStore as JaxStore
from nvme_strom_tpu.models.serving import DecodeServer as JaxDense
from nvme_strom_tpu.models.serving import PagedDecodeServer as JaxPaged
from nvme_strom_tpu.utils.config import EngineConfig as JaxEngineConfig
from nvme_strom_tpu.utils.stats import StromStats as JaxStats
from nvme_strom_tpu_torch.convert import params_from_jax
from nvme_strom_tpu_torch.io.engine import StromEngine
from nvme_strom_tpu_torch.models import kv_offload
from nvme_strom_tpu_torch.models import transformer as ttr
from nvme_strom_tpu_torch.models.kv_offload import (PrefixStore,
                                                    build_prefix_store)
from nvme_strom_tpu_torch.models.serving import (DecodeServer,
                                                 PagedDecodeServer)
from nvme_strom_tpu_torch.utils.config import EngineConfig

PAGE = 4
KV_COUNTERS = ("kv_pages_written", "kv_pages_deduped", "kv_bytes_saved",
               "kv_pages_restored", "kv_prefix_hits", "kv_prefix_misses",
               "kv_restore_failures", "kv_store_evictions")


@pytest.fixture(scope="module")
def setup():
    cfg_j = jtr.TransformerConfig(**{**jtr.tiny_config().__dict__,
                                     "dtype": jnp.float32})
    cfg_t = dataclasses.replace(ttr.tiny_config(), dtype=torch.float32)
    pj = jtr.init_params(jax.random.key(0), cfg_j)
    pt = params_from_jax({k: np.asarray(v) for k, v in pj.items()}, cfg_t,
                         "cpu")
    return cfg_j, cfg_t, pj, pt


@pytest.fixture
def engine():
    eng = StromEngine(EngineConfig(chunk_bytes=1 << 20,
                                   buffer_pool_bytes=16 << 20))
    yield eng
    eng.close_all()


@pytest.fixture
def jengine():
    eng = JaxEngine(JaxEngineConfig(chunk_bytes=1 << 20,
                                    buffer_pool_bytes=16 << 20),
                    stats=JaxStats())
    yield eng
    eng.close_all()


def _page_bytes(cfg):
    return (2 * cfg.n_layers * cfg.n_kv_heads * PAGE * cfg.head_dim
            * torch.empty(0, dtype=cfg.dtype).element_size())


def _store(cfg, eng, tmp_path, name="prefix.kvstore", pages=64):
    return PrefixStore(cfg, eng, str(tmp_path / name), page_tokens=PAGE,
                       capacity_bytes=pages * _page_bytes(cfg))


def _shape(cfg):
    return (cfg.n_layers, cfg.n_kv_heads, PAGE, cfg.head_dim)


def _solo(pj, cfg_j, prompt, max_new):
    """The JAX package's greedy tokens for one request alone."""
    return np.asarray(jdec.generate(pj, jnp.asarray([prompt], jnp.int32),
                                    cfg_j, max_new))[0].tolist()


def _restore_cpu(store, keys):
    return store.restore_many({0: (0, keys)}, device="cpu").get(0, {})


# -- identity: chain keys ---------------------------------------------------

_LLAMA3 = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
           "high_freq_factor": 4.0,
           "original_max_position_embeddings": 8192}


@pytest.mark.parametrize("jdt,tdt,extra", [
    (jnp.float32, torch.float32, {}),
    (jnp.bfloat16, torch.bfloat16, {}),
    (jnp.float16, torch.float16, {}),
    (jnp.bfloat16, torch.bfloat16, {"rope_theta": 500000.0,
                                    "rope_scaling": _LLAMA3}),
], ids=["f32", "bf16", "f16", "bf16 llama3 rope"])
def test_chain_keys_equal_jax(tmp_path, engine, jengine, jdt, tdt, extra):
    """The seed hashes the model identity as the JAX store does (numpy's
    dtype name, rope_theta as a float, rope_scaling as its sorted tuple,
    the JAX config's MoE defaults), so both give the same keys."""
    cfg_j = jtr.TransformerConfig(**{**jtr.tiny_config().__dict__,
                                     "dtype": jdt, **extra})
    cfg_t = dataclasses.replace(ttr.tiny_config(), dtype=tdt, **extra)
    js = JaxStore(cfg_j, jengine, str(tmp_path / "j.kvstore"), PAGE,
                  1 << 20)
    ts = PrefixStore(cfg_t, engine, str(tmp_path / "t.kvstore"), PAGE,
                     1 << 20)
    tokens = np.random.default_rng(3).integers(0, 128, 23).tolist()
    assert ts.page_bytes == js.page_bytes
    assert ts.chain_keys(tokens) == js.chain_keys(tokens)
    assert len(ts.chain_keys(tokens)) == (23 - 1) // PAGE
    assert ts.chain_keys(tokens[:PAGE]) == []
    js.close()
    ts.close()


#: the first key of chain 0..PAGE under tiny_config in float32
PINNED_KEY = "a414a5fac830da505106335843d4a30d8203af93"


def test_chain_keys_pinned(tmp_path, engine):
    """The first key of a fixed chain, pinned: a change to the seed's
    fields or their spelling shows here as well as against JAX."""
    cfg = dataclasses.replace(ttr.tiny_config(), dtype=torch.float32)
    ts = PrefixStore(cfg, engine, str(tmp_path / "t.kvstore"), PAGE, 1 << 20)
    assert ts.chain_keys(list(range(PAGE + 1)))[0].hex() == PINNED_KEY
    ts.close()


# -- cross-format: each package restores the other's store -----------------

def _pages(cfg_t, n, seed, bf16):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k, v = (rng.standard_normal(_shape(cfg_t)).astype(np.float32)
                for _ in range(2))
        if bf16:
            k, v = k.astype(ml_dtypes.bfloat16), v.astype(ml_dtypes.bfloat16)
        out.append((k, v))
    return out


def _as_np(t, bf16):
    a = t.contiguous().view(torch.int16 if bf16 else torch.float32).numpy()
    return a.view(ml_dtypes.bfloat16) if bf16 else a


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_stores_restore_each_others_pages(tmp_path, engine, jengine, bf16,
                                          writer):
    """One package writes pages and flushes a clean manifest; a new
    store of the other reattaches it and restores every page bitwise."""
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                             torch.float32)
    cfg_j = jtr.TransformerConfig(**{**jtr.tiny_config().__dict__,
                                     "dtype": jdt})
    cfg_t = dataclasses.replace(ttr.tiny_config(), dtype=tdt)
    path = str(tmp_path / "x.kvstore")
    pages = _pages(cfg_t, 3, 5, bf16)
    tokens = list(range(3 * PAGE + 1))
    w = (JaxStore(cfg_j, jengine, path, PAGE, 1 << 20) if writer == "jax"
         else PrefixStore(cfg_t, engine, path, PAGE, 1 << 20))
    keys = w.chain_keys(tokens)
    if writer == "jax":
        w.put([(kx, k, v) for kx, (k, v) in zip(keys, pages)])
    else:
        w.put([(kx, torch.from_numpy(k.view(np.int16)).view(tdt) if bf16
                else torch.from_numpy(k),
                torch.from_numpy(v.view(np.int16)).view(tdt) if bf16
                else torch.from_numpy(v))
               for kx, (k, v) in zip(keys, pages)])
    w.close()
    if writer == "jax":
        r = PrefixStore(cfg_t, engine, path, PAGE, 1 << 20)
        assert r.match(keys) == 3
        got = _restore_cpu(r, keys)
        assert sorted(got) == [0, 1, 2]
        for i, (k, v) in enumerate(pages):
            assert got[i][0].dtype == tdt and got[i][0].shape == _shape(cfg_t)
            assert _as_np(got[i][0], bf16).tobytes() == k.tobytes()
            assert _as_np(got[i][1], bf16).tobytes() == v.tobytes()
    else:
        r = JaxStore(cfg_j, jengine, path, PAGE, 1 << 20)
        assert r.match(keys) == 3
        got = r.restore_many({0: (0, keys)})[0]
        for i, (k, v) in enumerate(pages):
            assert np.asarray(got[i][0]).tobytes() == k.tobytes()
            assert np.asarray(got[i][1]).tobytes() == v.tobytes()
    r.close()


def test_jax_scrub_checks_a_store_the_port_wrote(tmp_path, engine, capsys):
    """The JAX strom-scrub reads the port's page file and manifest: no
    damage on a clean store, and exactly the page with a flipped byte."""
    from nvme_strom_tpu.tools import strom_scrub
    cfg = dataclasses.replace(ttr.tiny_config(), dtype=torch.float32)
    path = str(tmp_path / "serve.kvstore")
    store = PrefixStore(cfg, engine, path, PAGE, 1 << 20)
    for i, kx in enumerate(store.chain_keys(list(range(13)))):
        page = np.full(_shape(cfg), float(i + 1), np.float32)
        store.put([(kx, page, page)])
    store.close()
    assert strom_scrub.main([str(tmp_path), "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["damage"] == [] and rep["files_scanned"] >= 1
    assert rep["bytes_verified"] >= 3 * store.page_bytes
    with open(path, "r+b") as f:
        f.seek(store.page_bytes + 7)
        b = f.read(1)
        f.seek(store.page_bytes + 7)
        f.write(bytes([b[0] ^ 0x01]))
    assert strom_scrub.main([path, "--json"]) == 1
    rep = json.loads(capsys.readouterr().out)
    assert [d["page"] for d in rep["damage"]] == [1]
    assert "crc32c" in rep["damage"][0]["error"]


# -- the servers against the JAX servers ------------------------------------

def _requests(vocab, seed):
    rng = np.random.default_rng(seed)
    sys_a = rng.integers(0, vocab, 3 * PAGE).tolist()
    sys_b = rng.integers(0, vocab, 2 * PAGE).tolist()
    return [(f"r{i}", (sys_a if i % 2 else sys_b)
             + rng.integers(0, vocab, 1 + (3 * i) % 7).tolist(), 5)
            for i in range(6)]


def _serve(srv, reqs):
    for rid, p, m in reqs:
        srv.submit(rid, p, m)
    return srv.run()


def _counters(stats):
    return {k: int(getattr(stats, k)) for k in KV_COUNTERS}


@pytest.mark.parametrize("kind", ["dense", "paged", "paged no HBM cache"])
def test_tokens_and_counters_match_jax_servers(setup, tmp_path, engine,
                                               jengine, kind):
    """The same requests through the JAX servers over a JAX store and the
    port's over a port store, in three rounds: a server over the empty
    store, a second request wave on it, and a fresh server over the warm
    store.  Greedy tokens and every store counter agree each round, and
    every round equals the store-less server's tokens."""
    cfg_j, cfg_t, pj, pt = setup
    reqs = _requests(cfg_t.vocab, 7)

    def make(pkg, store):
        if kind == "dense":
            return (JaxDense(pj, cfg_j, 2, 64, kv_store=store)
                    if pkg == "jax" else
                    DecodeServer(pt, cfg_t, 2, 64, device="cpu",
                                 kv_store=store))
        pc = kind == "paged"
        return (JaxPaged(pj, cfg_j, 2, 64, total_blocks=24, block_len=PAGE,
                         prefix_cache=pc, kv_store=store)
                if pkg == "jax" else
                PagedDecodeServer(pt, cfg_t, 2, 64, total_blocks=24,
                                  block_len=PAGE, prefix_cache=pc,
                                  device="cpu", kv_store=store))

    plain = _serve(DecodeServer(pt, cfg_t, 2, 64, device="cpu"), reqs)
    js = JaxStore(cfg_j, jengine, str(tmp_path / "j.kvstore"), PAGE,
                  64 * _page_bytes(cfg_t))
    ts = _store(cfg_t, engine, tmp_path, "t.kvstore")
    jsrv, tsrv = make("jax", js), make("port", ts)
    for wave in (reqs[:3], reqs[3:]):
        assert _serve(tsrv, wave) == _serve(jsrv, wave)
        assert _counters(engine.stats) == _counters(jengine.stats)
    assert _serve(make("port", ts), reqs) == _serve(make("jax", js), reqs) \
        == plain
    assert _counters(engine.stats) == _counters(jengine.stats)
    assert engine.stats.kv_pages_restored > 0
    assert tsrv.stats()["kv_pages_written"] == engine.stats.kv_pages_written
    js.close()
    ts.close()


# -- mirrors of tests/test_kvserve.py's store cases --------------------------

def test_cross_session_dedupe_same_prefix_written_once(setup, engine,
                                                       tmp_path):
    """Sessions sharing a system prompt write its pages once; later
    admissions on the same server and on another one (paged) restore
    them, and every output is the JAX package's."""
    cfg_j, cfg, pj, pt = setup
    stats = engine.stats
    sys_prompt = np.random.default_rng(0).integers(
        0, cfg.vocab, 3 * PAGE).tolist()
    store = _store(cfg, engine, tmp_path)
    srv = DecodeServer(pt, cfg, 2, 64, device="cpu", kv_store=store)
    srv.submit("a", sys_prompt + [7, 8], 5)
    out_a = srv.run()["a"]
    assert stats.kv_pages_written == 3 and stats.kv_prefix_hits == 0
    srv.submit("b", sys_prompt + [9], 5)
    out_b = srv.run()["b"]
    assert stats.kv_pages_written == 3
    assert stats.kv_prefix_hits == 3 and stats.kv_pages_restored == 3
    srv2 = PagedDecodeServer(pt, cfg, 2, 64, total_blocks=16,
                             block_len=PAGE, device="cpu", kv_store=store)
    srv2.submit("c", sys_prompt + [11, 12], 5)
    out_c = srv2.run()["c"]
    assert stats.kv_pages_written == 3 and stats.kv_prefix_hits == 6
    assert out_a == _solo(pj, cfg_j, sys_prompt + [7, 8], 5)
    assert out_b == _solo(pj, cfg_j, sys_prompt + [9], 5)
    assert out_c == _solo(pj, cfg_j, sys_prompt + [11, 12], 5)
    store.close()


def test_dedupe_counts_on_explicit_double_put(setup, engine, tmp_path):
    cfg = setup[1]
    store = _store(cfg, engine, tmp_path)
    k = np.zeros(_shape(cfg), np.float32)
    keys = store.chain_keys(list(range(PAGE + 1)))
    assert store.put([(keys[0], k, k)]) == 1
    assert store.put([(keys[0], k, k)]) == 0
    assert engine.stats.kv_pages_deduped == 1
    assert engine.stats.kv_bytes_saved == store.page_bytes
    store.close()


def test_eviction_under_pressure_keeps_hottest_prefix(setup, engine,
                                                      tmp_path):
    """A full store evicts the lowest benefit score: the page restored
    three times survives, the one never restored goes."""
    cfg = setup[1]
    store = _store(cfg, engine, tmp_path, pages=2)
    assert store.capacity_pages == 2
    k = np.zeros(_shape(cfg), np.float32)
    key_a, key_b, key_c = (store.chain_keys([t] * (PAGE + 1))[0]
                           for t in (1, 2, 3))
    store.put([(key_a, k, k), (key_b, k, k)])
    store.flush()
    for _ in range(3):
        assert 0 in _restore_cpu(store, [key_a])
    store.put([(key_c, k, k)])
    assert engine.stats.kv_store_evictions == 1
    assert store.match([key_a]) == 1
    assert store.match([key_b]) == 0
    assert store.match([key_c]) == 1
    store.close()


def test_kv_prefix_env_off_is_bit_for_bit_per_session(setup, engine,
                                                      tmp_path,
                                                      monkeypatch):
    """STROM_KV_PREFIX unset or 0: no store, no store I/O or counters,
    and the tokens of a plain server; 1 builds a store with the page
    size asked for."""
    cfg_j, cfg, pj, pt = setup
    monkeypatch.delenv("STROM_KV_PREFIX", raising=False)
    assert build_prefix_store(cfg, engine, str(tmp_path / "x.kvstore"),
                              page_tokens=PAGE) is None
    monkeypatch.setenv("STROM_KV_PREFIX", "0")
    assert build_prefix_store(cfg, engine, str(tmp_path / "x.kvstore"),
                              page_tokens=PAGE) is None
    prompt = np.random.default_rng(9).integers(0, cfg.vocab, 11).tolist()
    srv = DecodeServer(pt, cfg, 1, 64, device="cpu", kv_store=None)
    srv.submit("p", prompt, 6)
    assert srv.run()["p"] == _solo(pj, cfg_j, prompt, 6)
    assert all(v == 0 for k, v in engine.stats.snapshot().items()
               if k.startswith("kv_"))
    assert not any(k.startswith("kv_") for k in srv.stats())
    assert not os.path.exists(tmp_path / "x.kvstore")
    monkeypatch.setenv("STROM_KV_PREFIX", "1")
    st = build_prefix_store(cfg, engine, str(tmp_path / "y.kvstore"),
                            page_tokens=PAGE)
    assert st is not None and st.page_tokens == PAGE
    st.close()
    monkeypatch.setenv("STROM_KV_STORE_MB", "0")
    assert build_prefix_store(cfg, engine, str(tmp_path / "z.kvstore"),
                              page_tokens=PAGE) is None


def test_batched_multi_request_restore_single_step(setup, engine, tmp_path,
                                                   monkeypatch):
    """Two same-prefix requests admitted in one step: one plan_and_submit
    reads both slots' pages, each page once (the planner merges the
    duplicate extents) and copied once; both outputs are the JAX
    package's."""
    cfg_j, cfg, pj, pt = setup
    stats = engine.stats
    sys_prompt = np.random.default_rng(13).integers(
        0, cfg.vocab, 2 * PAGE).tolist()
    store = _store(cfg, engine, tmp_path)
    seed = DecodeServer(pt, cfg, 1, 64, device="cpu", kv_store=store)
    seed.submit("seed", sys_prompt + [5], 2)
    seed.run()
    assert stats.kv_pages_written == 2
    calls = []
    real = kv_offload.plan_and_submit

    def counting(eng, extents, **kw):
        calls.append(len(extents))
        return real(eng, extents, **kw)

    monkeypatch.setattr(kv_offload, "plan_and_submit", counting)
    submitted0 = engine.sync_stats()["requests_submitted"]
    copies0 = store.copies
    srv = DecodeServer(pt, cfg, 2, 64, device="cpu", kv_store=store)
    reqs = {"x": sys_prompt + [6, 7], "y": sys_prompt + [8]}
    for rid, p in reqs.items():
        srv.submit(rid, p, 5)
    out = srv.run()
    assert calls == [4]                         # both slots, one batch
    assert stats.kv_pages_restored == 4
    assert engine.sync_stats()["requests_submitted"] - submitted0 <= 2
    assert store.copies - copies0 == 2          # each page copied once
    for rid, p in reqs.items():
        assert out[rid] == _solo(pj, cfg_j, p, 5), rid
    store.close()


def test_restore_heals_through_recompute_on_corruption(setup, engine,
                                                       tmp_path,
                                                       monkeypatch):
    """A corrupted page under STROM_VERIFY=full drops its entry and the
    admission recomputes it: exact tokens, and the page is rewritten and
    restores cleanly next time."""
    cfg_j, cfg, pj, pt = setup
    monkeypatch.setenv("STROM_VERIFY", "full")
    sys_prompt = np.random.default_rng(21).integers(
        0, cfg.vocab, 2 * PAGE).tolist()
    store = _store(cfg, engine, tmp_path)
    srv = DecodeServer(pt, cfg, 1, 64, device="cpu", kv_store=store)
    srv.submit("a", sys_prompt + [3], 4)
    srv.run()
    store.flush()
    with open(store.path, "r+b") as f:
        f.seek(17)
        b = f.read(1)
        f.seek(17)
        f.write(bytes([b[0] ^ 0xFF]))
    srv.submit("b", sys_prompt + [4], 4)
    assert srv.run()["b"] == _solo(pj, cfg_j, sys_prompt + [4], 4)
    assert engine.stats.checksum_failures >= 1
    assert engine.stats.kv_restore_failures >= 1
    assert engine.stats.bytes_verified >= store.page_bytes
    written = engine.stats.kv_pages_written
    assert written == 3                         # page 0 rewritten
    srv.submit("c", sys_prompt + [5], 4)
    assert srv.run()["c"] == _solo(pj, cfg_j, sys_prompt + [5], 4)
    assert engine.stats.checksum_failures == 1
    store.close()


def test_prefix_store_survives_process_restart(setup, engine, tmp_path):
    """A new store instance on the same path reattaches the clean
    manifest: the next session restores instead of recomputing."""
    cfg_j, cfg, pj, pt = setup
    sys_prompt = np.random.default_rng(31).integers(
        0, cfg.vocab, 2 * PAGE).tolist()
    store = _store(cfg, engine, tmp_path)
    srv = DecodeServer(pt, cfg, 1, 64, device="cpu", kv_store=store)
    srv.submit("a", sys_prompt + [1], 4)
    srv.run()
    store.close()
    written = engine.stats.kv_pages_written
    store2 = _store(cfg, engine, tmp_path)
    srv2 = DecodeServer(pt, cfg, 1, 64, device="cpu", kv_store=store2)
    srv2.submit("b", sys_prompt + [2], 4)
    assert srv2.run()["b"] == _solo(pj, cfg_j, sys_prompt + [2], 4)
    assert engine.stats.kv_pages_written == written
    assert engine.stats.kv_pages_restored >= 2
    store2.close()


@pytest.mark.parametrize("content", [
    "{not json", json.dumps({"version": 1, "page_bytes": 1, "clean": True}),
    json.dumps({"version": 1, "clean": False}),
    json.dumps({"version": 1, "page_bytes": None, "pages": {"x": 1}})])
def test_malformed_or_unclean_manifest_starts_empty(setup, engine, tmp_path,
                                                    content):
    cfg = setup[1]
    path = tmp_path / "prefix.kvstore"
    (tmp_path / "prefix.kvstore.kvman.json").write_text(content)
    store = _store(cfg, engine, tmp_path)
    assert store.pages_resident() == 0
    assert len(store._free) == store.capacity_pages
    assert os.path.exists(path)
    store.close()


def test_paged_store_page_size_must_equal_block_len(setup, engine,
                                                    tmp_path):
    cfg, pt = setup[1], setup[3]
    store = _store(cfg, engine, tmp_path)
    with pytest.raises(ValueError, match="block_len"):
        PagedDecodeServer(pt, cfg, 1, 64, total_blocks=8,
                          block_len=2 * PAGE, device="cpu", kv_store=store)
    store.close()


def test_warm_pages_reads_the_hottest_resident_pages(setup, engine,
                                                     tmp_path):
    cfg = setup[1]
    store = _store(cfg, engine, tmp_path)
    k = np.zeros(_shape(cfg), np.float32)
    keys = [store.chain_keys([t] * (PAGE + 1))[0] for t in range(1, 5)]
    store.put([(kx, k, k) for kx in keys])
    assert store.warm_pages(budget_pages=0) == 0
    assert store.warm_pages(budget_pages=3) == 3
    assert store.warm_pages() == 4
    assert all(e["pins"] == 0 for e in store._entries.values())
    store.close()
    assert store.warm_pages() == 0


# -- flush and close under concurrency ---------------------------------------

def test_flush_clean_manifest_covers_racing_put(setup, engine, tmp_path):
    """A put() racing flush()'s drain appends its batch and turns ready
    while the drainer waits; the drain loops until the pipeline is empty
    and the clean manifest stamps both pages."""
    cfg = setup[1]
    store = _store(cfg, engine, tmp_path)
    k = np.zeros(_shape(cfg), np.float32)
    key_a = store.chain_keys([1] * (PAGE + 1))[0]
    key_b = store.chain_keys([2] * (PAGE + 1))[0]
    store.put([(key_a, k, k)])

    class _RacingPend:
        def __init__(self, inner):
            self._inner = inner

        def wait(self):
            if not getattr(self, "fired", False):
                self.fired = True
                store.put([(key_b, k, k)])
            return self._inner.wait()

    with store._wlock:
        store._pending_writes[0] = [_RacingPend(p)
                                    for p in store._pending_writes[0]]
    store.flush()
    with store._wlock:
        assert store._pending_writes == []
    with open(store.manifest_path) as f:
        man = json.load(f)
    assert man["clean"]
    stamped = {v["key"] for v in man["pages"].values()}
    assert key_a.hex() in stamped and key_b.hex() in stamped
    store.close()


def test_flush_bounded_rounds_terminate_under_sustained_puts(
        setup, engine, tmp_path):
    """A put storm that refills the pipeline every round cannot pin
    flush(): it exits by its round bound and stamps only the final
    round's pre-drain snapshot."""
    cfg = setup[1]
    store = _store(cfg, engine, tmp_path)
    k = np.zeros(_shape(cfg), np.float32)
    keys = [store.chain_keys([t] * (PAGE + 1))[0] for t in range(1, 12)]
    store.put([(keys[0], k, k)])
    fired = []

    class _Refill:
        def __init__(self, inner):
            self._inner = inner

        def wait(self):
            if not getattr(self, "done", False):
                self.done = True
                if len(fired) + 1 < len(keys):
                    nxt = keys[len(fired) + 1]
                    if store.put([(nxt, k, k)]):
                        with store._wlock:
                            store._pending_writes[-1] = [
                                _Refill(p)
                                for p in store._pending_writes[-1]]
                        fired.append(nxt)
            return self._inner.wait()

    with store._wlock:
        store._pending_writes[0] = [_Refill(p)
                                    for p in store._pending_writes[0]]
    store.flush()
    with open(store.manifest_path) as f:
        man = json.load(f)
    assert man["clean"]
    stamped = {v["key"] for v in man["pages"].values()}
    assert keys[0].hex() in stamped
    assert len(fired) >= 8
    assert fired[-1].hex() not in stamped
    store.close()
    with store._wlock:
        assert store._pending_writes == []
    assert store.put([(keys[-1], k, k)]) == 0


def test_close_waits_for_inflight_put(setup, engine, tmp_path):
    """close() waits for a put() that won the gate before it closes the
    file, so the put never submits against a closed handle."""
    cfg = setup[1]
    store = _store(cfg, engine, tmp_path)
    k = np.zeros(_shape(cfg), np.float32)
    key = store.chain_keys([1] * (PAGE + 1))[0]
    gate = threading.Event()
    real = store.engine.submit_write

    def slow_submit(*a, **kw):
        gate.wait(5)
        return real(*a, **kw)

    store.engine.submit_write = slow_submit
    errs = []

    def putter():
        try:
            store.put([(key, k, k)])
        except Exception as e:
            errs.append(repr(e))

    t = threading.Thread(target=putter)
    t.start()
    time.sleep(0.05)
    closer = threading.Thread(target=store.close)
    closer.start()
    time.sleep(0.1)
    assert closer.is_alive()
    gate.set()
    t.join(5)
    closer.join(5)
    del store.engine.submit_write
    assert not errs, errs
    assert not t.is_alive() and not closer.is_alive()
    assert store._fh is None


def test_reentrant_put_during_drain_skips_backpressure(setup, engine,
                                                       tmp_path):
    """A put() re-entered from the active drain's own wait() is the
    drainer: past the backlog cap it skips the backpressure acquire
    instead of deadlocking on its own lock."""
    cfg = setup[1]
    store = _store(cfg, engine, tmp_path)
    k = np.zeros(_shape(cfg), np.float32)

    class _ReentrantPend:
        def __init__(self, t):
            self.t = t

        def wait(self):
            store.put([(store.chain_keys([self.t] * (PAGE + 1))[0], k, k)])

    with store._wlock:
        for t in range(3 * store._MAX_PENDING):
            store._pending_writes.append([_ReentrantPend(100 + t)])
    done = threading.Event()

    def flusher():
        store.flush()
        done.set()

    th = threading.Thread(target=flusher, daemon=True)
    th.start()
    assert done.wait(30), "flush deadlocked on its own drain lock"
    th.join(5)
    store.close()


def test_close_gates_restore_many(setup, engine, tmp_path):
    """A closed store's restore_many returns {} (the caller recomputes)
    instead of reading from a closed file."""
    cfg = setup[1]
    store = _store(cfg, engine, tmp_path)
    k = np.zeros(_shape(cfg), np.float32)
    key = store.chain_keys([1] * (PAGE + 1))[0]
    store.put([(key, k, k)])
    store.close()
    assert store.restore_many({0: (0, [key])}, device="cpu") == {}
