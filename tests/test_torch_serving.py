"""The port's continuous-batching servers (nvme_strom_tpu_torch/models/
serving.py) against the JAX package's DecodeServer on the JAX
parameters (tiny_config, float32): greedy tokens must be identical under
mixed lengths, staggered admission, slot recycling, EOS, lookahead and
prefix-cache reuse.  Sampled runs must reproduce within the port."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvme_strom_tpu.models import transformer as jtr
from nvme_strom_tpu.models.serving import DecodeServer as JaxServer
from nvme_strom_tpu_torch.convert import params_from_jax
from nvme_strom_tpu_torch.models import transformer as ttr
from nvme_strom_tpu_torch.models.serving import (DecodeServer,
                                                 PagedDecodeServer)


@pytest.fixture(scope="module")
def setup():
    cfg_j = jtr.TransformerConfig(**{**jtr.tiny_config().__dict__,
                                     "dtype": jnp.float32})
    cfg_t = dataclasses.replace(ttr.tiny_config(), dtype=torch.float32)
    pj = jtr.init_params(jax.random.key(0), cfg_j)
    pt = params_from_jax({k: np.asarray(v) for k, v in pj.items()}, cfg_t,
                         "cpu")
    return cfg_j, cfg_t, pj, pt


def _drive(srv, first, later, arrive_at=(2, 4, 6), lookahead=1):
    """Submit ``first``, then one of ``later`` at each step count in
    ``arrive_at`` (staggered admission); step until everything is
    done.  Requests are (rid, prompt, max_new, eos_id)."""
    for rid, p, m, eos in first:
        srv.submit(rid, p, m, eos_id=eos)
    later = list(later)
    got, steps = {}, 0
    while later or not srv.idle:
        got.update(srv.step_many(lookahead))
        steps += 1
        if later and steps in arrive_at:
            rid, p, m, eos = later.pop(0)
            srv.submit(rid, p, m, eos_id=eos)
        if srv.idle and later:
            rid, p, m, eos = later.pop(0)
            srv.submit(rid, p, m, eos_id=eos)
        assert steps < 500
    return got


def _requests(cfg, seed, lengths, budgets):
    rng = np.random.default_rng(seed)
    return [(f"q{i}", rng.integers(0, cfg.vocab, n).tolist(), m, None)
            for i, (n, m) in enumerate(zip(lengths, budgets))]


@pytest.fixture(scope="module")
def mixed(setup):
    """Five requests over two slots, one stopping at an EOS, served by
    the JAX server: the reference tokens."""
    cfg_j, _, pj, _ = setup
    reqs = _requests(cfg_j, 1, [5, 9, 3, 12, 7], [12, 7, 15, 6, 9])
    probe = _drive(JaxServer(pj, cfg_j, max_batch=2, max_len=64),
                   reqs[:1], [])
    rid, p, m, _ = reqs[0]
    reqs[0] = (rid, p, m, probe[rid][4])          # stops at token 5
    want = _drive(JaxServer(pj, cfg_j, max_batch=2, max_len=64), reqs[:2],
                  reqs[2:])
    assert len(want["q0"]) <= 5
    return reqs, want


@pytest.mark.parametrize("lookahead", [1, 4])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_greedy_tokens_match_jax_server(setup, mixed, paged, lookahead):
    _, cfg_t, _, pt = setup
    reqs, want = mixed
    srv = (PagedDecodeServer(pt, cfg_t, max_batch=2, max_len=64,
                             total_blocks=12, block_len=8, device="cpu")
           if paged else
           DecodeServer(pt, cfg_t, max_batch=2, max_len=64, device="cpu"))
    got = _drive(srv, reqs[:2], reqs[2:], lookahead=lookahead)
    assert got == want
    s = srv.stats()
    assert s["requests_finished"] == 5 and s["slots_busy"] == 0
    assert set(srv.request_metrics) == set(want)
    assert all(m["ttft_ms"] > 0 for m in srv.request_metrics.values())


def test_prefix_cache_reuse_matches_jax(setup):
    """Prompts sharing two full blocks: later requests reuse the cached
    blocks and prefill only their suffix, with the JAX server's
    tokens."""
    cfg_j, cfg_t, pj, pt = setup
    rng = np.random.default_rng(9)
    common = rng.integers(0, cfg_t.vocab, 16).tolist()
    reqs = [(f"p{i}", common + rng.integers(0, cfg_t.vocab, 3 + i).tolist(),
             6, None) for i in range(4)]
    want = _drive(JaxServer(pj, cfg_j, max_batch=2, max_len=64), reqs[:1],
                  reqs[1:])
    srv = PagedDecodeServer(pt, cfg_t, max_batch=2, max_len=64,
                            total_blocks=12, block_len=8, device="cpu")
    got = _drive(srv, reqs[:1], reqs[1:])
    assert got == want
    s = srv.stats()
    assert s["prefix_hits"] >= 2 and s["prefix_shared_blocks"] >= 4


def test_paged_pool_waits_then_admits(setup):
    """A pool too small for two worst cases at once serves them one
    after the other; one that can never fit raises instead of
    spinning."""
    _, cfg_t, _, pt = setup
    reqs = _requests(cfg_t, 4, [10, 11], [14, 13])
    srv = PagedDecodeServer(pt, cfg_t, max_batch=2, max_len=64,
                            total_blocks=3, block_len=8,
                            prefix_cache=False, device="cpu")
    ref = DecodeServer(pt, cfg_t, max_batch=2, max_len=64, device="cpu")
    assert _drive(srv, reqs, []) == _drive(ref, reqs, [])
    srv.submit("huge", list(range(30)), 2)
    with pytest.raises(RuntimeError, match="cannot ever be admitted"):
        srv.run()


def test_sampled_runs_reproduce_in_the_port(setup):
    _, cfg_t, _, pt = setup
    reqs = _requests(cfg_t, 2, [6, 9, 4], [10, 8, 12])

    def run(seed0, paged=False):
        srv = (PagedDecodeServer(pt, cfg_t, 3, 64, total_blocks=12,
                                 block_len=8, device="cpu") if paged
               else DecodeServer(pt, cfg_t, 3, 64, device="cpu"))
        for i, (rid, p, m, _) in enumerate(reqs):
            # request 2 stays greedy inside a sampled batch
            srv.submit(rid, p, m, temperature=0.0 if i == 2 else 0.9,
                       top_p=0.95, seed=seed0 + i)
        return srv.run(lookahead=3)

    a, b, c = run(11), run(11), run(12)
    assert a == b
    assert a != c
    assert run(11, paged=True) == a
    greedy = DecodeServer(pt, cfg_t, 1, 64, device="cpu")
    greedy.submit("g", reqs[2][1], reqs[2][2])
    assert greedy.run()["g"] == a["q2"]


def test_submit_validation(setup):
    _, cfg_t, _, pt = setup
    srv = DecodeServer(pt, cfg_t, 1, 16, device="cpu")
    for kw, match in [({"prompt_ids": []}, "empty"),
                      ({"max_new": 0}, "max_new"),
                      ({"temperature": -1.0}, "temperature"),
                      ({"top_p": 0.0}, "top_p"),
                      ({"max_new": 20}, "exceeds")]:
        args = {"rid": "x", "prompt_ids": [1, 2], "max_new": 2, **kw}
        with pytest.raises(ValueError, match=match):
            srv.submit(**args)
    srv.submit("x", [1, 2], 2)
    with pytest.raises(ValueError, match="already in flight"):
        srv.submit("x", [3], 1)
    with pytest.raises(ValueError, match="is on meta"):
        DecodeServer({k: v.to("meta") for k, v in pt.items()}, cfg_t, 1,
                     16, device="cpu")


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_gqa_group_of_7_matches_jax_server(paged):
    """A Qwen2-style GQA group of 7 (14 query heads over 2 kv heads,
    head_dim 8): the port's servers give the JAX server's greedy
    tokens."""
    cfg_j = jtr.TransformerConfig(**{**jtr.tiny_config().__dict__,
                                     "d_model": 112, "n_heads": 14,
                                     "n_kv_heads": 2,
                                     "dtype": jnp.float32})
    cfg_t = dataclasses.replace(ttr.tiny_config(), d_model=112, n_heads=14,
                                n_kv_heads=2, dtype=torch.float32)
    pj = jtr.init_params(jax.random.key(3), cfg_j)
    pt = params_from_jax({k: np.asarray(v) for k, v in pj.items()}, cfg_t,
                         "cpu")
    reqs = _requests(cfg_t, 7, [6, 11, 4], [9, 5, 8])
    want = _drive(JaxServer(pj, cfg_j, max_batch=2, max_len=64), reqs[:2],
                  reqs[2:])
    srv = (PagedDecodeServer(pt, cfg_t, max_batch=2, max_len=64,
                             total_blocks=12, block_len=8, device="cpu")
           if paged else
           DecodeServer(pt, cfg_t, max_batch=2, max_len=64, device="cpu"))
    assert _drive(srv, reqs[:2], reqs[2:]) == want
