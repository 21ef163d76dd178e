"""Speculative decoding in the port (nvme_strom_tpu_torch/models/
speculative.py) held against the JAX package: the cases of
tests/test_speculative.py, with float32 JAX parameters carried across
(``convert.params_from_jax``), so the greedy tokens must equal the JAX
``speculative_generate``'s and ``decode.generate``'s exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvme_strom_tpu.models import decode as jax_dec
from nvme_strom_tpu.models import speculative as jax_spec
from nvme_strom_tpu.models.transformer import TransformerConfig
from nvme_strom_tpu.models.transformer import init_params as jax_init
from nvme_strom_tpu.models.transformer import tiny_config as jax_tiny
from nvme_strom_tpu_torch.convert import params_from_jax
from nvme_strom_tpu_torch.models import decode as dec
from nvme_strom_tpu_torch.models.speculative import (SpecStats,
                                                     speculative_generate,
                                                     speculative_sample)
from nvme_strom_tpu_torch.models.transformer import tiny_config


def _port(params, cfg):
    return params_from_jax({k: np.asarray(v) for k, v in params.items()},
                           cfg, "cpu")


@pytest.fixture(scope="module")
def setup():
    jcfg = TransformerConfig(**{**jax_tiny().__dict__,
                                "dtype": jnp.float32})
    cfg = dataclasses.replace(tiny_config(), dtype=torch.float32)
    jtarget = jax_init(jax.random.key(0), jcfg)
    jdraft = jax_init(jax.random.key(7), jcfg)
    jprompt = jax.random.randint(jax.random.key(1), (1, 8), 0, jcfg.vocab)
    want = np.asarray(jax_dec.generate(jtarget, jprompt, jcfg, 24))
    return dict(jcfg=jcfg, cfg=cfg, jtarget=jtarget, jdraft=jdraft,
                jprompt=jprompt, want=want,
                target=_port(jtarget, cfg), draft=_port(jdraft, cfg),
                prompt=torch.from_numpy(np.array(jprompt)))


def test_target_greedy_matches_jax(setup):
    """The port's own greedy decode of the carried target is the JAX
    one's: the reference every case below compares with."""
    s = setup
    got = dec.generate(s["target"], s["prompt"], s["cfg"], 24).numpy()
    np.testing.assert_array_equal(got, s["want"])


def test_self_speculation_exact_and_efficient(setup):
    """Draft == target: every draft accepted, the tokens identical,
    ⌈23/4⌉ verify rounds + the prefill."""
    s = setup
    st = SpecStats()
    got = speculative_generate(s["target"], s["target"], s["prompt"],
                               s["cfg"], 24, k=4, stats=st).numpy()
    np.testing.assert_array_equal(got, s["want"])
    jst = jax_spec.SpecStats()
    jgot = np.asarray(jax_spec.speculative_generate(
        s["jtarget"], s["jtarget"], s["jprompt"], s["jcfg"], 24, k=4,
        stats=jst))
    np.testing.assert_array_equal(got, jgot)
    assert st.accept_rate == 1.0
    assert st.target_forwards <= 8
    assert dataclasses.asdict(st) == dataclasses.asdict(jst)


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_weak_draft_still_exact(setup, k):
    """A different draft changes only the cost: the tokens and the
    acceptance accounting are the JAX package's."""
    s = setup
    st = SpecStats()
    got = speculative_generate(s["draft"], s["target"], s["prompt"],
                               s["cfg"], 24, k=k, stats=st).numpy()
    np.testing.assert_array_equal(got, s["want"])
    jst = jax_spec.SpecStats()
    jgot = np.asarray(jax_spec.speculative_generate(
        s["jdraft"], s["jtarget"], s["jprompt"], s["jcfg"], 24, k=k,
        stats=jst))
    np.testing.assert_array_equal(got, jgot)
    assert dataclasses.asdict(st) == dataclasses.asdict(jst)
    assert st.drafted > 0
    assert st.target_forwards <= 24 + 1


def test_draft_on_the_decode_kernel_path_is_exact(setup):
    """``cache_attn`` swaps the draft steps' attention inner (the card's
    kernel 2; here its plain version): the tokens do not change."""
    from nvme_strom_tpu_torch.ops.decode_attention import decode_attention
    s = setup
    st = SpecStats()
    got = speculative_generate(s["draft"], s["target"], s["prompt"],
                               s["cfg"], 24, k=3, stats=st,
                               cache_attn=decode_attention).numpy()
    np.testing.assert_array_equal(got, s["want"])


def test_eos_padding(setup):
    """After eos the output pads, as ``decode.generate`` does."""
    s = setup
    eos = int(s["want"][0, 2])
    want = np.asarray(jax_dec.generate(s["jtarget"], s["jprompt"],
                                       s["jcfg"], 24, eos_id=eos))
    got = speculative_generate(s["target"], s["target"], s["prompt"],
                               s["cfg"], 24, k=4, eos_id=eos).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        dec.generate(s["target"], s["prompt"], s["cfg"], 24,
                     eos_id=eos).numpy(), want)


def test_validation(setup):
    s = setup
    with pytest.raises(ValueError, match="batch-1"):
        speculative_generate(s["target"], s["target"],
                             torch.zeros((2, 4), dtype=torch.int32),
                             s["cfg"], 8)
    with pytest.raises(ValueError, match="k must"):
        speculative_generate(s["target"], s["target"], s["prompt"],
                             s["cfg"], 8, k=0)
    with pytest.raises(ValueError, match="max_new_tokens"):
        speculative_generate(s["target"], s["target"], s["prompt"],
                             s["cfg"], 0)


def test_speculative_sample_self_draft_efficient_and_reproducible(setup):
    """Draft == target: near-total acceptance, the forward-count win,
    one seed reproduces exactly, another diverges."""
    s = setup
    st = SpecStats()
    a = speculative_sample(s["target"], s["target"], s["prompt"], s["cfg"],
                           24, temperature=0.8, k=4, seed=5,
                           stats=st).numpy()
    b = speculative_sample(s["target"], s["target"], s["prompt"], s["cfg"],
                           24, temperature=0.8, k=4, seed=5).numpy()
    np.testing.assert_array_equal(a, b)
    assert st.accept_rate >= 0.9
    assert st.target_forwards <= 8
    assert np.all((a >= 0) & (a < s["cfg"].vocab))
    c = speculative_sample(s["target"], s["target"], s["prompt"], s["cfg"],
                           24, temperature=0.8, k=4, seed=6).numpy()
    assert not np.array_equal(a, c)


def test_speculative_sample_matches_target_distribution(setup):
    """The rejection scheme's output law is the target's warped
    distribution: with a weak draft (the accept test really rejects),
    the second token's frequencies given the most common first token
    match the target's conditional from the port's own prefill within
    5 sigma."""
    s = setup
    cfg = s["cfg"]
    target = {**s["target"], "lm_head": s["target"]["lm_head"] * 6.0}
    draft = {**s["draft"], "lm_head": s["draft"]["lm_head"] * 6.0}
    temp = 1.2
    n = 400
    pairs = np.array([
        speculative_sample(draft, target, s["prompt"], cfg, 2,
                           temperature=temp, k=2, seed=i).numpy()[0]
        for i in range(n)])
    t0 = int(np.bincount(pairs[:, 0]).argmax())
    cond = pairs[pairs[:, 0] == t0, 1]
    m = cond.shape[0]
    assert m >= 40, f"conditioning token too rare ({m} samples)"
    ext = torch.cat([s["prompt"], torch.tensor([[t0]], dtype=torch.int32)],
                    dim=1)
    cache = dec.init_cache(cfg, 1, ext.shape[1] + 4)
    logits, _ = dec.prefill(target, ext, cfg, cache)
    p = torch.softmax(logits / temp, dim=-1)[0].numpy()
    counts = np.bincount(cond, minlength=cfg.vocab)
    for t in np.nonzero(p > 0.03)[0]:
        sd = np.sqrt(m * p[t] * (1 - p[t]))
        assert abs(counts[t] - m * p[t]) < 5 * sd + 1, (t, counts[t],
                                                         m * p[t])


def test_speculative_sample_validation(setup):
    s = setup
    with pytest.raises(ValueError, match="temperature"):
        speculative_sample(s["target"], s["target"], s["prompt"], s["cfg"],
                           4, temperature=0.0)
    with pytest.raises(ValueError, match="top_p"):
        speculative_sample(s["target"], s["target"], s["prompt"], s["cfg"],
                           4, temperature=1.0, top_p=0.0)
    with pytest.raises(ValueError, match="batch-1"):
        speculative_sample(s["target"], s["target"],
                           torch.zeros((2, 4), dtype=torch.int32), s["cfg"],
                           4, temperature=1.0)


def test_speculative_sample_top_p_stays_in_the_nucleus(setup):
    """With top_p every emitted token lies in its step's nucleus of the
    target (a token outside has probability 0 under the warped law):
    checked by replaying the target over the emitted prefix."""
    s = setup
    cfg = s["cfg"]
    out = speculative_sample(s["draft"], s["target"], s["prompt"], cfg, 8,
                             temperature=0.7, k=3, top_p=0.5,
                             seed=3).numpy()[0]
    ids = s["prompt"]
    for tok in out:
        cache = dec.init_cache(cfg, 1, ids.shape[1] + 1)
        logits, _ = dec.prefill(s["target"], ids, cfg, cache)
        kept = dec.nucleus_truncate(logits / 0.7, 0.5)[0]
        assert torch.isfinite(kept[int(tok)])
        ids = torch.cat([ids, torch.tensor([[int(tok)]],
                                           dtype=torch.int32)], dim=1)
