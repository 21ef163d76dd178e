"""The port's decoder (nvme_strom_tpu_torch/models/) against the JAX
package's on the JAX parameters carried over by ``params_from_jax``:
tiny_config at float32.  Logits agree to atol=1e-4 (float32 matmuls
summed in another order); greedy tokens are identical."""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from nvme_strom_tpu.models import decode as jdec
from nvme_strom_tpu.models import transformer as jtr
from nvme_strom_tpu.ops.decode_attention import make_decode_attn
from nvme_strom_tpu_torch.convert import params_from_jax
from nvme_strom_tpu_torch.models import decode as tdec
from nvme_strom_tpu_torch.models import transformer as ttr
from nvme_strom_tpu_torch.ops.decode_attention import decode_attention

TOL = 1e-4


def _configs(**kw):
    base = {**jtr.tiny_config().__dict__, "dtype": jnp.float32, **kw}
    cfg_j = jtr.TransformerConfig(**base)
    fields = {f.name for f in dataclasses.fields(ttr.TransformerConfig)}
    cfg_t = ttr.TransformerConfig(**{k: v for k, v in base.items()
                                     if k in fields and k != "dtype"},
                                  dtype=torch.float32)
    return cfg_j, cfg_t


def _setup(**kw):
    cfg_j, cfg_t = _configs(**kw)
    pj = jtr.init_params(jax.random.key(0), cfg_j)
    pt = params_from_jax({k: np.asarray(v) for k, v in pj.items()}, cfg_t,
                         "cpu")
    prompt = np.random.default_rng(0).integers(0, cfg_t.vocab, (2, 7))
    return cfg_j, cfg_t, pj, pt, prompt


@pytest.fixture(scope="module")
def setup():
    return _setup()


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_prefill_logits_and_cache(setup):
    cfg_j, cfg_t, pj, pt, prompt = setup
    want, cj = jdec.prefill(pj, jnp.asarray(prompt, jnp.int32), cfg_j,
                            jdec.init_cache(cfg_j, 2, 16))
    got, ct = tdec.prefill(pt, torch.from_numpy(prompt), cfg_t,
                           tdec.init_cache(cfg_t, 2, 16))
    _close(got, want)
    assert ct["pos"] == 7
    _close(ct["k"], cj["k"])
    _close(ct["v"], cj["v"])


@pytest.mark.parametrize("kernel", [False, True],
                         ids=["dense", "decode_attention"])
def test_decode_step_logits(setup, kernel):
    """Two decode steps after the prefill; the port's attention wrapper
    against the JAX Pallas kernel (interpret mode) or both dense
    paths."""
    cfg_j, cfg_t, pj, pt, prompt = setup
    cj = jdec.init_cache(cfg_j, 2, 16)
    ct = tdec.init_cache(cfg_t, 2, 16)
    lj, cj = jdec.prefill(pj, jnp.asarray(prompt, jnp.int32), cfg_j, cj)
    lt, ct = tdec.prefill(pt, torch.from_numpy(prompt), cfg_t, ct)
    tok = np.array(jnp.argmax(lj, -1))
    for _ in range(2):
        lj, cj = jdec.decode_step(pj, jnp.asarray(tok, jnp.int32), cfg_j,
                                  cj, make_decode_attn(interpret=True)
                                  if kernel else None)
        lt, ct = tdec.decode_step(pt, torch.from_numpy(tok), cfg_t, ct,
                                  decode_attention if kernel else None)
        _close(lt, lj)
        tok = np.array(jnp.argmax(lj, -1))
    _close(ct["k"], cj["k"])


def test_block_step_logits(setup):
    cfg_j, cfg_t, pj, pt, prompt = setup
    cj = jdec.init_cache(cfg_j, 2, 16)
    ct = tdec.init_cache(cfg_t, 2, 16)
    _, cj = jdec.prefill(pj, jnp.asarray(prompt[:, :4], jnp.int32), cfg_j,
                         cj)
    _, ct = tdec.prefill(pt, torch.from_numpy(prompt[:, :4]), cfg_t, ct)
    lj, _ = jdec.block_step(pj, jnp.asarray(prompt[:, 4:], jnp.int32),
                            cfg_j, cj)
    lt, ct = tdec.block_step(pt, torch.from_numpy(prompt[:, 4:]), cfg_t, ct)
    _close(lt, lj)
    assert ct["pos"] == 7


@pytest.mark.parametrize("eos", [None, "third"])
def test_greedy_generate_tokens_identical(setup, eos):
    cfg_j, cfg_t, pj, pt, prompt = setup
    want = np.asarray(jdec.generate(pj, jnp.asarray(prompt, jnp.int32),
                                    cfg_j, 10))
    eos_id = None if eos is None else int(want[0, 2])
    if eos_id is not None:
        want = np.asarray(jdec.generate(pj, jnp.asarray(prompt, jnp.int32),
                                        cfg_j, 10, eos_id=eos_id))
    got = tdec.generate(pt, torch.from_numpy(prompt), cfg_t, 10,
                        eos_id=eos_id)
    np.testing.assert_array_equal(got.numpy(), want)
    got_k = tdec.generate(pt, torch.from_numpy(prompt), cfg_t, 10,
                          eos_id=eos_id, cache_attn=decode_attention)
    np.testing.assert_array_equal(got_k.numpy(), want)


def test_llama3_rope_scaling_logits():
    scaling = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
               "high_freq_factor": 4.0,
               "original_max_position_embeddings": 16}
    cfg_j, cfg_t, pj, pt, prompt = _setup(rope_scaling=scaling,
                                          rope_theta=500000.0)
    want, _ = jdec.prefill(pj, jnp.asarray(prompt, jnp.int32), cfg_j,
                           jdec.init_cache(cfg_j, 2, 16))
    got, _ = tdec.prefill(pt, torch.from_numpy(prompt), cfg_t,
                          tdec.init_cache(cfg_t, 2, 16))
    _close(got, want)


def test_nucleus_truncate_matches_jax():
    logits = np.log(np.asarray([[0.5, 0.25, 0.15, 0.07, 0.03],
                                [0.1, 0.2, 0.3, 0.25, 0.15]], np.float32))
    for top_p in (0.6, 0.9, 1e-9):
        want = np.asarray(jdec.nucleus_truncate(jnp.asarray(logits), top_p))
        got = tdec.nucleus_truncate(torch.from_numpy(logits), top_p)
        np.testing.assert_array_equal(np.isinf(got.numpy()),
                                      np.isinf(want))
    per_row = tdec.nucleus_truncate(torch.from_numpy(logits),
                                    torch.tensor([0.6, 1.0]))
    assert np.isinf(per_row[0].numpy()).sum() == 3
    assert not np.isinf(per_row[1].numpy()).any()


def test_sampling_reproduces_with_a_generator(setup):
    _, cfg_t, _, pt, prompt = setup
    runs = [tdec.generate(pt, torch.from_numpy(prompt), cfg_t, 8,
                          temperature=0.9, top_p=0.9,
                          generator=torch.Generator().manual_seed(s))
            for s in (7, 7)]
    assert torch.equal(runs[0], runs[1])
    k1 = tdec.generate(pt, torch.from_numpy(prompt), cfg_t, 8,
                       temperature=0.7, top_k=1,
                       generator=torch.Generator().manual_seed(1))
    assert torch.equal(k1, tdec.generate(pt, torch.from_numpy(prompt),
                                         cfg_t, 8))


def test_params_from_jax_checks():
    _, cfg_t = _configs()
    good = {n: np.zeros(s, np.float32)
            for n, s in ttr.param_shapes(cfg_t).items()}
    with pytest.raises(KeyError, match="does not know"):
        params_from_jax({**good, "layers.0.w_extra": np.zeros(3)}, cfg_t,
                        "cpu")
    missing = dict(good)
    del missing["lm_head"]
    with pytest.raises(KeyError, match="missing"):
        params_from_jax(missing, cfg_t, "cpu")
    with pytest.raises(ValueError, match="shape"):
        params_from_jax({**good, "lm_head": np.zeros((3, 3), np.float32)},
                        cfg_t, "cpu")
    with pytest.raises(NotImplementedError, match="quantized"):
        params_from_jax({**good, "lm_head": {"q8": 0, "scale": 1}}, cfg_t,
                        "cpu")
    with pytest.raises(NotImplementedError, match="experts"):
        ttr.TransformerConfig(n_experts=4)
    # bf16 arrays carry over bit for bit; norms stay float32
    cfg16 = dataclasses.replace(cfg_t, dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    src = {n: rng.standard_normal(s).astype(ml_dtypes.bfloat16)
           for n, s in ttr.param_shapes(cfg16).items()}
    out = params_from_jax(src, cfg16, "cpu")
    assert out["lm_head"].dtype == torch.bfloat16
    assert out["final_norm"].dtype == torch.float32
    assert out["lm_head"].view(torch.int16).numpy().tobytes() == \
        src["lm_head"].tobytes()
