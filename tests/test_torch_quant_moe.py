"""Weight-only int8 / int4 quantization (nvme_strom_tpu_torch/models/
quant.py) and mixture-of-experts layers (models/moe.py) in the port,
held against the JAX package on the CPU with the same numpy weights: the
cases of tests/test_quant.py and tests/test_moe.py (expert and tensor
sharding wait for the port's multi-GPU slice, LoRA for its training
slice).

Quantized leaves must equal the JAX ones bit for bit; dequantized
weights exactly; logits within 2e-5 of the JAX forward in float32 and
within the JAX tests' rails (max-abs relative 0.05 for int8, 0.08 for
int8 MoE, 0.25 for int4) of the full-precision forward; routing tensors
exactly (aux to 1e-6); tokens equal."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvme_strom_tpu.models import decode as jdec
from nvme_strom_tpu.models import moe as jmoe
from nvme_strom_tpu.models import quant as jq
from nvme_strom_tpu.models import serving as jsrv
from nvme_strom_tpu.models import transformer as jtr
from nvme_strom_tpu_torch import generate as gen_main
from nvme_strom_tpu_torch.convert import params_from_jax
from nvme_strom_tpu_torch.models import decode as tdec
from nvme_strom_tpu_torch.models import moe as tmoe
from nvme_strom_tpu_torch.models import quant as tq
from nvme_strom_tpu_torch.models import serving as tsrv
from nvme_strom_tpu_torch.models import transformer as ttr
from nvme_strom_tpu_torch.parallel.weights import save_checkpoint

CPU = torch.device("cpu")
ATOL = 2e-5


def _cfgs(moe: bool, **kw):
    base_j = jtr.tiny_moe_config() if moe else jtr.tiny_config()
    base_t = ttr.tiny_moe_config() if moe else ttr.tiny_config()
    cfg_j = jtr.TransformerConfig(**{**base_j.__dict__,
                                     "dtype": jnp.float32, **kw})
    cfg_t = dataclasses.replace(base_t, dtype=torch.float32, **kw)
    return cfg_j, cfg_t


def _model(moe: bool, seed: int = 0, **kw):
    cfg_j, cfg_t = _cfgs(moe, **kw)
    pj = jtr.init_params(jax.random.key(seed), cfg_j)
    pt = params_from_jax({k: np.asarray(v) for k, v in pj.items()}, cfg_t,
                         CPU)
    return cfg_j, cfg_t, pj, pt


@pytest.fixture(scope="module")
def dense():
    return _model(False)


@pytest.fixture(scope="module")
def moe():
    return _model(True, seed=3)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / (np.abs(a).max() + 1e-9))


def _toks(shape, seed=1, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def _fwd(pj, pt, cfg_j, cfg_t, toks):
    lj = jtr.forward(pj, jnp.asarray(toks, jnp.int32), cfg_j)
    lt = ttr.forward(pt, torch.tensor(toks), cfg_t)
    return np.asarray(lj), lt.numpy()


QUANTIZERS = {
    "int8": (lambda p, m: m.quantize_weights_int8(p)),
    "int8_lm_head": (lambda p, m: m.quantize_weights_int8(
        p, suffixes=("lm_head",))),
    "int4_g32": (lambda p, m: m.quantize_weights_int4(p, group=32)),
    "int4_default": (lambda p, m: m.quantize_weights_int4(p)),
    # 24 divides neither 64 nor 128: the largest even divisor below it
    "int4_g24": (lambda p, m: m.quantize_weights_int4(p, group=24)),
    "mixed": (lambda p, m: m.quantize_weights_int4(
        m.quantize_weights_int8(p, suffixes=("lm_head",)), group=32)),
}


def _quantized(model, how):
    _, _, pj, pt = model
    return QUANTIZERS[how](pj, jq), QUANTIZERS[how](pt, tq)


# -- the quantized leaves ------------------------------------------------------

@pytest.mark.parametrize("how", list(QUANTIZERS))
@pytest.mark.parametrize("which", ["dense", "moe"])
def test_quantized_leaves_bitwise_equal(dense, moe, which, how):
    """Every leaf's kind, dtype, shape and bytes equal the JAX
    package's; the router, the embedding and the norms stay as they
    were."""
    qj, qt = _quantized(dense if which == "dense" else moe, how)
    assert list(qj) == list(qt)
    n = 0
    for name in qj:
        a, b = qj[name], qt[name]
        assert isinstance(a, dict) == isinstance(b, dict), name
        if not isinstance(a, dict):
            assert np.array_equal(np.asarray(a), _np(b)), name
            continue
        assert sorted(a) == sorted(b), name
        for k in a:
            ja, tb = np.asarray(a[k]), _np(b[k])
            assert ja.dtype == tb.dtype and ja.shape == tb.shape, (name, k)
            assert np.array_equal(ja, tb), (name, k)
        n += 1
    assert n > 0
    assert not isinstance(qt["tok_embed"], dict)
    assert not isinstance(qt["final_norm"], dict)
    if which == "moe":
        assert not isinstance(qt["layers.1.router"], dict)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("how", ["int8", "int4_g32", "int4_g24"])
def test_dequantized_weights_equal(moe, how, dtype):
    """``wmat`` of every quantized leaf equals the JAX ``wmat``, in the
    compute dtype, 3-D expert weights included."""
    qj, qt = _quantized(moe, how)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    for name, leaf in qt.items():
        if not isinstance(leaf, dict):
            continue
        a = np.asarray(jtr.wmat(qj, name, jd).astype(jnp.float32))
        b = ttr.wmat(qt, name, td).float().numpy()
        assert np.array_equal(a, b), name


@pytest.mark.parametrize("how", list(QUANTIZERS))
def test_logical_shape_and_nbytes_equal(moe, how):
    qj, qt = _quantized(moe, how)
    for name in qj:
        assert jq.logical_shape(qj[name]) == tq.logical_shape(qt[name]) \
            == tuple(moe[3][name].shape)
    assert jq.quantized_nbytes(qj) == tq.quantized_nbytes(qt)


def test_suffix_selection_and_idempotence(dense):
    _, _, _, pt = dense
    qp = tq.quantize_weights_int8(pt, suffixes=("lm_head",))
    assert isinstance(qp["lm_head"], dict)
    assert not isinstance(qp["layers.0.wq"], dict)
    qp2 = tq.quantize_weights_int8(qp)
    assert qp2["lm_head"] is qp["lm_head"]
    assert tq.DEFAULT_SUFFIXES == jq.DEFAULT_SUFFIXES
    assert tq.DEFAULT_SUFFIXES_INT4 == jq.DEFAULT_SUFFIXES_INT4
    # an odd d_in cannot pack: the weight stays full precision
    odd = {"x.wq": torch.randn(5, 4)}
    assert tq.quantize_weights_int4(odd)["x.wq"] is odd["x.wq"]


def test_int4_pack_roundtrip_exact():
    """unpack(pack(q)) == q for every nibble, groups included: the
    dequantized weight is the manual group absmax / 7 reference."""
    w = np.asarray(jax.random.normal(jax.random.key(0), (8, 6),
                                     jnp.float32))
    leaf = tq._quantize_one_int4(torch.from_numpy(w.copy()), group=4)
    assert leaf["q4"].shape == (4, 6) and leaf["q4"].dtype == torch.uint8
    assert tuple(leaf["scale4"].shape) == (2, 1, 6)
    deq = ttr.wmat({"w": leaf}, "w", torch.float32).numpy()
    wf = w.astype(np.float64).reshape(2, 4, 6)
    sc = np.maximum(np.abs(wf).max(axis=1, keepdims=True) / 7, 1e-12)
    q = np.clip(np.round(wf / sc), -7, 7)
    np.testing.assert_allclose(deq, (q * sc).reshape(8, 6), rtol=1e-6)
    jleaf = jq._quantize_one_int4(jnp.asarray(w), group=4)
    assert np.array_equal(np.asarray(jleaf["q4"]), leaf["q4"].numpy())


# -- quantized logits and tokens ---------------------------------------------

@pytest.mark.parametrize("how,rail", [("int8", 0.05), ("int4_g32", 0.25),
                                      ("mixed", 0.25)])
def test_quantized_logits_within_rails_and_jax(dense, how, rail):
    cfg_j, cfg_t, pj, pt = dense
    qj, qt = _quantized(dense, how)
    toks = _toks((2, 16))
    lj, lt = _fwd(qj, qt, cfg_j, cfg_t, toks)
    np.testing.assert_allclose(lt, lj, atol=ATOL, rtol=0)
    _, lf = _fwd(pj, pt, cfg_j, cfg_t, toks)
    assert _rel(lf, lt) < rail
    q, fp = tq.quantized_nbytes(qt)
    assert q * (6 if how.startswith("int4") else 3) < fp


@pytest.mark.parametrize("how,rail", [("int8", 0.08), ("mixed", 0.25)])
def test_quantized_moe_forward_and_mixed_tree(moe, how, rail):
    """3-D expert weights quantize with broadcastable scales; int8 and
    int4 leaves coexist in one tree; the router stays full precision."""
    cfg_j, cfg_t, pj, pt = moe
    qj, qt = _quantized(moe, how)
    if how == "mixed":
        assert "q8" in qt["lm_head"] and "q4" in qt["layers.1.moe_w_up"]
    toks = _toks((2, 8))
    lj, lt = _fwd(qj, qt, cfg_j, cfg_t, toks)
    np.testing.assert_allclose(lt, lj, atol=ATOL, rtol=0)
    _, lf = _fwd(pj, pt, cfg_j, cfg_t, toks)
    assert _rel(lf, lt) < rail


def _jax_generate(params, cfg, prompt, n):
    return np.asarray(jdec.generate(params, jnp.asarray([prompt],
                                                        jnp.int32),
                                    cfg, n))[0].tolist()


@pytest.mark.parametrize("how", ["int8", "int4_g32"])
def test_quantized_decode_and_serving(dense, how):
    """generate() runs on quantized params with the JAX package's
    tokens, and both servers give generate's (the JAX test's
    self-consistency)."""
    cfg_j, cfg_t, _, _ = dense
    qj, qt = _quantized(dense, how)
    prompt = [5, 6, 7]
    want = _jax_generate(qj, cfg_j, prompt, 8)
    got = tdec.generate(qt, torch.tensor([prompt]), cfg_t, 8)[0].tolist()
    assert got == want
    for s in (tsrv.DecodeServer(qt, cfg_t, 2, 64, device=CPU),
              tsrv.PagedDecodeServer(qt, cfg_t, 2, 64, total_blocks=8,
                                     block_len=16, device=CPU)):
        s.submit("r", prompt, max_new=8)
        assert s.run()["r"] == want


def test_params_from_jax_keeps_quantized_leaves(moe):
    """Quantized numpy leaves convert with their integer dtypes, MoE
    shapes are checked, the router stays float32 in a bf16 model."""
    cfg_j, cfg_t, pj, _ = moe
    qj = jq.quantize_weights_int4(jq.quantize_weights_int8(
        pj, suffixes=("lm_head",)), group=32)
    npq = {k: ({kk: np.asarray(vv) for kk, vv in v.items()}
               if isinstance(v, dict) else np.asarray(v))
           for k, v in qj.items()}
    cfg16 = dataclasses.replace(cfg_t, dtype=torch.bfloat16)
    out = params_from_jax(npq, cfg16, CPU)
    assert out["lm_head"]["q8"].dtype == torch.int8
    assert out["layers.1.moe_w_up"]["q4"].dtype == torch.uint8
    assert out["layers.1.moe_w_up"]["scale4"].dtype == torch.float32
    assert out["layers.1.router"].dtype == torch.float32
    assert out["layers.0.wq"]["q4"].dtype == torch.uint8
    bad = dict(npq)
    bad["layers.1.router"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="router"):
        params_from_jax(bad, cfg16, CPU)


def test_trainer_refuses_quantized_params(dense):
    _, _, _, pt = dense
    with pytest.raises(ValueError, match="quantized"):
        ttr.trainable_params(tq.quantize_weights_int8(pt), CPU)


def test_generate_main_int8_and_int4(tmp_path, dense, capsys):
    """``generate --int8`` / ``--int4`` / both on the CPU print the
    quantized MiB against float32 and the ids the API gives."""
    _, cfg32, _, pt = dense
    ckdir = tmp_path / "ck"
    ckdir.mkdir()
    save_checkpoint(str(ckdir / "model.safetensors"), pt)
    keep = {f.name: getattr(cfg32, f.name)
            for f in dataclasses.fields(cfg32) if f.name != "dtype"}
    (ckdir / "strom_config.json").write_text(json.dumps(keep))
    cfg = dataclasses.replace(cfg32, dtype=torch.bfloat16)
    ids = list(range(3, 15))
    for flags, how in ((["--int8"], "int8"), (["--int4"], "int4_default"),
                       (["--int8", "--int4"], "mixed_default")):
        assert gen_main.main(["--weights", str(ckdir), "--prompt",
                              ",".join(map(str, ids)), "--new", "6",
                              "--device", "cpu"] + flags) == 0
        out = capsys.readouterr().out
        assert " MiB (vs " in out
        line = next(x for x in out.splitlines()
                    if x.startswith("output ids:"))
        got = [int(t) for t in line.split(":", 1)[1].split(",")]
        params = {k: (v if v.dim() == 1 else v.to(torch.bfloat16))
                  for k, v in pt.items()}
        if how == "int8":
            qp = tq.quantize_weights_int8(params)
        elif how == "int4_default":
            qp = tq.quantize_weights_int4(params)
        else:
            qp = tq.quantize_weights_int4(tq.quantize_weights_int8(
                params, suffixes=("lm_head",)))
        want = tdec.generate(qp, torch.tensor([ids], dtype=torch.int32),
                             cfg, 6)[0].tolist()
        assert got == want, flags


# -- routing -------------------------------------------------------------------

def _probs(T, E, seed):
    return np.asarray(jax.nn.softmax(
        jax.random.normal(jax.random.key(seed), (T, E)), axis=-1))


@pytest.mark.parametrize("T,E,k,factor", [(32, 4, 2, 10.0), (32, 4, 2, 1.0),
                                          (24, 8, 2, 0.5), (16, 4, 1, 0.5)])
def test_dispatch_combine_equal(T, E, k, factor):
    """Dispatch and combine equal the JAX tensors, with capacity ample
    and binding (tokens dropped); the aux loss to 1e-6."""
    probs = _probs(T, E, T + E + k)
    C = tmoe.expert_capacity(T, E, k, factor)
    assert C == jmoe.expert_capacity(T, E, k, factor)
    dj, cj, aj = jmoe.moe_dispatch_combine(jnp.asarray(probs), k, C)
    dt, ct, at = tmoe.moe_dispatch_combine(torch.tensor(probs), k, C)
    assert np.array_equal(np.asarray(dj), dt.numpy())
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6)
    d = dt.numpy()
    assert (d.sum(axis=0) <= 1.0).all()          # a slot holds one token
    if factor >= 10.0:                           # nothing dropped
        np.testing.assert_array_equal(d.sum(axis=(1, 2)), np.full(T, k))
        np.testing.assert_allclose(ct.numpy().sum(axis=(1, 2)),
                                   np.ones(T), rtol=1e-5)
    else:
        assert d.sum() < T * k


def test_capacity_drops_tokens():
    """Every token routed to expert 0 fills its C slots and no more; the
    tie among the other experts breaks to the lower index, as in JAX."""
    T, E = 32, 4
    probs = np.tile(np.array([[1.0, 0.0, 0.0, 0.0]], np.float32), (T, 1))
    for k in (1, 2):
        dj, cj, _ = jmoe.moe_dispatch_combine(jnp.asarray(probs), k, 8)
        dt, ct, _ = tmoe.moe_dispatch_combine(torch.from_numpy(probs), k, 8)
        assert np.array_equal(np.asarray(dj), dt.numpy())
        assert np.array_equal(np.asarray(cj), ct.numpy())
        assert dt.numpy()[:, 0].sum() == 8
    assert dt.numpy()[:, 2:].sum() == 0


def test_group_size_and_capacity_rules():
    """Group sizes and capacities equal the JAX rules, the dispatch
    memory grows linearly with the batch, and a size that does not
    divide the tokens raises."""
    cfg_j, cfg_t = _cfgs(True)
    for gs in (0, 4, 16, 200):
        cj = jtr.TransformerConfig(**{**cfg_j.__dict__,
                                      "moe_group_size": gs})
        ct = dataclasses.replace(cfg_t, moe_group_size=gs)
        for T, s in ((64, 16), (128, 64), (16, 16)):
            assert tmoe.moe_group_size(ct, T, s) == \
                jmoe.moe_group_size(cj, T, s)

    def elems(b):
        T, s = b * cfg_t.max_seq, cfg_t.max_seq
        S = tmoe.moe_group_size(cfg_t, T, s)
        C = tmoe.expert_capacity(S, cfg_t.n_experts, cfg_t.expert_top_k,
                                 cfg_t.capacity_factor)
        return (T // S) * S * cfg_t.n_experts * C
    assert elems(2) == 2 * elems(1) and elems(4) == 4 * elems(1)
    with pytest.raises(ValueError, match="does not divide"):
        tmoe.moe_group_size(dataclasses.replace(cfg_t, moe_group_size=5),
                            64, 16)


@pytest.mark.parametrize("group,factor", [(0, 1.25), (0, 4.0), (32, 1.25),
                                          (32, 4.0)])
def test_moe_mlp_equal(group, factor):
    """``moe_mlp`` equals the JAX one within 2e-5 in float32, routed per
    batch row and globally, with capacity binding and ample."""
    cfg_j, cfg_t, pj, pt = _model(True, seed=5, capacity_factor=factor,
                                  moe_every=1, moe_group_size=group)
    x = np.asarray(jax.random.normal(jax.random.key(6), (4, 8, 64),
                                     jnp.float32))
    L = "layers.0."
    oj, aj = jmoe.moe_mlp(jnp.asarray(x), pj, L, cfg_j)
    ot, at = tmoe.moe_mlp(torch.from_numpy(x.copy()), pt, L, cfg_t)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6)


def test_single_expert_equals_dense_mlp():
    """One expert, top-1, ample capacity: the MoE MLP is the SwiGLU
    MLP."""
    _, cfg, _, pt = _model(True, n_experts=1, expert_top_k=1,
                           capacity_factor=2.0, moe_every=1)
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator()
                    .manual_seed(2))
    L = "layers.0."
    out, _ = tmoe.moe_mlp(x, pt, L, cfg)
    dense_p = {L + "w_gate": pt[L + "moe_w_gate"][0],
               L + "w_up": pt[L + "moe_w_up"][0],
               L + "w_down": pt[L + "moe_w_down"][0]}
    torch.testing.assert_close(out, ttr.mlp(x, dense_p, L), atol=1e-5,
                               rtol=1e-5)


# -- the MoE model end to end ---------------------------------------------------

def test_moe_params_and_init(moe):
    """The MoE layer's names and shapes are the JAX model's; the port's
    own init follows the same scheme (normal / sqrt(fan_in))."""
    cfg_j, cfg_t, pj, pt = moe
    assert ttr.param_shapes(cfg_t) == {k: tuple(v.shape)
                                       for k, v in pj.items()}
    assert [cfg_t.is_moe_layer(i) for i in range(4)] == \
        [cfg_j.is_moe_layer(i) for i in range(4)] == [False, True] * 2
    own = ttr.init_params(0, cfg_t)
    assert {k: v.shape for k, v in own.items()} == ttr.param_shapes(cfg_t)
    std = own["layers.1.moe_w_down"].std()
    assert abs(std * np.sqrt(cfg_t.d_ff) - 1.0) < 0.05


def test_tiny_moe_forward_decode_and_servers_equal_jax(moe):
    """On ``tiny_moe_config`` (capacity 1.25, tokens dropped in prefill)
    the forward, generate and both servers give the JAX package's
    logits and tokens."""
    cfg_j, cfg_t, pj, pt = moe
    toks = _toks((2, 16), seed=4)
    lj, lt = _fwd(pj, pt, cfg_j, cfg_t, toks)
    np.testing.assert_allclose(lt, lj, atol=ATOL, rtol=0)
    rng = np.random.default_rng(7)
    # the JAX servers pad a 5-token prompt to a 16-token bucket and a
    # 27-token one to 32
    reqs = [(f"r{i}", rng.integers(0, 128, n).tolist(), 8)
            for i, n in enumerate([5, 27])]
    _, p, m = reqs[1]
    got = tdec.generate(pt, torch.tensor([p]), cfg_t, m)[0].tolist()
    assert got == _jax_generate(pj, cfg_j, p, m)
    js = jsrv.DecodeServer(pj, cfg_j, max_batch=2, max_len=64)
    jp = jsrv.PagedDecodeServer(pj, cfg_j, max_batch=2, max_len=64,
                                total_blocks=16, block_len=16)
    outs = []
    for srv in (js, jp,
                tsrv.DecodeServer(pt, cfg_t, 2, 64, device=CPU),
                tsrv.PagedDecodeServer(pt, cfg_t, 2, 64, total_blocks=16,
                                       block_len=16, device=CPU)):
        for rid, p, m in reqs:
            srv.submit(rid, p, m)
        outs.append(srv.run(2))
    assert outs[2] == outs[0] and outs[3] == outs[1]


def test_moe_offloaded_generate_equals_generate(moe, tmp_path):
    """The offloaded cache's layers run the same MoE dispatch."""
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.models import kv_offload as tk
    _, cfg_t, _, pt = moe
    prompt = torch.tensor([list(range(3, 22))], dtype=torch.int32)
    want = tdec.generate(pt, prompt, cfg_t, 9)
    with StromEngine() as eng:
        got = tk.offloaded_generate(pt, prompt, cfg_t, tk.OffloadConfig(
            path=str(tmp_path / "o.bin"), page_len=4, window_pages=2),
            eng, 9)
    assert got.tolist() == want.tolist()


def test_moe_train_step_learns_and_aux(moe):
    """A few AdamW steps on the tiny MoE lower the loss (aux included);
    the aux loss equals the JAX one and is 0 for a dense model."""
    cfg_j, cfg_t, pj, _ = moe
    toks = _toks((2, cfg_t.max_seq), seed=3)
    _, aj = jtr.forward_with_aux(pj, jnp.asarray(toks, jnp.int32), cfg_j)
    params = ttr.trainable_params({k: np.array(v) for k, v in pj.items()},
                                  CPU)
    _, at = ttr.forward_with_aux(params, torch.tensor(toks), cfg_t)
    assert float(at.detach()) > 0.0
    np.testing.assert_allclose(float(at.detach()), float(aj), rtol=1e-5)
    lj = float(jtr.loss_fn(pj, jnp.asarray(toks, jnp.int32), cfg_j))
    lt = ttr.loss_fn(params, torch.tensor(toks), cfg_t)
    np.testing.assert_allclose(float(lt.detach()), lj, rtol=1e-5)
    step = ttr.make_train_step(cfg_t, ttr.adamw(params, 1e-2))
    l0 = float(lt.detach())
    for _ in range(5):
        loss = step(params, torch.tensor(toks))
    assert np.isfinite(float(loss)) and float(loss) < l0
    dense_cfg = dataclasses.replace(ttr.tiny_config(), dtype=torch.float32)
    dp = ttr.trainable_params(ttr.init_params(0, dense_cfg), CPU)
    _, aux0 = ttr.forward_with_aux(dp, torch.tensor(toks), dense_cfg)
    assert float(aux0) == 0.0
