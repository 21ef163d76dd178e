"""The port's GPipe pipeline (parallel/pipeline.py) across 2 and 4 gloo
processes on the CPU, held against the JAX package on the same numpy
inputs.

The cases are the twelve of the JAX package's ``tests/test_pipeline.py``
at four ranks or fewer: the stack round trips (dense and MoE), the loss
over pp, dp × pp, pp × tp and a degenerate pp 1, the gradients merged
back by name, the train step, the shape refusals, remat, sp inside the
pipeline (the dense ring), the MoE super-layers over ep, dp and tp, the
router aux loss and ``xent_chunks``.  All in float32: losses at
``rtol 1e-4`` and gradients at (1e-4 rel, 1e-5 abs) against the JAX
package's single-device ``loss_fn`` and its gradients (the JAX pipeline
equals them), the JAX pipeline's own loss where its mesh fits; logits
at (1e-4, 1e-5).  Each world size is one spawn of workers
(``tests/_torch_dist.py``) that runs every case of that size.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import _torch_dist
from nvme_strom_tpu.models import transformer as jtr
from nvme_strom_tpu.parallel import pipeline as jpp
from nvme_strom_tpu_torch.convert import params_from_jax
from nvme_strom_tpu_torch.models import transformer as ttr
from nvme_strom_tpu_torch.parallel import pipeline as tpp
from nvme_strom_tpu_torch.parallel.mesh import Mesh as TMesh, make_mesh

RTOL_LOSS = 1e-4
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
STEPS = 5
LR = 1e-2

TOKENS = np.random.default_rng(21).integers(0, 128, (8, 16)).astype(np.int32)


def _fields(jcfg):
    names = {f.name for f in dataclasses.fields(ttr.TransformerConfig)}
    out = {k: v for k, v in jcfg.__dict__.items()
           if k in names and k != "dtype"}
    out["remat_policy"] = "full" if jcfg.remat else (
        out.get("remat_policy") or "none")
    return out


@functools.lru_cache(maxsize=None)
def _model(kind: str):
    """(JAX config, port fields, JAX params, numpy params) of ``kind``:
    dense, remat, chunked (xent_chunks 4), moe (4 layers, capacity 4,
    no aux term) or moe_aux (router_aux_coef 0.01)."""
    if kind.startswith("moe"):
        jcfg = dataclasses.replace(
            jtr.tiny_moe_config(), n_layers=4, capacity_factor=4.0,
            router_aux_coef=0.01 if kind == "moe_aux" else 0.0)
        key = 2
    else:
        jcfg = jtr.tiny_config()
        key = 0
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32, max_seq=16,
                               remat=kind == "remat",
                               xent_chunks=4 if kind == "chunked" else 0)
    fields = _fields(jcfg)
    cfg = ttr.TransformerConfig(**fields, dtype=torch.float32)
    # seeded numpy weights, crossing into the port as a JAX checkpoint's
    full = {k: t.numpy() for k, t in params_from_jax(
        ttr.init_params(key, cfg), cfg, device="cpu").items()}
    return jcfg, fields, {k: jnp.asarray(v) for k, v in full.items()}, full


def _case(name, kind, model, axes, n_mb, **kw):
    _, fields, _, full = _model(model)
    return dict(name=name, kind=kind, axes=axes, n_mb=n_mb, cfg=fields,
                params=full, tokens=TOKENS, **kw)


def _cases(world: int) -> list:
    if world == 2:
        return [_case("pp2", "loss", "dense", {"pp": 2}, 4),
                _case("pp2_grad", "grad", "dense", {"pp": 2}, 4),
                _case("pp2_chunked", "loss", "chunked", {"pp": 2}, 4),
                _case("pp2_moe", "grad", "moe", {"pp": 2}, 2)]
    return [_case("dp2pp2", "loss", "dense", {"dp": 2, "pp": 2}, 2),
            _case("pp2tp2", "loss", "dense", {"pp": 2, "tp": 2}, 4),
            _case("pp2tp2_grad", "grad", "dense", {"pp": 2, "tp": 2}, 4),
            _case("dp2pp2_train", "train", "dense", {"dp": 2, "pp": 2}, 2,
                  lr=LR, steps=STEPS),
            _case("dp2pp2_remat", "grad", "remat", {"dp": 2, "pp": 2}, 2),
            _case("pp2sp2", "grad", "dense", {"pp": 2, "sp": 2}, 2),
            _case("pp2sp2_loss", "loss", "dense", {"pp": 2, "sp": 2}, 2),
            _case("pp2ep2_moe", "grad", "moe", {"pp": 2, "ep": 2}, 2),
            _case("dp2pp2_moe", "loss", "moe", {"dp": 2, "pp": 2}, 2),
            _case("pp2tp2_moe", "loss", "moe", {"pp": 2, "tp": 2}, 4),
            _case("pp2ep2_moe_aux", "loss", "moe_aux", {"pp": 2, "ep": 2},
                  2),
            _case("pp2ep2_moe_train", "train", "moe", {"pp": 2, "ep": 2}, 2,
                  lr=LR, steps=STEPS)]


@pytest.fixture(scope="module", autouse=True)
def spawned(tmp_path_factory):
    """Every case of both world sizes; both spawns start at once, before
    the module's first test, and run beside the JAX references."""
    handles = {w: _torch_dist.start(
        "pipeline_cases", w, tmp_path_factory.mktemp(f"pipeline{w}"),
        _cases(w), timeout=150) for w in (2, 4)}
    cache = {}

    def spawn(world):
        if world not in cache:
            cache[world] = _torch_dist.collect(handles[world])
        return cache[world]
    yield spawn
    for w, h in handles.items():
        if w not in cache:
            _torch_dist.collect(h)


def _res(spawned, name):
    world = 2 if name in {c["name"] for c in _cases(2)} else 4
    return [r[name] for r in spawned(world)]


# -- the JAX references --------------------------------------------------------

#: the models whose JAX single-device functions equal another's: remat
#: and chunked cross-entropy change how, not what, the dense model
#: computes (moe_aux adds its aux term: its loss is computed apart)
_SAME = {"remat": "dense", "chunked": "dense", "moe_aux": "moe"}


@functools.lru_cache(maxsize=None)
def _jax_ref(model: str):
    """The JAX single-device loss, its gradients and logits."""
    if model in _SAME:
        ref = _jax_ref(_SAME[model])
        if model != "moe_aux":
            return ref
        jcfg, _, pj, _ = _model(model)
        loss = jax.jit(lambda p, t: jtr.loss_fn(p, t, jcfg))(
            pj, jnp.asarray(TOKENS))
        return (float(loss),) + ref[1:]
    jcfg, _, pj, _ = _model(model)
    t = jnp.asarray(TOKENS)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, t: jtr.loss_fn(p, t, jcfg)))(pj, t)
    logits = jax.jit(lambda p, t: jtr.forward(p, t, jcfg))(pj, t)
    return (float(loss), {k: np.asarray(g) for k, g in grads.items()},
            np.asarray(logits))


@functools.lru_cache(maxsize=None)
def _jax_pp_loss(model: str, axes: tuple, n_mb: int):
    """The JAX pipeline's loss on a mesh of the conftest's devices."""
    jcfg, _, pj, _ = _model(model)
    n = int(np.prod([s for _, s in axes]))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape([s for _, s in axes]),
                tuple(a for a, _ in axes))
    stack, rest = jpp.split_layer_stack(pj, jcfg)
    return float(jax.jit(jpp.make_pp_loss(jcfg, mesh, n_mb))(
        stack, rest, jnp.asarray(TOKENS)))


def _merged_grads(per, model):
    """Every gradient by name: the ranks' stack slices assembled, merged
    back through ``merge_layer_stack``, and the rest's."""
    _, fields, _, _ = _model(model)
    cfg = ttr.TransformerConfig(**fields, dtype=torch.float32)
    flat = {n: _torch_dist.assemble(per, n) for n in per[0]["shapes"]}
    stack = tpp.from_leaves(tpp.split_layer_stack(
        {k: np.zeros(v, np.float32) for k, v in
         ttr.param_shapes(cfg).items()}, cfg)[0], flat)
    for r in per[1:]:
        for n, g in r["rest"].items():
            np.testing.assert_array_equal(g, per[0]["rest"][n],
                                          err_msg=f"{n} differs over ranks")
    return tpp.merge_layer_stack(stack, per[0]["rest"])


# -- in one process ------------------------------------------------------------

@pytest.mark.parametrize("model", ["dense", "moe"])
def test_stack_roundtrip_and_specs(model):
    """split / merge round-trip bitwise, with the JAX stack's structure
    and shapes; the stacked specs are the JAX package's."""
    jcfg, fields, pj, full = _model(model)
    cfg = ttr.TransformerConfig(**fields, dtype=torch.float32)
    stack, rest = tpp.split_layer_stack(full, cfg)
    jstack, jrest = jpp.split_layer_stack(pj, jcfg)
    assert {n: t.shape for n, t in tpp.named_leaves(stack)} == \
        {n: tuple(t.shape) for n, t in tpp.named_leaves(jstack)}
    assert set(rest) == set(jrest)
    if model == "moe":
        assert set(stack) == {"dense", "moe"}
        assert stack["moe"]["moe_w_gate"].shape[:2] == (2, cfg.n_experts)
    merged = tpp.merge_layer_stack(stack, rest)
    assert set(merged) == set(full)
    for k in full:
        np.testing.assert_array_equal(merged[k], full[k])
    specs = dict(tpp.named_leaves(tpp.stacked_specs(cfg)))
    jspecs = jpp.stacked_specs(jcfg)
    jflat = ({f"{g}/{k}": v for g, d in jspecs.items() for k, v in d.items()}
             if model == "moe" else jspecs)
    assert {k: tuple(v) for k, v in specs.items()} == \
        {k: tuple(v) for k, v in jflat.items()}


def test_pp1_is_the_plain_model():
    """A degenerate pipe (pp 1, one rank): the loss and every gradient
    equal the JAX single-device ones."""
    _, fields, _, full = _model("dense")
    cfg = ttr.TransformerConfig(**fields, dtype=torch.float32)
    stack, rest = tpp.split_layer_stack(full, cfg)
    stack = tpp.from_leaves(stack, {n: torch.from_numpy(t.copy())
                                   .requires_grad_()
                                   for n, t in tpp.named_leaves(stack)})
    rest = ttr.trainable_params(rest, "cpu")
    mesh = make_mesh({"pp": 1})
    loss, g_stack, g_rest = tpp.make_pp_value_and_grad(cfg, mesh, 2)(
        stack, rest, torch.from_numpy(TOKENS))
    want_loss, want, _ = _jax_ref("dense")
    np.testing.assert_allclose(float(loss), want_loss, rtol=RTOL_LOSS)
    got = tpp.merge_layer_stack(g_stack, g_rest)
    for n, g in want.items():
        np.testing.assert_allclose(got[n].numpy(), g, err_msg=n, **GRAD_TOL)


def test_pp_rejects_bad_shapes():
    _, fields, _, full = _model("dense")
    cfg = ttr.TransformerConfig(**fields, dtype=torch.float32)
    mesh = TMesh([2], ["pp"], rank=0)
    stack, rest = tpp.split_layer_stack(
        {k: torch.from_numpy(v) for k, v in full.items()}, cfg)
    with pytest.raises(ValueError, match="microbatch"):
        tpp.make_pp_loss(cfg, mesh, 3)(stack, rest,
                                       torch.from_numpy(TOKENS))
    bad = dataclasses.replace(cfg, n_layers=3)
    with pytest.raises(ValueError, match="stages"):
        tpp.make_pp_loss(bad, mesh, 2)
    with pytest.raises(ValueError, match="microbatch size"):
        tpp.make_pp_loss(cfg, TMesh([2, 2], ["dp", "pp"], rank=0), 4)(
            stack, rest, torch.from_numpy(TOKENS[:2]))


# -- across processes ------------------------------------------------------------

@pytest.mark.parametrize("name,model,jax_axes,n_mb", [
    ("pp2", "dense", None, 4),
    ("dp2pp2", "dense", None, 2),
    ("pp2tp2", "dense", None, 4),
    ("pp2sp2_loss", "dense", None, 2),
    ("pp2_chunked", "chunked", None, 4),
    ("dp2pp2_moe", "moe", None, 2),
    ("pp2tp2_moe", "moe", None, 4),
    ("pp2ep2_moe_aux", "moe_aux", (("dp", 2), ("pp", 2), ("ep", 2)), 2),
])
def test_pp_loss_matches_jax(spawned, name, model, jax_axes, n_mb):
    """The pipelined loss on every rank equals the JAX single-device loss
    (with the router aux term for moe_aux, nonzero there), as does the
    JAX pipeline's over dp × pp × ep; the logits every pp rank gets equal
    the JAX forward's block."""
    per = _res(spawned, name)
    want, _, logits = _jax_ref(model)
    if jax_axes is not None:
        np.testing.assert_allclose(_jax_pp_loss(model, jax_axes, n_mb),
                                   want, rtol=RTOL_LOSS)
    for r in per:
        np.testing.assert_allclose(r["loss"], want, rtol=RTOL_LOSS)
        (b0, b1), (s0, s1) = r["bounds"]
        np.testing.assert_allclose(r["logits"], logits[b0:b1, s0:s1],
                                   **LOGIT_TOL)
    if model == "moe_aux":
        assert all(r["aux"] > 0 for r in per)
        no_aux = _jax_ref("moe")[0]
        assert want > no_aux
        np.testing.assert_allclose(
            per[0]["loss"] - 0.01 * per[0]["aux"], no_aux, rtol=RTOL_LOSS)


@pytest.mark.parametrize("name,model", [
    ("pp2_grad", "dense"), ("pp2tp2_grad", "dense"),
    ("dp2pp2_remat", "remat"), ("pp2sp2", "dense"), ("pp2_moe", "moe"),
    ("pp2ep2_moe", "moe")])
def test_pp_grads_match_jax(spawned, name, model):
    """Through the explicit GPipe backward: the loss and every gradient,
    merged back by name, equal the JAX single-device ones; the rest's
    gradients are the same on every rank."""
    per = _res(spawned, name)
    want_loss, want, _ = _jax_ref(model)
    for r in per:
        np.testing.assert_allclose(r["loss"], want_loss, rtol=RTOL_LOSS)
    got = _merged_grads(per, model)
    assert set(got) == set(want)
    for n, g in want.items():
        np.testing.assert_allclose(got[n], g, err_msg=n, **GRAD_TOL)


@pytest.mark.parametrize("name,model", [("dp2pp2_train", "dense"),
                                        ("pp2ep2_moe_train", "moe")])
def test_pp_train_step_learns(spawned, name, model):
    """Five AdamW steps (lr 1e-2): the losses equal the port's one-rank
    ``make_train_step``'s, the first the JAX loss, and they fall."""
    per = _res(spawned, name)
    jcfg, fields, _, full = _model(model)
    cfg = ttr.TransformerConfig(**fields, dtype=torch.float32)
    params = ttr.trainable_params(full, "cpu")
    step = ttr.make_train_step(cfg, ttr.adamw(params, LR))
    want = [float(step(params, torch.from_numpy(TOKENS)))
            for _ in range(STEPS)]
    np.testing.assert_allclose(want[0], _jax_ref(model)[0], rtol=RTOL_LOSS)
    for r in per:
        np.testing.assert_allclose(r["losses"], want, rtol=RTOL_LOSS)
        assert r["losses"][-1] < r["losses"][0]
