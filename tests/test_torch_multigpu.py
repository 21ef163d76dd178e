"""The port's data and tensor parallel model (parallel/mesh.py,
parallel/collectives.py, parallel/shardings.py and the tp paths of
models/) across 2 and 4 gloo processes on the CPU, held against the JAX
package's mesh step and single-device functions and against the port's
own one-rank run.

Cases follow the JAX package's ``tests/test_model.py:73`` (the sharded
train step's loss, here over three AdamW steps), ``test_moe.py:129``
(both axis pairs), ``test_vit.py:68`` and ``test_decode.py:98``.  All in
float32: the row-parallel sums and the dp mean round apart from one
device, so losses hold at ``rtol 1e-4`` (the JAX test's pin) and
parameters and gradients at (1e-4 rel, 1e-5 abs).  Each world size is
one spawn of workers (``tests/_torch_dist.py``) that runs every case of
that size; a rank failing or outliving its join limit fails the tests.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as JP

import _torch_dist
from nvme_strom_tpu.models import transformer as jtr
from nvme_strom_tpu.models import vit as jvit
from nvme_strom_tpu.parallel import shardings as jsh
from nvme_strom_tpu_torch.models import decode as tdec
from nvme_strom_tpu_torch.models import transformer as ttr
from nvme_strom_tpu_torch.models import vit as tvit
from nvme_strom_tpu_torch.parallel import shardings as tsh
from nvme_strom_tpu_torch.parallel.mesh import make_mesh

RTOL_LOSS = 1e-4
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
STEPS = 3
LR = 3e-4


def _fields(jcfg, cls):
    names = {f.name for f in dataclasses.fields(cls)}
    out = {k: v for k, v in jcfg.__dict__.items()
           if k in names and k != "dtype"}
    if out.get("remat_policy") == "":     # the JAX config's "no remat"
        out["remat_policy"] = "none"
    return out


@functools.lru_cache(maxsize=None)
def _lm(moe: bool = False):
    base = jtr.tiny_moe_config() if moe else jtr.tiny_config()
    jcfg = dataclasses.replace(base, dtype=jnp.float32, max_seq=16)
    fields = _fields(jcfg, ttr.TransformerConfig)
    pj = jtr.init_params(jax.random.key(3 if moe else 6), jcfg)
    full = {k: np.asarray(v, np.float32) for k, v in pj.items()}
    return jcfg, fields, pj, full


def _vit():
    jcfg = dataclasses.replace(jvit.tiny_vit_config(), dtype=jnp.float32)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(tvit.ViTConfig)
              if f.name != "dtype"}
    cfg = tvit.ViTConfig(**fields, dtype=torch.float32)
    full = tvit.init_vit_params(0, cfg)
    rng = np.random.default_rng(5)
    images = rng.standard_normal((4, cfg.image_size, cfg.image_size,
                                  cfg.channels)).astype(np.float32)
    labels = rng.integers(0, cfg.n_classes, 4).astype(np.int32)
    return jcfg, fields, cfg, full, images, labels


TOKENS = np.random.default_rng(7).integers(0, 128, (4, 16)).astype(np.int32)
PROMPT = np.random.default_rng(8).integers(0, 128, (4, 6)).astype(np.int32)


def _cases(world: int) -> list:
    jcfg, fields, _, full = _lm()
    _, mfields, _, mfull = _lm(moe=True)
    _, vfields, _, vfull, images, labels = _vit()
    axes = {"dp": world // 2, "tp": 2}
    cases = [
        {"name": "train", "kind": "train", "axes": axes, "cfg": fields,
         "params": full, "tokens": TOKENS, "lr": LR, "steps": STEPS},
        {"name": "clip", "kind": "train", "axes": axes, "cfg": fields,
         "params": full, "tokens": TOKENS, "lr": LR, "steps": 1,
         "grad_clip": 0.5},
        {"name": "vit", "kind": "vit_train", "model": "vit", "axes": axes,
         "cfg": vfields, "params": vfull, "images": images,
         "labels": labels, "steps": STEPS},
        {"name": "generate", "kind": "generate", "axes": axes,
         "cfg": fields, "params": full, "tokens": PROMPT, "new": 5,
         "kernel": world == 4},
    ]
    if world == 4:
        for pair in (("dp", "ep"), ("ep", "tp")):
            cases.append({"name": "moe_" + "_".join(pair), "kind": "loss",
                          "axes": {pair[0]: 2, pair[1]: 2},
                          "cfg": mfields, "params": mfull,
                          "tokens": TOKENS})
    return cases


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """``spawn(world)``: every case of that world size; both sizes are
    launched together on first use."""
    handles = {w: _torch_dist.start(
        "model_cases", w, tmp_path_factory.mktemp(f"multigpu{w}"),
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


@pytest.fixture(params=[2, 4], ids=["2ranks", "4ranks"])
def ranks(request, spawned):
    return request.param, spawned(request.param)


# -- one-rank references -------------------------------------------------------

def _one_rank_train(fields, full, tokens, steps, grad_clip=0.0):
    cfg = ttr.TransformerConfig(**fields, dtype=torch.float32)
    params = ttr.trainable_params(full, "cpu")
    step = ttr.make_train_step(cfg, ttr.adamw(params, LR),
                               grad_clip=grad_clip)
    losses = [float(step(params, torch.from_numpy(tokens)))
              for _ in range(steps)]
    return losses, {n: p.detach().numpy() for n, p in params.items()}


@pytest.fixture(scope="module")
def one_rank():
    _, fields, _, full = _lm()
    return {"train": _one_rank_train(fields, full, TOKENS, STEPS),
            "clip": _one_rank_train(fields, full, TOKENS, 1, 0.5)}


@pytest.fixture(scope="module")
def jax_mesh_losses():
    """The JAX package's dp × tp mesh step, three AdamW steps, on 4 of
    the conftest's virtual CPU devices."""
    jcfg, _, pj, _ = _lm()
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "tp"))
    p_sh = jsh.param_shardings(jcfg, mesh)
    b_sh = jsh.batch_shardings(mesh)
    opt = optax.adamw(LR)
    params = {k: jax.device_put(v, p_sh[k]) for k, v in pj.items()}
    state = opt.init(params)
    step = jax.jit(jtr.make_train_step(jcfg, opt),
                   in_shardings=(p_sh, None, b_sh),
                   out_shardings=(p_sh, None, None))
    tokens = jax.device_put(jnp.asarray(TOKENS), b_sh)
    losses = []
    for _ in range(STEPS):
        params, state, loss = step(params, state, tokens)
        losses.append(float(loss))
    return losses


def test_specs_match_the_jax_package():
    """Same specs name for name (dense and MoE), same pruning, same
    fail-fast on a non-canonical axis."""
    jcfg, fields, _, _ = _lm(moe=True)
    cfg = ttr.TransformerConfig(**fields, dtype=torch.float32)
    want = jsh.param_specs(jcfg)
    got = tsh.param_specs(cfg)
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in want.items()}
    mesh = make_mesh({"dp": 1})
    assert tuple(tsh.prune_spec(tsh.P(None, "tp"), mesh)) == (None, None)
    jmesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    for spec in [(None, "tp"), (("dp", "tp"),), ("ep", None, "tp")]:
        assert tuple(tsh.prune_spec(tsh.P(*spec), mesh)) == \
            tuple(jsh.prune_spec(JP(*spec), jmesh))
    with pytest.raises(ValueError, match="canonical"):
        tsh.prune_spec(tsh.P("model"), mesh)
    vcfg = tvit.ViTConfig()
    assert {k: tuple(v) for k, v in tvit.vit_param_specs(vcfg).items()} == \
        {k: tuple(v) for k, v in jvit.vit_param_specs(jvit.ViTConfig())
         .items()}
    cs = tdec.cache_shardings(make_mesh({"dp": 1, "tp": 1}))
    assert tuple(cs["k"].spec) == (None, "dp", "tp", None, None)


def test_sharded_train_loss_matches_the_jax_mesh_step(ranks,
                                                      jax_mesh_losses):
    _, res = ranks
    for r in res:
        np.testing.assert_allclose(r["train"]["losses"], jax_mesh_losses,
                                   rtol=RTOL_LOSS)


def test_sharded_train_params_match_one_rank(ranks, one_rank):
    _, res = ranks
    losses, want = one_rank["train"]
    np.testing.assert_allclose(res[0]["train"]["losses"], losses,
                               rtol=RTOL_LOSS)
    per = [r["train"] for r in res]
    for name, w in want.items():
        np.testing.assert_allclose(_torch_dist.assemble(per, name), w,
                                   err_msg=name, **PARAM_TOL)


def test_global_norm_clip_counts_each_slice_once(ranks, one_rank):
    """``clip_by_global_norm`` under a mesh clips by the whole model's
    norm: the clipped step's parameters equal the one-rank clipped
    step's."""
    _, res = ranks
    _, want = one_rank["clip"]
    per = [r["clip"] for r in res]
    for name, w in want.items():
        np.testing.assert_allclose(_torch_dist.assemble(per, name), w,
                                   err_msg=name, **PARAM_TOL)


def test_sharded_vit_matches_jax_and_one_rank(ranks):
    _, res = ranks
    jcfg, fields, cfg, full, images, labels = _vit()
    want_logits = np.asarray(jax.jit(lambda p, x: jvit.vit_forward(
        p, x, jcfg))({k: jnp.asarray(v) for k, v in full.items()},
                     jnp.asarray(images)))
    params = ttr.trainable_params(full, "cpu")
    step = tvit.make_vit_train_step(cfg, ttr.adamw(params, 1e-3))
    losses = [float(step(params, torch.from_numpy(images),
                         torch.from_numpy(labels))) for _ in range(STEPS)]
    world = len(res)
    dp = world // 2
    for r, out in enumerate(res):
        rows = slice((r // 2) * 4 // dp, (r // 2 + 1) * 4 // dp)
        np.testing.assert_allclose(out["vit"]["logits"], want_logits[rows],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(out["vit"]["losses"], losses,
                                   rtol=RTOL_LOSS)
    per = [r["vit"] for r in res]
    for name, p in params.items():
        np.testing.assert_allclose(_torch_dist.assemble(per, name),
                                   p.detach().numpy(), err_msg=name,
                                   **PARAM_TOL)


def test_sharded_generate_tokens_equal(ranks):
    """dp × tp greedy decode (kernel 2's wrapper on the local heads with
    4 ranks) emits the one-rank port's tokens (which
    ``tests/test_torch_model.py`` holds equal to the JAX package's); the
    prompt's logits equal the JAX forward's."""
    _, res = ranks
    jcfg, fields, pj, full = _lm()
    cfg = ttr.TransformerConfig(**fields, dtype=torch.float32)
    params = {k: torch.from_numpy(v) for k, v in full.items()}
    want = tdec.generate(params, torch.from_numpy(PROMPT), cfg, 5).numpy()
    want_logits = np.asarray(jax.jit(lambda p, t: jtr.forward(
        p, t, jcfg))(pj, jnp.asarray(PROMPT)))
    np.testing.assert_array_equal(want[:, 0], want_logits[:, -1].argmax(-1))
    for out in res:
        a, b = out["generate"]["rows"]
        np.testing.assert_array_equal(out["generate"]["tokens"], want[a:b])
        np.testing.assert_allclose(out["generate"]["logits"],
                                   want_logits[a:b], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("pair", ["dp_ep", "ep_tp"])
def test_moe_sharded_matches_single_device(spawned, pair):
    """Experts over ep, each expert's FFN over tp (4 ranks): the loss
    equals the JAX package's single-device loss, and every gradient the
    port's one-rank gradient."""
    res = spawned(4)
    jcfg, fields, pj, full = _lm(moe=True)
    want = float(jax.jit(lambda p, t: jtr.loss_fn(p, t, jcfg))(
        pj, jnp.asarray(TOKENS)))
    cfg = ttr.TransformerConfig(**fields, dtype=torch.float32)
    params = ttr.trainable_params(full, "cpu")
    loss, grads = ttr.value_and_grad(params, torch.from_numpy(TOKENS), cfg)
    np.testing.assert_allclose(float(loss), want, rtol=RTOL_LOSS)
    per = [r["moe_" + pair] for r in res]
    for r in per:
        np.testing.assert_allclose(r["loss"], want, rtol=RTOL_LOSS)
    for name, g in grads.items():
        np.testing.assert_allclose(_torch_dist.assemble(per, name),
                                   g.numpy(), err_msg=name, **PARAM_TOL)
