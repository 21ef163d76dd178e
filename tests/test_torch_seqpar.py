"""The port's sequence parallelism (parallel/ring_attention.py,
parallel/ulysses.py, the sp paths of models/transformer.py and the
loader's ``seq_axis``) across 2 and 4 gloo processes on the CPU, held
against the JAX package on the same numpy inputs.

Cases follow the JAX package's ``tests/test_ring_attention.py`` (dense
and flash inners, causal and not, gradients, the model forward and the
sp train step), ``tests/test_ulysses.py`` (all three),
``tests/test_loader.py:160-190`` and ``:301`` and
``tests/test_multiprocess.py:130-160``.  All in float32: attention
within (2e-5, 2e-5) and its gradients within (5e-5, 5e-5), the JAX
tests' pins; logits within (1e-4, 1e-5); losses at ``rtol 1e-4`` and
parameters and gradients at (1e-4 rel, 1e-5 abs), the rule of a sharded
step (tests/test_torch_multigpu.py).  Each world size is one spawn of workers
(``tests/_torch_dist.py``) running every case of that size; the loader
runs in this process, one ``Mesh`` a rank.
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
from nvme_strom_tpu.data.loader import ShardedLoader as JaxLoader
from nvme_strom_tpu.models import transformer as jtr
from nvme_strom_tpu.parallel import ring_attention as jring
from nvme_strom_tpu.parallel import shardings as jsh
from nvme_strom_tpu.parallel.ulysses import make_ulysses_attn as julysses
from nvme_strom_tpu_torch.data.loader import ShardedLoader
from nvme_strom_tpu_torch.formats.wds import write_wds_shard
from nvme_strom_tpu_torch.convert import params_from_jax
from nvme_strom_tpu_torch.models import transformer as ttr
from nvme_strom_tpu_torch.parallel.mesh import Mesh as TMesh, make_mesh
from nvme_strom_tpu_torch.parallel.ring_attention import (make_ring_attn,
                                                          ring_attention)
from nvme_strom_tpu_torch.parallel.shardings import batch_shardings
from nvme_strom_tpu_torch.parallel.ulysses import ulysses_attention

ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-5, atol=5e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
RTOL_LOSS = 1e-4
STEPS = 3
LR = 3e-4
#: chip_smoke.py's rule for parameters after Adam steps: its first update is
#: lr·sign(g) whatever |g|, so where a step-1 gradient is below
#: NOISE_G of its tensor's rms the summation order alone decides that
#: sign; such elements are counted, at most EXEMPT_MAX of the model's
NOISE_G = 1e-3
EXEMPT_MAX = 1e-4

QKV = tuple(np.random.default_rng(11).standard_normal((2, 4, 32, 16))
            .astype(np.float32) for _ in range(3))
TOKENS = np.random.default_rng(12).integers(0, 128, (4, 16)).astype(np.int32)
MESHES = {2: [{"sp": 2}],
          4: [{"sp": 4}, {"dp": 2, "sp": 2}, {"tp": 2, "sp": 2}]}


def _mesh_id(axes) -> str:
    return "x".join(f"{a}{n}" for a, n in axes.items())


def _fields(jcfg):
    names = {f.name for f in dataclasses.fields(ttr.TransformerConfig)}
    out = {k: v for k, v in jcfg.__dict__.items()
           if k in names and k != "dtype"}
    if out.get("remat_policy") == "":
        out["remat_policy"] = "none"
    return out


@functools.lru_cache(maxsize=None)
def _lm(xent_chunks: int = 0):
    jcfg = dataclasses.replace(jtr.tiny_config(), dtype=jnp.float32,
                               max_seq=16, xent_chunks=xent_chunks)
    fields = _fields(jcfg)
    cfg = ttr.TransformerConfig(**fields, dtype=torch.float32)
    # seeded numpy weights, crossing into the port as a JAX checkpoint's
    full = {k: t.numpy() for k, t in params_from_jax(
        ttr.init_params(6, cfg), cfg, device="cpu").items()}
    return jcfg, fields, {k: jnp.asarray(v) for k, v in full.items()}, full


def _attn_cases(axes) -> list:
    q, k, v = QKV
    cases = []
    for inner in ("dense", "flash"):
        for causal in (True, False):
            cases.append({"name": f"ring_{inner}_{causal}_{_mesh_id(axes)}",
                          "kind": "attn", "impl": "ring", "inner": inner,
                          "causal": causal, "axes": axes, "q": q, "k": k,
                          "v": v, "grad": causal})
        cases.append({"name": f"ulysses_{inner}_{_mesh_id(axes)}",
                      "kind": "attn", "impl": "ulysses", "inner": inner,
                      "causal": True, "axes": axes, "q": q, "k": k, "v": v})
    return cases


def _model_cases(axes, world) -> list:
    _, fields, _, full = _lm()
    _, cfields, _, _ = _lm(xent_chunks=2)
    m = _mesh_id(axes)
    base = {"axes": axes, "params": full, "tokens": TOKENS}
    cases = [dict(base, name=f"fwd_{attn}_{m}", kind="forward",
                  cfg=fields, attn=attn)
             for attn in (None, "ring_dense", "ring_flash", "ulysses_dense",
                          "ulysses_flash")]
    cases.append(dict(base, name=f"loss_{m}", kind="loss", cfg=fields,
                      attn="ring_flash"))
    cases.append(dict(base, name=f"loss_chunked_{m}", kind="loss",
                      cfg=cfields, attn="ring_dense"))
    cases.append(dict(base, name=f"train_{m}", kind="train", cfg=fields,
                      attn="ring_dense" if world == 4 else "ring_flash",
                      lr=LR, steps=STEPS))
    cases.append(dict(base, name=f"clip_{m}", kind="train", cfg=fields,
                      attn="ulysses_dense", lr=LR, steps=1, grad_clip=0.5))
    return cases


def _cases(world: int) -> list:
    out = []
    for axes in MESHES[world]:
        out += _attn_cases(axes) + _model_cases(axes, world)
    return out


@pytest.fixture(scope="module", autouse=True)
def spawned(tmp_path_factory):
    """Every case of both world sizes; both spawns start at once, before
    the module's first test, and run beside the JAX references."""
    handles = {w: _torch_dist.start(
        "seqpar_cases", w, tmp_path_factory.mktemp(f"seqpar{w}"),
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


CASES = [(w, axes) for w in (2, 4) for axes in MESHES[w]]
CASE_IDS = [_mesh_id(axes) for _, axes in CASES]


# -- the JAX references ------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_mesh(*axes):
    n = int(np.prod([s for _, s in axes]))
    return Mesh(np.array(jax.devices()[:n]).reshape([s for _, s in axes]),
                tuple(a for a, _ in axes))


@functools.lru_cache(maxsize=None)
def _jax_ring(inner: str, causal: bool):
    """The JAX ring's output over sp 4."""
    mesh = _jax_mesh(("sp", 4))
    q, k, v = (jnp.asarray(t) for t in QKV)
    return np.asarray(jax.jit(lambda q, k, v: jring.ring_attention(
        q, k, v, mesh, causal=causal, inner=inner))(q, k, v))


@functools.lru_cache(maxsize=None)
def _jax_ring_grads():
    """The gradients of Σ out² through the JAX dense ring (causal), with
    respect to q, k and v; the JAX tests hold its flash inner to the
    same ones."""
    mesh = _jax_mesh(("sp", 4))
    q, k, v = (jnp.asarray(t) for t in QKV)
    return [np.asarray(g) for g in jax.jit(jax.grad(
        lambda q, k, v: jnp.sum(jring.ring_attention(q, k, v, mesh) ** 2),
        argnums=(0, 1, 2)))(q, k, v)]


@functools.lru_cache(maxsize=None)
def _jax_ulysses():
    q, k, v = (jnp.asarray(t) for t in QKV)
    return np.asarray(jax.jit(julysses(_jax_mesh(("sp", 4))))(q, k, v))


@functools.lru_cache(maxsize=None)
def _jax_model():
    """The JAX forward and loss (plain and with 2 xent chunks) and the
    loss's gradients, single device."""
    jcfg, _, pj, _ = _lm()
    ccfg, _, _, _ = _lm(xent_chunks=2)
    t = jnp.asarray(TOKENS)
    logits = np.asarray(jax.jit(lambda p, t: jtr.forward(p, t, jcfg))(pj, t))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, t: jtr.loss_fn(p, t, jcfg)))(pj, t)
    closs = jax.jit(lambda p, t: jtr.loss_fn(p, t, ccfg))(pj, t)
    return (logits, float(loss), {k: np.asarray(g) for k, g in grads.items()},
            float(closs))


@functools.lru_cache(maxsize=None)
def _one_rank_train(steps: int, grad_clip: float = 0.0):
    """The port's one-rank losses and parameters after ``steps``, and
    its step-1 gradients."""
    _, fields, _, full = _lm()
    cfg = ttr.TransformerConfig(**fields, dtype=torch.float32)
    params = ttr.trainable_params(full, "cpu")
    _, g1 = ttr.value_and_grad(params, torch.from_numpy(TOKENS), cfg)
    step = ttr.make_train_step(cfg, ttr.adamw(params, LR),
                               grad_clip=grad_clip)
    losses = [float(step(params, torch.from_numpy(TOKENS)))
              for _ in range(steps)]
    return (losses, {n: p.detach().numpy() for n, p in params.items()},
            {n: g.numpy() for n, g in g1.items()})


def _assert_params_close(per, want, g1):
    """Every assembled parameter within PARAM_TOL of ``want`` but the
    elements under a near-zero step-1 gradient (NOISE_G), at most
    EXEMPT_MAX of all."""
    exempt = total = 0
    for name, w in want.items():
        got = _torch_dist.assemble(per, name)
        bad = ~np.isclose(got, w, **PARAM_TOL)
        rms = np.sqrt(np.mean(np.square(g1[name])))
        quiet = np.abs(g1[name]) < NOISE_G * rms
        exempt += int((bad & quiet).sum())
        total += w.size
        np.testing.assert_allclose(np.where(quiet, w, got), w,
                                   err_msg=name, **PARAM_TOL)
    assert exempt <= EXEMPT_MAX * total, (exempt, total)


def _res(spawned, world, name):
    return [r[name] for r in spawned(world)]


# -- ring and Ulysses ----------------------------------------------------------

@pytest.mark.parametrize("inner", ["dense", "flash"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("world,axes", CASES, ids=CASE_IDS)
def test_ring_matches_jax(spawned, world, axes, inner, causal):
    """Each rank's block of the output equals the JAX ring's over the
    same inputs; causal, so do the gradients of Σ out² (the lse
    cotangent of the merge reaches every flash block)."""
    per = _res(spawned, world, f"ring_{inner}_{causal}_{_mesh_id(axes)}")
    np.testing.assert_allclose(_torch_dist.assemble(per, "o"),
                               _jax_ring(inner, causal), **ATTN_TOL)
    if causal:
        for n, g in zip("qkv", _jax_ring_grads()):
            np.testing.assert_allclose(_torch_dist.assemble(per, n), g,
                                       err_msg=n, **GRAD_TOL)


@pytest.mark.parametrize("inner", ["dense", "flash"])
@pytest.mark.parametrize("world,axes", CASES, ids=CASE_IDS)
def test_ulysses_matches_jax(spawned, world, axes, inner):
    per = _res(spawned, world, f"ulysses_{inner}_{_mesh_id(axes)}")
    np.testing.assert_allclose(_torch_dist.assemble(per, "o"),
                               _jax_ulysses(), **ATTN_TOL)


def test_ring_rejects_bad_inner():
    mesh = make_mesh({"sp": 1})
    q = torch.zeros(1, 2, 8, 8)
    with pytest.raises(ValueError, match="inner"):
        ring_attention(q, q, q, mesh, inner="nope")
    with pytest.raises(ValueError, match="inner"):
        make_ring_attn(mesh, inner="nope")
    with pytest.raises(ValueError, match="inner"):
        jring.ring_attention(jnp.zeros((1, 2, 8, 8)), jnp.zeros((1, 2, 8, 8)),
                             jnp.zeros((1, 2, 8, 8)),
                             _jax_mesh(("sp", 1)), inner="nope")


def test_ulysses_rejects_head_poor():
    """4 heads a rank under sp 8: the JAX error, naming the ring (no
    collective runs before the check)."""
    q = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="ring"):
        ulysses_attention(q, q, q, TMesh([8], ["sp"], rank=0))


def test_seq_shardings_match_the_jax_package():
    mesh = make_mesh({"dp": 1, "sp": 1})
    assert tuple(batch_shardings(mesh, seq_sharded=True).spec) == \
        tuple(jsh.batch_spec(seq_sharded=True)) == ("dp", "sp")
    with pytest.raises(ValueError, match="no 'sp'"):
        batch_shardings(make_mesh({"dp": 1}), seq_sharded=True)


# -- the model under sp ----------------------------------------------------------

@pytest.mark.parametrize("attn", [None, "ring_dense", "ring_flash",
                                  "ulysses_dense", "ulysses_flash"])
@pytest.mark.parametrize("world,axes", CASES, ids=CASE_IDS)
def test_forward_under_sp_matches_jax(spawned, world, axes, attn):
    """Each rank's logits (its rows, its span: RoPE at the span's
    positions) equal the JAX forward's block; no attn_fn takes the dense
    ring."""
    want = _jax_model()[0]
    for r in _res(spawned, world, f"fwd_{attn}_{_mesh_id(axes)}"):
        (b0, b1), (s0, s1) = r["bounds"]
        np.testing.assert_allclose(r["logits"], want[b0:b1, s0:s1],
                                   **LOGIT_TOL)


@pytest.mark.parametrize("world,axes", CASES, ids=CASE_IDS)
def test_sp_loss_and_gradients_match_jax(spawned, world, axes):
    """The spans' loss shares sum to the JAX loss (each span's last
    target from the next rank, the whole sequence counted), and every
    gradient, summed over sp and averaged over dp, equals JAX's; with
    two xent chunks too."""
    _, want_loss, want_grads, want_chunked = _jax_model()
    per = _res(spawned, world, f"loss_{_mesh_id(axes)}")
    for r in per:
        np.testing.assert_allclose(r["loss"], want_loss, rtol=RTOL_LOSS)
    for name, g in want_grads.items():
        np.testing.assert_allclose(_torch_dist.assemble(per, name), g,
                                   err_msg=name, **PARAM_TOL)
    for r in _res(spawned, world, f"loss_chunked_{_mesh_id(axes)}"):
        np.testing.assert_allclose(r["loss"], want_chunked, rtol=RTOL_LOSS)


@pytest.mark.parametrize("world,axes", CASES, ids=CASE_IDS)
def test_sp_train_step_matches(spawned, world, axes):
    """Three AdamW steps: the first loss equals the JAX loss, every loss
    and the parameters the port's one-rank run's."""
    per = _res(spawned, world, f"train_{_mesh_id(axes)}")
    losses, want, g1 = _one_rank_train(STEPS)
    for r in per:
        np.testing.assert_allclose(r["losses"][0], _jax_model()[1],
                                   rtol=RTOL_LOSS)
        np.testing.assert_allclose(r["losses"], losses, rtol=RTOL_LOSS)
    _assert_params_close(per, want, g1)


@pytest.mark.parametrize("world,axes", CASES, ids=CASE_IDS)
def test_sp_global_norm_clip_counts_a_replica_once(spawned, world, axes):
    """Clipped under sp (Ulysses): the loss is the JAX loss and every
    parameter equals the one-rank clipped step's, so each sp-replicated
    gradient counted once in the norm."""
    per = _res(spawned, world, f"clip_{_mesh_id(axes)}")
    for r in per:
        np.testing.assert_allclose(r["losses"], [_jax_model()[1]],
                                   rtol=RTOL_LOSS)
    _, want, g1 = _one_rank_train(1, 0.5)
    _assert_params_close(per, want, g1)


# -- the loader's seq_axis -------------------------------------------------------

def _token_shards(tmp_path, n_shards=4, per_shard=4, seq=16):
    rng = np.random.default_rng(13)
    rows = rng.integers(0, 1000, (n_shards, per_shard, seq)).astype(np.int32)
    paths = []
    for s in range(n_shards):
        p = tmp_path / f"tok-{s:05d}.tar"
        write_wds_shard(p, [{"bin": r.tobytes(), "cls": bytes([s])}
                            for r in rows[s]])
        paths.append(str(p))
    return paths


def _decode(parts):
    return {"tokens": np.frombuffer(parts["bin"], np.int32),
            "label": np.frombuffer(parts["cls"], np.uint8)[0]}


@pytest.mark.parametrize("axes", [{"dp": 2, "sp": 2}, {"sp": 2, "dp": 1},
                                  {"dp": 1, "sp": 4}],
                         ids=["dp2xsp2", "sp2xdp1", "dp1xsp4"])
def test_loader_seq_axis_matches_the_jax_loader(tmp_path, axes):
    """Each rank (a ``Mesh`` at its rank, in this process) reads its dp
    group's shards, the same as its sp peers', and yields its span of
    each (batch, seq) leaf, bitwise the JAX loader's rows of that group
    sliced; the rank-1 label leaf stays whole."""
    paths = _token_shards(tmp_path)
    dp = axes.get("dp", 1)
    jmesh = _jax_mesh(("dp", 1))
    want = {}
    for g in range(dp):
        with JaxLoader(paths, jmesh, 4, fmt="wds", decode=_decode,
                       process_index=g, process_count=dp) as jl:
            want[g] = list(jl._host_batches())
    size = int(np.prod(list(axes.values())))
    w = 16 // axes["sp"]
    shards = {}
    for r in range(size):
        mesh = TMesh(list(axes.values()), list(axes), rank=r)
        g, i = mesh.coords.get("dp", 0), mesh.coords["sp"]
        with ShardedLoader(paths, 4, fmt="wds", decode=_decode,
                           device="cpu", mesh=mesh, seq_axis="sp") as ld:
            assert ld.local_batch == 4 // dp
            shards.setdefault(g, set()).add(tuple(ld.local_shards))
            got = list(ld)
        assert len(got) == len(want[g]) > 0
        for b, jb in zip(got, want[g]):
            np.testing.assert_array_equal(
                b["tokens"].numpy(), jb["tokens"][:, i * w:(i + 1) * w])
            np.testing.assert_array_equal(b["label"].numpy(), jb["label"])
    # sp peers read the same shards, in the same order
    assert all(len(v) == 1 for v in shards.values())


def test_loader_seq_axis_refusals(tmp_path):
    paths = _token_shards(tmp_path, n_shards=1)
    mesh = TMesh([1, 2], ["dp", "sp"], rank=0)
    for fmt in ("fixedrec", "wds_raw"):
        with pytest.raises(ValueError, match="seq-shard"):
            ShardedLoader(paths, 2, fmt=fmt, device="cpu", mesh=mesh,
                          seq_axis="sp")
    with pytest.raises(ValueError, match="no 'sp'"):
        ShardedLoader(paths, 2, fmt="wds", device="cpu",
                      mesh=TMesh([2], ["dp"], rank=0), seq_axis="sp")
    odd = TMesh([1, 3], ["dp", "sp"], rank=1)
    with ShardedLoader(paths, 2, fmt="wds", decode=_decode, device="cpu",
                       mesh=odd, seq_axis="sp") as ld:
        with pytest.raises(ValueError, match="not divisible"):
            list(ld)
