"""Quantized params under tensor and expert parallelism in the port
(nvme_strom_tpu_torch/parallel/shardings.py ``shard_params``).

In the port each rank dequantizes its own local leaf (``wmat`` and the
kernels of ops/quant_matmul.py), so after ``shard_params`` every rank's
``wmat`` of an int8 or int4 leaf must be exactly the same slice of the
whole leaf's ``wmat``: under tp, ep and tp x ep, for 2-D dense and 3-D
expert weights.  A d_in shard boundary inside an int4 group raises.
Then the counterpart of ``tests/test_quant.py``
``test_int4_params_shard_over_tp``: the tiny int4 forward at tp 2 over
two gloo ranks (``tests/_torch_dist.py``) equals the unsharded one
within atol 2e-5, and its ep twin on the tiny MoE config; both are also
held to the JAX package's forward.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
from nvme_strom_tpu.models import quant as jq
from nvme_strom_tpu.models import transformer as jtr
from nvme_strom_tpu_torch.models import quant as tq
from nvme_strom_tpu_torch.models import transformer as ttr
from nvme_strom_tpu_torch.parallel.mesh import Mesh
from nvme_strom_tpu_torch.parallel.shardings import (param_shardings,
                                                     shard_params)

ATOL = 2e-5
#: widths where a group of 24 divides every d_in (96 and 192) and the tp
#: shards of each (48 and 96 rows) hold whole groups of 16 and of 24
WIDE = dict(d_model=96, d_ff=192)
QUANTIZERS = {
    "int8": lambda p: tq.quantize_weights_int8(p),
    "int4_g16": lambda p: tq.quantize_weights_int4(p, group=16),
    "int4_g24": lambda p: tq.quantize_weights_int4(p, group=24),
}
MESHES = {"tp2": {"tp": 2}, "ep2": {"ep": 2}, "tp2_ep2": {"ep": 2, "tp": 2}}


def _full(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {n: torch.randn(s, generator=g) * 0.1
            for n, s in ttr.param_shapes(cfg).items()}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("how", list(QUANTIZERS))
def test_every_rank_dequantizes_its_own_slice(how, mesh):
    cfg = dataclasses.replace(ttr.tiny_moe_config(), dtype=torch.float32,
                              **WIDE)
    q = QUANTIZERS[how](_full(cfg))
    axes = MESHES[mesh]
    n_leaves = 0
    for rank in range(int(np.prod(list(axes.values())))):
        m = Mesh(list(axes.values()), list(axes), rank)
        sh = param_shardings(cfg, m)
        local = shard_params(q, cfg, m)
        for name, leaf in q.items():
            if not isinstance(leaf, dict):
                continue
            whole = ttr.wmat(q, name, torch.float32)
            want = whole[tuple(slice(a, b) for a, b in
                               sh[name].local_bounds(whole.shape))]
            got = ttr.wmat(local, name, torch.float32)
            assert torch.equal(got, want), (name, rank)
            assert got.shape != whole.shape or "tp" not in str(sh[name])
            n_leaves += 1
    assert n_leaves > 0


def test_a_group_cut_by_a_shard_raises():
    """d_ff 48 in groups of 16 over tp 2: w_down's shards of 24 rows
    each cut a group; the error names the weight, the group, the
    shard."""
    cfg = dataclasses.replace(ttr.tiny_config(), dtype=torch.float32,
                              d_ff=48)
    q = tq.quantize_weights_int4(_full(cfg), group=16)
    m = Mesh([2], ["tp"], 0)
    with pytest.raises(ValueError, match=r"layers\.0\.w_down: int4 scale "
                       r"groups of 16 rows .* 24 rows over 'tp' \(2 "
                       r"shards\)"):
        shard_params(q, cfg, m)
    # whole groups of 8: the same weight cuts
    q8 = tq.quantize_weights_int4(_full(cfg), group=8)
    assert shard_params(q8, cfg, m)["layers.0.w_down"]["scale4"].shape[
        -3] == 3


# -- the forward over two gloo ranks -----------------------------------------

TOKENS = np.random.default_rng(1).integers(0, 128, (2, 16)).astype(np.int32)


def _fields(jcfg):
    names = {f.name for f in dataclasses.fields(ttr.TransformerConfig)}
    out = {k: v for k, v in jcfg.__dict__.items()
           if k in names and k != "dtype"}
    if out.get("remat_policy") == "":
        out["remat_policy"] = "none"
    return out


def _model(moe: bool):
    """The JAX tiny model quantized to int4 (groups of 32) by the JAX
    package: its config, params and leaves as numpy arrays."""
    base = jtr.tiny_moe_config() if moe else jtr.tiny_config()
    jcfg = jtr.TransformerConfig(**{**base.__dict__, "dtype": jnp.float32})
    qj = jq.quantize_weights_int4(
        jtr.init_params(jax.random.key(0), jcfg), group=32)
    full = {k: ({kk: np.array(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else np.array(v, np.float32))
            for k, v in qj.items()}
    return jcfg, qj, full


@pytest.fixture(scope="module")
def forwards(tmp_path_factory):
    """Both cases in one spawn of two ranks; the JAX forwards run while
    the ranks do."""
    cases, models = [], {}
    for name, moe, axes in (("tp", False, {"tp": 2}),
                            ("ep", True, {"ep": 2})):
        models[name] = _model(moe)
        cases.append({"name": name, "axes": axes,
                      "cfg": _fields(models[name][0]),
                      "params": models[name][2], "tokens": TOKENS})
    handle = _torch_dist.start("quant_cases", 2,
                               tmp_path_factory.mktemp("qsh"), cases,
                               timeout=150)
    want = {name: (_fields(jcfg), full, np.asarray(
        jtr.forward(qj, jnp.asarray(TOKENS), jcfg)))
        for name, (jcfg, qj, full) in models.items()}
    return _torch_dist.collect(handle), want


@pytest.mark.parametrize("case", ["tp", "ep"])
def test_sharded_int4_forward_matches_unsharded(forwards, case):
    res, want = forwards
    fields, full, jax_logits = want[case]
    cfg = ttr.TransformerConfig(**fields, dtype=torch.float32)
    params = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()}
                  if isinstance(v, dict) else torch.from_numpy(v))
              for k, v in full.items()}
    with torch.no_grad():
        one = ttr.forward(params, torch.from_numpy(TOKENS), cfg).numpy()
    np.testing.assert_allclose(one, jax_logits, atol=ATOL)
    for rank_out in res:
        np.testing.assert_allclose(rank_out[case], one, atol=ATOL)
