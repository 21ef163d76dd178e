"""The weight-only int8 / int4 matmul of the port (nvme_strom_tpu_torch/
ops/quant_matmul.py) on the CPU, held against the JAX package's
``x @ wmat(...)`` (nvme_strom_tpu/models/transformer.py) on the same
numpy weights and leaves.

The kernels themselves run on the card only (tests/test_torch_cuda.py
and chip_smoke.py ``check_quant``); here their plain versions and the
GEMV's split model are held to the JAX product, and the projections of
the model to today's ``x @ wmat(...)`` torch ops bit for bit.

Tolerances: float32 within atol 2e-5 (the two products sum in another
order).  bfloat16: both round the weight alike (exactly), sum in float32
and round the output once, so they differ by at most one bfloat16 ulp of
the output (rtol 2**-7) plus float32 summation-order noise near zero
(atol 1e-3 of the largest |out|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvme_strom_tpu.models import quant as jq
from nvme_strom_tpu.models import transformer as jtr
from nvme_strom_tpu_torch.models import quant as tq
from nvme_strom_tpu_torch.models import transformer as ttr
from nvme_strom_tpu_torch.ops import quant_matmul as qmm

ATOL32 = 2e-5
BF16_RTOL = 2 ** -7
BF16_ATOL_OF_MAX = 1e-3

#: (d_in, d_out) of the weights: d_in 96 takes groups of 32 and of 24
#: (3 and 4 groups), d_out 44 is not a multiple of the kernel's 8
K, N, E = 96, 44, 3
LEAVES = {
    "int8": lambda p, m: m.quantize_weights_int8(p, suffixes=("w",)),
    "int4_g32": lambda p, m: m.quantize_weights_int4(p, suffixes=("w",),
                                                     group=32),
    "int4_g24": lambda p, m: m.quantize_weights_int4(p, suffixes=("w",),
                                                     group=24),
}


def _weights(experts: bool, seed: int = 0) -> np.ndarray:
    shape = (E, K, N) if experts else (K, N)
    return (np.random.default_rng(seed).standard_normal(shape)
            * 0.05).astype(np.float32)


def _leaves(how: str, experts: bool):
    """The JAX leaf and the port's own, quantized from the same numpy
    weight (tests/test_torch_quant_moe.py holds them bit for bit)."""
    w = _weights(experts)
    jleaf = LEAVES[how]({"w": jnp.asarray(w)}, jq)["w"]
    tleaf = LEAVES[how]({"w": torch.from_numpy(w.copy())}, tq)["w"]
    for k in jleaf:
        assert np.array_equal(np.asarray(jleaf[k]), tleaf[k].numpy()), k
    return jleaf, tleaf


def _x(experts: bool, m: int, seed: int = 1) -> np.ndarray:
    shape = (E, m, K) if experts else (m, K)
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jax_product(x: np.ndarray, jleaf, dtype) -> np.ndarray:
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    out = jnp.asarray(x, jd) @ jtr.wmat({"w": jleaf}, "w", jd)
    return np.asarray(out.astype(jnp.float32))


def _close(got: torch.Tensor, want: np.ndarray, dtype: str) -> None:
    g = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(g, want, rtol=0, atol=ATOL32)
    else:
        np.testing.assert_allclose(
            g, want, rtol=BF16_RTOL,
            atol=BF16_ATOL_OF_MAX * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 5, 17])
@pytest.mark.parametrize("how", list(LEAVES))
@pytest.mark.parametrize("experts", [False, True], ids=["2d", "3d"])
def test_plain_product_matches_jax(experts, how, m, dtype):
    """``quant_matmul_plain`` and ``quant_matmul`` on CPU tensors (the
    route the wrapper takes there) against the JAX ``x @ wmat``."""
    jleaf, tleaf = _leaves(how, experts)
    x = _x(experts, m)
    want = _jax_product(x, jleaf, dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = qmm.quant_matmul_plain(xt, tleaf)
    assert got.dtype == xt.dtype and tuple(got.shape) == want.shape
    _close(got, want, dtype)
    assert torch.equal(qmm.quant_matmul(xt, tleaf), got)


#: split lengths of the GEMV's model: 16 splits each int4 group of 32 in
#: two, 40 straddles groups of 32 and of 24, 96 is one split; the int8
#: leaf also takes an odd split
SPLITS = {"int8": (7, 16, 40, 96), "int4_g32": (16, 40, 96),
          "int4_g24": (16, 40, 96)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 5, 17])
@pytest.mark.parametrize("how", list(LEAVES))
@pytest.mark.parametrize("experts", [False, True], ids=["2d", "3d"])
def test_split_model_matches_jax(experts, how, m, dtype):
    """The GEMV's split partials and their fixed-order combine in torch
    against the JAX ``x @ wmat``, at split lengths that cut through an
    int4 group; x in the kernel's (E, M, K) layout for a 3-D leaf."""
    jleaf, tleaf = _leaves(how, experts)
    x = _x(experts, m)
    want = _jax_product(x, jleaf, dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    plain = qmm.quant_matmul_plain(xt, tleaf)
    for rows in SPLITS[how]:
        got = qmm.quant_gemv_split_plain(xt, tleaf, rows)
        assert got.dtype == xt.dtype and tuple(got.shape) == want.shape
        _close(got, want, dtype)
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0,
                                       atol=ATOL32)


def test_split_model_refuses_an_odd_int4_split():
    _, tleaf = _leaves("int4_g32", False)
    with pytest.raises(ValueError, match="even row"):
        qmm.quant_gemv_split_plain(torch.zeros(1, K), tleaf, 15)


@pytest.mark.parametrize("how", list(LEAVES))
def test_gemv_wrapper_on_cpu_is_the_plain_product(how):
    """``quant_gemv`` takes x (E, M, K); on the CPU it is the plain
    product, for a 2-D leaf with E = 1."""
    for experts in (False, True):
        _, tleaf = _leaves(how, experts)
        x = torch.from_numpy(_x(True, 3)[: E if experts else 1])
        got = qmm.quant_gemv(x, tleaf)
        want = qmm.quant_matmul_plain(x if experts else x[0], tleaf)
        assert torch.equal(got, want if experts else want[None])


@pytest.mark.parametrize("how", list(LEAVES))
def test_dequant_plain_is_the_jax_weight(how):
    for experts in (False, True):
        jleaf, tleaf = _leaves(how, experts)
        for dt, jd in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
            want = np.asarray(jtr.wmat({"w": jleaf}, "w", jd).astype(
                jnp.float32))
            got = qmm.dequant(tleaf, dt)
            assert torch.equal(got, qmm.dequant_plain(tleaf, dt))
            np.testing.assert_array_equal(got.float().numpy(), want)
    assert qmm.dequant_plain.device_calls == 0


def test_leaf_parts():
    _, l8 = _leaves("int8", True)
    _, l4 = _leaves("int4_g24", False)
    q, s, bits, e, k, n, g = qmm.leaf_parts(l8)
    assert (bits, e, k, n, g) == (8, E, K, N, K)
    q, s, bits, e, k, n, g = qmm.leaf_parts(l4)
    assert (bits, e, k, n, g) == (4, 1, K, N, 24)
    with pytest.raises(ValueError, match="does not fit"):
        qmm.leaf_parts({"q8": l8["q8"], "scale": l8["scale"][:, :, :-1]})
    with pytest.raises(ValueError, match="expected"):
        qmm.leaf_parts({"q4": l4["q4"].to(torch.int8),
                        "scale4": l4["scale4"]})
    with pytest.raises(ValueError, match="does not fit"):
        qmm.quant_gemv(torch.zeros(1, 2, K + 2), l4)


@pytest.mark.parametrize("m", [1, 2, 3, 8, 9, 16, 17, 64])
@pytest.mark.parametrize("shape", [(1, 4096, 14336), (1, 14336, 4096),
                                   (1, 4096, 1024), (8, 4096, 14336),
                                   (1, 4096, 32000), (1, 48, 1000)])
def test_kernel_launch(shape, m):
    """The split plan: splits of whole, even rows (an int4 split starts
    on an even row), at least MIN_SPLIT_ROWS, covering d_in with no empty
    split, never more splits than the grid's target of BLOCKS_PER_SM
    blocks a SM needs; the workspace every split's partials."""
    e, k, n = shape
    sms = 132
    rows, splits, ws = qmm.kernel_launch(e, m, k, n, sms)
    assert rows % qmm.SPLIT_ROW_STEP == 0 and rows >= qmm.MIN_SPLIT_ROWS
    assert (splits - 1) * rows < k <= splits * rows
    assert ws == (splits * e * m * n if splits > 1 else 0)
    mt, vec = qmm.row_tile(m)
    assert mt >= min(m, 16) and mt * vec <= 64
    base = -(-n // (32 * vec)) * e * -(-m // mt)
    assert splits <= max(1, -(-qmm.BLOCKS_PER_SM * sms // base))


@pytest.mark.parametrize("how", list(LEAVES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_project_is_x_at_wmat_bitwise(how, dtype):
    """The model's projections (dense ``project`` and the experts'
    batched one) on CPU tensors are exactly today's ``x @ wmat(...)``;
    a plain leaf is ``x @ w``."""
    from nvme_strom_tpu_torch.models import moe as tmoe
    _, l2 = _leaves(how, False)
    _, l3 = _leaves(how, True)
    p = {"w": l2, "we": l3, "plain": torch.from_numpy(_weights(False))}
    x = torch.from_numpy(_x(False, 5)).to(dtype).reshape(1, 5, K)
    assert torch.equal(ttr.project(x, p, "w"),
                       x @ ttr.wmat(p, "w", dtype))
    assert torch.equal(ttr.project(x, p, "plain"),
                       x @ p["plain"].to(dtype))
    xe = torch.from_numpy(_x(True, 4)).to(dtype)
    assert torch.equal(tmoe._expert_project(xe, p, "we"),
                       xe @ ttr.wmat(p, "we", dtype))
