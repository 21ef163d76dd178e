"""The port's .npy / .npz reader (nvme_strom_tpu_torch/formats/npy.py)
and its two new entry points, ``train_vit`` and ``eval_ppl``, held
against the JAX package: the npy cases of tests/test_formats.py (plans
equal to the JAX planner's, payloads bitwise; 8-byte dtypes read where
the JAX reader refuses them without x64), what tests/test_example.py
asserts of the two examples, run in process on the CPU, and the eval
loss against the JAX example's formula over the same weights."""

import dataclasses
import json
import re
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvme_strom_tpu.formats import npy as jax_npy
from nvme_strom_tpu.models import quant as jax_quant
from nvme_strom_tpu.models.transformer import forward as jax_forward
from nvme_strom_tpu.models.transformer import init_params as jax_init
from nvme_strom_tpu.models.transformer import tiny_config as jax_tiny
from nvme_strom_tpu.parallel.weights import save_checkpoint as jax_save
from nvme_strom_tpu_torch import eval_ppl, train_vit
from nvme_strom_tpu_torch.convert import params_from_jax
from nvme_strom_tpu_torch.formats import (plan_npy, plan_npz,
                                          read_npy_to_device,
                                          read_npz_to_device)
from nvme_strom_tpu_torch.io.engine import StromEngine
from nvme_strom_tpu_torch.models import quant
from nvme_strom_tpu_torch.models.transformer import tiny_config

CPU = "cpu"


def _same_entry(ours, theirs):
    assert (ours.key, ours.offset, ours.length, ours.dtype,
            tuple(ours.shape)) == (theirs.key, theirs.offset, theirs.length,
                                   theirs.dtype, tuple(theirs.shape))


class TestNpy:

    def test_npy_roundtrip_dtypes(self, tmp_path):
        rng = np.random.default_rng(0)
        arrays = {
            "f32": rng.standard_normal((33, 7)).astype(np.float32),
            "i32": rng.integers(-2**30, 2**30, (5, 4, 3)).astype(np.int32),
            "u8": rng.integers(0, 255, 1000, dtype=np.uint8),
            "f16": rng.standard_normal(17).astype(np.float16),
            "scalar0d": np.ones((), np.float32) * np.float32(3.5),
            "empty": np.zeros((0, 4), np.float32),
        }
        with StromEngine() as eng:
            for name, arr in arrays.items():
                p = str(tmp_path / f"{name}.npy")
                np.save(p, arr)
                entry = plan_npy(p)
                _same_entry(entry, jax_npy.plan_npy(p))
                assert entry.length == arr.nbytes
                assert tuple(entry.shape) == arr.shape
                got = read_npy_to_device(eng, p, device=CPU)
                assert got.shape == arr.shape
                np.testing.assert_array_equal(got.numpy(), arr)

    def test_eight_byte_dtypes_read_bitwise(self, tmp_path):
        """int64 / float64 / uint64: the JAX reader refuses them without
        x64 (its bitcast would truncate); torch has them, so the port
        reads them bitwise."""
        rng = np.random.default_rng(1)
        arrays = {"i64": rng.integers(-2**40, 2**40, (6,)),
                  "f64": rng.standard_normal((3, 5)),
                  "u64": rng.integers(0, 2**63, 4, dtype=np.uint64)}
        with StromEngine() as eng:
            for name, arr in arrays.items():
                p = str(tmp_path / f"{name}.npy")
                np.save(p, arr)
                assert plan_npy(p).length == arr.nbytes
                got = read_npy_to_device(eng, p, device=CPU)
                np.testing.assert_array_equal(got.numpy(), arr)
                assert got.numpy().dtype == arr.dtype
        # the reference refuses the same file
        from nvme_strom_tpu.io.engine import StromEngine as JaxEngine
        if not jax.config.jax_enable_x64:
            with JaxEngine() as jeng, pytest.raises(ValueError, match="x64"):
                jax_npy.read_npy_to_device(jeng,
                                           str(tmp_path / "i64.npy"))

    def test_npy_rejects_fortran_and_object(self, tmp_path):
        pf = str(tmp_path / "f.npy")
        np.save(pf, np.asfortranarray(np.arange(12.0).reshape(3, 4)))
        with pytest.raises(ValueError, match="fortran"):
            plan_npy(pf)
        po = str(tmp_path / "o.npy")
        np.save(po, np.array([{"a": 1}], dtype=object), allow_pickle=True)
        with pytest.raises(ValueError, match="object"):
            plan_npy(po)

    def test_npz_members_to_device(self, tmp_path):
        rng = np.random.default_rng(1)
        a = rng.standard_normal((16, 16)).astype(np.float32)
        b = rng.integers(0, 99, 64, dtype=np.int32)
        p = str(tmp_path / "pack.npz")
        np.savez(p, weights=a, ids=b)
        plan = plan_npz(p)
        jplan = jax_npy.plan_npz(p)
        assert {e.key for e in plan.entries} == {"weights", "ids"}
        for ours, theirs in zip(plan.entries, jplan.entries):
            _same_entry(ours, theirs)
        assert plan.ranges() == jplan.ranges()
        with StromEngine() as eng:
            out = read_npz_to_device(eng, p, device=CPU)
            np.testing.assert_array_equal(out["weights"].numpy(), a)
            np.testing.assert_array_equal(out["ids"].numpy(), b)
            only = read_npz_to_device(eng, p, device=CPU, keys=["ids"])
            assert set(only) == {"ids"}
            with pytest.raises(KeyError, match="not in plan"):
                read_npz_to_device(eng, p, device=CPU, keys=["nope"])

    def test_npz_rejects_compressed(self, tmp_path):
        p = str(tmp_path / "c.npz")
        np.savez_compressed(p, x=np.arange(1000.0))
        with pytest.raises(ValueError, match="compressed"):
            plan_npz(p)

    def test_npy_rejects_big_endian_and_structured(self, tmp_path):
        pb = str(tmp_path / "be.npy")
        np.save(pb, np.arange(10, dtype=np.float32).astype(">f4"))
        with pytest.raises(ValueError, match="big-endian"):
            plan_npy(pb)
        ps = str(tmp_path / "rec.npy")
        np.save(ps, np.zeros(4, dtype=[("a", "<i4"), ("b", "<f4")]))
        with pytest.raises(ValueError, match="structured"):
            plan_npy(ps)

    def test_npy_header_larger_than_window(self, tmp_path):
        arr = np.zeros((2, 3), np.float32)
        p = str(tmp_path / "bighdr.npy")
        np.save(p, arr)
        raw = open(p, "rb").read()
        hdr_end = 10 + struct.unpack_from("<H", raw, 8)[0]
        header = raw[10:hdr_end].rstrip(b"\n").rstrip()
        pad = 8192 - (10 + len(header) + 1)
        big = (raw[:8] + struct.pack("<H", len(header) + pad + 1)
               + header + b" " * pad + b"\n" + raw[hdr_end:])
        open(p, "wb").write(big)
        np.testing.assert_array_equal(np.load(p), arr)
        entry = plan_npy(p)
        _same_entry(entry, jax_npy.plan_npy(p))
        assert entry.offset == 8192
        assert entry.length == arr.nbytes

    def test_npy_header_fuzz(self, tmp_path):
        """Corrupt headers raise, never hang or allocate without bound,
        and where the JAX planner accepts one the port's plan is its."""
        rng = np.random.default_rng(9)
        good = str(tmp_path / "good.npy")
        np.save(good, np.zeros(8, np.float32))
        raw = bytearray(open(good, "rb").read())
        p = str(tmp_path / "fuzz.npy")
        errors = (ValueError, SyntaxError, KeyError, TypeError,
                  OverflowError)
        for _ in range(300):
            buf = bytearray(raw)
            for _ in range(rng.integers(1, 6)):
                buf[rng.integers(0, len(buf))] = rng.integers(0, 256)
            open(p, "wb").write(bytes(buf))
            try:
                theirs = jax_npy.plan_npy(p)
            except errors:
                theirs = None
            try:
                ours = plan_npy(p)
            except errors:
                assert theirs is None
                continue
            assert ours.length >= 0
            _same_entry(ours, theirs)


# -- the entry points ---------------------------------------------------------

def test_train_vit_fixedrec(capsys):
    """``train_vit`` streams fixedrec records and decodes them on the
    device: finite losses, the step lines, the stats line."""
    assert train_vit.main(["--steps", "4", "--global-batch", "8",
                           "--image-size", "32", "--classes", "10",
                           "--device", CPU]) == 0
    out = capsys.readouterr().out
    assert "step 4" in out
    losses = [float(m) for m in re.findall(r"loss=([\d.]+)", out)]
    assert losses and all(l == l and l < 100 for l in losses)
    assert "engine stats" in out and "bounce=" in out
    assert "img/s" in out


def test_train_vit_tp_waits_for_multi_gpu(capsys):
    with pytest.raises(SystemExit) as e:
        train_vit.main(["--tp", "2", "--device", CPU])
    assert e.value.code != 0
    assert "torchrun" in capsys.readouterr().err


def test_train_vit_decodes_records_on_the_device(tmp_path):
    """``decode_records`` views the label bytes as the labels written
    (little-endian int32) and scales the image bytes by 1/255."""
    from nvme_strom_tpu_torch.formats.fixedrec import FixedRecIndex
    from nvme_strom_tpu_torch.models.vit import tiny_vit_config
    cfg = dataclasses.replace(tiny_vit_config(), image_size=4, patch_size=2,
                              dtype=torch.float32)
    img_bytes = 3 * 4 * 4
    paths = train_vit.synthesize_shards(str(tmp_path), img_bytes, 10,
                                        n_shards=1, per_shard=5)
    ix = FixedRecIndex(paths[0])
    # the records open the file; the footer follows them
    rec = np.fromfile(paths[0], np.uint8, count=ix.count * ix.record_bytes
                      ).reshape(ix.count, ix.record_bytes)
    imgs, labels = train_vit.decode_records(torch.from_numpy(rec), cfg)
    assert labels.tolist() == \
        rec[:, img_bytes:].copy().view("<i4")[:, 0].tolist()
    assert ((labels >= 0) & (labels < 10)).all()
    np.testing.assert_array_equal(
        imgs.numpy(), rec[:, :img_bytes].reshape(5, 4, 4, 3)
        .astype(np.float32) / 255.0)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The JAX tiny config's weights saved by the JAX package, its
    config beside them, and 12 rows of 32 uniform-random token ids."""
    d = tmp_path_factory.mktemp("eval")
    cfg = jax_tiny()
    params = jax_init(jax.random.key(0), cfg)
    wdir = d / "w"
    wdir.mkdir()
    jax_save(str(wdir / "model.safetensors"), params)
    with open(wdir / "strom_config.json", "w") as f:
        json.dump({k: v for k, v in cfg.__dict__.items() if k != "dtype"}, f)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab, (12, 32)).astype(np.int32)
    np.save(d / "ev.npy", toks)
    return dict(dir=d, wdir=str(wdir), npy=str(d / "ev.npy"), cfg=cfg,
                params=params, toks=toks)


def _ppl(out: str) -> float:
    return float(out.split("perplexity:")[1].split()[0])


def test_eval_ppl_cli(weights, capsys):
    """Uniform-random tokens through an untrained model: perplexity
    within 0.5–4 × the vocabulary, also under the mixed recipe."""
    vocab = weights["cfg"].vocab
    assert eval_ppl.main(["--weights", weights["wdir"], "--npy",
                          weights["npy"], "--batch", "4",
                          "--device", CPU]) == 0
    out = capsys.readouterr().out
    assert 0.5 * vocab < _ppl(out) < 4 * vocab
    assert "engine stats" in out
    assert eval_ppl.main(["--weights", weights["wdir"], "--npy",
                          weights["npy"], "--batch", "4", "--int8",
                          "--int4", "--device", CPU]) == 0
    out = capsys.readouterr().out
    assert "int4: matmul weights packed" in out
    assert 0.5 * vocab < _ppl(out) < 4 * vocab


def test_eval_ppl_chunked_and_batches_cap(weights, capsys):
    """``--xent-chunks`` gives the full path's cross-entropy; ``--batches``
    caps the batches evaluated."""
    ce = {}
    for extra in ([], ["--xent-chunks", "4"]):
        assert eval_ppl.main(["--weights", weights["wdir"], "--npy",
                              weights["npy"], "--batch", "4",
                              "--dtype", "float32", "--device", CPU]
                             + extra) == 0
        out = capsys.readouterr().out
        ce[len(extra)] = float(out.split("cross-entropy:")[1].split()[0])
    assert ce[2] == pytest.approx(ce[0], rel=1e-5)
    assert eval_ppl.main(["--weights", weights["wdir"], "--npy",
                          weights["npy"], "--batch", "4", "--batches", "1",
                          "--device", CPU]) == 0
    assert "evaluated 1 batches" in capsys.readouterr().out


def test_eval_ppl_data_dir(weights, tmp_path, capsys):
    from nvme_strom_tpu_torch.train_lm import synthesize_shards
    synthesize_shards(str(tmp_path), weights["cfg"].vocab, 32, n_shards=2,
                      per_shard=8)
    assert eval_ppl.main(["--weights", weights["wdir"], "--data-dir",
                          str(tmp_path), "--batch", "4", "--batches", "3",
                          "--device", CPU]) == 0
    out = capsys.readouterr().out
    assert "evaluated 3 batches" in out
    assert 0.5 * weights["cfg"].vocab < _ppl(out) < 4 * weights["cfg"].vocab


@pytest.mark.parametrize("arr, match", [
    (np.zeros((4,), np.int32), "must be \\(n, seq\\)"),
    (np.zeros((4, 8), np.int64), "int32 token ids"),
    (np.zeros((4, 1), np.int32), "nothing to predict"),
    (np.full((4, 8), 10**6, np.int32), "outside"),
])
def test_eval_ppl_npy_refusals(weights, tmp_path, capsys, arr, match):
    p = str(tmp_path / "bad.npy")
    np.save(p, arr)
    with pytest.raises(SystemExit) as e:
        eval_ppl.main(["--weights", weights["wdir"], "--npy", p,
                       "--batch", "4", "--device", CPU])
    assert e.value.code != 0
    assert re.search(match, capsys.readouterr().err)


def _jax_eval_loss(params, tokens, cfg):
    """The JAX example's ``eval_loss`` formula (examples/eval_ppl.py)."""
    logits = jax_forward(params, tokens, cfg)
    lp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), -1)
    ll = jnp.take_along_axis(lp, tokens[:, 1:, None], axis=-1)
    return -jnp.mean(ll)


@pytest.mark.parametrize("recipe", ["fp", "int8"])
def test_eval_loss_matches_jax_formula(weights, recipe):
    """Over the same weights and tokens in float32 the port's
    ``eval_loss`` is the JAX example's within 1e-4 relative, plain and
    with int8 weights (each package quantizing its own copy)."""
    jcfg = dataclasses.replace(weights["cfg"], dtype=jnp.float32)
    cfg = dataclasses.replace(tiny_config(), dtype=torch.float32)
    jparams = weights["params"]
    params = params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                             cfg, CPU)
    if recipe == "int8":
        jparams = jax_quant.quantize_weights_int8(jparams)
        params = quant.quantize_weights_int8(params)
    toks = weights["toks"][:4]
    want = float(_jax_eval_loss(jparams, jnp.asarray(toks), jcfg))
    got = float(eval_ppl.eval_loss(params, torch.from_numpy(toks), cfg))
    assert got == pytest.approx(want, rel=1e-4)
