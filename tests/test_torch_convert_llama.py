"""The port's HF Llama converter (nvme_strom_tpu_torch/tools/
convert_llama.py) and ``generate --from-hf`` held against the JAX
package's: HF-named safetensors are written here from a seed (no
download), both converters run on the same directory, and their outputs
must hold the same tensors byte for byte, the same ``strom_config.json``
and ``source.json``; greedy float32 tokens of the port's ``generate
--from-hf --device cpu`` must equal the JAX model's on the converted
weights (exact: token ids)."""

import json
import os

import numpy as np
import pytest
import torch

from nvme_strom_tpu.tools import convert_llama as jax_convert
from nvme_strom_tpu_torch import generate as gen_main
from nvme_strom_tpu_torch.formats.safetensors import (SafetensorsFile,
                                                      write_safetensors)
from nvme_strom_tpu_torch.tools import convert_llama

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128,
            rms_norm_eps=1e-5, rope_theta=10000.0, hidden_act="silu",
            tie_word_embeddings=False)
LLAMA3_SCALING = {"rope_type": "llama3", "factor": 8.0,
                  "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                  "original_max_position_embeddings": 16}


def write_hf_dir(d, seed=0, dtype=torch.float32, files=1, extra=None,
                 inv_freq=False, **overrides):
    """An HF Llama checkpoint directory: ``config.json`` and HF-named
    ``(out, in)`` weights drawn from ``seed``, in ``files`` safetensors
    files (more than one: with ``model.safetensors.index.json``)."""
    cfg = dict(TINY, **overrides)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg, f)
    rng = np.random.default_rng(seed)
    dm, ff, v = cfg["hidden_size"], cfg["intermediate_size"], \
        cfg["vocab_size"]
    hd = dm // cfg["num_attention_heads"]
    kv = cfg["num_key_value_heads"] * hd

    def w(*shape, scale=0.08):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)
        ).to(dtype)

    tensors = {"model.embed_tokens.weight": w(v, dm, scale=1.0)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        tensors.update({
            p + "self_attn.q_proj.weight": w(dm, dm),
            p + "self_attn.k_proj.weight": w(kv, dm),
            p + "self_attn.v_proj.weight": w(kv, dm),
            p + "self_attn.o_proj.weight": w(dm, dm),
            p + "mlp.gate_proj.weight": w(ff, dm),
            p + "mlp.up_proj.weight": w(ff, dm),
            p + "mlp.down_proj.weight": w(dm, ff),
            p + "input_layernorm.weight": 1.0 + w(dm, scale=0.1),
            p + "post_attention_layernorm.weight": 1.0 + w(dm, scale=0.1),
        })
        if inv_freq:
            tensors[p + "self_attn.rotary_emb.inv_freq"] = w(hd // 2)
    tensors["model.norm.weight"] = 1.0 + w(dm, scale=0.1)
    if not cfg["tie_word_embeddings"]:
        tensors["lm_head.weight"] = w(v, dm)
    tensors.update(extra or {})
    names = list(tensors)
    per = -(-len(names) // files)
    weight_map = {}
    for k in range(files):
        part = names[k * per:(k + 1) * per]
        fname = (f"model-{k + 1:05d}-of-{files:05d}.safetensors"
                 if files > 1 else "model.safetensors")
        write_safetensors(os.path.join(d, fname),
                          {n: tensors[n] for n in part})
        weight_map.update({n: fname for n in part})
    if files > 1:
        with open(os.path.join(d, "model.safetensors.index.json"),
                  "w") as f:
            json.dump({"metadata": {}, "weight_map": weight_map}, f)
    return d


def read_dir(d):
    """{name: (dtype, shape, bytes)} of every safetensors file in ``d``."""
    out = {}
    for n in sorted(os.listdir(d)):
        if not n.endswith(".safetensors"):
            continue
        sf = SafetensorsFile(os.path.join(d, n))
        with open(sf.path, "rb") as f:
            for name, t in sf.tensors.items():
                f.seek(t["offset"])
                out[name] = (t["dtype"], tuple(t["shape"]),
                             f.read(t["nbytes"]))
    return out


def _json(path):
    with open(path) as f:
        return json.load(f)


def test_map_name_matches_jax():
    names = ["model.embed_tokens.weight", "model.norm.weight",
             "lm_head.weight", "model.layers.0.self_attn.q_proj.weight",
             "model.layers.31.mlp.down_proj.weight",
             "model.layers.7.post_attention_layernorm.weight",
             "model.layers.0.self_attn.rotary_emb.inv_freq",
             "model.layers.0.self_attn.q_proj.bias", "other"]
    for n in names:
        assert convert_llama.map_name(n) == jax_convert.map_name(n), n


@pytest.mark.parametrize("case", ["plain", "tied", "llama3", "bf16",
                                  "index", "inv_freq"])
def test_convert_bitwise_equal_to_jax(tmp_path, case):
    """Both converters on one HF directory: the same tensors byte for
    byte (names, dtypes, shapes), config, provenance and summary."""
    kw = {"plain": {}, "tied": {"tie_word_embeddings": True},
          "llama3": {"rope_scaling": LLAMA3_SCALING},
          "bf16": {"dtype": torch.bfloat16}, "index": {"files": 3},
          "inv_freq": {"inv_freq": True}}[case]
    hf = write_hf_dir(str(tmp_path / "hf"), seed=1, **kw)
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    # a small shard size exercises the flush order too
    s_port = convert_llama.convert(hf, ours, shard_bytes=64 << 10)
    s_jax = jax_convert.convert(hf, theirs, shard_bytes=64 << 10)
    assert s_port["tensors"] == s_jax["tensors"]
    assert s_port["shards"] == s_jax["shards"] > 1
    assert s_port["skipped"] == s_jax["skipped"]
    assert s_port["config"] == s_jax["config"]
    got, want = read_dir(ours), read_dir(theirs)
    assert set(got) == set(want)
    for name in want:
        assert got[name] == want[name], name
    for fname in ("strom_config.json", "source.json"):
        assert _json(os.path.join(ours, fname)) == \
            _json(os.path.join(theirs, fname))
    if case == "tied":
        assert "lm_head" in got
    if case == "llama3":
        assert _json(os.path.join(ours, "strom_config.json"))[
            "rope_scaling"]["rope_type"] == "llama3"


@pytest.mark.parametrize("bad,match", [
    ({"hidden_act": "gelu"}, "hidden_act"),
    ({"attention_bias": True}, "attention_bias"),
    ({"mlp_bias": True}, "mlp_bias"),
    ({"head_dim": 32}, "head_dim"),
    ({"rope_scaling": {"rope_type": "yarn", "factor": 4}}, "rope_scaling"),
    ({"hidden_size": 66}, "divisible"),
])
def test_config_from_hf_refuses_like_jax(bad, match):
    hf = dict(TINY, **bad)
    with pytest.raises(ValueError, match=match):
        convert_llama.config_from_hf(hf)
    with pytest.raises(ValueError, match=match):
        jax_convert.config_from_hf(hf)


def test_config_from_hf_matches_jax():
    hf = dict(TINY, rope_scaling=LLAMA3_SCALING)
    ours = convert_llama.config_from_hf(hf)
    theirs = jax_convert.config_from_hf(hf)
    for k in convert_llama._CONFIG_KEYS:
        assert getattr(ours, k) == getattr(theirs, k), k
    assert ours.rope_scaling_dict == dict(theirs.rope_scaling)


def test_unmapped_weight_refused_and_ignored(tmp_path):
    extra = {"model.layers.0.self_attn.q_proj.bias": torch.zeros(64)}
    hf = write_hf_dir(str(tmp_path / "hf"), extra=extra)
    for conv in (convert_llama, jax_convert):
        with pytest.raises(ValueError, match="unmapped weight"):
            conv.convert(hf, str(tmp_path / f"out_{conv.__name__}"))
    s_port = convert_llama.convert(hf, str(tmp_path / "p"),
                                   ignore_unmapped=True)
    s_jax = jax_convert.convert(hf, str(tmp_path / "j"),
                                ignore_unmapped=True)
    assert s_port["skipped"] == s_jax["skipped"] == list(extra)


def test_missing_lm_head_refused(tmp_path):
    hf = write_hf_dir(str(tmp_path / "hf"), tie_word_embeddings=True)
    with open(os.path.join(hf, "config.json"), "w") as f:
        json.dump(dict(TINY), f)     # untied, but no lm_head tensor
    with pytest.raises(ValueError, match="lm_head"):
        convert_llama.convert(hf, str(tmp_path / "out"))


def _jax_tokens(out_dir, prompt, new):
    import functools

    import jax
    import jax.numpy as jnp
    from nvme_strom_tpu.models.decode import generate
    from nvme_strom_tpu.models.transformer import TransformerConfig
    from nvme_strom_tpu.parallel.weights import LazyCheckpoint
    cfg = TransformerConfig(dtype=jnp.float32,
                            **_json(os.path.join(out_dir,
                                                 "strom_config.json")))
    params = LazyCheckpoint(out_dir).load_sharded(
        lambda name, shape: jax.sharding.SingleDeviceSharding(
            jax.devices()[0]))
    gen = jax.jit(functools.partial(generate, cfg=cfg, max_new_tokens=new))
    return np.asarray(gen(params, jnp.asarray([prompt], jnp.int32))[0]
                      ).tolist()


def _port_tokens(capsys, argv):
    assert gen_main.main(argv) == 0
    out = capsys.readouterr().out
    line = next(x for x in out.splitlines() if x.startswith("output ids:"))
    return [int(t) for t in line.split(":", 1)[1].strip().split(",")], out


@pytest.mark.parametrize("case", ["plain", "llama3"])
def test_generate_from_hf_tokens_equal_jax(tmp_path, capsys, case):
    """``generate --from-hf`` converts once, reuses the conversion, and
    its greedy float32 tokens equal the JAX model's on the converted
    weights."""
    kw = {"rope_scaling": LLAMA3_SCALING} if case == "llama3" else {}
    hf = write_hf_dir(str(tmp_path / "hf"), seed=3, **kw)
    out_dir = str(tmp_path / "converted")
    prompt = [5, 17, 99, 3, 64, 2, 120, 33, 8, 41, 77, 19, 60, 7, 90, 11,
              1, 2, 3, 4]
    argv = ["--from-hf", hf, "--out-dir", out_dir, "--prompt",
            ",".join(map(str, prompt)), "--new", "12", "--device", "cpu",
            "--dtype", "float32"]
    ours, text = _port_tokens(capsys, argv)
    assert "converted 21 tensors" in text
    again, text = _port_tokens(capsys, argv)
    assert "converted" not in text and again == ours
    assert ours == _jax_tokens(out_dir, prompt, 12)


def test_generate_from_hf_needs_out_dir(tmp_path, capsys):
    with pytest.raises(SystemExit):
        gen_main.main(["--from-hf", str(tmp_path), "--device", "cpu"])
    assert "--out-dir" in capsys.readouterr().err


def test_train_lm_from_hf_converts_once_and_refuses_another(tmp_path,
                                                            capsys):
    """``train_lm --from-hf``: the model config is the checkpoint's
    (``max_seq`` capped at ``--seq-len``), the conversion is made once
    under ``--ckpt-dir/hf_converted`` and reused, and a conversion of
    another checkpoint is refused, as the JAX example does."""
    from nvme_strom_tpu_torch import train_lm
    hf = write_hf_dir(str(tmp_path / "hf"), seed=4)
    ck = str(tmp_path / "ck")
    base = ["--from-hf", hf, "--ckpt-dir", ck, "--device", "cpu",
            "--seq-len", "32", "--global-batch", "2", "--save-every", "2"]
    assert train_lm.main(base + ["--steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "from-hf: converted 21 tensors" in out
    assert "model: d=64 L=2 vocab=128 seq=32" in out
    assert _json(os.path.join(ck, "hf_converted", "source.json"))[
        "config_sha256"]
    assert train_lm.main(base + ["--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "reusing converted shards" in out and "resumed from step 2" in out
    other = write_hf_dir(str(tmp_path / "hf2"), seed=5,
                         max_position_embeddings=64)
    with pytest.raises(SystemExit):
        train_lm.main(["--from-hf", other] + base[2:] + ["--steps", "4"])
    assert "different checkpoint" in capsys.readouterr().err


@pytest.mark.parametrize("extra,msg", [
    (["--tiny"], "mutually exclusive"),
    (["--init-weights", "w"], "mutually exclusive"),
])
def test_train_lm_from_hf_conflicts(tmp_path, capsys, extra, msg):
    from nvme_strom_tpu_torch import train_lm
    with pytest.raises(SystemExit):
        train_lm.main(["--from-hf", str(tmp_path), "--ckpt-dir",
                       str(tmp_path / "ck"), "--device", "cpu", *extra])
    assert msg in capsys.readouterr().err
    with pytest.raises(SystemExit):
        train_lm.main(["--from-hf", str(tmp_path), "--device", "cpu"])
    assert "--ckpt-dir" in capsys.readouterr().err
