"""convert_llama — a HuggingFace Llama checkpoint (local safetensors with
HF names) → the port's layout.

HF names its tensors ``model.layers.N.self_attn.q_proj.weight`` and
stores projections ``(out, in)``; models/transformer.py names them
``layers.N.wq`` and keeps ``(in, out)``.  This tool converts once, on the
host (copies here are deliberate and off the hot path); the output is
read like any checkpoint of the port (``LazyCheckpoint``, the engine's
O_DIRECT reads through ``h2d_copy``).

- RoPE: both rotate half-split features with ``theta^(-i/half)``
  frequencies, so no head-dim permutation; llama3 ``rope_scaling`` is
  carried into the config.
- Projections transpose; the token embedding is ``(vocab, d)`` on both
  sides; tied embeddings (``tie_word_embeddings``) become an explicit
  transposed ``lm_head``.
- Architecture knobs the model does not implement (a non-SiLU
  activation, biases, a decoupled head_dim, another rope scaling) are
  refused, and so is an unmapped weight tensor: converting without it
  would give a model with wrong logits.

Counterpart of nvme_strom_tpu/tools/convert_llama.py: the same tensors,
byte for byte, and the same ``strom_config.json`` and ``source.json``.
Reads through the port's safetensors reader, writes with its writer.

    python -m nvme_strom_tpu_torch.tools.convert_llama HF_DIR OUT_DIR \\
        [--shard-bytes BYTES] [--ignore-unmapped]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import sys
from typing import Dict, Iterator, Optional, Tuple

_LAYER_RULES: Tuple[Tuple[str, str, bool], ...] = (
    # (HF suffix, the port's suffix, transpose)
    ("self_attn.q_proj.weight", "wq", True),
    ("self_attn.k_proj.weight", "wk", True),
    ("self_attn.v_proj.weight", "wv", True),
    ("self_attn.o_proj.weight", "wo", True),
    ("mlp.gate_proj.weight", "w_gate", True),
    ("mlp.up_proj.weight", "w_up", True),
    ("mlp.down_proj.weight", "w_down", True),
    ("input_layernorm.weight", "attn_norm", False),
    ("post_attention_layernorm.weight", "mlp_norm", False),
)

_TOP_RULES: Dict[str, Tuple[str, bool]] = {
    "model.embed_tokens.weight": ("tok_embed", False),
    "model.norm.weight": ("final_norm", False),
    "lm_head.weight": ("lm_head", True),
}

_LAYER_RE = re.compile(r"^model\.layers\.(\d+)\.(.+)$")

#: non-weight buffers some exports carry, dropped without a word
_SKIP_OK_RE = re.compile(r"rotary_emb\.inv_freq$")

#: the config fields ``strom_config.json`` holds
_CONFIG_KEYS = ("vocab", "d_model", "n_layers", "n_heads", "n_kv_heads",
                "d_ff", "max_seq", "rope_theta", "norm_eps")


def map_name(hf_name: str) -> Optional[Tuple[str, bool]]:
    """HF tensor name → (the port's name, transpose); None when not
    mapped (``convert`` decides whether that is a buffer or an error)."""
    if hf_name in _TOP_RULES:
        return _TOP_RULES[hf_name]
    m = _LAYER_RE.match(hf_name)
    if m:
        idx, rest = m.group(1), m.group(2)
        for hf_suffix, ours, tr in _LAYER_RULES:
            if rest == hf_suffix:
                return f"layers.{idx}.{ours}", tr
    return None


def config_from_hf(hf_cfg: dict):
    """HF ``config.json`` → ``TransformerConfig`` (dense Llama family);
    raises on what the model does not implement."""
    from nvme_strom_tpu_torch.models.transformer import TransformerConfig
    act = hf_cfg.get("hidden_act", "silu")
    if act != "silu":
        raise ValueError(f"unsupported hidden_act {act!r} (model is "
                         "SiLU-gated)")
    for knob in ("attention_bias", "mlp_bias"):
        if hf_cfg.get(knob):
            raise ValueError(f"unsupported {knob}=True (model has no "
                             "bias terms)")
    if hf_cfg["hidden_size"] % hf_cfg["num_attention_heads"]:
        raise ValueError("hidden_size not divisible by num_attention_heads")
    derived_hd = hf_cfg["hidden_size"] // hf_cfg["num_attention_heads"]
    if hf_cfg.get("head_dim", derived_hd) != derived_hd:
        raise ValueError(
            f"unsupported explicit head_dim={hf_cfg['head_dim']} "
            f"(model derives {derived_hd} = hidden_size/num_heads)")
    scaling = hf_cfg.get("rope_scaling")
    if scaling is not None:
        rt = scaling.get("rope_type", scaling.get("type"))
        if rt != "llama3":
            raise ValueError(f"unsupported rope_scaling type {rt!r} "
                             "(only llama3 frequency scaling)")
        scaling = {k: v for k, v in scaling.items()
                   if k in ("rope_type", "type", "factor",
                            "low_freq_factor", "high_freq_factor",
                            "original_max_position_embeddings")}
    return TransformerConfig(
        vocab=hf_cfg["vocab_size"],
        d_model=hf_cfg["hidden_size"],
        n_layers=hf_cfg["num_hidden_layers"],
        n_heads=hf_cfg["num_attention_heads"],
        n_kv_heads=hf_cfg.get("num_key_value_heads",
                              hf_cfg["num_attention_heads"]),
        d_ff=hf_cfg["intermediate_size"],
        max_seq=hf_cfg.get("max_position_embeddings", 2048),
        rope_theta=float(hf_cfg.get("rope_theta", 10000.0)),
        rope_scaling=scaling,
        norm_eps=float(hf_cfg.get("rms_norm_eps", 1e-5)),
    )


def _hf_files(hf_dir: str) -> list:
    """The checkpoint's safetensors files: those of
    ``model.safetensors.index.json``, else every one in the directory,
    sorted."""
    idx_path = os.path.join(hf_dir, "model.safetensors.index.json")
    if os.path.exists(idx_path):
        with open(idx_path) as f:
            index = json.load(f)
        return sorted({os.path.join(hf_dir, v)
                       for v in index["weight_map"].values()})
    return sorted(os.path.join(hf_dir, n) for n in os.listdir(hf_dir)
                  if n.endswith(".safetensors"))


def _iter_hf_tensors(hf_dir: str) -> Iterator[Tuple[str, "object"]]:
    """(HF name, CPU tensor in its stored dtype) across every file of
    the checkpoint, in file then header order."""
    import torch
    from nvme_strom_tpu_torch.parallel.weights import LazyCheckpoint
    from nvme_strom_tpu_torch.formats.safetensors import torch_dtype
    ckpt = LazyCheckpoint(_hf_files(hf_dir))
    for sf in ckpt.files:
        with open(sf.path, "rb") as f:
            for name in sf.keys():
                t = sf.tensors[name]
                f.seek(t["offset"])
                raw = bytearray(f.read(t["nbytes"]))
                arr = torch.frombuffer(raw, dtype=torch_dtype(t["dtype"])) \
                    if raw else torch.empty(0, dtype=torch_dtype(t["dtype"]))
                yield name, arr.reshape(t["shape"])


def _config_sha(hf_dir: str) -> str:
    with open(os.path.join(hf_dir, "config.json"), "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def convert(hf_dir: str, out_dir: str, shard_bytes: int = 1 << 30,
            ignore_unmapped: bool = False) -> dict:
    """Convert ``hf_dir`` into ``out_dir``: ``strom-NNNNN.safetensors``
    shards of about ``shard_bytes``, ``strom_config.json`` and
    ``source.json`` (the source's path and its config's sha256, which
    ``train_lm --from-hf`` checks before it reuses a conversion).
    Returns ``{"tensors", "shards", "skipped", "config"}``.
    ``ignore_unmapped`` lists an unmapped weight under ``skipped``
    instead of raising."""
    from nvme_strom_tpu_torch.formats.safetensors import write_safetensors
    os.makedirs(out_dir, exist_ok=True)
    # a rerun with other sharding would leave stale shards beside the
    # new ones (and duplicate tensors): clear this tool's own pattern
    for stale in os.listdir(out_dir):
        if re.fullmatch(r"strom-\d{5}\.safetensors", stale):
            os.unlink(os.path.join(out_dir, stale))
    with open(os.path.join(hf_dir, "config.json")) as f:
        hf_cfg = json.load(f)
    cfg = config_from_hf(hf_cfg)

    pending: Dict[str, object] = {}
    pending_bytes = 0
    shards: list = []
    seen: set = set()
    embed = None

    def flush():
        nonlocal pending, pending_bytes
        if not pending:
            return
        p = os.path.join(out_dir, f"strom-{len(shards):05d}.safetensors")
        write_safetensors(p, pending)
        shards.append(p)
        pending, pending_bytes = {}, 0

    def emit(name: str, t):
        nonlocal pending_bytes
        pending[name] = t
        pending_bytes += t.numel() * t.element_size()
        if pending_bytes >= shard_bytes:
            flush()

    skipped = []
    for hf_name, t in _iter_hf_tensors(hf_dir):
        mapped = map_name(hf_name)
        if mapped is None:
            if not (_SKIP_OK_RE.search(hf_name) or ignore_unmapped):
                raise ValueError(
                    f"unmapped weight tensor {hf_name!r} — converting "
                    "without it would produce a numerically wrong model "
                    "(pass ignore_unmapped=True / --ignore-unmapped to "
                    "drop it anyway)")
            skipped.append(hf_name)
            continue
        ours, transpose = mapped
        if ours == "tok_embed":
            embed = t
        seen.add(ours)
        emit(ours, t.t().contiguous() if transpose else t)

    if "lm_head" not in seen:
        if not hf_cfg.get("tie_word_embeddings", False) or embed is None:
            raise ValueError("checkpoint has no lm_head.weight and "
                             "tie_word_embeddings is not set")
        emit("lm_head", embed.t().contiguous())
        seen.add("lm_head")
    flush()

    cfg_out = {k: getattr(cfg, k) for k in _CONFIG_KEYS}
    if cfg.rope_scaling:
        cfg_out["rope_scaling"] = cfg.rope_scaling_dict
    with open(os.path.join(out_dir, "source.json"), "w") as f:
        json.dump({"hf_dir": os.path.realpath(hf_dir),
                   "config_sha256": _config_sha(hf_dir)}, f, indent=1)
    with open(os.path.join(out_dir, "strom_config.json"), "w") as f:
        json.dump(cfg_out, f, indent=1)
    return {"tensors": len(seen), "shards": len(shards),
            "skipped": skipped, "config": cfg_out}


def converted_for(hf_dir: str, out_dir: str) -> Optional[bool]:
    """Whether ``out_dir`` already holds a conversion of ``hf_dir``:
    None when it holds none, False when it holds another checkpoint's
    (``source.json``'s config sha256 differs)."""
    marker = os.path.join(out_dir, "strom_config.json")
    src_marker = os.path.join(out_dir, "source.json")
    if not (os.path.exists(marker) and os.path.exists(src_marker)):
        return None
    with open(src_marker) as f:
        src = json.load(f)
    return src.get("config_sha256") == _config_sha(hf_dir)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="convert_llama",
        description="HF Llama checkpoint → nvme_strom_tpu_torch "
                    "safetensors")
    ap.add_argument("hf_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--shard-bytes", type=int, default=1 << 30)
    ap.add_argument("--ignore-unmapped", action="store_true",
                    help="drop unmapped weight tensors instead of erroring")
    args = ap.parse_args(argv)
    summary = convert(args.hf_dir, args.out_dir, args.shard_bytes,
                      ignore_unmapped=args.ignore_unmapped)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
