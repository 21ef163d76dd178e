"""Weight-only int8 and int4 quantization for inference (counterpart of
nvme_strom_tpu/models/quant.py).

int8 is per-output-channel absmax:

    q8 = round(w / scale) in [-127, 127],  scale = absmax(w, axis=-2) / 127

held as a ``{"q8": int8 (..., d_in, d_out), "scale": float32 (..., 1,
d_out)}`` leaf.  int4 (:func:`quantize_weights_int4`) takes absmax
groups of ``group`` rows along d_in (default 128) with two values a
byte: ``{"q4": uint8 (..., d_in / 2, d_out), "scale4": float32 (...,
n_groups, 1, d_out)}``; row ``2i`` is byte ``i``'s low nibble, row
``2i + 1`` its high nibble, each stored as ``q + 8``.
``transformer.wmat`` dequantizes either kind in the compute dtype and
``transformer.project`` multiplies by it (on the card through the
kernels of ops/quant_matmul.py), so every inference path (decode, both
servers, the offloaded cache) serves quantized params with the code that
serves full-precision ones.  The rounding and clipping are the JAX
package's, and the leaves equal its bit for bit; here they are torch ops
on whatever device holds the weight.

Only matmul weights are quantized: ``tok_embed`` is gathered, not
multiplied, norms are tiny, and the MoE router stays full precision
(its logits choose the experts).  Training on quantized params is not
supported (``transformer.trainable_params`` raises): quantize a trained
checkpoint, then serve.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

#: weight names (the component after the last ".") quantized by default:
#: every matmul weight but the embedding table and the MoE router; the
#: match is on the exact component, so ``("w_gate",)`` never selects the
#: experts' ``moe_w_gate``
DEFAULT_SUFFIXES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                    "moe_w_gate", "moe_w_up", "moe_w_down", "lm_head")

#: int4 leaves the lm_head full precision: it ranks the tokens, and 4-bit
#: noise hurts it most.  The mixed recipe quantizes it to int8 first;
#: ``wmat`` serves mixed trees leaf by leaf
DEFAULT_SUFFIXES_INT4 = tuple(sfx for sfx in DEFAULT_SUFFIXES
                              if sfx != "lm_head")


# The JAX package divides by the constants 127 and 7 inside ``jax.jit``,
# where XLA multiplies by their float32 reciprocals instead: the scales
# here do the same, so they equal the JAX ones bit for bit.
_INV127 = 1.0 / 127.0
_INV7 = 1.0 / 7.0


def _quantize_one(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    wf = w.float()
    scale = (wf.abs().amax(dim=-2, keepdim=True)
             * _INV127).clamp_min(1e-12)
    q8 = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    # scale keeps its broadcast shape (..., 1, d_out): 2-D dense and 3-D
    # per-expert weights dequantize alike
    return {"q8": q8, "scale": scale}


def _int4_group(din: int, group: int) -> int:
    """The largest even divisor of ``din`` that is at most ``group``
    (``group`` itself when it divides), else ``din``."""
    if din % group == 0 and group % 2 == 0:
        return group
    return next((c for c in range(min(group, din), 1, -1)
                 if din % c == 0 and c % 2 == 0), din)


def _quantize_one_int4(w: torch.Tensor, group: int
                       ) -> Optional[Dict[str, torch.Tensor]]:
    """``{"q4", "scale4"}``, or None when d_in is odd (cannot pack)."""
    din = int(w.shape[-2])
    if din % 2:
        return None
    g = _int4_group(din, group)
    lead = tuple(w.shape[:-2])
    dout = int(w.shape[-1])
    wf = w.float().reshape(*lead, din // g, g, dout)
    scale = (wf.abs().amax(dim=-2, keepdim=True) * _INV7).clamp_min(1e-12)
    q = torch.clamp(torch.round(wf / scale), -7, 7).to(torch.int8)
    qu = (q + 8).to(torch.uint8).reshape(*lead, din, dout)
    packed = qu[..., 0::2, :] | (qu[..., 1::2, :] << 4)
    return {"q4": packed, "scale4": scale}


def _selected(name: str, w, suffixes) -> bool:
    return (not isinstance(w, dict)
            and name.rsplit(".", 1)[-1] in suffixes
            and getattr(w, "ndim", 0) >= 2)


def quantize_weights_int8(params: Dict,
                          suffixes: Optional[Sequence[str]] = None
                          ) -> Dict:
    """``{name: tensor}`` → the same dict with the selected weights
    (``suffixes``, default :data:`DEFAULT_SUFFIXES`) as int8 leaves.
    Quantized leaves and 1-D tensors pass through."""
    suffixes = tuple(DEFAULT_SUFFIXES if suffixes is None else suffixes)
    return {name: (_quantize_one(w) if _selected(name, w, suffixes)
                   else w)
            for name, w in params.items()}


def quantize_weights_int4(params: Dict,
                          suffixes: Optional[Sequence[str]] = None,
                          group: int = 128) -> Dict:
    """``{name: tensor}`` → the selected weights (default
    :data:`DEFAULT_SUFFIXES_INT4`) as packed int4 leaves with group-wise
    scales.  A weight whose d_in is odd stays full precision; quantized
    leaves pass through."""
    suffixes = tuple(DEFAULT_SUFFIXES_INT4 if suffixes is None
                     else suffixes)
    out = {}
    for name, w in params.items():
        q = _quantize_one_int4(w, group) if _selected(name, w, suffixes) \
            else None
        out[name] = w if q is None else q
    return out


def logical_shape(leaf) -> tuple:
    """The unquantized shape of any param leaf: a tensor's own, an int8
    leaf's ``q8`` shape, an int4 leaf's with d_in unpacked."""
    if isinstance(leaf, dict):
        if "q8" in leaf:
            return tuple(leaf["q8"].shape)
        q4 = leaf["q4"]
        return (*q4.shape[:-2], 2 * q4.shape[-2], q4.shape[-1])
    return tuple(leaf.shape)


def _nbytes(t) -> int:
    return int(t.numel() * t.element_size())


def quantized_nbytes(params: Dict) -> tuple:
    """(bytes of the quantized leaves, the bytes those weights take in
    float32): the memory claim, measured."""
    q = fp = 0
    for w in params.values():
        if not isinstance(w, dict):
            continue
        if "q8" in w:
            q += _nbytes(w["q8"]) + _nbytes(w["scale"])
            fp += int(w["q8"].numel()) * 4
        else:
            q += _nbytes(w["q4"]) + _nbytes(w["scale4"])
            fp += int(w["q4"].numel()) * 2 * 4   # two values a byte
    return q, fp
