"""Parameters of the JAX package → the port's.

Both packages use one flat namespace and one layout (``x @ w`` with
``w (d_in, d_out)``), so the conversion maps names and dtypes and checks
every shape.  It takes numpy arrays (``np.asarray`` of the JAX
parameters); bfloat16 arrays are reinterpreted bit for bit.  A quantized
leaf (models/quant.py) is a dict of numpy arrays, ``{"q8", "scale"}`` or
``{"q4", "scale4"}``, and keeps its dtypes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from nvme_strom_tpu_torch.device import resolve_device
from nvme_strom_tpu_torch.models.quant import logical_shape
from nvme_strom_tpu_torch.models.transformer import (TransformerConfig,
                                                     param_shapes)


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.array(arr, order="C")      # owned and writable
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_jax(np_params: Dict[str, np.ndarray], cfg: TransformerConfig,
                    device=None) -> Dict[str, torch.Tensor]:
    """``{name: numpy array}`` of the JAX model → ``{name: tensor}`` on
    ``device`` (default ``cuda:0``): matrices in ``cfg.dtype``; norm
    weights and MoE routers in float32 (the JAX model routes in float32
    whatever its dtype); a quantized leaf's tensors in their own dtypes
    (``q8`` int8, ``q4`` uint8, scales float32).  Raises on a missing or
    unknown name, or a (logical) shape that differs from ``cfg``'s."""
    dev = resolve_device(device)
    want = param_shapes(cfg)
    unknown = sorted(set(np_params) - set(want))
    if unknown:
        raise KeyError(f"parameters this port does not know: {unknown}")
    missing = sorted(set(want) - set(np_params))
    if missing:
        raise KeyError(f"parameters missing for this config: {missing}")
    out = {}
    for name, shape in want.items():
        arr = np_params[name]
        if isinstance(arr, dict):
            leaf = {k: _to_tensor(np.asarray(v)).to(dev)
                    for k, v in arr.items()}
            got = logical_shape(leaf)
        else:
            arr = np.asarray(arr)
            got = arr.shape
        if tuple(got) != shape:
            raise ValueError(f"{name}: shape {tuple(got)}, config wants "
                             f"{shape}")
        if isinstance(arr, dict):
            out[name] = leaf
            continue
        dtype = (torch.float32
                 if len(shape) == 1 or name.endswith(".router")
                 else cfg.dtype)
        out[name] = _to_tensor(arr).to(device=dev, dtype=dtype)
    return out


def adapters_from_jax(np_adapters: Dict[str, tuple], device=None,
                      dtype: torch.dtype = torch.float32) -> Dict[str, tuple]:
    """LoRA adapters of the JAX package (``{name: (A, B)}``, numpy
    arrays) → the port's: ``dtype`` leaf tensors on ``device`` (default
    ``cuda:0``) that require grad.  The two packages draw their adapters
    from different random streams, so a parity test carries one set
    across instead of drawing twice."""
    dev = resolve_device(device)
    return {n: tuple(_to_tensor(np.asarray(t)).to(device=dev, dtype=dtype)
                     .requires_grad_() for t in ab)
            for n, ab in np_adapters.items()}


def vit_params_from_jax(np_params: Dict[str, np.ndarray], cfg,
                        device=None) -> Dict[str, torch.Tensor]:
    """``{name: numpy array}`` of the JAX ViT (models/vit.py) → float32
    master tensors on ``device`` (default ``cuda:0``), which the port's
    ViT casts to ``cfg.dtype`` at each product as the JAX model does.
    Raises on a missing or unknown name, or a shape that differs from
    ``cfg``'s."""
    from nvme_strom_tpu_torch.models.vit import vit_param_shapes
    dev = resolve_device(device)
    want = vit_param_shapes(cfg)
    unknown = sorted(set(np_params) - set(want))
    if unknown:
        raise KeyError(f"parameters this port does not know: {unknown}")
    missing = sorted(set(want) - set(np_params))
    if missing:
        raise KeyError(f"parameters missing for this config: {missing}")
    out = {}
    for name, shape in want.items():
        arr = np.asarray(np_params[name])
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape}, config wants "
                             f"{shape}")
        out[name] = _to_tensor(arr).to(device=dev, dtype=torch.float32)
    return out
