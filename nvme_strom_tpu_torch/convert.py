"""Parameters of the JAX package → the port's.

Both packages use one flat namespace and one layout (``x @ w`` with
``w (d_in, d_out)``), so the conversion maps names and dtypes and checks
every shape.  It takes numpy arrays (``np.asarray`` of the JAX
parameters); bfloat16 arrays are reinterpreted bit for bit.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from nvme_strom_tpu_torch.device import resolve_device
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
    ``device`` (default ``cuda:0``): matrices in ``cfg.dtype``, norm
    weights in float32.  Raises on a missing or unknown name, a
    quantized leaf, or a shape that differs from ``cfg``'s."""
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
            raise NotImplementedError(
                f"{name}: quantized weights are not ported yet")
        arr = np.asarray(arr)
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape}, config wants "
                             f"{shape}")
        dtype = torch.float32 if len(shape) == 1 else cfg.dtype
        out[name] = _to_tensor(arr).to(device=dev, dtype=dtype)
    return out
