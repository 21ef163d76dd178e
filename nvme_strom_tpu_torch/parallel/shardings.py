"""Parameter and batch shardings of the decoder (counterpart of
nvme_strom_tpu/parallel/shardings.py).

The specs are the JAX package's Megatron layout, name for name: the
q / k / v, gate and up products split their output columns over
``tp`` (column-parallel), ``wo`` and ``w_down`` their input rows
(row-parallel, summed over ``tp`` after), the token embedding its
features and the lm_head its vocabulary; MoE experts split over ``ep``
(models/moe.py ``moe_param_specs``).  A :class:`Sharding` is a spec on a
:class:`~nvme_strom_tpu_torch.parallel.mesh.Mesh`: it says which slice of
a global tensor each rank holds (:meth:`Sharding.local_bounds`) and
which rank owns each distinct slice in a checkpoint
(:meth:`Sharding.tiles`, the lowest rank holding it, as the JAX
manager's tile owner).  The JAX ``replicate_scalars`` has no
counterpart: a torch scalar is on every rank already.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from nvme_strom_tpu_torch.models.moe import moe_param_specs


class P(tuple):
    """A partition spec: one entry per dimension, an axis name, a tuple
    of names, or None (``jax.sharding.PartitionSpec``'s tuple, which
    also reads a one-name tuple as the name)."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, (tuple, list)) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def param_specs(cfg) -> Dict[str, P]:
    specs = {"tok_embed": P(None, "tp"),      # d_model split
             "final_norm": P(),
             "lm_head": P(None, "tp")}        # vocabulary split
    for i in range(cfg.n_layers):
        L = f"layers.{i}."
        specs[L + "attn_norm"] = P()
        specs[L + "wq"] = P(None, "tp")       # heads split over tp
        specs[L + "wk"] = P(None, "tp")
        specs[L + "wv"] = P(None, "tp")
        specs[L + "wo"] = P("tp", None)       # row-parallel: sum after
        specs[L + "mlp_norm"] = P()
        if cfg.is_moe_layer(i):
            specs.update({k: P(*v) for k, v in
                          moe_param_specs(cfg, L).items()})
        else:
            specs[L + "w_gate"] = P(None, "tp")
            specs[L + "w_up"] = P(None, "tp")
            specs[L + "w_down"] = P("tp", None)
    return specs


#: the canonical mesh axes: a spec axis absent from the mesh replicates
#: (that parallelism is off); any other name is a bug and raises
CANONICAL_AXES = frozenset({"dp", "tp", "sp", "pp", "ep"})


def prune_spec(spec, mesh) -> P:
    """Drop canonical axis names the mesh lacks, so one set of specs
    serves every mesh; a name neither in the mesh nor canonical
    raises."""
    def keep(entry):
        if entry is None:
            return None
        if isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if keep(a) is not None)
            return kept if kept else None
        if entry in mesh.shape:
            return entry
        if entry not in CANONICAL_AXES:
            raise ValueError(
                f"spec axis {entry!r} is neither in the mesh "
                f"{dict(mesh.shape)} nor a canonical axis "
                f"{sorted(CANONICAL_AXES)}")
        return None
    return P(*(keep(e) for e in spec))


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


class Sharding:
    """``spec`` (pruned to ``mesh``) laid over ``mesh``'s ranks."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = prune_spec(spec, mesh)

    def _split(self, dim_entry, coords) -> tuple:
        """(index, count) of a rank's block along one dimension."""
        idx, count = 0, 1
        for a in _axes(dim_entry):
            idx = idx * self.mesh.shape[a] + coords[a]
            count *= self.mesh.shape[a]
        return idx, count

    def bounds(self, shape, coords) -> tuple:
        """((lo, hi), ...) of the rank at ``coords``."""
        shape = tuple(int(s) for s in shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than "
                             f"shape {shape}")
        out = []
        for d, n in enumerate(shape):
            entry = self.spec[d] if d < len(self.spec) else None
            i, c = self._split(entry, coords)
            if n % c:
                raise ValueError(f"dimension {d} of {shape} does not split "
                                 f"into {c} ({self.spec})")
            out.append((i * (n // c), (i + 1) * (n // c)))
        return tuple(out)

    def local_bounds(self, shape) -> tuple:
        return self.bounds(shape, self.mesh.coords)

    def local_shape(self, shape) -> tuple:
        return tuple(b - a for a, b in self.local_bounds(shape))

    def tiles(self, shape) -> list:
        """Every distinct slice as (bounds, owner rank), sorted; the
        owner is the lowest rank holding it."""
        owners: dict = {}
        for r, coords in enumerate(self.mesh.devices_coords()):
            owners.setdefault(self.bounds(shape, coords), r)
        return sorted(owners.items())

    def __repr__(self) -> str:
        return f"Sharding({self.spec!r}, {self.mesh!r})"


def param_shardings(cfg, mesh) -> Dict[str, Sharding]:
    return {k: Sharding(mesh, spec) for k, spec in param_specs(cfg).items()}


def _slice(t, bounds):
    return t[tuple(slice(a, b) for a, b in bounds)]


def _to_tensor(x, device):
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    return t.to(device).contiguous().clone() if device is not None \
        else t.contiguous().clone()


def shard_params(params: Dict, cfg, mesh, device=None,
                 shardings: Optional[Dict] = None) -> Dict:
    """This rank's slice of every parameter of the full ``params``
    (tensors or numpy arrays), on ``device`` (default: where each
    is).  Weight-only quantized leaves (models/quant.py) split as the
    JAX ``shard_params`` places them: ``q8`` / ``q4`` by the weight's
    own spec, ``scale`` by its output axis, ``scale4`` along d_out
    only.  A parameter without a spec raises."""
    sh = shardings if shardings is not None else param_shardings(cfg, mesh)
    out = {}
    for name, w in params.items():
        if name not in sh:
            raise KeyError(f"no sharding spec for param {name!r}")
        s = sh[name]
        if isinstance(w, dict):
            key = "q8" if "q8" in w else "q4"
            spec = tuple(s.spec) + (None,) * (w[key].dim() - len(s.spec))
            wsh = Sharding(mesh, P(*spec))
            if key == "q8":
                ssh = Sharding(mesh, P(*spec[:-2], None, spec[-1]))
                skey = "scale"
            else:
                ssh = Sharding(mesh, P(*[None] * (w["scale4"].dim() - 1),
                                       spec[-1]))
                skey = "scale4"
            out[name] = {
                key: _to_tensor(_slice(w[key], wsh.local_bounds(
                    w[key].shape)), device),
                skey: _to_tensor(_slice(w[skey], ssh.local_bounds(
                    w[skey].shape)), device)}
            continue
        out[name] = _to_tensor(_slice(w, s.local_bounds(np.shape(w))),
                               device)
    return out


def batch_spec(seq_sharded: bool = False) -> P:
    """(batch, seq) tokens: batch over dp; seq over sp for ring or
    Ulysses attention (parallel/ring_attention.py, parallel/ulysses.py),
    each rank holding one span of every row."""
    return P("dp", "sp") if seq_sharded else P("dp", None)


def batch_shardings(mesh, seq_sharded: bool = False) -> Sharding:
    """:func:`batch_spec` on ``mesh``; ``seq_sharded`` on a mesh without
    ``sp`` raises."""
    if seq_sharded and "sp" not in mesh.shape:
        raise ValueError("mesh has no 'sp' axis for sequence sharding")
    return Sharding(mesh, batch_spec(seq_sharded))


class Shard:
    """One rank's slice of a global tensor, as a checkpoint leaf
    (checkpoint/manager.py): ``local`` holds ``bounds`` of a tensor of
    ``shape`` laid out by ``sharding``; ``tiles`` lists every distinct
    slice with its owner rank."""

    def __init__(self, local: torch.Tensor, sharding: Sharding, shape):
        self.local = local
        self.sharding = sharding
        self.shape = tuple(int(s) for s in shape)
        self.bounds = sharding.local_bounds(self.shape)
        if tuple(local.shape) != tuple(b - a for a, b in self.bounds):
            raise ValueError(f"local {tuple(local.shape)} is not the slice "
                             f"{self.bounds} of {self.shape}")
        self.tiles = sharding.tiles(self.shape)

    @property
    def dtype(self):
        return self.local.dtype

    def __repr__(self) -> str:
        return f"Shard({self.bounds} of {self.shape})"


def local_slice(batch, mesh, axis: str = "dp", seq_axis=None):
    """This rank's block of a global batch: the rows along ``axis``
    (dim 0) its ``dp`` group feeds and, with ``seq_axis``, its span of
    dim 1 (the sequence, for ring or Ulysses attention).  A dim 1 that
    ``seq_axis`` does not divide raises."""
    from nvme_strom_tpu_torch.parallel.mesh import batch_sharding
    sh = batch_sharding(mesh, axis, seq_axis)
    if seq_axis is not None:
        n = mesh.shape[seq_axis]
        if batch.shape[1] % n:
            raise ValueError(f"seq {batch.shape[1]} not divisible by "
                             f"{seq_axis}={n}")
        (b0, b1), (s0, s1) = sh.local_bounds(tuple(batch.shape[:2]))
        return batch[b0:b1, s0:s1]
    b0, b1 = sh.local_bounds(tuple(batch.shape[:1]))[0]
    return batch[b0:b1]
