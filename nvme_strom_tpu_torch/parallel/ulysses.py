"""Ulysses sequence parallelism: an all-to-all trades the sequence split
for a head split (counterpart of nvme_strom_tpu/parallel/ulysses.py).

Activations arrive with the sequence split over ``sp``.  One all-to-all
per tensor (``collectives.all_to_all``) splits the heads over ``sp`` and
gathers the whole sequence, the local attention runs on that head slice
with an ordinary causal mask (dense, or the flash kernels through
``make_flash_attn()``), and one more all-to-all restores the sequence
split.  Four exchanges a call against the ring's n − 1 (each of K and V
stacked); it needs the heads a rank holds to divide by ``sp``.
"""

from __future__ import annotations

from nvme_strom_tpu_torch.parallel import collectives as _coll


def _dense_causal(q, k, v):
    """The model's dense causal attention over (b, h, s, d) blocks."""
    from nvme_strom_tpu_torch.models.transformer import (
        dense_causal_attention_grouped)
    b, h, s, d = q.shape
    out = dense_causal_attention_grouped(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    return out.reshape(b, s, h, d).transpose(1, 2)


def ulysses_attention(q, k, v, mesh, sp_axis: str = "sp", attn=None):
    """Causal attention with the sequence split over ``mesh``'s
    ``sp_axis``: q / k / v (b_local, h_local, s / sp, d) are this rank's
    blocks, K/V expanded to Q's heads.  ``attn(q, k, v)`` is the local
    inner over the whole sequence (default dense); it sees h_local / sp
    heads.  Heads a rank holds that ``sp`` does not divide raise
    ``ValueError`` naming the ring."""
    n_sp = mesh.shape.get(sp_axis, 1)
    inner = attn or _dense_causal
    if q.shape[1] % n_sp:
        raise ValueError(
            f"{q.shape[1]} heads per tp shard not divisible by "
            f"sp={n_sp}; use ring attention for head-poor configs")
    group = mesh.group(sp_axis)
    if group is None:
        return inner(q, k, v)
    # heads split over sp, the sequence gathered
    q, k, v = (_coll.all_to_all(t, group, split_dim=1, concat_dim=2)
               for t in (q, k, v))
    o = inner(q, k, v)
    # the sequence split back over sp, the heads gathered
    return _coll.all_to_all(o, group, split_dim=2, concat_dim=1)


def make_ulysses_attn(mesh, sp_axis: str = "sp", attn=None):
    """``attn_fn(q, k, v)`` for models/transformer: the all-to-all
    alternative to ``make_ring_attn``."""

    def attn_fn(q, k, v):
        return ulysses_attention(q, k, v, mesh, sp_axis=sp_axis, attn=attn)

    return attn_fn
