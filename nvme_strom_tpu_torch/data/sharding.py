"""Shard assignment and per-epoch permutations (counterpart of
nvme_strom_tpu/data/sharding.py): deterministic, so every process and
both packages agree on them."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def assign_shards(paths: Sequence, process_index: int,
                  process_count: int) -> List:
    """Round-robin over the sorted paths; every process gets at least
    one shard."""
    if process_count < 1:
        raise ValueError("process_count must be >= 1")
    if not 0 <= process_index < process_count:
        raise ValueError(
            f"process_index {process_index} not in [0, {process_count})")
    ordered = sorted(str(p) for p in paths)
    if len(ordered) < process_count:
        raise ValueError(
            f"{len(ordered)} shards < {process_count} processes: "
            "every process needs at least one shard")
    return ordered[process_index::process_count]


def shuffled_indices(n: int, seed: int, epoch: int = 0) -> np.ndarray:
    """The permutation of range(n) for (seed, epoch)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    return rng.permutation(n)
