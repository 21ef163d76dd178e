"""Weighted mixing of several loaders (counterpart of
nvme_strom_tpu/data/mixture.py ``MixtureLoader``).

Language-model pretraining feeds a weighted mixture of corpora through
one engine.  The source drawn at step t is a pure function of (seed, t),
``np.random.default_rng((seed, t))``, so every process draws the same
source without talking to the others, and the sequence is the JAX
package's exactly.  An exhausted source restarts: iterating a
``ShardedLoader`` again is its next epoch, reshuffled.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np

__all__ = ["MixtureLoader"]


class MixtureLoader:
    """Draw batches from several loaders with fixed weights.

    ``sources``: (loader, weight) pairs; any iterable that restarts on
    ``iter()`` qualifies.  Weights are normalised and must be positive.
    ``max_restarts``: how often an exhausted source may restart (None:
    without bound); a source whose first epoch is empty raises, since
    dropping it would skew the mixture.  Iteration yields ``(batch,
    source index)``; ``counts`` holds how many batches each source
    served."""

    def __init__(self, sources: Sequence[tuple], *, seed: int = 0,
                 max_restarts: Optional[int] = None):
        if not sources:
            raise ValueError("MixtureLoader needs at least one source")
        self.loaders = [s for s, _ in sources]
        w = np.asarray([float(wt) for _, wt in sources], np.float64)
        if (w <= 0).any():
            raise ValueError(f"weights must be positive, got {w.tolist()}")
        self.weights = w / w.sum()
        self.seed = int(seed)
        self.max_restarts = max_restarts
        self.counts = [0] * len(self.loaders)
        self.step = 0

    def _draw(self, step: int) -> int:
        """The source of ``step``, a pure function of (seed, step)."""
        rng = np.random.default_rng((self.seed, step))
        return int(rng.choice(len(self.weights), p=self.weights))

    def __iter__(self) -> Iterator:
        iters = [iter(ld) for ld in self.loaders]
        restarts = [0] * len(iters)
        try:
            while True:
                s = self._draw(self.step)
                try:
                    batch = next(iters[s])
                except StopIteration:
                    restarts[s] += 1
                    if (self.max_restarts is not None
                            and restarts[s] > self.max_restarts):
                        return
                    iters[s] = iter(self.loaders[s])
                    try:
                        batch = next(iters[s])
                    except StopIteration:
                        raise ValueError(
                            f"mixture source {s} yielded no batches: an "
                            "empty corpus would silently skew the "
                            "mixture") from None
                self.counts[s] += 1
                self.step += 1
                yield batch, s
        finally:
            # an abandoned mixture stops its sources' producer threads
            # before their engine can be torn down
            for it in iters:
                close = getattr(it, "close", None)
                if close is not None:
                    close()
