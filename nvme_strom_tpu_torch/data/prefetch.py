"""Keep N batches pulled ahead of the training step (counterpart of
nvme_strom_tpu/data/prefetch.py ``prefetch_to_device``).

It overlaps no work: pulls run in the caller's thread, and a batch's
device copy has completed when ``to_device`` returns.  For a pipeline
that already yields device tensors (``ShardedLoader``, whose reads and
decoding run on its own producer thread) this is lookahead only.  With
``device=``, numpy leaves are moved there on pull through the bridge
(``to_device``: ``h2d_copy`` on a card)."""

from __future__ import annotations

import collections
from typing import Iterable, Iterator

import numpy as np

from nvme_strom_tpu_torch.data.loader import _map
from nvme_strom_tpu_torch.device import resolve_device
from nvme_strom_tpu_torch.ops.bridge import to_device


def prefetch_to_device(batches: Iterable, size: int = 2,
                       device=None) -> Iterator:
    """Yield from ``batches`` while keeping ``size`` items pulled ahead.
    Validates now (a plain function returning a generator); closing the
    generator closes the wrapped iterator, so a loader's producer thread
    winds down before its engine is torn down."""
    if size < 1:
        raise ValueError("size must be >= 1")
    dev = resolve_device(device) if device is not None else None
    return _prefetch_gen(iter(batches), size, dev)


def _prefetch_gen(it, size: int, dev) -> Iterator:
    def pull():
        b = next(it)
        if dev is None:
            return b
        return _map(lambda x: to_device(None, x, dev)
                    if isinstance(x, np.ndarray) else x, b)

    buf: collections.deque = collections.deque()
    try:
        try:
            for _ in range(size):
                buf.append(pull())
        except StopIteration:
            pass
        while buf:
            out = buf.popleft()
            try:
                buf.append(pull())
            except StopIteration:
                pass
            yield out
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()
