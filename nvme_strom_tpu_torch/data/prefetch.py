"""Keep N batches pulled ahead of the training step (counterpart of
nvme_strom_tpu/data/prefetch.py ``prefetch_to_device``).

Pulls run in the caller's thread, ``size`` batches ahead.  With
``device=`` a CUDA device, each pulled batch's numpy leaves start their
copies to the card at once on a side stream (``ops/bridge.py``
``AsyncPut``: ``host_to_device`` with ``stream=``, so ``h2d_copy``),
while the step on the consumer's stream goes on; when a batch is
yielded, the consumer's stream waits on its copies' events, not the
host, and each tensor records that stream for the allocator.  A
pipeline that already yields device tensors (``ShardedLoader``, whose
own copies run the same way) gets lookahead only.  On the CPU a numpy
leaf is copied when pulled.
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator

import numpy as np

from nvme_strom_tpu_torch.data.loader import _map
from nvme_strom_tpu_torch.device import resolve_device
from nvme_strom_tpu_torch.ops.bridge import AsyncPut, Transfer


def prefetch_to_device(batches: Iterable, size: int = 2,
                       device=None) -> Iterator:
    """Yield from ``batches`` while keeping ``size`` items pulled ahead,
    their numpy leaves already on their way to ``device`` (default: left
    as they are) on the bridge's side stream.
    Validates now (a plain function returning a generator); closing the
    generator closes the wrapped iterator, so a loader's producer thread
    winds down before its engine is torn down, and waits out the copies
    still in flight."""
    if size < 1:
        raise ValueError("size must be >= 1")
    dev = resolve_device(device) if device is not None else None
    return _prefetch_gen(iter(batches), size, dev)


def _prefetch_gen(it, size: int, dev) -> Iterator:
    put = AsyncPut(None, dev) if dev is not None else None

    def pull():
        b = next(it)
        if put is None:
            return b
        return _map(lambda x: put.start(x) if isinstance(x, np.ndarray)
                    else x, b)

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
            yield out if put is None else _map(put.finish, out)
    finally:
        try:
            close = getattr(it, "close", None)
            if close is not None:
                close()
        finally:
            if put is not None:
                put.close()
            for b in buf:
                _map(lambda t: t.synchronize()
                     if isinstance(t, Transfer) else None, b)
