"""Sharded dataloader for one process and one device: WebDataset shards
on NVMe → device batches (counterpart of nvme_strom_tpu/data/loader.py
``ShardedLoader`` with ``fmt="wds"``).

Per batch, in a producer thread:

    shard index (tar headers only) → planned member reads through the
    engine → decode (user fn) → host batch (np.stack)

and in the consumer, each batch leaf goes to the device through the
bridge's ``host_to_device`` (on a CUDA device the ``h2d_copy`` kernel).
The sample order is the JAX loader's: shards sorted, then, with
``LoaderConfig.shuffle_buffer``, shard order and each shard's sample
order permuted per epoch from the seed (data/sharding.py).

Under ``STROM_VERIFY`` (utils/checksum.py) each sample part is checked
against its shard's ``.crc.json`` sidecar when the shard has one
(``stamp_wds`` writes it): a mismatch is read once more, past the host
tier, and a part that still fails raises :class:`ChecksumError` naming
the shard.  With ``STROM_VERIFY`` off the loader does no CRC work.

Shard quarantine (``LoaderConfig.shard_error_budget``): a shard whose
index, read, check or decode fails is skipped for this epoch and every
later one, counted ``shards_quarantined``, logged and traced as a
``strom.loader.quarantine`` span, while fewer than the budget are out;
past it, or with the default budget of 0, the failure raises
:class:`ShardReadError` naming the shard (and, past a budget, the
quarantine list).  Under ``STROM_RESILIENT=1`` the engine's own retries
come first, so only a failure they could not heal reaches the
quarantine.  Mixtures, the
tfrecord / fixedrec / raw formats and sequence sharding are not part of
this port yet.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from collections import OrderedDict
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from nvme_strom_tpu_torch.data.sharding import (assign_shards,
                                                shuffled_indices)
from nvme_strom_tpu_torch.device import resolve_device
from nvme_strom_tpu_torch.formats.wds import WdsShardIndex
from nvme_strom_tpu_torch.io.engine import StromEngine, wait_exact
from nvme_strom_tpu_torch.io.faults import build_engine
from nvme_strom_tpu_torch.io.hostcache import spoil_span
from nvme_strom_tpu_torch.io.plan import plan_and_submit
from nvme_strom_tpu_torch.ops.bridge import to_device
from nvme_strom_tpu_torch.utils.checksum import VerifyPolicy, load_sidecar
from nvme_strom_tpu_torch.utils.config import LoaderConfig

_SENTINEL = object()
_log = logging.getLogger(__name__)


class ShardReadError(RuntimeError):
    """A shard failed (index, read, check or decode) and could not be
    quarantined.  Names the shard (``path``); the failure is the
    ``__cause__``."""

    def __init__(self, path, exc: BaseException, detail: str = ""):
        self.path = str(path)
        super().__init__(
            f"shard {self.path}: {type(exc).__name__}: {exc}"
            + (f" ({detail})" if detail else ""))


class LoaderErrors(RuntimeError):
    """Several producer-side errors queued before the consumer saw any:
    all of them in ``errors`` (oldest first) and in the message."""

    def __init__(self, errors):
        self.errors = list(errors)
        super().__init__(
            f"{len(self.errors)} loader errors: "
            + "; ".join(f"{type(e).__name__}: {e}" for e in self.errors))


def _default_decode(parts: dict) -> np.ndarray:
    """A single-part sample → its bytes as uint8."""
    if len(parts) != 1:
        raise ValueError(
            f"sample has parts {sorted(parts)}; pass decode= to combine")
    (payload,) = parts.values()
    return np.frombuffer(payload, dtype=np.uint8)


def _stack(samples: list):
    """Samples (arrays, or dicts / tuples of arrays) → one batch."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: _stack([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([s[i] for s in samples])
                           for i in range(len(first)))
    return np.stack(samples)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


class ShardedLoader:
    """Iterate device batches of ``global_batch`` samples from
    WebDataset shards.  ``decode(parts: {ext: bytes}) -> array`` (or a
    dict / tuple of arrays); ``exts`` keeps only these member
    extensions; ``engine``: a shared StromEngine (one is created by
    ``io/faults.py`` ``build_engine`` and owned otherwise); ``device``:
    where batches go (default ``cuda:0``).  Each ``iter()`` is one
    epoch.  ``quarantined`` lists the shards skipped under
    ``config.shard_error_budget``, in failure order."""

    def __init__(self, shard_paths: Sequence, global_batch: int,
                 fmt: str = "wds", decode: Optional[Callable] = None,
                 engine: Optional[StromEngine] = None,
                 exts: Optional[List[str]] = None,
                 config: Optional[LoaderConfig] = None, device=None):
        if fmt != "wds":
            raise NotImplementedError(f"fmt {fmt!r} is not ported yet "
                                      "(wds only)")
        if global_batch < 1:
            raise ValueError(f"global_batch must be >= 1, got "
                             f"{global_batch}")
        self.device = resolve_device(device)
        self.fmt = fmt
        self.decode = decode or _default_decode
        self.exts = exts
        self.config = config or LoaderConfig()
        self.global_batch = global_batch
        self.local_batch = global_batch
        self.local_shards = assign_shards(shard_paths, 0, 1)
        self._owns_engine = engine is None
        self._engine = engine if engine is not None else build_engine()
        self.epoch = 0
        self.quarantined: List[str] = []
        self._quarantined_set: set = set()
        self._shard_index: "OrderedDict[str, list]" = OrderedDict()
        self._shard_index_total = 0
        self._verify = VerifyPolicy()
        #: shard path → its Sidecar, or None when it has none
        self._sidecars: dict = {}

    # -- samples (host side) -------------------------------------------------

    def _index_shard(self, path) -> list:
        key = str(path)
        cached = self._shard_index.get(key)
        if cached is not None:
            self._shard_index.move_to_end(key)
            return cached
        idx = WdsShardIndex(path)
        out = [{ext: rng for ext, rng in idx.samples[k].items()
                if self.exts is None or ext in self.exts}
               for k in idx.order]
        cap = self.config.index_cache_samples
        if cap > 0:
            self._shard_index[key] = out
            self._shard_index_total += len(out)
            while (self._shard_index_total > cap
                   and len(self._shard_index) > 1):
                _, old = self._shard_index.popitem(last=False)
                self._shard_index_total -= len(old)
        return out

    def _sidecar(self, path):
        key = str(path)
        if key not in self._sidecars:
            self._sidecars[key] = load_sidecar(key)
        return self._sidecars[key]

    def _iter_local_samples(self) -> Iterator:
        order = list(self.local_shards)
        if self.config.shuffle_buffer:
            perm = shuffled_indices(len(order), self.config.seed, self.epoch)
            order = [order[i] for i in perm]
        for path in order:
            if str(path) in self._quarantined_set:
                continue               # out since an earlier failure
            try:
                yield from self._shard_samples(path)
            except Exception as e:     # GeneratorExit passes
                self._quarantine_or_raise(path, e)

    def _quarantine_or_raise(self, path, e: Exception) -> None:
        """Skip the failing shard from now on while the error budget
        lasts; otherwise raise, naming it."""
        budget = self.config.shard_error_budget
        if budget <= 0:
            raise ShardReadError(path, e) from e
        if len(self.quarantined) >= budget:
            raise ShardReadError(
                path, e,
                f"shard error budget ({budget}) exhausted; already "
                f"quarantined: {self.quarantined}") from e
        self.quarantined.append(str(path))
        self._quarantined_set.add(str(path))
        self._engine.stats.add(shards_quarantined=1)
        tracer = self._engine.tracer
        if tracer.enabled:
            now = time.monotonic_ns()
            tracer.add_span("strom.loader.quarantine", now, now,
                            category="strom.resilient", shard=str(path),
                            error=f"{type(e).__name__}: {e}")
        _log.warning(
            "quarantining shard %s after %s: %s (%d/%d of error budget "
            "used)", path, type(e).__name__, e, len(self.quarantined),
            budget)

    def _shard_samples(self, path) -> Iterator:
        """Index → pipelined reads (one planned batch per sample, half
        the engine's queue depth in flight) → decode, for one shard."""
        eng = self._engine
        samples = self._index_shard(path)
        sample_order = range(len(samples))
        if self.config.shuffle_buffer:
            sample_order = shuffled_indices(len(samples),
                                            self.config.seed + 1, self.epoch)
        depth = max(2, eng.config.queue_depth // 2)
        fh = eng.open(path)
        pend: list = []
        policy = self._verify
        sidecar = self._sidecar(path) if policy.enabled else None

        def read_part(pieces) -> bytes:
            # a short read is a truncated shard: loud
            return b"".join(wait_exact(p).tobytes() for p in pieces)

        def reread(off, ln) -> bytes:
            (pieces,) = plan_and_submit(eng, [(fh, off, ln)])
            try:
                return read_part(pieces)
            finally:
                for p in pieces:
                    p.release()

        def verify_part(ext, off, ln, payload: bytes) -> bytes:
            """Check one part against the sidecar when it is stamped and
            the policy samples it; one re-read heals a transient
            mismatch, a second raises ChecksumError."""
            expected = sidecar.lookup(off, ln)
            if expected is None or not policy.want():
                return payload
            return policy.check_with_reread(
                payload, expected, lambda: reread(off, ln), eng.stats,
                where=f"sample part {ext!r} at [{off}:+{ln}] of {path}",
                spoil=lambda: spoil_span(eng, fh, off, ln, eng.stats))

        def finish(entry):
            spans, reads = entry
            try:
                parts = {ext: read_part(pieces)
                         for ext, pieces in reads.items()}
            finally:
                # every buffer back before a re-read takes one
                for pieces in reads.values():
                    for p in pieces:
                        p.release()
            if sidecar is not None:
                parts = {ext: verify_part(ext, *spans[ext], payload)
                         for ext, payload in parts.items()}
            eng.stats.add(bounce_bytes=sum(len(v) for v in parts.values()))
            return self.decode(parts)

        try:
            for si in sample_order:
                items = list(samples[si].items())
                planned = plan_and_submit(
                    eng, [(fh, off, ln) for _, (off, ln) in items])
                pend.append((samples[si], {ext: pieces for (ext, _), pieces
                                           in zip(items, planned)}))
                if len(pend) >= depth:
                    yield finish(pend.pop(0))
            while pend:
                yield finish(pend.pop(0))
        finally:
            for _spans, reads in pend:   # in-flight reads hold buffers
                for pieces in reads.values():
                    for p in pieces:
                        p.release()
            eng.close(fh)

    def _host_batches(self) -> Iterator:
        batch: list = []
        for sample in self._iter_local_samples():
            batch.append(sample)
            if len(batch) == self.local_batch:
                yield _stack(batch)
                batch = []
        # a partial final batch is dropped: batches keep one shape

    # -- batches on the device ---------------------------------------------

    def __iter__(self) -> Iterator:
        """One epoch of batches on ``self.device``."""
        q: queue.Queue = queue.Queue(maxsize=self.config.prefetch)
        err: list = []
        stop = threading.Event()

        def put_checked(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            gen = self._host_batches()
            try:
                for hb in gen:
                    if not put_checked(hb):
                        break
            except Exception as e:     # raised again in the consumer
                err.append(e)
            finally:
                try:
                    gen.close()        # drains the shard's reads
                except Exception as e:
                    err.append(e)
                put_checked(_SENTINEL)

        t = threading.Thread(target=producer, daemon=True,
                             name="strom-loader")
        t.start()
        try:
            while True:
                hb = q.get()
                if hb is _SENTINEL:
                    if len(err) == 1:
                        raise err[0]
                    if err:
                        raise LoaderErrors(err) from err[0]
                    break
                yield _map(lambda x: to_device(self._engine, x,
                                               self.device), hb)
        finally:
            # an abandoned iterator stops the producer before returning,
            # so close() never races a thread still submitting reads
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=30)
        self.epoch += 1

    def close(self) -> None:
        if self._owns_engine:
            self._engine.close_all()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
