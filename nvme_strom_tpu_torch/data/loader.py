"""Sharded dataloader: shards on NVMe → device batches, one process a
device (counterpart of nvme_strom_tpu/data/loader.py ``ShardedLoader``).

Each process reads only its own rows.  Under a ``mesh``
(parallel/mesh.py) the processes that hold the same block of the batch
axis (``dp``) form one group (:func:`_batch_groups`): a group reads its
own round-robin share of the shards and yields its ``global_batch / dp``
rows, and the ranks of one group (its ``tp`` peers) read the same
shards in the same order.  Without a mesh every process is a group of
its own (``process_index`` / ``process_count``, default the
``torch.distributed`` rank and world size).  Batches are this process's
rows: the port has no global array to assemble, and with one device a
process the JAX ``_process_span`` / ``_device_row_spans`` are the
group's block of rows.  With ``seq_axis`` (per-sample formats) the
ranks that differ only along that axis (sp peers) are one group: they
read the same shards in the same order, and each keeps its own span of
dim 1 of every rank-2 leaf, the (batch, seq) layout of ring and Ulysses
attention; only that span is copied to the device.

Formats (``fmt``):

- ``wds`` (WebDataset tar shards) and ``tfrecord`` (``parts == {"":
  payload}``) run per sample: in a producer thread, shard index →
  planned member reads through the engine → decode (user fn) → host
  batch (np.stack); in the consumer each batch leaf starts its device
  copy on the bridge's side stream (``h2d_copy`` on a card), and the
  consumer's stream waits on the copy's event instead of the host
  (``ops/bridge.py`` ``AsyncPut``).
- ``fixedrec`` (formats/fixedrec.py) and ``wds_raw`` (single-part tar
  samples of one byte length) are the zero-copy paths: a batch is one
  contiguous span (for ``wds_raw``, one strided span of members, or one
  read a member when the stride is not uniform), read O_DIRECT into the
  engine's staging and copied to the device by ``h2d_copy`` with no host
  decode; a staging buffer is released once its copy's event has
  completed.  They take no ``decode`` and no ``shard_error_budget``,
  and shuffle shard order only.  Their payload never reaches the host,
  so their integrity check is the offline scrubber's, against the
  shards' ``.crc.json`` stamps (``write_fixedrec(checksums=True)``).

The sample order is the JAX loader's: shards sorted, then, with
``LoaderConfig.shuffle_buffer``, shard order and (per-sample formats)
each shard's sample order permuted per epoch from the seed
(data/sharding.py).  A partial final batch is dropped, or raises with
``LoaderConfig.drop_remainder=False``.

Under ``STROM_VERIFY`` (utils/checksum.py) each sample part of the
per-sample formats is checked against its shard's ``.crc.json`` sidecar
when the shard has one (``stamp_wds`` writes it): a mismatch is read
once more, past the host tier, and a part that still fails raises
:class:`ChecksumError` naming the shard.  With ``STROM_VERIFY`` off the
loader does no CRC work.

Shard quarantine (``LoaderConfig.shard_error_budget``, per-sample
formats): a shard whose index, read, check or decode fails is skipped
for this epoch and every later one, counted ``shards_quarantined``,
logged and traced as a ``strom.loader.quarantine`` span, while fewer
than the budget are out; past it, or with the default budget of 0, the
failure raises :class:`ShardReadError` naming the shard (and, past a
budget, the quarantine list).  Under ``STROM_RESILIENT=1`` the engine's
own retries come first, so only a failure they could not heal reaches
the quarantine.
"""

from __future__ import annotations

import logging
import os
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
from nvme_strom_tpu_torch.formats.tfrecord import TFRecordIndex
from nvme_strom_tpu_torch.formats.wds import WdsShardIndex
from nvme_strom_tpu_torch.io.engine import StromEngine, wait_exact
from nvme_strom_tpu_torch.io.faults import build_engine
from nvme_strom_tpu_torch.io.hostcache import spoil_span
from nvme_strom_tpu_torch.io.plan import plan_and_submit
from nvme_strom_tpu_torch.ops.bridge import (AsyncPut, StagingRetirePool,
                                             host_to_device, torch_dtype)
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


def _group_blocks(blocks: dict, n_blk: int, pi: int, axis: str) -> tuple:
    """(this process's group index, group count) from ``blocks``,
    process → the set of batch-axis blocks its devices cover.  The
    groups must tile the blocks equally: overlapping or unequal cover
    would hand different shards to processes that feed the same rows."""
    groups = sorted({frozenset(b) for b in blocks.values()}, key=min)
    all_blocks = [b for g in groups for b in g]
    if (len(all_blocks) != len(set(all_blocks))
            or set(all_blocks) != set(range(n_blk))
            or len({len(g) for g in groups}) != 1):
        raise ValueError(
            f"batch axis {axis!r}: process groups do not tile the "
            f"axis blocks equally ({[sorted(g) for g in groups]}); "
            "unsupported mesh layout")
    return groups.index(frozenset(blocks[pi])), len(groups)


def _batch_groups(mesh, axis: str, pi: int) -> tuple:
    """(group index, group count): processes whose devices cover the
    same blocks of ``axis`` share a group (the mesh's other axes)."""
    if axis not in mesh.shape:
        raise ValueError(f"mesh {mesh.shape} has no batch axis {axis!r}")
    blocks = {r: {c[axis]} for r, c in enumerate(mesh.devices_coords())}
    return _group_blocks(blocks, mesh.shape[axis], pi, axis)


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


class _Span(list):
    """The PendingReads of one strided run of ``k`` tar members."""

    def __init__(self, pieces, k: int):
        super().__init__(pieces)
        self.k = k


class ShardedLoader:
    """Iterate device batches of ``global_batch`` samples from shards of
    format ``fmt`` (``wds``, ``wds_raw``, ``tfrecord`` or ``fixedrec``;
    see the module docstring).  ``decode(parts: {ext: bytes}) -> array``
    (or a dict / tuple of arrays; per-sample formats only); ``exts``
    keeps only these member extensions (tar formats); ``engine``: a
    shared StromEngine (one is created by ``io/faults.py``
    ``build_engine`` and owned otherwise); ``device``: where batches go
    (default ``cuda:0``).  Each ``iter()`` is one epoch.  ``quarantined``
    lists the shards skipped under ``config.shard_error_budget``, in
    failure order; ``pieces_copied`` counts the zero-copy paths' staging
    pieces copied to the device (one ``h2d_copy`` launch each on a
    card)."""

    def __init__(self, shard_paths: Sequence, global_batch: int,
                 fmt: str = "wds", decode: Optional[Callable] = None,
                 engine: Optional[StromEngine] = None,
                 exts: Optional[List[str]] = None,
                 config: Optional[LoaderConfig] = None, device=None,
                 mesh=None, seq_axis: Optional[str] = None,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        if fmt not in ("wds", "wds_raw", "tfrecord", "fixedrec"):
            raise ValueError(f"unknown fmt {fmt!r}")
        if fmt in ("fixedrec", "wds_raw"):
            if decode is not None:
                raise ValueError(
                    f"{fmt} is a zero-copy raw path: payload goes "
                    "staging→device untouched; decode on device instead")
            if seq_axis is not None:
                raise ValueError(
                    f"{fmt} cannot seq-shard: a rank's seq slice of "
                    "every row is not a contiguous file span")
            if config is not None and config.shard_error_budget > 0:
                raise ValueError(
                    f"{fmt} does not support shard_error_budget: its "
                    "batch spans coalesce across shards, so per-shard "
                    "quarantine isolation does not exist")
        if global_batch < 1:
            raise ValueError(f"global_batch must be >= 1, got "
                             f"{global_batch}")
        from nvme_strom_tpu_torch.parallel.mesh import (batch_sharding,
                                                        local_device,
                                                        process_info)
        if seq_axis is not None:
            if mesh is None:
                raise ValueError("seq_axis needs a mesh")
            batch_sharding(mesh, "dp", seq_axis)   # the axis must exist
        #: the mesh axis dim 1 of rank-2 leaves is split over (or None)
        self.seq_axis = seq_axis
        self.device = resolve_device(device if device is not None or
                                     mesh is None else local_device())
        self.mesh = mesh
        self.fmt = fmt
        self.decode = decode or _default_decode
        self.exts = exts
        self.config = config or LoaderConfig()
        self.global_batch = global_batch
        if mesh is not None and process_index is None and \
                process_count is None:
            group_idx, n_groups = _batch_groups(mesh, "dp", mesh.rank)
        else:
            rank, world = process_info()
            group_idx = rank if process_index is None else process_index
            n_groups = world if process_count is None else process_count
        if global_batch % n_groups:
            raise ValueError(
                f"global_batch {global_batch} not divisible by "
                f"{n_groups} batch-axis groups")
        #: this process's batch-axis group and the number of groups
        self.group_index, self.group_count = group_idx, n_groups
        self.local_batch = global_batch // n_groups
        self.local_shards = assign_shards(shard_paths, group_idx, n_groups)
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
        self.pieces_copied = 0

    # -- samples (host side) -------------------------------------------------

    def _index_shard(self, path) -> list:
        key = str(path)
        cached = self._shard_index.get(key)
        if cached is not None:
            self._shard_index.move_to_end(key)
            return cached
        if self.fmt in ("wds", "wds_raw"):
            idx = WdsShardIndex(path)
            out = [{ext: rng for ext, rng in idx.samples[k].items()
                    if self.exts is None or ext in self.exts}
                   for k in idx.order]
        else:
            idx = TFRecordIndex(path)
            out = [{"": (off, ln)} for off, ln in zip(idx.offsets,
                                                      idx.lengths)]
            # the record walk faulted the file resident; a resident span
            # would send every record read down the buffered path
            fd = os.open(key, os.O_RDONLY)
            try:
                os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
            except OSError:
                pass
            finally:
                os.close(fd)
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
        if batch and not self.config.drop_remainder:
            raise ValueError(
                "partial final batch with drop_remainder=False is not "
                "representable as a fixed batch shape; pad your dataset "
                "or use drop_remainder=True")

    # -- batches on the device ---------------------------------------------

    def __iter__(self) -> Iterator:
        """One epoch of batches on ``self.device``."""
        if self.fmt == "fixedrec":
            return self._iter_fixedrec()
        if self.fmt == "wds_raw":
            return self._iter_wds_raw()
        return self._iter_samples()

    def _iter_samples(self) -> Iterator:
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
        put = AsyncPut(self._engine, self.device)
        try:
            while True:
                hb = q.get()
                if hb is _SENTINEL:
                    if len(err) == 1:
                        raise err[0]
                    if err:
                        raise LoaderErrors(err) from err[0]
                    break
                if self.seq_axis is not None:
                    hb = _map(self._seq_span, hb)
                yield _map(put.finish, _map(put.start, hb))
        finally:
            put.close()
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

    def _seq_span(self, x: np.ndarray) -> np.ndarray:
        """This rank's span of dim 1 of a rank-2 (batch, seq) leaf, a
        view (the copy to the device makes it contiguous); leaves of any
        other rank whole."""
        if x.ndim != 2:
            return x
        n = self.mesh.shape[self.seq_axis]
        if x.shape[1] % n:
            raise ValueError(
                f"seq_axis={self.seq_axis!r} (size {n}) cannot shard "
                f"batch leaf of shape {x.shape}: dim 1 not divisible")
        w = x.shape[1] // n
        i = self.mesh.coords[self.seq_axis]
        return x[:, i * w:(i + 1) * w]

    # -- the zero-copy paths: fixedrec and wds_raw -------------------------

    def _epoch_shard_order(self) -> List:
        """This epoch's shard order: the zero-copy paths shuffle whole
        shards only (shuffle records when the dataset is written)."""
        order = list(self.local_shards)
        if self.config.shuffle_buffer:
            perm = shuffled_indices(len(order), self.config.seed, self.epoch)
            order = [order[i] for i in perm]
        return order

    def _count_batches(self, total: int) -> int:
        if total % self.local_batch and not self.config.drop_remainder:
            raise ValueError(
                f"{total} local records do not fill batches of "
                f"{self.local_batch}; pad the dataset or set "
                "drop_remainder=True")
        return total // self.local_batch

    def _copy_pieces(self, pieces, transfers: list) -> torch.Tensor:
        """Completed staging pieces → one flat uint8 device tensor on the
        current stream; each piece's copy (``h2d_copy`` on a card) runs
        on the bridge's side stream and is appended to ``transfers``."""
        parts = []
        for pr in pieces:
            # a plan never crosses EOF: a short read is truncation
            t = host_to_device(self._engine, wait_exact(pr), self.device)
            transfers.append(t)
            self.pieces_copied += 1
            if t.event is not None:
                cur = torch.cuda.current_stream(self.device)
                cur.wait_event(t.event)
                t.tensor.record_stream(cur)
            parts.append(t.tensor)
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def _zero_copy_batches(self, n_batches: int, batch_pieces: int,
                           plan_reads, assemble, fhs) -> Iterator:
        """The read-ahead shared by fixedrec and wds_raw.
        ``plan_reads(r0, r1)`` submits the reads of local records [r0,
        r1) and returns them as nested lists of PendingReads;
        ``assemble(reads, transfers)`` turns them into the batch tensor,
        appending each copy's Transfer.  Up to ``config.prefetch``
        batches are planned ahead; a batch's staging buffers go back to
        the pool once its copies' events have completed, and the pool
        must hold one batch's pieces or the reads could never all be
        served.  Closes ``fhs`` and counts the epoch on exit."""
        eng = self._engine
        if batch_pieces > eng.n_buffers:
            raise ValueError(
                f"one batch needs {batch_pieces} staging buffers but the "
                f"pool has {eng.n_buffers}; raise EngineConfig."
                "chunk_bytes or lower the batch size")

        def flat(reads) -> list:
            out = []
            for x in reads:
                out.extend(flat(x) if isinstance(x, list) else [x])
            return out

        depth = max(1, self.config.prefetch)
        retire = StagingRetirePool(depth)
        held = [0]

        def finish(reads):
            prs = flat(reads)
            transfers: list = []
            try:
                out = assemble(reads, transfers)
            except BaseException:
                for t in transfers:      # copies out of the staging first
                    t.synchronize()
                for pr in prs:
                    pr.release()
                held[0] -= len(prs)
                raise

            def release_all():
                for pr in prs:
                    pr.release()
                held[0] -= len(prs)
            retire.push(release_all, transfers)
            return out

        pending: list = []       # planned batches, reads in flight
        ready: list = []         # batches whose copies are dispatched
        try:
            for b in range(n_batches):
                b0 = b * self.local_batch
                retire.drain_ready()
                while held[0] + batch_pieces > eng.n_buffers:
                    if pending:
                        ready.append(finish(pending.pop(0)))
                    elif not retire.retire_oldest():
                        break
                reads = plan_reads(b0, b0 + self.local_batch)
                pending.append(reads)
                held[0] += len(flat(reads))
                while pending and all(pr.is_ready()
                                      for pr in flat(pending[0])):
                    ready.append(finish(pending.pop(0)))
                if len(pending) + len(ready) > depth:
                    if not ready:
                        ready.append(finish(pending.pop(0)))
                    yield ready.pop(0)
            while pending:
                ready.append(finish(pending.pop(0)))
            while ready:
                yield ready.pop(0)
        finally:
            retire.flush()
            for reads in pending:
                for pr in flat(reads):
                    pr.release()
            for fh in fhs:
                eng.close(fh)
        self.epoch += 1

    def _iter_fixedrec(self) -> Iterator:
        """One epoch of fixedrec batches: a batch's records are one
        contiguous span of a shard (split only at shard ends and, by the
        planner, at whole records within a staging buffer), copied to
        the device piece by piece and viewed as the records' dtype and
        shape there."""
        from nvme_strom_tpu_torch.formats.fixedrec import FixedRecIndex
        eng = self._engine
        order = self._epoch_shard_order()
        idxs = [FixedRecIndex(p) for p in order]
        if not idxs:
            self.epoch += 1
            return
        rec_bytes, dtype, rshape = (idxs[0].record_bytes, idxs[0].dtype,
                                    idxs[0].shape)
        for ix in idxs[1:]:
            if (ix.record_bytes, ix.dtype, ix.shape) != (rec_bytes, dtype,
                                                         rshape):
                raise ValueError(f"{ix.path}: record layout differs from "
                                 f"{idxs[0].path}")
        max_read = (eng.config.chunk_bytes // rec_bytes) * rec_bytes
        if max_read == 0:
            raise ValueError(
                f"record ({rec_bytes}B) exceeds engine chunk_bytes "
                f"({eng.config.chunk_bytes}B); raise EngineConfig."
                "chunk_bytes")
        base, total = [], 0
        for ix in idxs:
            base.append(total)
            total += ix.count
        n_batches = self._count_batches(total)

        def row_spans(r0, r1):
            """Records [r0, r1) → [(shard, offset, nbytes)] contiguous
            extents, split at shard ends only."""
            out, si = [], 0
            while r0 < r1:
                while base[si] + idxs[si].count <= r0:
                    si += 1
                take = min(r1, base[si] + idxs[si].count) - r0
                out.append((si, (r0 - base[si]) * rec_bytes,
                            take * rec_bytes))
                r0 += take
            return out

        fhs = [eng.open(p) for p in order]

        def plan_reads(r0, r1):
            parts = plan_and_submit(
                eng, [(fhs[si], off, nb) for si, off, nb
                      in row_spans(r0, r1)],
                split_unit=rec_bytes, chunk_bytes=max_read,
                klass="prefetch")
            return [p for pieces in parts for p in pieces]

        tdtype = torch_dtype(dtype)

        def assemble(reads, transfers):
            out = self._copy_pieces(reads, transfers)
            return out.view(tdtype).reshape((self.local_batch,) + rshape)

        batch_pieces = max(
            (sum(-(-nb // max_read) for _, _, nb in row_spans(
                b * self.local_batch, (b + 1) * self.local_batch))
             for b in range(n_batches)), default=1)
        yield from self._zero_copy_batches(n_batches, batch_pieces,
                                           plan_reads, assemble, fhs)

    def _iter_wds_raw(self) -> Iterator:
        """One epoch of raw-member WebDataset batches, (batch, member
        bytes) uint8.  Members of one payload size sit at a constant
        stride (header + padded payload), so a run of consecutive
        members is one strided span, read and copied as one piece and
        cut to rows on the device (``view(k, stride)[:, :mlen]``); when
        the stride is not uniform each member is its own read."""
        eng = self._engine
        order = self._epoch_shard_order()
        recs: list = []          # (shard, offset, length) per record
        mlen = None
        for si, path in enumerate(order):
            for parts in self._index_shard(path):
                if len(parts) != 1:
                    raise ValueError(
                        f"{path}: wds_raw needs single-part samples (got "
                        f"{sorted(parts)}); restrict with exts= or use the "
                        "standard wds path")
                ((off, ln),) = parts.values()
                if mlen is None:
                    mlen = ln
                elif ln != mlen:
                    raise ValueError(
                        f"{path}: member length {ln} != {mlen}; wds_raw "
                        "stacks fixed-size members: variable-size samples "
                        "need the standard wds path")
                recs.append((si, off, ln))
        if mlen is None:
            self.epoch += 1
            return
        n_batches = self._count_batches(len(recs))
        chunk = eng.config.chunk_bytes
        stride = None
        uniform = True
        for (s0, o0, _), (s1, o1, _) in zip(recs, recs[1:]):
            if s0 == s1:
                if stride is None:
                    stride = o1 - o0
                elif o1 - o0 != stride:
                    uniform = False
                    break
        uniform = uniform and stride is not None and stride >= mlen
        if uniform:
            last = {si: off for si, off, _ in recs}
            # reading one header gap past the last member stays inside
            # tar's end-of-archive blocks
            uniform = all(off + stride <= os.path.getsize(order[si])
                          for si, off in last.items())
        if uniform:
            sis = np.fromiter((r[0] for r in recs), np.int64, len(recs))
            offs = np.fromiter((r[1] for r in recs), np.int64, len(recs))
            #: brk[r]: record r starts a new strided group
            brk = np.ones(len(recs), bool)
            brk[1:] = (sis[1:] != sis[:-1]) | (offs[1:]
                                               != offs[:-1] + stride)
        fhs = [eng.open(p) for p in order]

        def groups(r0, r1):
            out = []
            for r in range(r0, r1):
                si, off, _ = recs[r]
                if out and not brk[r]:
                    out[-1][2] += 1
                else:
                    out.append([si, off, 1])
            return out

        if uniform:
            def plan_reads(r0, r1):
                gs = groups(r0, r1)
                planned = plan_and_submit(
                    eng, [(fhs[si], off, k * stride) for si, off, k in gs],
                    chunk_bytes=chunk, klass="prefetch")
                return [_Span(p, k) for p, (_, _, k) in zip(planned, gs)]

            def assemble(reads, transfers):
                blocks = [self._copy_pieces(prs, transfers)
                          .view(prs.k, stride)[:, :mlen] for prs in reads]
                return torch.cat(blocks) if len(blocks) > 1 \
                    else blocks[0].contiguous()

            def batch_pieces_of(a, b):
                starts = np.flatnonzero(brk[a:b])
                if starts.size == 0 or starts[0] != 0:
                    starts = np.concatenate(([0], starts))
                k = np.diff(np.append(starts, b - a))
                return int(np.sum(-(-(k * stride) // chunk)))

            batch_pieces = max(
                (batch_pieces_of(b * self.local_batch,
                                 (b + 1) * self.local_batch)
                 for b in range(n_batches)), default=1)
        else:
            def plan_reads(r0, r1):
                planned = plan_and_submit(
                    eng, [(fhs[recs[r][0]], recs[r][1], recs[r][2])
                          for r in range(r0, r1)],
                    chunk_bytes=chunk, klass="prefetch")
                return [list(p) for p in planned]

            def assemble(reads, transfers):
                return torch.stack([self._copy_pieces(prs, transfers)
                                    for prs in reads])

            batch_pieces = self.local_batch * -(-mlen // chunk)

        yield from self._zero_copy_batches(n_batches, batch_pieces,
                                           plan_reads, assemble, fhs)

    def close(self) -> None:
        if self._owns_engine:
            self._engine.close_all()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
