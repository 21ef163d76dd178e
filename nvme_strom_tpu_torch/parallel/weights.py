"""safetensors weights on NVMe → device tensors on one device
(counterpart of nvme_strom_tpu/parallel/weights.py ``LazyCheckpoint``
and ``save_checkpoint``).

Each tensor's rows are streamed through the engine in chunks of at most
one staging buffer (rows are contiguous on disk), copied to the device
straight out of the staging buffers, and joined on the device; the
staging buffers are released by a :class:`StagingRetirePool` once the
copies out of them have completed.  With ``STROM_ICI_SCATTER=1`` the
files are read once across an exchange group and every tensor is read
from the gathered bytes (ops/ici.py), copied to the card in place from
their page-locked store.

Under ``STROM_VERIFY`` (utils/checksum.py) each tensor's streamed chunks
are run through a CRC32C and compared with the write-time stamp the
file's metadata carries (``formats/safetensors.py``
``tensor_checksums``), on the direct and the scatter path alike: the
chunks count in ``bytes_verified``, a mismatch in ``checksum_failures``,
and the load raises :class:`ChecksumError` before it returns any tensor.
The copies out of the chunks are already on their way to the device by
then; a file without stamps verifies nothing.

:class:`FaultingCheckpoint` is the weights half of serve-while-restoring
cold start (io/coldstart.py): a server starts on it before any tensor is
resident, a request's first step faults the missing tensors in at
``decode`` class from the first, while a bulk thread streams them at
``restore`` class from the last, each tensor read from NVMe once across
the two lanes.

:meth:`LazyCheckpoint.load_sharded` is the multi-process load: each
process reads only the row span of its own slice of every tensor (its
``Sharding``, parallel/shardings.py), once, even where a column split
cuts the span, copies the span's chunks to its device through kernel 1
and cuts its columns out there.  So a process holding a column slice
reads the whole row span, as each host of the JAX package does, but
bounces nothing.  ``STROM_VERIFY`` checks a span that covers the whole
tensor; ``STROM_ICI_SCATTER=1`` serves the spans from the read-once
exchange (ops/ici.py), one rank a process.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from nvme_strom_tpu_torch.device import resolve_device
from nvme_strom_tpu_torch.formats.safetensors import (SafetensorsFile,
                                                      tensor_checksums,
                                                      torch_dtype,
                                                      write_safetensors)
from nvme_strom_tpu_torch.io.engine import StromEngine, crc32c, wait_exact
from nvme_strom_tpu_torch.io.faults import build_engine
from nvme_strom_tpu_torch.io.plan import join_pieces, plan_and_submit
from nvme_strom_tpu_torch.ops.bridge import (StagingRetirePool,
                                             host_to_device)
from nvme_strom_tpu_torch.ops.ici import (ExchangeError, ici_scatter_enabled,
                                          scatter_engine)
from nvme_strom_tpu_torch.utils.checksum import (ChecksumError,
                                                 VerifyPolicy)


def _sharding_of(shardings, name: str, shape):
    """``name``'s Sharding from {name: Sharding} or ``fn(name, shape)``
    (the JAX ``_sharding_for``); KeyError without one."""
    sh = (shardings.get(name) if isinstance(shardings, dict)
          else shardings(name, shape))
    if sh is None:
        raise KeyError(f"no sharding for tensor {name}")
    return sh


class LazyCheckpoint:
    """Union view over one or more safetensors files: a list of paths,
    one path, or a directory of ``*.safetensors``."""

    def __init__(self, source: Union[str, os.PathLike, Sequence]):
        if isinstance(source, (str, os.PathLike)):
            src = str(source)
            if os.path.isdir(src):
                paths = sorted(os.path.join(src, n) for n in os.listdir(src)
                               if n.endswith(".safetensors"))
            else:
                paths = [src]
        else:
            paths = [str(p) for p in source]
        if not paths:
            raise ValueError(f"no safetensors files in {source!r}")
        self.files = [SafetensorsFile(p) for p in paths]
        self._by_name: Dict[str, SafetensorsFile] = {}
        for sf in self.files:
            for name in sf.keys():
                if name in self._by_name:
                    raise ValueError(f"duplicate tensor {name}")
                self._by_name[name] = sf

    def keys(self):
        return self._by_name.keys()

    def load(self, engine: Optional[StromEngine] = None, device=None,
             ici_group=None) -> Dict[str, torch.Tensor]:
        """Every tensor on ``device`` (default ``cuda:0``) in its stored
        dtype.  ``engine=None`` uses a temporary engine.

        ``STROM_ICI_SCATTER=1``: each rank of ``ici_group`` (default
        ``exchange_group(STROM_ICI_HOSTS)``) reads a 1/N share of the
        files, the shares are all-gathered, and every tensor is read
        from the gathered bytes; any failure of that set-up browns out
        to reading the files directly (``ici_fallbacks``)."""
        dev = resolve_device(device)
        policy = VerifyPolicy()
        # file path → its tensors' write-time CRC32C stamps
        stamps = ({sf.path: tensor_checksums(sf) for sf in self.files}
                  if policy.enabled else {})
        own = engine is None
        base = engine if engine is not None else build_engine()
        try:
            eng = None
            if ici_scatter_enabled():
                eng = scatter_engine(base, [sf.path for sf in self.files],
                                     group=ici_group)
            return {name: self._load_tensor(eng or base, name, dev, policy,
                                            stamps)
                    for name in self.keys()}
        finally:
            if own:
                base.close_all()

    def shape(self, name) -> tuple:
        return tuple(self._by_name[name].tensors[name]["shape"])

    def load_sharded(self, shardings, engine: Optional[StromEngine] = None,
                     device=None) -> Dict[str, torch.Tensor]:
        """This process's slice of every tensor, on ``device`` (default
        the process's own, parallel/mesh.py ``local_device``).

        ``shardings``: {name: Sharding} or ``fn(name, shape) ->
        Sharding`` (parallel/shardings.py); a tensor without one raises.
        Only the rows of the slice are read, each span once; a column
        slice is cut on the device from its span's rows.
        ``STROM_ICI_SCATTER=1``: the files are read once across the
        processes (each reading its share, ops/ici.py
        ``ProcessExchange``) and every span is served from the
        exchanged bytes."""
        from nvme_strom_tpu_torch.parallel.mesh import local_device
        dev = resolve_device(device if device is not None
                             else local_device())
        policy = VerifyPolicy()
        stamps = ({sf.path: tensor_checksums(sf) for sf in self.files}
                  if policy.enabled else {})
        own = engine is None
        base = engine if engine is not None else build_engine()
        try:
            eng = None
            if ici_scatter_enabled():
                eng = scatter_engine(base, [sf.path for sf in self.files])
            out = {}
            for name in self.keys():
                bounds = _sharding_of(shardings, name, self.shape(name)
                                      ).local_bounds(self.shape(name))
                out[name] = self._load_tensor(eng or base, name, dev,
                                              policy, stamps, bounds=bounds)
            return out
        finally:
            if own:
                base.close_all()

    def _load_tensor(self, eng: StromEngine, name: str,
                     dev: torch.device, policy: VerifyPolicy,
                     stamps: Dict[str, Dict[str, int]],
                     klass: Optional[str] = None,
                     stream=None, bounds=None) -> torch.Tensor:
        """One tensor on ``dev``, its reads of QoS class ``klass`` and
        its copies on ``stream`` (default: the bridge's side stream);
        the copies have completed when it returns (its bytes are on the
        device in stream order of the caller's current stream).
        ``bounds`` ((lo, hi) a dimension) loads that slice: its rows
        are read, its columns cut on the device."""
        sf = self._by_name[name]
        info = sf.tensors[name]
        shape = tuple(info["shape"])
        r0, r1 = (0, shape[0]) if shape else (0, 1)
        if bounds is not None and shape:
            r0, r1 = bounds[0]
        stamp = stamps.get(sf.path, {}).get(name)
        check = (stamp is not None and policy.want()
                 and (r0, r1) == ((0, shape[0]) if shape else (0, 1)))
        crc = 0
        # the pool must keep a buffer free beyond the reads in flight and
        # the retirements it defers, or a deferred read could wait on a
        # buffer only this loader can release
        stream_depth = max(2, eng.config.queue_depth // 2)
        retire = StagingRetirePool(max(0, min(eng.config.queue_depth // 2,
                                              eng.n_buffers - stream_depth
                                              - 1)))
        fh = eng.open(sf.path)
        transfers = []
        try:
            for view, release in self._stream_rows(eng, fh, sf, name,
                                                   klass, r0, r1):
                if check:
                    crc = crc32c(view, crc)
                    eng.stats.add(bytes_verified=int(view.nbytes))
                try:
                    t = host_to_device(eng, view, dev, stream=stream)
                except BaseException:
                    if release is not None:
                        release()
                    raise
                transfers.append(t)
                retire.push(release, [t])
            if check and crc != stamp:
                eng.stats.add(checksum_failures=1)
                raise ChecksumError(
                    f"tensor {name} of {sf.path} fails its stamped CRC32C "
                    f"({crc:#010x} != {stamp:#010x}): corrupt weights must "
                    "not reach the model")
        finally:
            retire.flush()
            for t in transfers:
                t.synchronize()
            eng.close(fh)
        parts = [t.tensor for t in transfers]
        flat = (parts[0] if len(parts) == 1 else
                torch.cat(parts) if parts else
                torch.empty(0, dtype=torch.uint8, device=dev))
        if bounds is None or not shape:
            return flat.view(torch_dtype(info["dtype"])).reshape(shape)
        rows = flat.view(torch_dtype(info["dtype"])).reshape(
            (r1 - r0,) + shape[1:])
        tail = tuple(slice(a, b) for a, b in bounds[1:])
        if any((a, b) != (0, n) for (a, b), n in zip(bounds[1:],
                                                     shape[1:])):
            rows = rows[(slice(None),) + tail].contiguous()
        return rows

    def _stream_rows(self, eng: StromEngine, fh: int, sf: SafetensorsFile,
                     name: str, klass: Optional[str] = None,
                     r0: int = 0, r1: Optional[int] = None):
        """Yield (host view, release callback or None) per row chunk of
        rows [r0, r1) of ``name`` (default all), each at most one
        staging buffer.  The consumer calls the callback once the copies
        out of the view have completed; None marks host-owned memory."""
        info = sf.tensors[name]
        shape = info["shape"]
        if not shape or info["nbytes"] == 0:
            if info["nbytes"] == 0:
                return
            (pieces,) = plan_and_submit(eng, [(fh, info["offset"],
                                               info["nbytes"])],
                                        klass=klass)
            p = join_pieces(pieces, eng.stats)
            try:
                view = wait_exact(p)
            except BaseException:
                p.release()
                raise
            yield view, p.release
            return
        row_bytes = info["nbytes"] // shape[0]
        chunk = eng.config.chunk_bytes
        if row_bytes > chunk:
            # one row outgrows a staging buffer: assemble rows on the
            # host (a bounce — raise chunk_bytes to avoid it)
            for r in range(r0, shape[0] if r1 is None else r1):
                ent = sf.slice_plan(name, r, 1)
                buf = np.empty(ent.length, dtype=np.uint8)
                (pieces,) = plan_and_submit(eng, [(fh, ent.offset,
                                                   ent.length)],
                                            klass=klass)
                pos = 0
                for p in pieces:
                    try:
                        v = wait_exact(p)
                        buf[pos:pos + v.nbytes] = v
                        pos += v.nbytes
                    finally:
                        p.release()
                eng.stats.add(bounce_bytes=ent.length)
                yield buf, None
            return
        rows = max(1, chunk // row_bytes)
        end = shape[0] if r1 is None else r1
        slices = [sf.slice_plan(name, r, min(rows, end - r))
                  for r in range(r0, end, rows)]
        planned = plan_and_submit(eng, [(fh, e.offset, e.length)
                                        for e in slices], klass=klass)
        pend = [join_pieces(pieces, eng.stats) for pieces in planned]
        try:
            while pend:
                p = pend[0]
                view = wait_exact(p)
                pend.pop(0)
                yield view, p.release
        finally:
            for p in pend:
                p.release()


class FaultingCheckpoint:
    """Demand-faulting front end over :class:`LazyCheckpoint` on one
    device (counterpart of the JAX package's ``FaultingCheckpoint``,
    which takes shardings where this takes ``device``).

    A server built on it (models/serving.py) takes traffic at once.  Two
    lanes then race on one claim table, each tensor read from NVMe at
    most once whichever gets there first:

    * demand faults: :meth:`get` / :meth:`materialize` load a missing
      tensor at ``decode`` class, ahead of what the QoS scheduler holds;
    * the bulk lane: :meth:`start_bulk` streams the tensors on a thread
      at ``restore`` class, from the last key back, through the
      read-once scatter under ``STROM_ICI_SCATTER=1`` (over
      ``ici_group``) as :meth:`LazyCheckpoint.load` does.  The JAX
      package's bulk lane walks the keys from the first, as its demand
      lane does, so a request arriving at boot only ever waits on the
      bulk lane's claims; walking from the other end, the two lanes
      read disjoint tensors at once and meet in the middle.

    A waiter blocks on the claimant's event instead of reading again.  A
    failed claim (the bulk lane's ring tripped) wakes its waiters and
    is dropped, so a demand fault claims the tensor again and loads it
    at ``decode`` class: the breakers brown the bulk lane out with no
    consumer error.  ``STROM_VERIFY`` applies as on the eager load.

    Every byte reaches the card through ``h2d_copy`` straight from the
    engine's staging buffers.  The bulk lane's copies and joins run on
    its own CUDA stream, apart from the bridge's side stream that a
    demand fault's copies take, and it records an event after each
    tensor; a tensor it loaded is handed out only after the caller's
    current stream waits on that event.

    ``shardings`` ({name: Sharding} or ``fn(name, shape)``,
    parallel/shardings.py) makes each tensor this process's slice, read
    as :meth:`LazyCheckpoint.load_sharded` reads it."""

    def __init__(self, source, device=None,
                 engine: Optional[StromEngine] = None, coordinator=None,
                 ici_group=None, shardings=None):
        self.ckpt = (source if isinstance(source, LazyCheckpoint)
                     else LazyCheckpoint(source))
        self.device = resolve_device(device)
        self._shardings = shardings
        self.coordinator = coordinator
        self._ici_group = ici_group
        self._own = engine is None
        self.engine = engine if engine is not None else build_engine()
        self._policy = VerifyPolicy()
        self._stamps = ({sf.path: tensor_checksums(sf)
                         for sf in self.ckpt.files}
                        if self._policy.enabled else {})
        self._lock = threading.Lock()
        self._tensors: Dict[str, torch.Tensor] = {}
        #: name → the bulk stream's event after its copies (CUDA only)
        self._events: Dict[str, object] = {}
        self._claims: Dict[str, threading.Event] = {}
        #: tensors faulted at decode class, in fault order
        self._fault_names: List[str] = []
        self._resident_ev = threading.Event()
        self._bulk_thread: Optional[threading.Thread] = None
        #: what the bulk lane raised, per tensor it gave up on
        self.bulk_errors: Dict[str, str] = {}
        #: a fault of the exchange across processes that stopped the bulk
        #: lane (ops/ici.py ``ExchangeError``): :meth:`join_bulk` raises it
        self.bulk_failure: Optional[BaseException] = None

    def keys(self):
        return self.ckpt.keys()

    def resident(self) -> bool:
        """True once every tensor is on the device."""
        return self._resident_ev.is_set()

    def wait_resident(self, timeout: Optional[float] = None) -> bool:
        return self._resident_ev.wait(timeout)

    def fault_names(self) -> List[str]:
        """Tensors demand-faulted at decode class, in fault order."""
        with self._lock:
            return list(self._fault_names)

    def _bounds(self, name: str):
        """This process's slice of ``name``, or None (the whole)."""
        if self._shardings is None:
            return None
        shape = self.ckpt.shape(name)
        return _sharding_of(self._shardings, name, shape).local_bounds(shape)

    def _ready(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """``t`` usable on the caller's current stream: a bulk-lane
        tensor's event is waited on by that stream first."""
        ev = self._events.get(name)
        if ev is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ev)
            t.record_stream(cur)
        return t

    def _acquire(self, name: str, eng, klass: str, stream=None):
        """Load ``name`` under the claim table: (tensor, loaded by this
        call), its copies on ``stream``.  A failed claim is dropped for
        the next caller."""
        while True:
            with self._lock:
                t = self._tensors.get(name)
                if t is not None:
                    return t, False
                ev = self._claims.get(name)
                mine = ev is None
                if mine:
                    ev = self._claims[name] = threading.Event()
            if not mine:
                ev.wait()
                continue   # loaded (returned above) or failed (reclaim)
            try:
                bounds = self._bounds(name)
                t = self.ckpt._load_tensor(
                    eng, name, self.device, self._policy, self._stamps,
                    klass=klass, stream=stream,
                    **({} if bounds is None else {"bounds": bounds}))
                done_ev = None
                if self.device.type == "cuda":
                    done_ev = torch.cuda.Event()
                    done_ev.record(torch.cuda.current_stream(self.device))
            except BaseException:
                with self._lock:
                    self._claims.pop(name, None)
                ev.set()
                raise
            with self._lock:
                self._tensors[name] = t
                if done_ev is not None:
                    self._events[name] = done_ev
                self._claims.pop(name, None)
                done = len(self._tensors) == len(self.ckpt.keys())
            ev.set()
            if done:
                self._resident_ev.set()
                if self.coordinator is not None:
                    self.coordinator.note_weights_resident()
            return t, True

    def get(self, name: str, klass: str = "decode") -> torch.Tensor:
        """``name`` on the device, faulted in at ``klass`` if missing."""
        t0 = time.monotonic()
        t, loaded = self._acquire(name, self.engine, klass)
        if loaded and klass == "decode":
            ms = (time.monotonic() - t0) * 1e3
            with self._lock:
                self._fault_names.append(name)
            self.engine.stats.add(
                coldstart_faults=1,
                coldstart_fault_bytes=t.numel() * t.element_size())
            if self.coordinator is not None:
                self.coordinator.note_fault_ms(ms)
        return self._ready(name, t)

    def materialize(self, klass: str = "decode") -> Dict[str, torch.Tensor]:
        """Every tensor, faulting the missing ones in at ``klass``: the
        servers' first step makes the whole dict resident."""
        return {name: self.get(name, klass=klass)
                for name in self.ckpt.keys()}

    def start_bulk(self) -> threading.Thread:
        """Start the bulk lane (idempotent); returns its thread."""
        with self._lock:
            if self._bulk_thread is not None:
                return self._bulk_thread
            t = threading.Thread(target=self._bulk_run,
                                 name="strom-coldstart-bulk", daemon=True)
            self._bulk_thread = t
        t.start()
        return t

    def _bulk_run(self) -> None:
        eng = self.engine
        if ici_scatter_enabled():
            try:
                eng = scatter_engine(self.engine,
                                     [sf.path for sf in self.ckpt.files],
                                     group=self._ici_group) or self.engine
            except ExchangeError as e:
                self.bulk_failure = e
                return
        stream = (torch.cuda.Stream(self.device)
                  if self.device.type == "cuda" else None)
        for name in reversed(list(self.ckpt.keys())):
            try:
                if stream is not None:
                    with torch.cuda.stream(stream):
                        _, loaded = self._acquire(name, eng, "restore",
                                                  stream=stream)
                else:
                    _, loaded = self._acquire(name, eng, "restore")
            except Exception as e:   # noqa: BLE001 — the lane never takes
                # the replica down: the tensor is left to a demand fault
                self.bulk_errors[name] = repr(e)
                loaded = False
            if loaded:
                self.engine.stats.add(coldstart_bulk_tensors=1)

    def join_bulk(self, timeout: Optional[float] = None) -> None:
        """Wait for the bulk lane; raise the exchange fault that stopped
        it, if one did."""
        with self._lock:
            t = self._bulk_thread
        if t is not None:
            t.join(timeout)
        if self.bulk_failure is not None:
            raise self.bulk_failure

    def close(self) -> None:
        """Join the bulk lane, then close an engine this object built."""
        try:
            self.join_bulk()
        finally:
            if self._own:
                self.engine.close_all()


def save_checkpoint(path, params: Dict[str, object]) -> None:
    """Tensors (any device) or numpy arrays → one safetensors file,
    durable and out of the page cache when this returns."""
    write_safetensors(path, params)
