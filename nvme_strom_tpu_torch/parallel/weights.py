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
then; a file without stamps verifies nothing.  Sharding and demand
faulting are not part of this port yet.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Union

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
from nvme_strom_tpu_torch.ops.ici import ici_scatter_enabled, scatter_engine
from nvme_strom_tpu_torch.utils.checksum import (ChecksumError,
                                                 VerifyPolicy)


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

    def _load_tensor(self, eng: StromEngine, name: str,
                     dev: torch.device, policy: VerifyPolicy,
                     stamps: Dict[str, Dict[str, int]]) -> torch.Tensor:
        sf = self._by_name[name]
        info = sf.tensors[name]
        shape = tuple(info["shape"])
        stamp = stamps.get(sf.path, {}).get(name)
        check = stamp is not None and policy.want()
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
            for view, release in self._stream_rows(eng, fh, sf, name):
                if check:
                    crc = crc32c(view, crc)
                    eng.stats.add(bytes_verified=int(view.nbytes))
                try:
                    t = host_to_device(eng, view, dev)
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
        return flat.view(torch_dtype(info["dtype"])).reshape(shape)

    def _stream_rows(self, eng: StromEngine, fh: int, sf: SafetensorsFile,
                     name: str):
        """Yield (host view, release callback or None) per row chunk of
        ``name``, each at most one staging buffer.  The consumer calls
        the callback once the copies out of the view have completed;
        None marks host-owned memory."""
        info = sf.tensors[name]
        shape = info["shape"]
        if not shape or info["nbytes"] == 0:
            if info["nbytes"] == 0:
                return
            (pieces,) = plan_and_submit(eng, [(fh, info["offset"],
                                               info["nbytes"])])
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
            for r in range(shape[0]):
                ent = sf.slice_plan(name, r, 1)
                buf = np.empty(ent.length, dtype=np.uint8)
                (pieces,) = plan_and_submit(eng, [(fh, ent.offset,
                                                   ent.length)])
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
        slices = [sf.slice_plan(name, r, min(rows, shape[0] - r))
                  for r in range(0, shape[0], rows)]
        planned = plan_and_submit(eng, [(fh, e.offset, e.length)
                                        for e in slices])
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


def save_checkpoint(path, params: Dict[str, object]) -> None:
    """Tensors (any device) or numpy arrays → one safetensors file,
    durable and out of the page cache when this returns."""
    write_safetensors(path, params)
