"""Step-numbered checkpoints of training state through the engine's
O_DIRECT writer, for one process (counterpart of
nvme_strom_tpu/checkpoint/manager.py ``CheckpointManager``).

Layout of one checkpoint, the JAX package's format 2:

    <dir>/step_00000100/state-00000.safetensors   every tensor
    <dir>/step_00000100/meta.json                 {"format": 2, "step",
                                                   "tensors": index}

A state is any nesting of dicts, lists and tuples with tensors, numpy
arrays or Python scalars at the leaves; a leaf is named by its path,
keys joined with ``|`` as the JAX package's ``flatten_with_names`` joins
them, so a params-only checkpoint is readable by both packages.  Each
tensor saves as one whole tile; restore also reads tensors stored as
several tiles (the JAX package's saves from a mesh) and assembles them.
Saves are atomic: the step is staged in ``.tmp_step_XXXXXXXX`` and
renamed into place once every byte is on disk; a staging directory left
by a crashed save is never taken for a checkpoint and is removed at
startup once it is older than ``gc_min_age_s``.  Restore steps past a
damaged step to an older one, and can read the step once across an
exchange group (``STROM_ICI_SCATTER``, ops/ici.py).  Multi-host saves
and ``STROM_VERIFY`` on restore are not part of this port yet.
"""

from __future__ import annotations

import concurrent.futures
import errno
import json
import logging
import os
import re
import shutil
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from nvme_strom_tpu_torch.checkpoint.scatter import build_restore_manifest
from nvme_strom_tpu_torch.formats.safetensors import (
    SafetensorsFile, torch_dtype, write_safetensors_engine)
from nvme_strom_tpu_torch.io.engine import StromEngine, wait_exact
from nvme_strom_tpu_torch.io.plan import plan_and_submit
from nvme_strom_tpu_torch.ops.bridge import host_to_device, pinned_mapping
from nvme_strom_tpu_torch.ops.ici import (ici_hosts, ici_scatter_enabled,
                                          ici_unit_bytes, scatter_engine)
from nvme_strom_tpu_torch.parallel.mesh import exchange_group

_STEP_RE = re.compile(r"^step_(\d{8})$")
_TMP_RE = re.compile(r"^\.tmp_step_(\d{8})$")
_FILE = "state-00000.safetensors"
_log = logging.getLogger(__name__)


def flatten_with_names(tree, prefix: str = "") -> Dict[str, object]:
    """Nested dicts / lists / tuples → {path name: leaf}: dict keys and
    sequence indices joined with ``|`` (tensor names may hold ``.`` and
    ``/``); a bare leaf is ``_root``."""
    out: Dict[str, object] = {}

    def walk(node, path):
        if isinstance(node, dict):
            items = node.items()
        elif isinstance(node, (list, tuple)):
            items = enumerate(node)
        else:
            name = "|".join(path) or "_root"
            if name in out:
                raise ValueError(f"duplicate flattened name {name!r}")
            out[name] = node
            return
        for k, v in items:
            walk(v, path + [str(k)])

    walk(tree, [prefix] if prefix else [])
    return out


def _unflatten_like(tree, values: Dict[str, object], path=()):
    if isinstance(tree, dict):
        return {k: _unflatten_like(v, values, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten_like(v, values, path + (str(i),))
                          for i, v in enumerate(tree))
    return values["|".join(path) or "_root"]


class TargetMismatchError(ValueError):
    """The restore target disagrees with the checkpoint (a wrong
    shape): a caller's bug, never damage, so restore does not step past
    it to an older checkpoint."""


def _tile_key(name: str, bounds: tuple, shape: tuple) -> str:
    """Safetensors entry name of one stored tile; a whole-tensor tile
    keeps the plain name (the JAX package's ``_tile_key``)."""
    if tuple(bounds) == tuple((0, d) for d in shape):
        return name
    return name + "@t" + "x".join(f"{a}-{b}" for a, b in bounds)


def _dtype_name(leaf) -> str:
    """The index's dtype name (numpy spelling, "bfloat16" included)."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


def _newest_mtime(path: str) -> float:
    newest = os.path.getmtime(path)
    with os.scandir(path) as it:
        for ent in it:
            newest = max(newest, ent.stat().st_mtime)
    return newest


class CheckpointManager:
    """Save / restore step-numbered checkpoints in ``directory``.

    ``max_to_keep``: the newest steps kept after a save (None keeps
    all).  ``engine``: a shared StromEngine (a temporary one per save or
    restore otherwise).  ``gc_min_age_s``: a ``.tmp_step_*`` staging
    directory untouched this long is a crashed save's debris and is
    removed when the manager is created (a live save keeps its files'
    mtimes moving)."""

    def __init__(self, directory: Union[str, os.PathLike],
                 max_to_keep: Optional[int] = 3,
                 engine: Optional[StromEngine] = None,
                 gc_min_age_s: float = 3600.0):
        self.directory = str(directory)
        self.max_to_keep = max_to_keep
        self._engine = engine
        self._executor: Optional[concurrent.futures.Executor] = None
        self._pending: Optional[concurrent.futures.Future] = None
        os.makedirs(self.directory, exist_ok=True)
        #: staging directories of crashed saves removed at startup
        self.tmp_gc: list = []
        #: the step the last restore read (an older one than asked for
        #: when it fell back past a damaged step)
        self.last_restore_step: Optional[int] = None
        self._gc_tmp_dirs(gc_min_age_s)

    def _gc_tmp_dirs(self, min_age: float) -> None:
        now = time.time()
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name)
            if not _TMP_RE.match(name) or not os.path.isdir(path):
                continue
            try:
                if now - _newest_mtime(path) < min_age:
                    continue
            except OSError:
                continue               # racing removal: not ours
            shutil.rmtree(path, ignore_errors=True)
            if os.path.exists(path):
                _log.warning("could not remove checkpoint staging dir %s",
                             path)
                continue
            self.tmp_gc.append(path)
            _log.warning("removed staging dir %s of a crashed save", path)

    # -- introspection -----------------------------------------------------

    def all_steps(self) -> list:
        """Steps whose meta.json parses and is format 2 (a torn save
        never shadows an intact older step)."""
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if not m:
                continue
            try:
                with open(os.path.join(self.directory, name,
                                       "meta.json")) as f:
                    if json.load(f).get("format") != 2:
                        continue
            except (OSError, json.JSONDecodeError):
                continue
            steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    # -- save --------------------------------------------------------------

    def save(self, step: int, state, force: bool = False) -> str:
        """Write ``state`` as checkpoint ``step``; returns its path.
        ``force`` replaces an existing step."""
        self.wait_pending()
        return self._write(step, *self._snapshot(step, state, force))

    def save_async(self, step: int, state, force: bool = False
                   ) -> concurrent.futures.Future:
        """Snapshot ``state`` to host memory now (the training loop may
        update its tensors right after), then write it on a background
        thread.  At most one save is in flight: this and every save or
        restore first waits for the previous one and re-raises its
        error.  Returns a future of the final path."""
        self.wait_pending()
        args = self._snapshot(step, state, force)
        if self._executor is None:
            self._executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="strom-ckpt")
        self._pending = self._executor.submit(self._write, step, *args)
        return self._pending

    def wait_pending(self) -> None:
        """Block until an in-flight ``save_async`` is done; re-raises its
        failure."""
        if self._pending is not None:
            f, self._pending = self._pending, None
            f.result()

    def close(self) -> None:
        self.wait_pending()
        if self._executor is not None:
            self._executor.shutdown()
            self._executor = None

    def _snapshot(self, step: int, state, force: bool):
        """Validate, stage the temp dir, and copy every leaf to host
        memory: device tensors through pinned buffers, one synchronise
        for all.  The copy is the checkpoint's consistency point."""
        final = self.step_dir(step)
        if os.path.exists(final):
            if not force:
                raise FileExistsError(f"checkpoint step {step} exists")
            shutil.rmtree(final)
        tmp = os.path.join(self.directory, f".tmp_step_{step:08d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        host: Dict[str, torch.Tensor] = {}
        index: Dict[str, dict] = {}
        cuda = False
        for name, leaf in flatten_with_names(state).items():
            if leaf is None:
                continue
            if isinstance(leaf, torch.Tensor):
                t = leaf.detach()
                if t.device.type == "cuda":
                    cp = torch.empty(t.shape, dtype=t.dtype,
                                     pin_memory=True)
                    cp.copy_(t, non_blocking=True)
                    cuda = True
                else:
                    cp = t.to("cpu", copy=True).contiguous()
            else:
                cp = torch.from_numpy(np.array(leaf))
            host[name] = cp
            index[name] = {
                "shape": list(cp.shape), "dtype": _dtype_name(leaf),
                "scalar": not isinstance(leaf, (torch.Tensor, np.ndarray)),
                "tiles": [{"file": _FILE,
                           "idx": [[0, d] for d in cp.shape]}]}
        if cuda:
            torch.cuda.synchronize()
        return tmp, final, host, index

    def _write(self, step: int, tmp: str, final: str,
               host: Dict[str, torch.Tensor], index: Dict[str, dict]) -> str:
        """Engine writes, the manifest, the durable rename, pruning."""
        eng, own = self._get_engine()
        t0 = time.monotonic()
        try:
            write_safetensors_engine(os.path.join(tmp, _FILE), host, eng,
                                     metadata={"step": step, "process": 0})
        finally:
            if own:
                eng.close_all()
        t1 = time.monotonic()
        meta = {"format": 2, "step": step, "time": time.time(),
                "process_count": 1, "tensors": index}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        dfd = os.open(self.directory, os.O_RDONLY)
        try:
            os.fsync(dfd)                # the rename itself is durable
        finally:
            os.close(dfd)
        #: seconds of the last save's tensor writes and of its commit
        self.last_save_phases = {"tiles_s": t1 - t0,
                                 "commit_s": time.monotonic() - t1}
        if self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self.step_dir(old), ignore_errors=True)
        return final

    # -- restore -----------------------------------------------------------

    #: errors that mean "this checkpoint step is damaged" (torn manifest
    #: or header, missing or truncated data file, a tensor its tiles
    #: under-cover): restore steps past them to an older step.  A target
    #: that does not fit (TargetMismatchError, or KeyError for a tensor
    #: the step lacks) is a caller's bug that every step would repeat: it
    #: raises at once.
    _DAMAGE = (OSError, ValueError)

    def restore(self, target=None, step: Optional[int] = None,
                device=None, fallback: bool = True, ici_group=None):
        """Read checkpoint ``step`` (default: the latest).

        With a ``target`` (the state's structure, leaves giving shape
        and dtype), returns the same structure: a tensor leaf comes back
        on the target's device (``device`` overrides) in the target's
        dtype, a numpy leaf as numpy, a Python scalar as its type.
        Without one, returns ``{name: tensor}`` of every tensor on
        ``device`` (default the CPU).  A tensor stored as several tiles
        (a JAX package save from a mesh) is assembled from them.  Bytes
        reach a CUDA device through the bridge (``h2d_copy``).

        ``fallback``: when the chosen step turns out damaged, restore
        the next older step instead, logged and counted in
        ``restore_fallbacks``; ``last_restore_step`` says which step was
        read.  A ``step`` that never existed raises.

        ``STROM_ICI_SCATTER=1``: the step's payload is read once, each
        of the ``ici_group``'s ranks (default
        ``exchange_group(STROM_ICI_HOSTS)``) reading a 1/N share, and
        all-gathered (ops/ici.py); every tile read is then served from
        the gathered bytes.  Any failure of that set-up browns out to
        the read-all path (``ici_fallbacks``)."""
        self.wait_pending()
        steps = self.all_steps()
        if step is None:
            if not steps:
                raise FileNotFoundError(
                    f"no checkpoints under {self.directory}")
            candidates = steps[::-1]
        else:
            if step not in steps and not os.path.isdir(self.step_dir(step)):
                raise FileNotFoundError(
                    f"checkpoint step {step} does not exist under "
                    f"{self.directory} (have {steps})")
            candidates = [step] + [s for s in steps[::-1] if s < step]
        if not fallback:
            candidates = candidates[:1]
        named_t = flatten_with_names(target) if target is not None else None
        eng, own = self._get_engine()
        try:
            for i, s in enumerate(candidates):
                try:
                    served = self._scatter_engine(eng, s, ici_group)
                    out = self._restore_step(served or eng, s, target,
                                             named_t, device)
                except self._DAMAGE as e:
                    if isinstance(e, TargetMismatchError) or \
                            i + 1 >= len(candidates):
                        raise
                    eng.stats.add(restore_fallbacks=1)
                    _log.warning("checkpoint step %d is damaged (%s: %s); "
                                 "falling back to step %d", s,
                                 type(e).__name__, e, candidates[i + 1])
                else:
                    self.last_restore_step = s
                    return out
        finally:
            if own:
                eng.close_all()

    def _scatter_engine(self, eng: StromEngine, step: int, group=None):
        """The read-once scatter front-end over ``eng`` for ``step``, or
        None for the read-all path (mode off, or any failure to set it
        up, counted in ``ici_fallbacks``)."""
        if not ici_scatter_enabled():
            return None
        try:
            if group is None:
                group = exchange_group(ici_hosts())
            man = build_restore_manifest(self.step_dir(step), group.n,
                                         ici_unit_bytes())
            return scatter_engine(eng, list(man.paths), group=group,
                                  manifest=man.shares)
        except Exception as e:      # brown-out: the caller reads it all
            _log.warning("ici scatter disabled for step %d: %s: %s (falling "
                         "back to local full reads)", step,
                         type(e).__name__, e)
            eng.stats.add(ici_fallbacks=1)
            return None

    def _restore_step(self, eng, step: int, target, named_t, device):
        """One restore attempt against exactly checkpoint ``step``."""
        d = self.step_dir(step)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        if meta.get("format") != 2:
            raise ValueError(f"checkpoint format {meta.get('format')} "
                             "unsupported (this reader is format 2)")
        tensors = meta["tensors"]
        files: Dict[str, SafetensorsFile] = {}
        if target is None:
            dev = torch.device("cpu" if device is None else device)
            return {n: self._read(eng, d, files, n, info, dev)
                    for n, info in tensors.items()}
        out = {}
        for name, tleaf in named_t.items():
            if tleaf is None:
                out[name] = None
                continue
            info = tensors.get(name)
            if info is None:
                raise KeyError(f"checkpoint step {step} lacks tensor "
                               f"{name!r}")
            shape = tuple(info["shape"])
            if tuple(np.shape(tleaf)) != shape:
                raise TargetMismatchError(
                    f"{name}: checkpoint shape {shape} != target "
                    f"{tuple(np.shape(tleaf))}")
            if isinstance(tleaf, torch.Tensor):
                dev = tleaf.device if device is None else \
                    torch.device(device)
                out[name] = self._read(eng, d, files, name, info,
                                       dev).to(tleaf.dtype)
                continue
            t = self._read(eng, d, files, name, info, torch.device("cpu"))
            out[name] = (type(tleaf)(t.item()) if info.get("scalar")
                         else t.numpy().astype(tleaf.dtype, copy=False))
        return _unflatten_like(target, out)

    def _read(self, eng, cdir: str, files: dict, name: str, info: dict,
              dev: torch.device) -> torch.Tensor:
        """One tensor on ``dev``, assembled on the host from its stored
        tiles (page-locked when bound for a CUDA device), then through
        the bridge onto the card."""
        shape = tuple(info["shape"])
        read_region = self._region_reader(eng, cdir, files, name, info)
        host = read_region(tuple((0, n) for n in shape),
                           pin=dev.type == "cuda")
        if dev.type != "cuda" or host.numel() == 0:
            return host.to(dev)
        flat = host.reshape(-1).view(torch.uint8)
        tr = host_to_device(eng, flat.numpy(), dev,
                            [pinned_mapping(flat, dev)])
        tr.synchronize()
        return tr.tensor.view(host.dtype).reshape(shape)

    def _region_reader(self, eng, cdir: str, files: dict, name: str,
                       info: dict):
        """``read_region(bounds, pin=False)`` → a CPU tensor of that
        region of the stored tensor, assembled from whichever stored
        tiles intersect it.  Rows are contiguous on disk, so of each
        tile only the rows the region needs are read; a tile that
        covers whole rows of the region is read straight into it."""
        shape = tuple(info["shape"])
        dtype = torch_dtype(info["dtype"])
        isz = torch.empty(0, dtype=dtype).element_size()
        tiles = [(tuple(tuple(b) for b in t["idx"]), t["file"])
                 for t in info["tiles"]]

        def read_tile_rows(bounds, fname, a, b, out):
            """Rows [a, b) (tile-local, leading axis) of a stored tile
            into the contiguous tensor ``out``."""
            sf = files.get(fname)
            if sf is None:
                sf = files[fname] = SafetensorsFile(os.path.join(cdir,
                                                                 fname))
            t = sf.tensors[_tile_key(name, bounds, shape)]
            tshape = tuple(hi - lo for lo, hi in bounds)
            if tuple(t["shape"]) != tshape:
                raise ValueError(f"{name}: stored tile {bounds} has shape "
                                 f"{tuple(t['shape'])}")
            row_bytes = isz * int(np.prod(tshape[1:], dtype=np.int64))
            self._engine_read(eng, sf.path, t["offset"] + a * row_bytes,
                              out.reshape(-1).view(torch.uint8).numpy())
            return out

        def read_region(bounds, pin: bool = False) -> torch.Tensor:
            rshape = tuple(b - a for a, b in bounds)
            out = torch.empty(rshape, dtype=dtype, pin_memory=pin)
            if not shape:                   # a scalar: its one () tile
                return read_tile_rows((), tiles[0][1], 0, 1, out)
            if out.numel() == 0:
                return out
            covered = 0
            for tb, fname in tiles:
                lo = tuple(max(a, ta) for (a, _), (ta, _) in zip(bounds, tb))
                hi = tuple(min(b, tz) for (_, b), (_, tz) in zip(bounds, tb))
                if any(l >= h for l, h in zip(lo, hi)):
                    continue
                a, b = lo[0] - tb[0][0], hi[0] - tb[0][0]
                dst = out[tuple(slice(l - ra, h - ra) for l, h, (ra, _)
                                in zip(lo, hi, bounds))]
                whole = all(l == ta and h == tz for l, h, (ta, tz)
                            in zip(lo[1:], hi[1:], tb[1:]))
                if whole and dst.is_contiguous():
                    read_tile_rows(tb, fname, a, b, dst)
                else:
                    tshape = tuple(z - y for y, z in tb)
                    rows = read_tile_rows(tb, fname, a, b, torch.empty(
                        (b - a,) + tshape[1:], dtype=dtype))
                    dst.copy_(rows[(slice(None),) + tuple(
                        slice(l - ta, h - ta) for l, h, (ta, _)
                        in zip(lo[1:], hi[1:], tb[1:]))])
                    eng.stats.add(bounce_bytes=dst.numel() * isz)
                covered += int(np.prod([h - l for l, h in zip(lo, hi)],
                                       dtype=np.int64))
            if covered < out.numel():
                raise ValueError(f"{name}: region {bounds} under-covered by "
                                 f"stored tiles ({covered}/{out.numel()} "
                                 "elements)")
            return out

        return read_region

    @staticmethod
    def _engine_read(eng, path: str, offset: int, out: np.ndarray) -> None:
        """``out.nbytes`` bytes of ``path`` at ``offset`` into ``out``
        through chunked engine reads: the one host copy of a restored
        byte, counted in ``bounce_bytes``.  A short read raises
        (damage)."""
        length = out.nbytes
        fh = eng.open(path)
        pend: list = []
        pos = 0
        try:
            if length:
                (pend,) = plan_and_submit(eng, [(fh, offset, length)])
                pend = list(pend)
            while pend:
                v = wait_exact(pend[0])     # a truncated tile fails here
                out[pos:pos + v.nbytes] = v
                pos += v.nbytes
                pend.pop(0).release()
        finally:
            for p in pend:
                p.release()
            eng.close(fh)
        if pos != length:
            raise OSError(errno.EIO, f"short tile read: {pos} of {length} "
                          "bytes", str(path))
        eng.stats.add(bounce_bytes=length)

    def _get_engine(self):
        if self._engine is not None:
            return self._engine, False
        return StromEngine(), True
