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
tensor is one whole tile.  Saves are atomic: the step is staged in
``.tmp_step_XXXXXXXX`` and renamed into place once every byte is on
disk; a staging directory left by a crashed save is never taken for a
checkpoint and is removed at startup once it is older than
``gc_min_age_s``.  Multi-host saves and sharded tiles are not part of
this port yet.
"""

from __future__ import annotations

import concurrent.futures
import json
import logging
import os
import re
import shutil
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from nvme_strom_tpu_torch.formats.safetensors import (
    SafetensorsFile, torch_dtype, write_safetensors_engine)
from nvme_strom_tpu_torch.io.engine import StromEngine, wait_exact
from nvme_strom_tpu_torch.io.plan import plan_and_submit
from nvme_strom_tpu_torch.ops.bridge import host_to_device

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

    def restore(self, target=None, step: Optional[int] = None,
                device=None):
        """Read checkpoint ``step`` (default: the latest).

        With a ``target`` (the state's structure, leaves giving shape
        and dtype), returns the same structure: a tensor leaf comes back
        on the target's device (``device`` overrides) in the target's
        dtype, a numpy leaf as numpy, a Python scalar as its type.
        Without one, returns ``{name: tensor}`` of every tensor on
        ``device`` (default the CPU).  Bytes reach a CUDA device through
        the bridge (``h2d_copy``)."""
        self.wait_pending()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoints under {self.directory}")
        d = self.step_dir(step)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        if meta.get("format") != 2:
            raise ValueError(f"checkpoint format {meta.get('format')} "
                             "unsupported (this reader is format 2)")
        tensors = meta["tensors"]
        eng, own = self._get_engine()
        files: Dict[str, SafetensorsFile] = {}
        try:
            if target is None:
                dev = torch.device("cpu" if device is None else device)
                return {n: self._read(eng, d, files, n, info, dev)
                        for n, info in tensors.items()}
            out = {}
            for name, tleaf in flatten_with_names(target).items():
                if tleaf is None:
                    out[name] = None
                    continue
                info = tensors.get(name)
                if info is None:
                    raise KeyError(f"checkpoint step {step} lacks tensor "
                                   f"{name!r}")
                shape = tuple(info["shape"])
                if tuple(np.shape(tleaf)) != shape:
                    raise ValueError(f"{name}: checkpoint shape {shape} != "
                                     f"target {tuple(np.shape(tleaf))}")
                if isinstance(tleaf, torch.Tensor):
                    dev = tleaf.device if device is None else \
                        torch.device(device)
                    out[name] = self._read(eng, d, files, name, info,
                                           dev).to(tleaf.dtype)
                    continue
                t = self._read(eng, d, files, name, info,
                               torch.device("cpu"))
                out[name] = (type(tleaf)(t.item()) if info.get("scalar")
                             else t.numpy().astype(tleaf.dtype, copy=False))
            return _unflatten_like(target, out)
        finally:
            if own:
                eng.close_all()

    @staticmethod
    def _read(eng: StromEngine, cdir: str, files: dict, name: str,
              info: dict, dev: torch.device) -> torch.Tensor:
        """One whole-tile tensor from its file on ``dev``: chunked
        engine reads into an owning host buffer (the one host copy,
        counted), then through the bridge onto a CUDA device."""
        tiles = info["tiles"]
        shape = tuple(info["shape"])
        if len(tiles) != 1 or [tuple(b) for b in tiles[0]["idx"]] != \
                [(0, n) for n in shape]:
            raise NotImplementedError(
                f"{name}: sharded tiles are not ported yet")
        fname = tiles[0]["file"]
        sf = files.get(fname)
        if sf is None:
            sf = files[fname] = SafetensorsFile(os.path.join(cdir, fname))
        t = sf.tensors[name]
        out = np.empty(t["nbytes"], dtype=np.uint8)
        fh = eng.open(sf.path)
        pend: list = []
        try:
            if t["nbytes"]:
                (pend,) = plan_and_submit(eng, [(fh, t["offset"],
                                                 t["nbytes"])])
                pend = list(pend)
            pos = 0
            while pend:
                p = pend.pop(0)
                v = wait_exact(p)
                out[pos:pos + v.nbytes] = v
                pos += v.nbytes
                p.release()
        finally:
            for p in pend:
                p.release()
            eng.close(fh)
        eng.stats.add(bounce_bytes=int(out.nbytes))
        if dev.type == "cuda":
            tr = host_to_device(eng, out, dev)
            tr.synchronize()
            flat = tr.tensor
        else:
            flat = torch.from_numpy(out)
        return flat.view(torch_dtype(t["dtype"])).reshape(shape)

    def _get_engine(self):
        if self._engine is not None:
            return self._engine, False
        return StromEngine(), True
