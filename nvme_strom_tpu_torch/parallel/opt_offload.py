"""NVMe-offloaded optimizer state (counterpart of
nvme_strom_tpu/parallel/opt_offload.py): AdamW whose moments live in an
engine-backed file, not in device memory.

Per ``update(params, grads)``:

  1. group g's moment slots stream NVMe → staging → device through
     ``DeviceStream.stream_ranges`` (``h2d_copy`` on a card), assembled
     on the device;
  2. the AdamW update runs as torch ops, in place on the parameters and
     the streamed moments;
  3. the updated moments go home one group late: their device → host
     copy starts on the bridge's side stream into page-locked buffers,
     and the NVMe writes are submitted once the next group has been
     dispatched, so neither leg stalls the group loop.

Device memory holds the moments of two adjacent groups
(:meth:`OffloadedAdam.peak_group_bytes`) instead of twice the model.
The cost is one read and one write of the moment bytes a step.

Durability: moments update in place.  Each update commits a ``dirty``
manifest before its first slot write and clears it, with the advanced
``step``, only after every write has drained, so a crash mid-step is
refused at resume instead of silently mixing steps.  The moment file and
manifest keep the JAX package's layouts (leaf names as
``jax.tree_util.keystr`` prints them, sorted; 4096-aligned m / v slots),
so a directory written by the JAX ``OffloadedAdam`` resumes here and the
other way round.  With one process a leaf is one slot pair in
``moments.bin`` / ``moments.json``.  With several (``torch.distributed``)
each process keeps the moments of its own parameter slices in
``moments-{proc:05d}.bin`` / ``.json``: a leaf is one piece, keyed by its
slice's global bounds (``shardings``, parallel/shardings.py), groups are
cut on global bytes so every process runs the same rounds, and a resume
all-gathers each process's step and refusal, so the processes resume
from one step or all refuse (the JAX ``_local_pieces`` layout and its
all-gather check).  Slot writes are padded to the 4096-byte slot size
with zeros (the file's padding is zero either way) so every write is
O_DIRECT.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np
import torch

from nvme_strom_tpu_torch.ops.bridge import (DeviceStream, split_ranges,
                                             stage_to_host,
                                             submit_chunked_writes)

_ALIGN = 4096
_MANIFEST_VERSION = 1
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def _align_up(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def named_leaves(tree, path: str = "") -> Dict[str, torch.Tensor]:
    """Nested dicts / lists / tuples of tensors → {name: tensor}, each
    name the leaf's path as ``jax.tree_util.keystr`` prints it
    (``['layers.0.wq']``, ``['a'][0]``)."""
    out: Dict[str, torch.Tensor] = {}
    if isinstance(tree, dict):
        for k in tree:
            out.update(named_leaves(tree[k], f"{path}[{k!r}]"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(named_leaves(v, f"{path}[{i}]"))
    else:
        out[path] = tree
    return out


def _global_shape(sharding, local_shape) -> tuple:
    """The global shape whose slice under ``sharding`` is
    ``local_shape`` (each split dimension times its ranks)."""
    mesh = sharding.mesh
    out = []
    for d, n in enumerate(local_shape):
        entry = sharding.spec[d] if d < len(sharding.spec) else None
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        out.append(n * int(np.prod([mesh.shape[a] for a in axes],
                                   dtype=np.int64)))
    return tuple(out)


class OffloadedAdam:
    """AdamW whose m / v moments live in ``path/moments.bin`` (manifest
    ``path/moments.json``).

    The layout derives from ``params`` (a tree of tensors, see
    :func:`named_leaves`); an existing manifest of the same layout
    resumes (``step`` picks up where it left off), a dirty one or one of
    another layout is refused, no manifest starts from zeroed moments.

    ``update(params, grads)`` updates the parameter tensors in place (as
    a torch optimizer does) and returns ``params``; its math is
    ``optax.adamw(lr, b1, b2, eps, weight_decay)``: bias correction at
    count t, weight decay scaled by the learning rate.  ``lr`` is a
    float or ``fn(step) -> float``, evaluated at each update's
    ``step``.  ``moment_dtype`` bfloat16 halves the NVMe traffic; the
    parity with optax holds for float32.  ``group_bytes`` bounds one
    group's moments on the device.  ``shardings`` (needed with several
    processes): {param key: Sharding} of each leaf's slice."""

    def __init__(self, path, params, *, lr, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, group_bytes: int = 64 << 20,
                 moment_dtype: torch.dtype = torch.float32, engine=None,
                 depth: int = 4, shardings=None):
        if moment_dtype not in _DTYPE_NAMES:
            raise ValueError(f"moment_dtype {moment_dtype}: expected "
                             "torch.float32 or torch.bfloat16")
        self.lr = lr if callable(lr) else float(lr)
        self.b1, self.b2 = float(b1), float(b2)
        self.eps, self.weight_decay = float(eps), float(weight_decay)
        self.moment_dtype = moment_dtype
        self._own_engine = engine is None
        if engine is None:
            from nvme_strom_tpu_torch.io.faults import build_engine
            engine = build_engine()
        self.engine = engine
        self._fh = None
        try:
            leaves = named_leaves(params)
            if not leaves:
                raise ValueError("params hold no tensors")
            self.device = next(iter(leaves.values())).device
            self.stream = DeviceStream(engine, self.device, depth=depth,
                                       klass="restore")
            self._init_state(path, leaves, group_bytes, shardings)
        except BaseException:
            # a refusal must not leak the engine built here
            if self._own_engine:
                self.engine.close_all()
            raise

    def _init_state(self, path, leaves: Dict[str, torch.Tensor],
                    group_bytes: int, shardings=None) -> None:
        from nvme_strom_tpu_torch.parallel.mesh import (all_gather_object,
                                                        process_info)
        proc, nproc = process_info()
        self._multi = nproc > 1
        if self._multi and shardings is None:
            raise ValueError("OffloadedAdam across processes needs "
                             "shardings= (each leaf's slice)")
        isz = torch.empty(0, dtype=self.moment_dtype).element_size()
        self._layout: Dict[str, dict] = {}
        off = 0
        for name in sorted(leaves):
            shape = tuple(int(s) for s in leaves[name].shape)
            nbytes = int(np.prod(shape, dtype=np.int64)) * isz
            if not self._multi:
                self._layout[name] = {"shape": shape, "nbytes": nbytes,
                                      "off_m": off,
                                      "off_v": off + _align_up(nbytes)}
                off += 2 * _align_up(nbytes)
                continue
            sh = shardings.get(name[2:-2] if name.startswith("['") else
                               name) if isinstance(shardings, dict) \
                else shardings(name)
            if sh is None:
                raise KeyError(f"no sharding for leaf {name}")
            # one device a process: the leaf's one piece is its slice
            gshape = _global_shape(sh, shape)
            bounds = sh.local_bounds(gshape)
            self._layout[name] = {
                "shape": gshape,
                "pieces": [{"key": [list(b) for b in bounds],
                            "shape": shape, "nbytes": nbytes, "fanout": 1,
                            "off_m": off,
                            "off_v": off + _align_up(nbytes)}]}
            off += 2 * _align_up(nbytes)
        self._total_bytes = off
        # groups: consecutive slots, about group_bytes of device memory
        self._groups: List[List[str]] = []
        cur: list = []
        cur_b = 0
        for name, d in self._layout.items():
            # global bytes: every process must cut the same groups
            b = 2 * isz * int(np.prod(d["shape"], dtype=np.int64))
            if cur and cur_b + b > group_bytes:
                self._groups.append(cur)
                cur, cur_b = [], 0
            cur.append(name)
            cur_b += b
        if cur:
            self._groups.append(cur)
        os.makedirs(path, exist_ok=True)
        suffix = f"-{proc:05d}" if self._multi else ""
        self.data_path = os.path.join(path, f"moments{suffix}.bin")
        self.manifest_path = os.path.join(path, f"moments{suffix}.json")
        self.step = 0
        local_err = None
        try:
            if not self._try_resume():
                self._create_zeroed()
        except Exception as e:      # every rank must reach the gather
            if not self._multi:
                raise
            local_err = f"{type(e).__name__}: {e}"
        if self._multi:
            seen = all_gather_object((self.step, local_err))
            if any(err for _, err in seen):
                raise ValueError(
                    local_err or "another process refused to resume its "
                    "moment file (dirty or layout mismatch): every process "
                    "must resume from matching state")
            steps = sorted({st for st, _ in seen})
            if len(steps) > 1:
                raise ValueError(
                    f"moment files disagree on the optimizer step across "
                    f"processes ({steps}): a previous run crashed between "
                    "per-process commits; restore params from the "
                    "matching checkpoint into fresh moment dirs")
        self._fh = self.engine.open(self.data_path, writable=True)

    def _slot(self, name: str) -> tuple:
        """(off_m, off_v, nbytes, local shape) of a leaf's slot pair."""
        d = self._layout[name]
        if "pieces" in d:
            d = d["pieces"][0]
        return d["off_m"], d["off_v"], d["nbytes"], tuple(d["shape"])

    # -- the manifest --------------------------------------------------

    def _manifest(self, dirty: bool = False) -> dict:
        return {"version": _MANIFEST_VERSION, "step": self.step,
                "dirty": dirty, "dtype": _DTYPE_NAMES[self.moment_dtype],
                "align": _ALIGN, "total_bytes": self._total_bytes,
                "leaves": json.loads(json.dumps(self._layout))}

    def _try_resume(self) -> bool:
        try:
            with open(self.manifest_path) as f:
                m = json.load(f)
        except (OSError, json.JSONDecodeError):
            return False
        ours = self._manifest()
        if (m.get("version") != _MANIFEST_VERSION
                or m.get("dtype") != ours["dtype"]
                or m.get("leaves", {}) != ours["leaves"]):
            raise ValueError(
                f"existing moment file at {self.manifest_path} has a "
                "different layout/dtype than these params: refusing to "
                "overwrite optimizer state; point at a fresh directory "
                "or delete it explicitly")
        if m.get("dirty"):
            raise ValueError(
                f"moment file at {self.manifest_path} is marked dirty: a "
                f"previous update crashed mid-step (after step "
                f"{int(m['step'])}), so slots hold a mix of steps and "
                "resuming would silently diverge.  Restore params from "
                "the matching checkpoint into a fresh moment dir, or "
                "delete this one explicitly")
        self.step = int(m["step"])
        return True

    def _create_zeroed(self) -> None:
        fh = self.engine.open(self.data_path, writable=True)
        pend: list = []
        try:
            chunk = self.engine.config.chunk_bytes
            zeros = np.zeros(min(chunk, self._total_bytes), np.uint8)
            for off in range(0, self._total_bytes, chunk):
                n = min(chunk, self._total_bytes - off)
                submit_chunked_writes(self.engine, fh, off, zeros[:n], pend)
            while pend:
                pend.pop(0).wait()
        finally:
            for p in pend:
                p.release()
            self.engine.close(fh)
        self.step = 0
        self._commit_manifest()

    def _commit_manifest(self, dirty: bool = False) -> None:
        tmp = self.manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._manifest(dirty), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.manifest_path)

    # -- one step ------------------------------------------------------

    def _read_group(self, names):
        """The group's moments NVMe → device: ([m], [v]) in name
        order, each assembled from its chunks on the device."""
        ranges: list = []
        counts: list = []
        chunk = self.engine.config.chunk_bytes
        for n in names:
            off_m, off_v, nbytes, _ = self._slot(n)
            for off in (off_m, off_v):
                flat, cnt = split_ranges([(off, nbytes)], chunk)
                ranges.extend(flat)
                counts.append(cnt[0])
        it = iter(self.stream.stream_ranges(self._fh, ranges))
        ci = iter(counts)
        ms, vs = [], []
        for n in names:
            shape = self._slot(n)[3]
            for out in (ms, vs):
                parts = [next(it) for _ in range(next(ci))]
                flat = parts[0] if len(parts) == 1 else torch.cat(parts)
                out.append(flat.view(self.moment_dtype).reshape(shape))
        return ms, vs

    def _update_group(self, ps, gs, ms, vs, t: int, lr: float):
        """AdamW on one group, in place on ``ps``; returns the new
        moments in ``moment_dtype``."""
        b1, b2, eps, wd = self.b1, self.b2, self.eps, self.weight_decay
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t
        out_m, out_v = [], []
        for p, g, m, v in zip(ps, gs, ms, vs):
            g32 = g.detach().float()
            m32 = m.float() if m.dtype != torch.float32 else m
            v32 = v.float() if v.dtype != torch.float32 else v
            m32.mul_(b1).add_(g32, alpha=1 - b1)
            v32.mul_(b2).addcmul_(g32, g32, value=1 - b2)
            denom = (v32 / bc2).sqrt_().add_(eps)
            step = (m32 / bc1).div_(denom)
            del denom
            step.add_(p, alpha=wd)
            if p.dtype == torch.float32:
                p.sub_(step, alpha=lr)
            else:
                p.copy_(p.float().sub_(step, alpha=lr))
            out_m.append(m32.to(self.moment_dtype))
            out_v.append(v32.to(self.moment_dtype))
        return out_m, out_v

    def _stage(self, names, ms, vs) -> list:
        """Start the device → host copies of a group's moments (padded
        to their slots' 4096 bytes)."""
        staged = []
        for n, m, v in zip(names, ms, vs):
            off_m, off_v, _, _ = self._slot(n)
            staged.append((off_m, stage_to_host(m, pad_to=_ALIGN)))
            staged.append((off_v, stage_to_host(v, pad_to=_ALIGN)))
        return staged

    def _write(self, staged, pend: list, keep: list) -> None:
        for off, st in staged:
            st.synchronize()
            keep.append(st)
            submit_chunked_writes(self.engine, self._fh, off, st.view, pend)

    def update(self, params, grads):
        """One AdamW step of ``params`` (in place) from ``grads`` (a tree
        of the same names); the moments advance on NVMe, ``step``
        increments and the manifest is committed after every write has
        drained.  Returns ``params``."""
        p_named = named_leaves(params)
        g_named = named_leaves(grads)
        if set(p_named) != set(self._layout) or \
                set(g_named) != set(self._layout):
            raise ValueError("params/grads tree does not match the "
                             "layout this optimizer was built for")
        t = self.step + 1
        lr = float(self.lr(self.step)) if callable(self.lr) else self.lr
        pend: list = []
        keep: list = []          # host buffers of writes in flight
        # dirty before the first in-place slot write: a crash mid-step
        # leaves a mix of steps, and only this marker shows it
        self._commit_manifest(dirty=True)
        staged = None
        try:
            with torch.no_grad():
                for names in self._groups:
                    ms, vs = self._read_group(names)
                    out_m, out_v = self._update_group(
                        [p_named[n] for n in names],
                        [g_named[n] for n in names], ms, vs, t, lr)
                    del ms, vs
                    # the previous group's writes go out now: its copy
                    # home has had this group's read and update to land
                    if staged is not None:
                        self._write(staged, pend, keep)
                    staged = self._stage(names, out_m, out_v)
                    del out_m, out_v
                if staged is not None:
                    self._write(staged, pend, keep)
                    staged = None
            # a failed moment write must raise here: the manifest must
            # not claim a step whose slots never landed
            while pend:
                pend.pop(0).wait()
        finally:
            for p in pend:
                try:
                    p.wait()
                except OSError:
                    pass
            if staged is not None:
                for _, st in staged:
                    st.synchronize()
        self.step += 1
        self._commit_manifest()
        return params

    # -- sizes and lifetime --------------------------------------------

    def moment_bytes(self) -> int:
        """NVMe footprint of the moments (the manifest's total)."""
        return self._total_bytes

    def num_groups(self) -> int:
        """Read → update → write rounds a step takes."""
        return len(self._groups)

    def peak_group_bytes(self) -> int:
        """The most device memory the moments take during a step: the
        group updating plus the previous one whose copy home is still in
        flight."""
        per = [sum(2 * self._slot(n)[2] for n in g)
               for g in self._groups]
        if len(per) == 1:
            return per[0]
        return max(a + b for a, b in zip(per, per[1:]))

    def close(self) -> None:
        if self._fh is not None:
            self.engine.close(self._fh)
            self._fh = None
        if self._own_engine and self.engine is not None:
            self.engine.close_all()
            self.engine = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
