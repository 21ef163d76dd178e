"""Library train loop, on one device or a mesh of processes
(counterpart of nvme_strom_tpu/train.py ``Trainer`` and ``FitResult``):

    from nvme_strom_tpu_torch.train import Trainer
    with Trainer(cfg, ckpt_dir="run1", save_every=100,
                 watchdog_s=300) as tr:
        result = tr.fit(batches, steps=10_000)

Owned concerns: parameter init, a warm start streamed from safetensors
through the engine, checkpoint resume (which wins over a warm start),
the train step, the save cadence (synchronous or background), the
hung-step watchdog and per-step hooks.  Data stays an iterator of (b, s)
token batches (``ShardedLoader`` or anything else).  Parameters are
float32 master weights (a warm start is cast to float32).

Under a ``mesh`` (parallel/mesh.py, one process a rank) each rank holds
its slices of the parameters and of the AdamW moments
(parallel/shardings.py ``param_shardings``), takes its ``dp`` block of
each batch (the rows a mesh-aware ``ShardedLoader`` yields; with ``sp``,
its span of them, ``seq_axis="sp"``, and an ``attn_fn`` such as
``make_ring_attn(mesh, inner="flash")``), sums the gradients over ``sp``
and averages them over ``dp``, warm-starts through ``load_sharded`` (each
rank reading its own rows), and saves and resumes its own tiles of the
checkpoint (checkpoint/manager.py), under this mesh or another.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from nvme_strom_tpu_torch.device import resolve_device
from nvme_strom_tpu_torch.formats.safetensors import torch_dtype
from nvme_strom_tpu_torch.io.engine import StromEngine
from nvme_strom_tpu_torch.io.faults import build_engine
from nvme_strom_tpu_torch.models.transformer import (
    adamw, init_params, make_train_step, param_shapes, trainable_params)
from nvme_strom_tpu_torch.ops.bridge import to_device
from nvme_strom_tpu_torch.parallel.mesh import local_device
from nvme_strom_tpu_torch.parallel.shardings import (Shard, param_shardings,
                                                     shard_params)

__all__ = ["Trainer", "FitResult", "optimizer_state", "restore_state"]


@dataclass
class FitResult:
    steps: int                 # global step after fit
    last_loss: float
    steps_per_s: float
    resumed_from: Optional[int]


def optimizer_state(optimizer: torch.optim.Optimizer, params: dict,
                    shardings: Optional[dict] = None,
                    shapes: Optional[dict] = None) -> dict:
    """The optimizer's per-parameter tensors as {state key: {param name:
    tensor}} (AdamW: ``step``, ``exp_avg``, ``exp_avg_sq``).  With
    ``shardings`` and the global ``shapes``, each tensor of a
    parameter's shape is a :class:`Shard` of that parameter's layout."""
    out: dict = {}
    for name, p in params.items():
        for key, val in optimizer.state.get(p, {}).items():
            if isinstance(val, torch.Tensor):
                if shardings is not None and val.shape == p.shape:
                    val = Shard(val, shardings[name], shapes[name])
                out.setdefault(key, {})[name] = val
    return out


def restore_state(manager, step: int, params: dict,
                  optimizer: torch.optim.Optimizer, device,
                  shardings: Optional[dict] = None,
                  shapes: Optional[dict] = None) -> None:
    """Checkpoint ``step`` of ``(params, optimizer_state(...))`` copied
    into the live tensors of ``params`` and the optimizer's state (the
    optimizer keeps its references).  With ``shardings`` and the global
    ``shapes`` each rank reads only its own slices, whatever mesh wrote
    the checkpoint."""
    if shardings is None:
        flat = manager.restore(step=step, device=device)
    else:
        with open(os.path.join(manager.step_dir(step), "meta.json")) as f:
            stored = json.load(f)["tensors"]
        target = {}
        for key_name, info in stored.items():
            name = key_name.split("|")[-1]
            if name in params and tuple(info["shape"]) == \
                    tuple(shapes[name]):
                target[key_name] = Shard(
                    torch.empty(params[name].shape, device=device,
                                dtype=torch_dtype(info["dtype"])),
                    shardings[name], shapes[name])
            else:
                target[key_name] = torch.empty(
                    info["shape"], dtype=torch_dtype(info["dtype"]),
                    device=device)
        flat = manager.restore(target, step=step, fallback=False)
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(flat.pop(f"0|{name}"))
    for key_name, t in flat.items():
        part, key, name = key_name.split("|", 2)
        if part != "1" or name not in params:
            raise KeyError(f"checkpoint tensor {key_name!r} is not "
                           "this trainer's state")
        # AdamW keeps its step count on the host
        optimizer.state[params[name]][key] = (
            t.cpu() if key == "step" else t)


class Trainer:
    """See the module docstring.  Parameters:

    ``cfg``: TransformerConfig.  ``optimizer``: a callable taking the
    parameter tensors and returning a torch optimizer (default
    ``adamw(params, lr)``, optax.adamw's settings).  ``ckpt_dir``:
    enables checkpoint / resume through the engine's O_DIRECT writer;
    ``save_every`` steps between saves (0 = only the final save);
    ``async_save`` writes in the background after a synchronous
    snapshot.  ``init_weights``: safetensors path or directory for a warm
    start (ignored when a checkpoint exists: resume wins).
    ``watchdog_s``: per-step deadline; a hung step dumps stacks and the
    engine's counters.  ``hooks``: callables ``(step, loss, dt_s)`` run
    after every step (StopIteration from one stops the run).
    ``device``: default ``cuda:0``.  ``lr_schedule``: ``fn(count) ->
    lr`` (``transformer.lr_schedule``), set before each update from the
    optimizer's own step count, so a resumed run continues it;
    ``grad_clip`` > 0 clips the gradients to that global norm first;
    ``act_store``: the activation store of ``remat_policy="nvme"``.
    ``mesh``: a parallel/mesh.py ``Mesh`` over the processes (see the
    module docstring; the device then defaults to the process's own)."""

    def __init__(self, cfg, *, optimizer: Optional[Callable] = None,
                 lr: float = 3e-4, ckpt_dir=None,
                 engine: Optional[StromEngine] = None, attn_fn=None,
                 accum_steps: int = 1, init_weights=None,
                 save_every: int = 0, async_save: bool = False,
                 watchdog_s: float = 0.0, seed: int = 0,
                 hooks: Sequence[Callable] = (), device=None,
                 lr_schedule: Optional[Callable] = None,
                 grad_clip: float = 0.0, act_store=None, mesh=None):
        self.cfg = cfg
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.device = resolve_device(
            device if device is not None or self.mesh is None
            else local_device())
        self.shapes = param_shapes(cfg)
        self.shardings = (param_shardings(cfg, self.mesh)
                          if self.mesh is not None else None)
        self.hooks = list(hooks)
        self._own_engine = engine is None
        self.engine = engine if engine is not None else build_engine()
        self.save_every = int(save_every)
        self.async_save = bool(async_save)
        self._closed = False

        self._wd = None
        if watchdog_s > 0:
            from nvme_strom_tpu_torch.utils.watchdog import StepWatchdog
            self._wd = StepWatchdog(watchdog_s, engine=self.engine)

        self.manager = None
        start = None
        if ckpt_dir is not None:
            from nvme_strom_tpu_torch.checkpoint.manager import (
                CheckpointManager)
            self.manager = CheckpointManager(ckpt_dir, engine=self.engine)
            start = self.manager.latest_step()

        if init_weights is not None and start is None:
            from nvme_strom_tpu_torch.parallel.weights import LazyCheckpoint
            ck = LazyCheckpoint(init_weights)
            got = {n: ck.shape(n) for n in ck.keys()}
            if got != self.shapes:
                raise ValueError(f"{init_weights}: tensors {got} do not "
                                 f"match the config's {self.shapes}")
            loaded = (ck.load(self.engine, device=self.device)
                      if self.mesh is None else
                      ck.load_sharded(self.shardings, self.engine,
                                      device=self.device))
            self.params = trainable_params(loaded, self.device)
        else:
            full = init_params(seed, cfg)
            if self.mesh is not None:
                full = shard_params(full, cfg, self.mesh,
                                    shardings=self.shardings)
            self.params = trainable_params(full, self.device)
        make_opt = optimizer or (lambda ps: adamw(ps, lr))
        self.optimizer = make_opt(list(self.params.values()))
        if start is not None:
            self._restore(start)
        self.resumed_from = start
        self.step = start or 0
        self._last_saved = start       # a resumed step is already on disk
        self._step_fn = make_train_step(cfg, self.optimizer,
                                        attn_fn=attn_fn,
                                        accum_steps=accum_steps,
                                        act_store=act_store,
                                        lr=lr_schedule, grad_clip=grad_clip,
                                        mesh=self.mesh,
                                        shardings=self.shardings)

    def _restore(self, step: int) -> None:
        restore_state(self.manager, step, self.params, self.optimizer,
                      self.device, self.shardings, self.shapes)

    def state(self):
        """(params, optimizer state): what a checkpoint holds; under a
        mesh every parameter-shaped tensor is this rank's Shard."""
        if self.shardings is None:
            return (self.params,
                    optimizer_state(self.optimizer, self.params))
        params = {n: Shard(p, self.shardings[n], self.shapes[n])
                  for n, p in self.params.items()}
        return (params, optimizer_state(self.optimizer, self.params,
                                        self.shardings, self.shapes))

    # ------------------------------------------------------------------

    def fit(self, batches: Iterable, steps: int) -> FitResult:
        """Run until global step ``steps`` (absolute, so a resumed run
        finishes the same schedule).  Saves every ``save_every`` steps
        and at the end; data running out or a hook raising StopIteration
        stops early, after a final save."""
        if self.step >= steps:
            return FitResult(self.step, float("nan"), 0.0,
                             self.resumed_from)
        it = iter(batches)
        loss = None
        lossf = float("nan")
        t0 = time.monotonic()
        n0 = self.step
        try:
            while self.step < steps:
                ts = time.monotonic()
                ctx = (self._wd.step(f"step {self.step + 1}")
                       if self._wd else nullcontext())
                # the deadline covers the whole iteration: input wait,
                # step, the loss sync and the cadence save
                with ctx:
                    tokens = next(it)
                    if not isinstance(tokens, torch.Tensor):
                        tokens = to_device(self.engine, np.asarray(tokens),
                                           self.device)
                    loss = self._step_fn(self.params, tokens)
                    lossf = float(loss)
                    self.step += 1
                    if (self.manager is not None and self.save_every
                            and self.step % self.save_every == 0):
                        self._save()
                for h in self.hooks:
                    h(self.step, lossf, time.monotonic() - ts)
        except StopIteration:
            pass                       # data exhausted or a hook stop
        if (self.manager is not None and loss is not None
                and self._last_saved != self.step):
            self._save()
        if self.manager is not None:
            self.manager.wait_pending()
        wall = time.monotonic() - t0
        return FitResult(self.step, lossf,
                         (self.step - n0) / wall if wall > 0 else 0.0,
                         self.resumed_from)

    def _save(self) -> None:
        if self.async_save:
            self.manager.save_async(self.step, self.state())
        else:
            self.manager.save(self.step, self.state())
        self._last_saved = self.step

    def save(self) -> None:
        """Checkpoint now (blocking), whatever the cadence."""
        if self.manager is None:
            raise ValueError("Trainer built without ckpt_dir")
        self.manager.save(self.step, self.state(), force=True)
        self._last_saved = self.step

    # ------------------------------------------------------------------

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            if self.manager is not None:
                self.manager.close()
        finally:
            if self._wd is not None:
                self._wd.close()
            if self._own_engine:
                self.engine.close_all()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
