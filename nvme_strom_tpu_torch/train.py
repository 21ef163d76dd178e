"""Library train loop on one device (counterpart of
nvme_strom_tpu/train.py ``Trainer`` and ``FitResult``):

    from nvme_strom_tpu_torch.train import Trainer
    with Trainer(cfg, ckpt_dir="run1", save_every=100,
                 watchdog_s=300) as tr:
        result = tr.fit(batches, steps=10_000)

Owned concerns: parameter init, a warm start streamed from safetensors
through the engine, checkpoint resume (which wins over a warm start),
the train step, the save cadence (synchronous or background), the
hung-step watchdog and per-step hooks.  Data stays an iterator of (b, s)
token batches (``ShardedLoader`` or anything else).  Parameters are
float32 master weights (a warm start is cast to float32); the mesh and
shardings of the JAX trainer wait for the multi-GPU slice.
"""

from __future__ import annotations

import time
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from nvme_strom_tpu_torch.device import resolve_device
from nvme_strom_tpu_torch.io.engine import StromEngine
from nvme_strom_tpu_torch.io.faults import build_engine
from nvme_strom_tpu_torch.models.transformer import (
    adamw, init_params, make_train_step, param_shapes, trainable_params)
from nvme_strom_tpu_torch.ops.bridge import to_device

__all__ = ["Trainer", "FitResult", "optimizer_state"]


@dataclass
class FitResult:
    steps: int                 # global step after fit
    last_loss: float
    steps_per_s: float
    resumed_from: Optional[int]


def optimizer_state(optimizer: torch.optim.Optimizer, params: dict) -> dict:
    """The optimizer's per-parameter tensors as {state key: {param name:
    tensor}} (AdamW: ``step``, ``exp_avg``, ``exp_avg_sq``)."""
    out: dict = {}
    for name, p in params.items():
        for key, val in optimizer.state.get(p, {}).items():
            if isinstance(val, torch.Tensor):
                out.setdefault(key, {})[name] = val
    return out


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
    ``device``: default ``cuda:0``."""

    def __init__(self, cfg, *, optimizer: Optional[Callable] = None,
                 lr: float = 3e-4, ckpt_dir=None,
                 engine: Optional[StromEngine] = None, attn_fn=None,
                 accum_steps: int = 1, init_weights=None,
                 save_every: int = 0, async_save: bool = False,
                 watchdog_s: float = 0.0, seed: int = 0,
                 hooks: Sequence[Callable] = (), device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
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
            loaded = LazyCheckpoint(init_weights).load(self.engine,
                                                       device=self.device)
            want = param_shapes(cfg)
            got = {n: tuple(t.shape) for n, t in loaded.items()}
            if got != want:
                raise ValueError(f"{init_weights}: tensors {got} do not "
                                 f"match the config's {want}")
            self.params = trainable_params(loaded, self.device)
        else:
            self.params = trainable_params(init_params(seed, cfg),
                                           self.device)
        make_opt = optimizer or (lambda ps: adamw(ps, lr))
        self.optimizer = make_opt(list(self.params.values()))
        if start is not None:
            self._restore(start)
        self.resumed_from = start
        self.step = start or 0
        self._last_saved = start       # a resumed step is already on disk
        self._step_fn = make_train_step(cfg, self.optimizer,
                                        attn_fn=attn_fn,
                                        accum_steps=accum_steps)

    def _restore(self, step: int) -> None:
        """Parameters and optimizer state from checkpoint ``step``,
        copied into the live tensors (the optimizer keeps its
        references)."""
        flat = self.manager.restore(step=step, device=self.device)
        with torch.no_grad():
            for name, p in self.params.items():
                p.copy_(flat.pop(f"0|{name}"))
        for key_name, t in flat.items():
            part, key, name = key_name.split("|", 2)
            if part != "1" or name not in self.params:
                raise KeyError(f"checkpoint tensor {key_name!r} is not "
                               "this trainer's state")
            # AdamW keeps its step count on the host
            self.optimizer.state[self.params[name]][key] = (
                t.cpu() if key == "step" else t)

    def state(self):
        """(params, optimizer state): what a checkpoint holds."""
        return (self.params, optimizer_state(self.optimizer, self.params))

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
