"""NVMe-offloaded saved activations (counterpart of
nvme_strom_tpu/parallel/act_offload.py): training beyond device memory
on the activation axis.

Under ``remat_policy="full"`` the backward still keeps one (b, s, d)
layer input per layer alive from forward to backward, O(n_layers) of
device memory.  ``remat_policy="nvme"`` moves those inputs to NVMe:

  forward:   layer i runs without keeping its graph; its input goes
             device → page-locked host buffer (an asynchronous copy on
             the bridge's side stream) → an engine write, submitted
             without waiting for the NVMe write;
  backward:  the input comes back NVMe → staging → device through the
             bridge (``h2d_copy`` on a card) while slot i-1's read is
             already submitted (``prefetch_hits``), and the layer is
             recomputed under ``enable_grad``: gradients flow to its
             parameters and its input.

Activations therefore take one layer's worth of device memory whatever
the depth, at the price of moving each layer input to NVMe and back
once a step.  Ordering is program order plus a per-slot drain: a slot's
read first waits out the slot's pending host copy and NVMe write.  The
store is single-process: one engine, one file.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from nvme_strom_tpu_torch.io.engine import wait_exact
from nvme_strom_tpu_torch.ops.bridge import (host_to_device, split_ranges,
                                             stage_to_host,
                                             submit_chunked_writes)

_ALIGN = 4096


def _align_up(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


class ActivationStore:
    """Slotted NVMe backing for one training step's layer inputs.

    One slot per layer; the slot size latches at the first write (every
    layer input shares one (b, s, d) shape and dtype).  ``engine``: a
    shared StromEngine (one from ``io/faults.py`` ``build_engine`` is
    created and owned otherwise).  Each slot keeps one host buffer of
    its size (page-locked on a card) for the copy home, reused every
    step.  Counters: ``writes``, ``reads``, ``prefetch_hits``."""

    def __init__(self, path, n_slots: int, engine=None):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.path = str(path)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._own_engine = engine is None
        if engine is None:
            from nvme_strom_tpu_torch.io.faults import build_engine
            engine = build_engine()
        self.engine = engine
        self.n_slots = n_slots
        self._slot_bytes: Optional[int] = None
        self._nbytes = 0
        self._shape = None
        self._dtype = None
        with open(self.path, "wb"):
            pass
        self._fh = self.engine.open(self.path, writable=True)
        #: slot → its host buffer (numpy view, owner), reused every step
        self._host: Dict[int, tuple] = {}
        #: slot → the HostStage whose device→host copy is in flight
        self._staged: Dict[int, object] = {}
        #: slot → in-flight PendingWrites
        self._pending: Dict[int, list] = {}
        self._written: set = set()
        #: slot → [(position, PendingRead)] submitted ahead of its read
        #: (backward walks the slots high → low, so reading slot i
        #: prefetches slot i-1 under layer i's recompute)
        self._prefetch: Dict[int, list] = {}
        self.writes = 0
        self.reads = 0
        self.prefetch_hits = 0

    def _check_slot(self, slot: int) -> int:
        slot = int(slot)
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} out of [0, {self.n_slots})")
        return slot

    def write(self, slot, x: torch.Tensor) -> None:
        """Send ``x`` (a tensor, or a numpy array) to ``slot``; returns
        before the bytes are on NVMe."""
        slot = self._check_slot(slot)
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        x = x.detach()
        if self._slot_bytes is None:
            self._nbytes = x.numel() * x.element_size()
            self._slot_bytes = _align_up(self._nbytes)
            self._shape, self._dtype = tuple(x.shape), x.dtype
        elif (tuple(x.shape), x.dtype) != (self._shape, self._dtype):
            raise ValueError(
                f"slot {slot}: activation {tuple(x.shape)}/{x.dtype} != "
                f"store layout {self._shape}/{self._dtype}: one store "
                "serves one step shape; use a second store")
        self._drain(slot)             # an unread previous write is stale
        self._discard_prefetch(slot)  # it would serve last step's bytes
        buf = self._host.get(slot)
        if buf is None:
            from nvme_strom_tpu_torch.ops.bridge import host_buffer
            buf = self._host[slot] = host_buffer(self._slot_bytes, x.device)
        self._staged[slot] = stage_to_host(x, out=buf[0], pad_to=_ALIGN,
                                           keep=buf[1])
        self._written.add(slot)
        self.writes += 1
        self._submit_ready()

    def _submit_write(self, slot: int) -> None:
        stage = self._staged.pop(slot)
        stage.synchronize()
        pend: list = []
        submit_chunked_writes(self.engine, self._fh,
                              slot * self._slot_bytes, stage.view, pend)
        self._pending[slot] = pend

    def _submit_ready(self) -> None:
        """Submit the NVMe writes of every slot whose host copy is done;
        the rest wait for a later write or their read."""
        for slot in [s for s, st in self._staged.items() if st.is_ready()]:
            self._submit_write(slot)

    def _submit_slot_read(self, slot: int) -> list:
        off0 = slot * self._slot_bytes
        ranges, _ = split_ranges([(off0, self._nbytes)],
                                 self.engine.config.chunk_bytes)
        return [(off - off0, self.engine.submit_read(self._fh, off, ln))
                for off, ln in ranges]

    def _discard_prefetch(self, slot: int) -> None:
        # a speculative read's bytes were about to be dropped anyway: a
        # failure there must not kill the step, and every chunk's
        # staging goes back even when an earlier chunk failed
        for _, r in self._prefetch.pop(slot, ()):
            try:
                r.release()
            except OSError:
                pass

    def read(self, slot, device=None) -> torch.Tensor:
        """The tensor last written to ``slot``, on ``device`` (default
        the CPU), read back through the engine and the bridge."""
        slot = self._check_slot(slot)
        if self._slot_bytes is None:
            raise ValueError("read before any write")
        dev = torch.device("cpu") if device is None else torch.device(device)
        reqs = self._prefetch.pop(slot, None)
        if reqs is not None:
            self.prefetch_hits += 1
        else:
            self._drain(slot)
            reqs = self._submit_slot_read(slot)
        nxt = slot - 1
        if (nxt >= 0 and nxt not in self._prefetch
                and nxt in self._written):
            self._drain(nxt)
            self._prefetch[nxt] = self._submit_slot_read(nxt)
        parts, transfers = [], []
        try:
            for _, r in reqs:
                t = host_to_device(self.engine, wait_exact(r), dev)
                transfers.append(t)
                parts.append(t.tensor)
        finally:
            for t in transfers:     # the staging is recycled below
                t.synchronize()
            for _, r in reqs:
                r.release()
        flat = parts[0] if len(parts) == 1 else torch.cat(parts)
        self.reads += 1
        return flat.view(self._dtype).reshape(self._shape)

    def _drain(self, slot: int) -> None:
        if slot in self._staged:
            self._submit_write(slot)
        for p in self._pending.pop(slot, ()):
            p.wait()

    def close(self) -> None:
        if getattr(self, "_fh", None) is not None:
            try:
                for s in list(self._staged) + list(self._pending):
                    self._drain(s)
            finally:
                for s in list(self._prefetch):
                    self._discard_prefetch(s)
                self.engine.close(self._fh)
                self._fh = None
                self._host.clear()
        if self._own_engine and self.engine is not None:
            self.engine.close_all()
            self.engine = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _OffloadLayer(torch.autograd.Function):
    """``core(params, x) -> (y, aux)`` whose input lives on NVMe between
    forward and backward; the parameters are inputs of the function so
    autograd routes their gradients (or their producers' gradients)
    through its backward."""

    @staticmethod
    def forward(ctx, core, store, slot, names, x, *values):
        params = dict(zip(names, values))
        y, aux = core(params, x)
        store.write(slot, x)
        ctx.core, ctx.store, ctx.slot, ctx.names = core, store, slot, names
        ctx.device = x.device
        ctx.save_for_backward(*values)
        return y, aux

    @staticmethod
    def backward(ctx, gy, gaux):
        values = ctx.saved_tensors
        x = ctx.store.read(ctx.slot, ctx.device)
        wants = ctx.needs_input_grad[5:]
        leaves = [v.detach().requires_grad_(w) for v, w
                  in zip(values, wants)]
        x = x.requires_grad_(ctx.needs_input_grad[4])
        with torch.enable_grad():
            y, aux = ctx.core(dict(zip(ctx.names, leaves)), x)
        outs, grads_out = [y], [gy]
        if aux.requires_grad and gaux is not None:
            outs.append(aux)
            grads_out.append(gaux)
        inputs = [x] + leaves
        take = [t for t in inputs if t.requires_grad]
        got = iter(torch.autograd.grad(outs, take, grads_out,
                                       allow_unused=True))
        grads = [next(got) if t.requires_grad else None for t in inputs]
        return (None, None, None, None, *grads)


def offload_layer(core: Callable, store: ActivationStore, slot: int,
                  params: Dict[str, torch.Tensor], x: torch.Tensor):
    """``core(params, x) -> (y, aux)`` (one decoder layer, whose
    parameters are ``params``) run so that its input ``x`` lives in the
    store's ``slot`` between forward and backward.  Outside autograd
    (no input requires grad) it is a plain call."""
    names = tuple(params)
    values = tuple(params[n] for n in names)
    if not torch.is_grad_enabled() or not (
            x.requires_grad or any(v.requires_grad for v in values)):
        return core(params, x)
    return _OffloadLayer.apply(core, store, slot, names, x, *values)
