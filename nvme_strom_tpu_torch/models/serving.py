"""Continuous batching over fixed slots (counterpart of
nvme_strom_tpu/models/serving.py ``DecodeServer`` and
``PagedDecodeServer``).

Requests arrive with any prompt length; the server packs them into a
fixed-slot batch, admits queued work as soon as a slot frees, and every
decode step advances every active slot at its own position.  On a CUDA
device the decode step always runs the hand-written attention kernels
(ops/decode_attention.py for the dense per-slot cache,
ops/paged_attention.py for the shared block pool); their plain versions
run only for CPU tensors.

Positions and the per-slot sampling parameters live on the host (no
device sync sits in front of a step); the next tokens stay on the
device until ``step_many``'s single readback.  Greedy requests take the
exact argmax; sampled requests draw from a ``torch.Generator`` (Philox
on the card) seeded per (request seed, position), so they reproduce on
one device.

Admission prefills the exact prompt: PyTorch runs eagerly, so the JAX
server's power-of-two prompt buckets, which bound its compile count,
are not needed.  A model with mixture-of-experts layers whose expert
capacity can bind is the exception (``moe.prefill_len`` decides): there
the capacity couples the tokens of a routing group, pad tokens included,
so the prompt (or the suffix past restored pages) is right-padded
exactly as the JAX server pads it, and both route alike.

``kv_store`` attaches the SSD-backed KV prefix store
(models/kv_offload.py ``PrefixStore``): a step plans every admission
first, restores all their store-resident prompt pages in one batched
read (through ``h2d_copy`` onto the card), then finishes each one:
restored pages head the request's cache and ``block_step`` prefills only
the suffix.  Newly computed full pages are written back once, however
many sessions share them.

Load shedding: ``shed_probe=`` is a callable that returns True while
new prefills should defer (queued requests wait, in-flight decode goes
on, nothing fails); each deferred admission counts ``admissions_shed``.
With no probe and a ``kv_store``, the server sheds while the store
engine's supervisor (io/health.py) has the device degraded, and each
check is a supervision tick: with admissions deferred no other read
may be left to carry the recovery probe.

Tenants (io/tenants.py), only under ``STROM_TENANTS=1``: ``submit(...,
tenant=)`` resolves the request's tenant once.  While any queued request
has one, admission is tier-aware: under backlog pressure (more queued
than free slots) only the best tier present admits, and each admission
spends a token of its tenant's bucket; a request passed over stays
queued and counts in ``tenant_sheds`` and ``admissions_shed``.  The
batched restore and each admission's prefill and store puts run in the
tenant's scope, so the scheduler, the host tier and the store charge
them to it, and each tenant's TTFT p99 feeds the store's
``SloGovernor``.  With tenants off the tag is ignored and every path is
the one without tenants, bit for bit.  A tenant whose sheds since its
last window reach ``STROM_TENANT_STORM_SHEDS`` trips a ``tenant_storm``
dump of the store engine's flight recorder (io/flightrec.py), counted
in ``tenant_storm_dumps`` when one is written.

Cold start: ``params`` may be a lazy source, anything with
``materialize()`` (parallel/weights.py ``FaultingCheckpoint``).  The
server then accepts submissions at once, tells the source's
coordinator that serving started, starts its bulk lane, and resolves
the params at the first step with ``materialize(klass="decode")``: the
first step makes every parameter resident, as the JAX server's does.

Drain (io/handoff.py ``DrainCoordinator``): ``begin_drain`` closes the
admission gate for the rest of the server's life.  New prefills defer
with the shed path's semantics (they stay queued, counted in
``admissions_deferred`` and ``handoff_deferred``) while in-flight slots
decode on; ``run`` returns once only deferred requests are left.
``export_sessions`` hands the live sessions (in-flight slots first,
then the queue) to a handoff bundle as their prompt, the tokens
already delivered, the remaining budget, the sampling parameters and
their prefix-store page keys, and with ``pop`` takes them off the
server, freeing their slots (and the paged server's blocks).  Until a
drain begins none of this state shows in ``stats()``.

Request traces: while the server's tracer is on (the store engine's, or
the global one), ``submit`` gives each request a root ``TraceContext``;
its admission runs under a child context (the ``strom.serve.admit``
span, the batched restore's ``strom.serve.kv_restore`` under the first
traced request), so the store's, the scheduler's and the engine's spans
hang under the request, and its retirement emits the root
``strom.serve.request`` span and, under ``STROM_ATTRIB=1``, folds the
request's spans into the attribution profiles (obs/attrib.py,
class ``decode``).
"""

from __future__ import annotations

import contextlib
import hashlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from nvme_strom_tpu_torch.device import resolve_device
from nvme_strom_tpu_torch.io.tenants import (TokenBucket, get_registry,
                                             tenant_context,
                                             tenants_enabled, tier_rank)
from nvme_strom_tpu_torch.models import decode as _dec
from nvme_strom_tpu_torch.models.moe import prefill_len
from nvme_strom_tpu_torch.models.transformer import (
    TransformerConfig, embed, mlp_block, project, qkv_project, rms_norm)
from nvme_strom_tpu_torch.obs.attrib import get_collector
from nvme_strom_tpu_torch.ops.decode_attention import decode_attention
from nvme_strom_tpu_torch.ops.paged_attention import paged_attention
from nvme_strom_tpu_torch.utils.trace import (TraceContext, global_tracer,
                                              use_context)


@dataclass
class _Request:
    rid: object
    prompt: List[int]
    max_new: int
    eos_id: Optional[int]
    temperature: float = 0.0      # 0 = greedy
    top_p: float = 1.0
    seed: int = 0
    out: List[int] = field(default_factory=list)
    chain_keys: object = None     # paged prefix-cache memo
    store_keys: object = None     # prefix-store memo (its page size may
    #                               differ from the HBM block size)
    # submitted, admitted, first token delivered to the host
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: Optional[float] = None
    # the resolved io/tenants.Tenant; None while STROM_TENANTS=0
    tenant: object = None
    # the request's root TraceContext (utils/trace.py) and its submit
    # time in ns, while a tracer is on at submit
    trace: object = None
    t_submit_ns: int = 0


def _draw_seed(seed: int, pos: int) -> int:
    """A 64-bit generator seed from (request seed, position), mixed so
    that its low 32 bits, all a CPU generator keeps, depend on both
    (the splitmix64 finalizer)."""
    z = (((seed & 0xFFFFFFFF) << 32) | (pos & 0xFFFFFFFF)) \
        + 0x9E3779B97F4A7C15
    z &= 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


def _sample_slots(logits: torch.Tensor, temps: List[float],
                  top_ps: List[float], seeds: List[int],
                  pos: List[int]) -> torch.Tensor:
    """Next token per row of ``logits`` (B, V): the exact argmax for
    rows with temperature 0, else a temperature / top-p draw from a
    generator seeded by (seed, position)."""
    out = logits.argmax(dim=-1)
    for i, t in enumerate(temps):
        if t <= 0:
            continue
        masked = _dec.nucleus_truncate(logits[i] / max(t, 1e-6), top_ps[i])
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(_draw_seed(seeds[i], pos[i]))
        out[i] = torch.multinomial(torch.softmax(masked, dim=-1), 1,
                                   generator=gen)[0]
    return out


def _batched_step(params: Dict, cfg: TransformerConfig, tok: torch.Tensor,
                  pos: torch.Tensor, write_and_attend) -> torch.Tensor:
    """The transformer of one decode step for every slot, each at its
    own position ``pos`` (B,).  ``write_and_attend(i, q, k, v)`` writes
    layer i's new K/V into the server's storage and returns the
    attention output (B, nh, 1, hd)."""
    B = tok.shape[0]
    x = embed(params, tok[:, None], cfg)
    positions = pos.float()[:, None]
    for i in range(cfg.n_layers):
        L = f"layers.{i}."
        h = rms_norm(x, params[L + "attn_norm"], cfg.norm_eps)
        q, k, v = qkv_project(h, params, L, cfg, positions)
        a = write_and_attend(i, q.contiguous(), k, v)
        a = a.transpose(1, 2).reshape(B, 1, -1)
        x = x + project(a, params, L + "wo")
        h = rms_norm(x, params[L + "mlp_norm"], cfg.norm_eps)
        x = (x + mlp_block(h, params, L, cfg)).to(cfg.dtype)
    x = rms_norm(x[:, 0], params["final_norm"], cfg.norm_eps)
    return project(x, params, "lm_head").float()


class DecodeServer:
    """Fixed-slot continuous-batching decode server with a dense
    per-slot KV cache (n_layers, max_batch, n_kv_heads, max_len, hd).

    ``submit`` enqueues (greedy by default, or per-request
    ``temperature``/``top_p``/``seed``); ``step`` admits queued requests
    into free slots, advances every active slot one token and returns
    the requests that finished ({request id: tokens}); ``run`` drains
    everything."""

    #: retired requests whose per-request metrics are kept
    METRICS_KEEP = 4096
    #: TTFT samples kept per tenant for its p99, and the count before
    #: the p99 is trusted
    _TENANT_TTFT_WIN = 64
    _TENANT_TTFT_MIN = 8

    def __init__(self, params: Dict[str, torch.Tensor],
                 cfg: TransformerConfig, max_batch: int, max_len: int,
                 device=None, kv_store=None, shed_probe=None):
        self.device = resolve_device(device)
        #: the shared NVMe prefix store (None: the store-less path)
        self.kv_store = kv_store
        #: True while new prefills should defer (None: never)
        self._shed_probe = shed_probe
        #: admission opportunities deferred by shedding, tenants' too
        self.admissions_shed = 0
        #: the drain's closed admission gate (set once, by begin_drain)
        self._draining = False
        #: admission opportunities deferred by the drain
        self.admissions_deferred = 0
        #: a lazy params source, resolved at the first step
        self._param_source = None
        if not isinstance(params, dict) and hasattr(params, "materialize"):
            self._param_source = params
            params = None
            coord = getattr(self._param_source, "coordinator", None)
            if coord is not None:
                coord.note_serving_started()
            start = getattr(self._param_source, "start_bulk", None)
            if start is not None:
                start()   # serve while restoring, from the first moment
        else:
            self._check_devices(params)
        self.params = params
        self.cfg = cfg
        self.B = max_batch
        self.max_len = max_len
        self.pos_h: List[int] = [0] * max_batch
        self.tok = torch.zeros(max_batch, dtype=torch.long,
                               device=self.device)
        self.temp_h: List[float] = [0.0] * max_batch
        self.topp_h: List[float] = [1.0] * max_batch
        self.seed_h: List[int] = [0] * max_batch
        self.slots: List[Optional[_Request]] = [None] * max_batch
        self.queue: List[_Request] = []
        #: (slot, device tensor) first tokens read back with the batch
        self._pending_first: List[tuple] = []
        #: cumulative phase timers: admission + prefill, decode dispatch,
        #: host readbacks
        self.timings: Dict[str, float] = {
            "admit_s": 0.0, "dispatch_s": 0.0, "readback_s": 0.0,
            "steps": 0, "readbacks": 0}
        #: {rid: {"ttft_ms", "admit_wait_ms"}} of retired requests
        self.request_metrics: Dict[object, Dict[str, float]] = {}
        self._metrics_agg = {"n": 0, "ttft_sum": 0.0, "ttft_max": 0.0,
                             "wait_sum": 0.0, "wait_max": 0.0}
        # tenant admission state, empty until a request with a tenant
        # arrives
        self._tenant_cfg = None
        self._buckets: Dict[str, TokenBucket] = {}
        #: requests passed over per tenant, cumulative
        self.tenant_sheds: Dict[str, int] = {}
        #: sheds per tenant since its last storm window closed
        self._storm_window: Dict[str, int] = {}
        #: recent TTFTs per tenant (its p99 feeds the SLO governor)
        self._tenant_ttft: Dict[str, List[float]] = {}
        self._alloc_storage()

    def _check_devices(self, params: Dict[str, torch.Tensor]) -> None:
        for name, leaf in params.items():
            # a quantized leaf is a dict of tensors (models/quant.py)
            for t in (leaf.values() if isinstance(leaf, dict) else (leaf,)):
                if t.device != self.device:
                    raise ValueError(f"parameter {name} is on {t.device}, "
                                     f"the server on {self.device}")

    def _ensure_params(self) -> None:
        """Resolve a lazy params source: every tensor not yet resident
        is faulted in at ``decode`` class, ahead of the bulk and warmup
        streams; what the bulk lane landed comes from its claim table
        without another read."""
        if self.params is None and self._param_source is not None:
            params = self._param_source.materialize(klass="decode")
            self._check_devices(params)
            self.params = params

    def _alloc_storage(self) -> None:
        cfg = self.cfg
        shape = (cfg.n_layers, self.B, cfg.n_kv_heads, self.max_len,
                 cfg.head_dim)
        self.k_cache = torch.zeros(shape, dtype=cfg.dtype,
                                   device=self.device)
        self.v_cache = torch.zeros_like(self.k_cache)

    # -- intake -------------------------------------------------------------

    def submit(self, rid, prompt_ids: List[int], max_new: int,
               eos_id: Optional[int] = None, temperature: float = 0.0,
               top_p: float = 1.0, seed: int = 0, tenant=None) -> None:
        if not prompt_ids:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if len(prompt_ids) + max_new > self.max_len:
            raise ValueError(
                f"prompt {len(prompt_ids)} + max_new {max_new} exceeds "
                f"server max_len {self.max_len}")
        if rid in {r.rid for r in self.queue} | {
                r.rid for r in self.slots if r is not None}:
            raise ValueError(f"request id {rid!r} already in flight")
        req = _Request(
            rid, list(prompt_ids), max_new, eos_id, temperature=temperature,
            top_p=top_p, seed=seed & 0xFFFFFFFF, t_submit=time.monotonic())
        if tenant is not None and tenants_enabled():
            # resolved once; with tenants off the tag is ignored
            req.tenant = get_registry().get(tenant)
        if self._tracer() is not None:
            req.trace = TraceContext.new()
            req.t_submit_ns = time.monotonic_ns()
        self.queue.append(req)

    def _tracer(self):
        """The server's span sink: the store engine's tracer with a
        store (one trace for the whole stack), else the global tracer;
        None while it is off, so each call site is one test."""
        store = self.kv_store
        tracer = (getattr(getattr(store, "engine", None), "tracer", None)
                  if store is not None else None)
        if tracer is None:
            tracer = global_tracer
        return tracer if tracer.enabled else None

    # -- admission ----------------------------------------------------------
    #
    # Plan (capacity decisions, in queue order), one batched restore of
    # every admitting slot's store-resident pages, then finish (prefill
    # and place).  Without a store the two halves are the plain admit.

    def _admit_plan(self, slot: int, req: _Request) -> dict:
        """Capacity decisions only (all of a step's admissions plan
        before any of them prefills)."""
        return {"slot": slot, "req": req}

    def _prompt(self, ids: List[int], padded: int) -> torch.Tensor:
        """``ids`` as a (1, n) tensor, right-padded with 0 to the
        ``moe.prefill_len`` of ``padded``, the JAX server's length for
        this prefill (see the module docstring)."""
        n = prefill_len(self.cfg, len(ids), padded)
        ids = list(ids) + [0] * (n - len(ids))
        return torch.tensor([ids], dtype=torch.long, device=self.device)

    def _store_keys(self, req: _Request) -> list:
        """The request's prefix-store chain keys, hashed once."""
        if self.kv_store is None:
            return []
        if req.store_keys is None:
            req.store_keys = self.kv_store.chain_keys(req.prompt)
        return req.store_keys

    def _store_skip(self, plan: dict) -> int:
        """Chain pages a cheaper tier already covers (the paged server's
        HBM block cache); the store restores only past them."""
        return 0

    def _store_fits(self, plan: dict, n_pages: int) -> bool:
        """Whether a page-granular admission cache fits ``max_len`` (the
        JAX server's rule, kept so both count the same hits)."""
        s = len(plan["req"].prompt)
        P = self.kv_store.page_tokens
        return -(-s // P) * P <= self.max_len

    def _restore_prefixes(self, plans: list) -> Dict[int, dict]:
        """Every admitting slot's store-resident pages in one
        ``restore_many`` batch: {slot: {chain index: (k, v)}} on this
        server's device.  Pages past the resident prefix count
        ``kv_prefix_misses``."""
        store = self.kv_store
        wants: Dict[int, tuple] = {}
        misses = 0
        for plan in plans:
            keys = self._store_keys(plan["req"])
            if not keys:
                continue
            skip = self._store_skip(plan)
            matched = store.match(keys)
            misses += len(keys) - matched
            if matched > skip and self._store_fits(plan, matched):
                wants[plan["slot"]] = (skip, keys[skip:matched])
        if misses:
            store.stats.add(kv_prefix_misses=misses)
        if not wants:
            return {}
        # one shared read: charged to the first participating tenant,
        # and traced under the first traced request's tree (exact for a
        # one-request step; the span names every trace id it served)
        by_slot = {p["slot"]: p["req"] for p in plans}
        ten = next((by_slot[s].tenant for s in wants
                    if by_slot[s].tenant is not None), None)
        tracer = self._tracer()
        if tracer is None:
            with tenant_context(ten):
                return store.restore_many(wants, device=self.device)
        traced = [by_slot[s].trace for s in wants
                  if by_slot[s].trace is not None]
        ctx = traced[0].child() if traced else None
        t0 = time.monotonic_ns()
        with use_context(ctx), tenant_context(ten):
            restored = store.restore_many(wants, device=self.device)
        tracer.add_span(
            "strom.serve.kv_restore", t0, time.monotonic_ns(),
            category="strom.serve", ctx=ctx, slots=len(wants),
            pages=sum(len(k) for _s, k in wants.values()),
            traces=[f"{t.trace_id:x}" for t in traced])
        return restored

    @staticmethod
    def _contiguous_from(restored: dict, start: int) -> list:
        """The restored pages at chain indices start, start + 1, ...
        without a gap: the usable prefix extension."""
        use = []
        while start + len(use) in restored:
            use.append(restored[start + len(use)])
        return use

    def _finish(self, plan: dict, restored: dict) -> None:
        """``_admit_finish`` in the request's tenant scope, so the lines
        its prefill touches and the pages it puts are charged to it, and
        in its trace: the ``strom.serve.admit`` span, with every span
        the finish causes (store puts, engine writes) under it."""
        req = plan["req"]
        scope = (tenant_context(req.tenant) if req.tenant is not None
                 else contextlib.nullcontext())
        tracer = self._tracer()
        if tracer is None or req.trace is None:
            with scope:
                self._admit_finish(plan, restored)
            return
        ctx = req.trace.child()
        t0 = time.monotonic_ns()
        with use_context(ctx), scope:
            self._admit_finish(plan, restored)
        tracer.add_span(
            "strom.serve.admit", t0, time.monotonic_ns(),
            category="strom.serve", ctx=ctx, rid=str(req.rid),
            slot=plan["slot"], prompt_tokens=len(req.prompt),
            restored_pages=len(restored),
            queue_wait_ms=round(1000.0 * (time.monotonic() - req.t_submit),
                                3))

    def _admit_finish(self, plan: dict, restored: dict) -> None:
        """Prefill the prompt and place its KV in the slot's rows.  With
        restored pages, they head a page-granular cache and
        ``block_step`` prefills only the suffix."""
        slot, req = plan["slot"], plan["req"]
        s = len(req.prompt)
        use = self._contiguous_from(restored, 0)
        if use:
            P = self.kv_store.page_tokens
            cache = _dec.init_cache(self.cfg, 1, -(-s // P) * P,
                                    device=self.device)
            for j, (k, v) in enumerate(use):
                cache["k"][:, 0, :, j * P:(j + 1) * P] = k
                cache["v"][:, 0, :, j * P:(j + 1) * P] = v
            cache["pos"] = len(use) * P
            suffix = req.prompt[len(use) * P:]
            logits, cache = _dec.block_step(
                self.params, self._prompt(suffix, cache["k"].shape[3]
                                          - cache["pos"]),
                self.cfg, cache, last=len(suffix) - 1)
        else:
            # the JAX server's bucket: a power of two >= 16, at most
            # max_len
            bucket = 16
            while bucket < s:
                bucket *= 2
            ids = self._prompt(req.prompt, min(bucket, self.max_len))
            cache = _dec.init_cache(self.cfg, 1, ids.shape[1],
                                    device=self.device)
            logits, cache = _dec.prefill(self.params, ids, self.cfg, cache,
                                         last=s - 1)
        self.k_cache[:, slot, :, :s] = cache["k"][:, 0, :, :s]
        self.v_cache[:, slot, :, :s] = cache["v"][:, 0, :, :s]
        if self.kv_store is not None:
            self._store_put(req, cache, len(use))
        self._occupy(slot, req, logits)

    def _store_put(self, req: _Request, cache: Dict, have: int) -> None:
        """Write this admission's newly computed full prompt pages
        (chain indices ``have``..) to the store, which dedupes by key:
        one device→host pull for all of them, into one pinned buffer."""
        keys = self._store_keys(req)
        n = len(keys) - have
        if n <= 0:
            return
        cfg, P = self.cfg, self.kv_store.page_tokens
        L, nkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim

        def pages_of(t):
            return (t[:, 0, :, have * P:(have + n) * P]
                    .reshape(L, nkv, n, P, hd).permute(2, 0, 1, 3, 4))
        dev_pages = torch.stack([pages_of(cache["k"]),
                                 pages_of(cache["v"])], dim=1)
        host = torch.empty(dev_pages.shape, dtype=dev_pages.dtype,
                           pin_memory=self.device.type == "cuda")
        host.copy_(dev_pages)
        self.kv_store.put([(keys[have + i], host[i, 0], host[i, 1])
                           for i in range(n)])

    def _occupy(self, slot: int, req: _Request, logits: torch.Tensor):
        """Slot bookkeeping once the prompt's KV is in place; the first
        token stays on the device until the batch readback."""
        s = len(req.prompt)
        first = _sample_slots(logits, [req.temperature], [req.top_p],
                              [req.seed], [s - 1])
        self._pending_first.append((slot, first))
        self.slots[slot] = req
        self.temp_h[slot] = req.temperature
        self.topp_h[slot] = req.top_p
        self.seed_h[slot] = req.seed
        self.pos_h[slot] = s
        self.tok[slot] = first[0]
        req.t_admit = time.monotonic()

    def _can_admit(self, req: _Request) -> bool:
        return True        # a dense slot carries its own reservation

    def _retire_or_keep(self, slot: int) -> Optional[tuple]:
        req = self.slots[slot]
        if len(req.out) >= req.max_new or (
                req.eos_id is not None and req.out[-1] == req.eos_id):
            self.slots[slot] = None
            self._record_metrics(req)
            return req.rid, req.out
        return None

    def _record_metrics(self, req: _Request) -> None:
        """TTFT (submit → first token at the host) and admission wait."""
        ttft_ms = (1000.0 * (req.t_first - req.t_submit)
                   if req.t_first is not None else 0.0)
        wait_ms = 1000.0 * (req.t_admit - req.t_submit)
        tracer = self._tracer()
        if tracer is not None and req.trace is not None:
            end_ns = time.monotonic_ns()
            # the request's root span, submit to retirement: the tree
            # every admit, restore, queue and engine span hangs under
            tracer.add_span("strom.serve.request", req.t_submit_ns, end_ns,
                            category="strom.serve", ctx=req.trace,
                            rid=str(req.rid), ttft_ms=round(ttft_ms, 3),
                            admit_wait_ms=round(wait_ms, 3),
                            tokens=len(req.out))
            col = get_collector()
            if col is not None:
                # serving requests are the decode class
                col.request_retired(req.trace.trace_id, req.t_submit_ns,
                                    end_ns, klass="decode",
                                    extra={"rid": str(req.rid),
                                           "ttft_ms": round(ttft_ms, 3)})
        self.request_metrics[req.rid] = {"ttft_ms": round(ttft_ms, 3),
                                         "admit_wait_ms": round(wait_ms, 3)}
        while len(self.request_metrics) > self.METRICS_KEEP:
            self.request_metrics.pop(next(iter(self.request_metrics)))
        agg = self._metrics_agg
        agg["n"] += 1
        agg["ttft_sum"] += ttft_ms
        agg["ttft_max"] = max(agg["ttft_max"], ttft_ms)
        agg["wait_sum"] += wait_ms
        agg["wait_max"] = max(agg["wait_max"], wait_ms)
        if req.tenant is not None:
            self._observe_tenant_ttft(req.tenant, ttft_ms)

    def _observe_tenant_ttft(self, tenant, ttft_ms: float) -> None:
        """A sliding TTFT window per tenant; once it holds
        ``_TENANT_TTFT_MIN`` samples its p99 goes to the store's
        ``SloGovernor.observe_tenant``."""
        win = self._tenant_ttft.setdefault(tenant.id, [])
        win.append(ttft_ms)
        if len(win) > self._TENANT_TTFT_WIN:
            del win[0]
        stats = self._engine_stats()
        if stats is not None:
            stats.add_tenant_stat(tenant.id, requests_finished=1)
        if (tenant.slo_p99_ms <= 0 or self.kv_store is None
                or len(win) < self._TENANT_TTFT_MIN):
            return
        w = sorted(win)
        self.kv_store.slo.observe_tenant(
            self.kv_store.engine, tenant,
            w[min(len(w) - 1, int(0.99 * len(w)))], stats=stats)

    # -- serving ------------------------------------------------------------

    @property
    def idle(self) -> bool:
        return not self.queue and all(s is None for s in self.slots)

    def stats(self) -> Dict[str, float]:
        """Slot occupancy, queue depth, the retired requests' TTFT and
        admission-wait aggregates, and, with a store, its ``kv_``
        counters and gauges (shared by every server on the store's
        engine)."""
        agg = self._metrics_agg
        n = agg["n"]
        out = {
            "slots_total": self.B,
            "slots_busy": sum(r is not None for r in self.slots),
            "queued": len(self.queue),
            "inflight_tokens": sum(len(r.out) for r in self.slots
                                   if r is not None),
            "requests_finished": n,
            "ttft_ms_avg": round(agg["ttft_sum"] / n, 3) if n else 0.0,
            "ttft_ms_max": round(agg["ttft_max"], 3),
            "admit_wait_ms_avg": round(agg["wait_sum"] / n, 3) if n else 0.0,
            "admit_wait_ms_max": round(agg["wait_max"], 3),
            "admissions_shed": self.admissions_shed,
        }
        if self.tenant_sheds:        # only once the tenant layer acted
            out["tenant_sheds"] = dict(self.tenant_sheds)
        if self._draining:           # and these once a drain began
            out["draining"] = True
            out["admissions_deferred"] = self.admissions_deferred
        if self.kv_store is not None:
            out.update({k: v for k, v in
                        self.kv_store.stats.snapshot().items()
                        if k.startswith("kv_")})
        return out

    # -- load shedding and tenant admission ---------------------------------

    def _shed_now(self) -> bool:
        """True while new prefills should defer: the explicit probe says
        so, or without one the store engine's device is degraded."""
        if self._shed_probe is not None:
            return bool(self._shed_probe())
        sup = (getattr(self.kv_store.engine, "supervisor", None)
               if self.kv_store is not None else None)
        if sup is None:
            return False
        # a shedding server is a supervision heartbeat: tick() probes
        # from the last degraded span (time-gated inside)
        sup.tick()
        return sup.degraded()

    def _engine_stats(self):
        """The store engine's counters (None without a store)."""
        return self.kv_store.engine.stats if self.kv_store is not None \
            else None

    def _note_shed(self, n: int) -> None:
        self.admissions_shed += n
        stats = self._engine_stats()
        if stats is not None:
            stats.add(serve_admissions_shed=n)

    # -- drain and handoff (io/handoff.py) -----------------------------------

    @property
    def draining(self) -> bool:
        return self._draining

    def begin_drain(self) -> None:
        """Close the admission gate for the rest of this server's life:
        queued prefills defer (kept for export, never dropped) while
        in-flight slots decode to completion."""
        self._draining = True

    def _note_drain_defer(self, n: int) -> None:
        self.admissions_deferred += n
        stats = self._engine_stats()
        if stats is not None:
            stats.add(handoff_deferred=n)

    def export_sessions(self, limit: int = 256,
                        pop: bool = False) -> List[dict]:
        """The live sessions for a handoff bundle, in-flight slots first
        (their decode progress is the costly part), then the queue, at
        most ``limit``.  Each carries its prompt, the tokens already
        delivered (``emitted``), the remaining ``max_new``, its sampling
        parameters (a seeded draw is keyed by position, so the
        replacement continues identically) and the prefix-store page
        keys of ``prompt + emitted`` (hex).  ``pop`` takes the exported
        sessions off this server: their results are the replacement's
        to deliver."""
        out: List[dict] = []
        taken_slots: List[int] = []
        taken_q: List[_Request] = []
        for i, r in enumerate(self.slots):
            if len(out) >= limit:
                break
            if r is None or r.max_new - len(r.out) < 1:
                continue          # retiring this step anyway
            out.append(self._export_one(r, emitted=list(r.out)))
            taken_slots.append(i)
        for r in self.queue:
            if len(out) >= limit:
                break
            out.append(self._export_one(r, emitted=[]))
            taken_q.append(r)
        if pop:
            for i in taken_slots:
                self._release_slot(i)
                self.slots[i] = None
            self.queue = [r for r in self.queue if r not in taken_q]
        return out

    def _export_one(self, r: _Request, emitted: List[int]) -> dict:
        doc = {"rid": r.rid, "prompt": list(r.prompt), "emitted": emitted,
               "max_new": r.max_new - len(emitted), "eos_id": r.eos_id,
               "temperature": r.temperature, "top_p": r.top_p,
               "seed": int(r.seed),
               "tenant": r.tenant.id if r.tenant is not None else None,
               "kv_keys": []}
        if self.kv_store is not None:
            doc["kv_keys"] = [k.hex() for k in self.kv_store.chain_keys(
                list(r.prompt) + emitted)]
        return doc

    def _release_slot(self, slot: int) -> None:
        """Capacity a slot holds besides its dense rows; the paged
        server frees its blocks."""

    def _tenant_config(self):
        if self._tenant_cfg is None:
            # the registry's config: an explicit tenants.configure()
            # governs here too
            self._tenant_cfg = get_registry().config
        return self._tenant_cfg

    def _bucket(self, tenant) -> TokenBucket:
        """The tenant's admission bucket, made on first sight from its
        own rate and burst or the ``STROM_TENANT_*`` defaults."""
        b = self._buckets.get(tenant.id)
        if b is None:
            cfg = self._tenant_config()
            b = TokenBucket(
                tenant.rate if tenant.rate > 0 else cfg.default_rate,
                tenant.burst if tenant.burst > 0 else cfg.default_burst)
            self._buckets[tenant.id] = b
        return b

    def _admit_tenants(self) -> list:
        """Tier-aware admission.  Under backlog pressure (more queued
        than free slots) only the best tier present admits; each
        admission spends a token of its tenant's bucket, and an empty
        bucket passes over that request only.  A request passed over
        stays queued and is counted; among the admissible the queue is
        FIFO, and a ``_can_admit`` refusal stops the scan."""
        free = sum(s is None for s in self.slots)
        plans: list = []
        if not free:
            return plans
        pressure = len(self.queue) > free
        best = None
        if pressure:
            best = min(tier_rank(r.tenant.tier) for r in self.queue
                       if r.tenant is not None)
        shed: Dict[str, int] = {}
        slots = iter([s for s in range(self.B) if self.slots[s] is None])
        i = 0
        while free and i < len(self.queue):
            req = self.queue[i]
            t = req.tenant
            if t is not None and ((pressure and tier_rank(t.tier) > best)
                                  or not self._bucket(t).try_take()):
                shed[t.id] = shed.get(t.id, 0) + 1
                i += 1
                continue
            if not self._can_admit(req):
                break
            plans.append(self._admit_plan(next(slots), self.queue.pop(i)))
            free -= 1
        if shed:
            self._note_tenant_shed(shed)
        return plans

    def _note_tenant_shed(self, shed: Dict[str, int]) -> None:
        """Count one step's tenant sheds on the server, the engine and
        each tenant, and in each tenant's storm window; the tenants
        whose window reaches ``STROM_TENANT_STORM_SHEDS`` close it and
        trip one ``tenant_storm`` flight dump naming them."""
        n = sum(shed.values())
        self.admissions_shed += n
        stats = self._engine_stats()
        if stats is not None:
            stats.add(tenant_admissions_shed=n)
        for tid, k in shed.items():
            self.tenant_sheds[tid] = self.tenant_sheds.get(tid, 0) + k
            self._storm_window[tid] = self._storm_window.get(tid, 0) + k
            if stats is not None:
                stats.add_tenant_stat(tid, admissions_shed=k)
        thresh = self._tenant_config().storm_sheds
        hot = [t for t, k in self._storm_window.items() if k >= thresh]
        if not hot:
            return
        for tid in hot:
            self._storm_window[tid] = 0
        flight = (getattr(self.kv_store.engine, "flight", None)
                  if self.kv_store is not None else None)
        if flight is None:
            return
        path = flight.dump("tenant_storm",
                           extra={"tenants": hot,
                                  "sheds": dict(self.tenant_sheds),
                                  "queued": len(self.queue)})
        # only dumps written count: the recorder's per-reason rate limit
        # swallows a sustained storm's re-triggers
        if path is not None and stats is not None:
            stats.add(tenant_storm_dumps=1)
            for tid in hot:
                stats.add_tenant_stat(tid, storm_dumps=1)

    def _run_step(self) -> torch.Tensor:
        """One decode step of every slot → next tokens (B,) on device."""
        pos = torch.tensor(self.pos_h, dtype=torch.int32,
                           device=self.device)
        rows = torch.arange(self.B, device=self.device)
        idx = pos.long()

        def write_and_attend(i, q, k, v):
            self.k_cache[i, rows, :, idx] = k[:, :, 0].to(self.cfg.dtype)
            self.v_cache[i, rows, :, idx] = v[:, :, 0].to(self.cfg.dtype)
            return decode_attention(q, self.k_cache[i], self.v_cache[i],
                                    pos)

        logits = _batched_step(self.params, self.cfg, self.tok, pos,
                               write_and_attend)
        return _sample_slots(logits, self.temp_h, self.topp_h, self.seed_h,
                             self.pos_h)

    def step(self) -> Dict[object, List[int]]:
        """Admit → one batched decode step → retire finished."""
        return self.step_many(1)

    def step_many(self, k_steps: int) -> Dict[object, List[int]]:
        """Admit → up to ``k_steps`` decode steps → ONE host readback →
        retire finished.  A request that finishes at sub-step j keeps
        decoding to the batch end; its surplus tokens are discarded, and
        each slot's sub-steps are capped at its max_new remainder, so
        positions never pass its reservation."""
        self._ensure_params()
        finished: Dict[object, List[int]] = {}
        t0 = time.monotonic()
        plans = []
        if self.queue and self._draining:
            # the drain's closed gate: queued requests wait for export
            # while the in-flight slots run out
            self._note_drain_defer(min(sum(s is None for s in self.slots),
                                       len(self.queue)))
        elif self.queue and self._shed_now():
            # new prefills defer; in-flight decode keeps its slots
            self._note_shed(min(sum(s is None for s in self.slots),
                                len(self.queue)))
        elif any(r.tenant is not None for r in self.queue):
            plans = self._admit_tenants()
        else:
            for slot in range(self.B):
                if (self.slots[slot] is None and self.queue
                        and self._can_admit(self.queue[0])):
                    plans.append(self._admit_plan(slot, self.queue.pop(0)))
        restored = (self._restore_prefixes(plans)
                    if plans and self.kv_store is not None else {})
        for plan in plans:
            self._finish(plan, restored.get(plan["slot"], {}))
        self.timings["admit_s"] += time.monotonic() - t0
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return finished
        pending_slots = {s for s, _ in self._pending_first}
        left = {b: (self.slots[b].max_new - len(self.slots[b].out)
                    - (1 if b in pending_slots else 0)) for b in active}
        k_eff = max(1, min(k_steps, max(left.values())))
        toks: List[torch.Tensor] = []
        stepped: List[List[int]] = []
        t0 = time.monotonic()
        for j in range(k_eff):
            stepping = [b for b in active if left[b] > j]
            if not stepping:
                break
            nxt = self._run_step()
            mask = torch.tensor([left.get(b, 0) > j for b in range(self.B)],
                                device=self.device)
            self.tok = torch.where(mask, nxt, self.tok)
            for b in stepping:
                self.pos_h[b] += 1
            toks.append(nxt)
            stepped.append(stepping)
        self.timings["dispatch_s"] += time.monotonic() - t0
        t0 = time.monotonic()
        pending, self._pending_first = self._pending_first, []
        flat = torch.cat([v for _, v in pending] + toks)
        host = flat.tolist()                     # the ONE readback
        self.timings["readback_s"] += time.monotonic() - t0
        self.timings["steps"] += len(toks)
        self.timings["readbacks"] += 1
        first_h, rest = host[:len(pending)], host[len(pending):]
        t_now = time.monotonic()
        for (slot, _), v in zip(pending, first_h):
            self.slots[slot].t_first = t_now
            self.slots[slot].out.append(int(v))
            ret = self._retire_or_keep(slot)
            if ret:
                finished[ret[0]] = ret[1]
        for j, stepping in enumerate(stepped):
            for slot in stepping:
                if self.slots[slot] is None:
                    continue          # retired earlier in this batch
                self.slots[slot].out.append(int(rest[j * self.B + slot]))
                ret = self._retire_or_keep(slot)
                if ret:
                    finished[ret[0]] = ret[1]
        return finished

    def run(self, lookahead: int = 1) -> Dict[object, List[int]]:
        """Step until every request finished (draining: until only
        deferred requests are left); ``lookahead`` decode steps per host
        readback.  Raises when the queue head can never be admitted and
        nothing in flight can free capacity."""
        if lookahead < 1:
            raise ValueError(f"lookahead must be >= 1, got {lookahead}")
        results: Dict[object, List[int]] = {}
        while not self.idle:
            if self._draining and all(s is None for s in self.slots):
                # only drain-deferred requests are left: they belong to
                # the handoff bundle, and the closed gate admits none
                break
            if (self.queue and all(s is None for s in self.slots)
                    and not self._can_admit(self.queue[0])):
                raise RuntimeError(
                    f"request {self.queue[0].rid!r} cannot ever be admitted "
                    "(needs more capacity than the server has) and no "
                    "in-flight work can free any")
            results.update(self.step_many(lookahead))
        return results


class PagedDecodeServer(DecodeServer):
    """Continuous batching over a SHARED pool of ``total_blocks`` KV
    blocks of ``block_len`` positions (paged attention).

    Each request reserves its worst case ``ceil((prompt+max_new) /
    block_len)`` blocks at admission, so it can never starve
    mid-decode; requests wait in the queue while the pool is short.
    With ``prefix_cache`` every full prompt block registers under a
    chain hash of the prompt up to it, and a later request with the same
    chain reuses those blocks read-only and prefills only its suffix;
    blocks no request holds stay cached and are evicted oldest-first
    when the pool runs short."""

    def __init__(self, params: Dict[str, torch.Tensor],
                 cfg: TransformerConfig, max_batch: int, max_len: int,
                 total_blocks: int, block_len: int = 128,
                 prefix_cache: bool = True, device=None, kv_store=None,
                 shed_probe=None):
        if block_len < 1 or total_blocks < 1:
            raise ValueError("block_len and total_blocks must be >= 1")
        if kv_store is not None and kv_store.page_tokens != block_len:
            # store pages go 1:1 into pool blocks; another size would
            # need a re-chunking copy on every restore
            raise ValueError(
                f"kv_store.page_tokens ({kv_store.page_tokens}) must "
                f"equal block_len ({block_len})")
        self.block_len = block_len
        self.total_blocks = total_blocks
        self.prefix_cache = prefix_cache
        self.max_blocks = -(-max_len // block_len)
        super().__init__(params, cfg, max_batch, max_len, device=device,
                         kv_store=kv_store, shed_probe=shed_probe)

    def _alloc_storage(self) -> None:
        cfg = self.cfg
        # +1: a trash block for the writes of free slots, which still
        # compute a (masked) step
        shape = (cfg.n_layers, self.total_blocks + 1, cfg.n_kv_heads,
                 self.block_len, cfg.head_dim)
        self.k_pool = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
        self.v_pool = torch.zeros_like(self.k_pool)
        self._trash = self.total_blocks
        self.free: List[int] = list(range(self.total_blocks))
        self.blocks: List[List[int]] = [[] for _ in range(self.B)]
        self._table_dev: Optional[torch.Tensor] = None
        self._pc: Dict[bytes, dict] = {}        # key -> {blk, refs}
        self._pc_by_blk: Dict[int, bytes] = {}
        self._pc_lru: Dict[bytes, None] = {}    # refs == 0, oldest first
        self._pc_hits = 0
        self._pc_shared_blocks = 0

    def _table(self) -> torch.Tensor:
        """(B, max_blocks) int32 block table, rebuilt only when block
        membership changes; padding entries are 0 and never read."""
        if self._table_dev is None:
            t = np.zeros((self.B, self.max_blocks), np.int32)
            for b, blks in enumerate(self.blocks):
                t[b, :len(blks)] = blks
            self._table_dev = torch.from_numpy(t).to(self.device)
        return self._table_dev

    # -- prefix cache ---------------------------------------------------------

    def _chain_keys(self, prompt: List[int]) -> List[bytes]:
        """Chain hash per FULL prompt block, capped at (s-1)//bk so at
        least one suffix token always prefills live."""
        bk = self.block_len
        keys, h = [], b""
        for i in range((len(prompt) - 1) // bk):
            chunk = np.asarray(prompt[i * bk:(i + 1) * bk],
                               np.int32).tobytes()
            h = hashlib.sha1(h + chunk).digest()
            keys.append(h)
        return keys

    def _req_keys(self, req: _Request) -> List[bytes]:
        if not self.prefix_cache:
            return []
        if req.chain_keys is None:
            req.chain_keys = self._chain_keys(req.prompt)
        return req.chain_keys

    def _pc_match(self, keys: List[bytes]) -> List[bytes]:
        out = []
        for kx in keys:
            if kx not in self._pc:
                break
            out.append(kx)
        return out

    def _pc_acquire(self, key: bytes) -> int:
        e = self._pc[key]
        e["refs"] += 1
        self._pc_lru.pop(key, None)
        return e["blk"]

    def _pc_register(self, key: bytes, blk: int) -> None:
        if key in self._pc:
            return
        self._pc[key] = {"blk": blk, "refs": 1}
        self._pc_by_blk[blk] = key

    def _pc_release(self, blk: int) -> bool:
        """Drop a ref; True if the block stays cached (evictable at 0)."""
        key = self._pc_by_blk.get(blk)
        if key is None:
            return False
        e = self._pc[key]
        e["refs"] -= 1
        if e["refs"] == 0:
            self._pc_lru[key] = None
        return True

    def _pc_evict_one(self) -> int:
        key = next(iter(self._pc_lru))
        del self._pc_lru[key]
        blk = self._pc.pop(key)["blk"]
        del self._pc_by_blk[blk]
        return blk

    def _alloc_blocks(self, n: int) -> List[int]:
        out = []
        for _ in range(n):
            if not self.free:
                self.free.append(self._pc_evict_one())
            out.append(self.free.pop())
        return out

    # -- admission ------------------------------------------------------------

    def _admit_plan(self, slot: int, req: _Request) -> dict:
        """Prefix-cache refs and block allocation, in queue order."""
        need = -(-(len(req.prompt) + req.max_new) // self.block_len)
        keys = self._req_keys(req)
        matched = self._pc_match(keys)
        shared = [self._pc_acquire(kx) for kx in matched]
        return {"slot": slot, "req": req, "keys": keys, "c": len(matched),
                "blks": shared + self._alloc_blocks(need - len(matched))}

    def _store_skip(self, plan: dict) -> int:
        # pages the HBM block cache holds cost one gather, less than any
        # NVMe read: the store starts past them
        return plan["c"]

    def _store_fits(self, plan: dict, n_pages: int) -> bool:
        return True    # restored pages land in blocks already reserved

    def _admit_finish(self, plan: dict, restored: dict) -> None:
        """Pages restored from the store go into the request's own new
        blocks past its HBM prefix-cache match and register in that
        cache; then the suffix past every cached block (the whole prompt
        when none) is prefilled and its KV scattered into the request's
        blocks."""
        slot, req = plan["slot"], plan["req"]
        keys, c, blks = plan["keys"], plan["c"], plan["blks"]
        cfg, bk = self.cfg, self.block_len
        s = len(req.prompt)
        self.blocks[slot] = blks
        self._table_dev = None
        n_pb = -(-s // bk)
        cache = _dec.init_cache(cfg, 1, n_pb * bk, device=self.device)
        L, nkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        if c:
            self._pc_hits += 1
            self._pc_shared_blocks += c
        use = self._contiguous_from(restored, c)
        if use:
            idx = torch.tensor(blks[c:c + len(use)], device=self.device)
            self.k_pool[:, idx] = torch.stack([k for k, _ in use], dim=1)
            self.v_pool[:, idx] = torch.stack([v for _, v in use], dim=1)
            # keys is empty without the HBM cache: restores still serve,
            # there is just no registry to join
            for j in range(len(use) if keys else 0):
                self._pc_register(keys[c + j], blks[c + j])
        ct = c + len(use)
        if ct:
            idx = torch.tensor(blks[:ct], device=self.device)
            for pool, dst in ((self.k_pool, cache["k"]),
                              (self.v_pool, cache["v"])):
                dst[:, 0, :, :ct * bk] = (pool[:, idx]
                                          .permute(0, 2, 1, 3, 4)
                                          .reshape(L, nkv, ct * bk, hd))
            cache["pos"] = ct * bk
            suffix = req.prompt[ct * bk:]
            logits, cache = _dec.block_step(
                self.params, self._prompt(suffix, (n_pb - ct) * bk), cfg,
                cache, last=len(suffix) - 1)
        else:
            logits, cache = _dec.prefill(self.params,
                                         self._prompt(req.prompt,
                                                      n_pb * bk),
                                         cfg, cache, last=s - 1)
        idx = torch.tensor(blks[ct:n_pb], device=self.device)
        for pool, src in ((self.k_pool, cache["k"]),
                          (self.v_pool, cache["v"])):
            pool[:, idx] = (src[:, 0, :, ct * bk:n_pb * bk]
                            .reshape(L, nkv, n_pb - ct, bk, hd)
                            .permute(0, 2, 1, 3, 4))
        for i in range(ct, len(keys)):
            self._pc_register(keys[i], blks[i])
        if self.kv_store is not None:
            self._store_put(req, cache, ct)
        self._occupy(slot, req, logits)

    def _can_admit(self, req: _Request) -> bool:
        """Free blocks plus evictable cached blocks (not the ones this
        request would reuse) cover the worst case past its cached
        prefix."""
        need = -(-(len(req.prompt) + req.max_new) // self.block_len)
        if not self.prefix_cache:
            return len(self.free) >= need
        matched = set(self._pc_match(self._req_keys(req)))
        evictable = sum(1 for k in self._pc_lru if k not in matched)
        return len(self.free) + evictable >= need - len(matched)

    def _retire_or_keep(self, slot: int):
        ret = super()._retire_or_keep(slot)
        if ret is not None:
            self._release_slot(slot)
        return ret

    def _release_slot(self, slot: int) -> None:
        """The slot's blocks back to the pool (a cache-registered block
        drops a ref and stays evictable), on retirement and on a drain's
        export alike.  Nothing is written back: the store's pages were
        put at admission."""
        for blk in self.blocks[slot]:
            if not self._pc_release(blk):
                self.free.append(blk)
        self.blocks[slot] = []
        self._table_dev = None

    def stats(self) -> Dict[str, float]:
        out = super().stats()
        out.update(blocks_total=self.total_blocks,
                   blocks_free=len(self.free),
                   prefix_cached_blocks=len(self._pc),
                   prefix_evictable=len(self._pc_lru),
                   prefix_hits=self._pc_hits,
                   prefix_shared_blocks=self._pc_shared_blocks)
        return out

    def _run_step(self) -> torch.Tensor:
        bk = self.block_len
        blk = torch.tensor([self.blocks[b][self.pos_h[b] // bk]
                            if self.blocks[b] else self._trash
                            for b in range(self.B)], device=self.device)
        off = torch.tensor([p % bk for p in self.pos_h], device=self.device)
        pos = torch.tensor(self.pos_h, dtype=torch.int32, device=self.device)
        table = self._table()

        def write_and_attend(i, q, k, v):
            self.k_pool[i, blk, :, off] = k[:, :, 0].to(self.cfg.dtype)
            self.v_pool[i, blk, :, off] = v[:, :, 0].to(self.cfg.dtype)
            return paged_attention(q, self.k_pool[i], self.v_pool[i], table,
                                   pos)

        logits = _batched_step(self.params, self.cfg, self.tok, pos,
                               write_and_attend)
        return _sample_slots(logits, self.temp_h, self.topp_h, self.seed_h,
                             self.pos_h)
