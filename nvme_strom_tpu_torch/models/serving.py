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
are not needed.

``kv_store`` attaches the SSD-backed KV prefix store
(models/kv_offload.py ``PrefixStore``): a step plans every admission
first, restores all their store-resident prompt pages in one batched
read (through ``h2d_copy`` onto the card), then finishes each one:
restored pages head the request's cache and ``block_step`` prefills only
the suffix.  Newly computed full pages are written back once, however
many sessions share them.  Tenants, load shedding, drain/handoff,
session export and cold start of the JAX server are not part of this
port yet.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from nvme_strom_tpu_torch.device import resolve_device
from nvme_strom_tpu_torch.models import decode as _dec
from nvme_strom_tpu_torch.models.transformer import (
    TransformerConfig, embed, mlp, qkv_project, rms_norm, wmat)
from nvme_strom_tpu_torch.ops.decode_attention import decode_attention
from nvme_strom_tpu_torch.ops.paged_attention import paged_attention


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
        x = x + a @ wmat(params, L + "wo", a.dtype)
        h = rms_norm(x, params[L + "mlp_norm"], cfg.norm_eps)
        x = (x + mlp(h, params, L)).to(cfg.dtype)
    x = rms_norm(x[:, 0], params["final_norm"], cfg.norm_eps)
    return (x @ wmat(params, "lm_head", x.dtype)).float()


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

    def __init__(self, params: Dict[str, torch.Tensor],
                 cfg: TransformerConfig, max_batch: int, max_len: int,
                 device=None, kv_store=None):
        self.device = resolve_device(device)
        #: the shared NVMe prefix store (None: the store-less path)
        self.kv_store = kv_store
        for name, t in params.items():
            if t.device != self.device:
                raise ValueError(f"parameter {name} is on {t.device}, the "
                                 f"server on {self.device}")
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
        self._alloc_storage()

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
               top_p: float = 1.0, seed: int = 0) -> None:
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
        self.queue.append(_Request(
            rid, list(prompt_ids), max_new, eos_id, temperature=temperature,
            top_p=top_p, seed=seed & 0xFFFFFFFF, t_submit=time.monotonic()))

    # -- admission ----------------------------------------------------------
    #
    # Plan (capacity decisions, in queue order), one batched restore of
    # every admitting slot's store-resident pages, then finish (prefill
    # and place).  Without a store the two halves are the plain admit.

    def _admit_plan(self, slot: int, req: _Request) -> dict:
        """Capacity decisions only (all of a step's admissions plan
        before any of them prefills)."""
        return {"slot": slot, "req": req}

    def _prompt(self, ids: List[int]) -> torch.Tensor:
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
        return store.restore_many(wants, device=self.device)

    @staticmethod
    def _contiguous_from(restored: dict, start: int) -> list:
        """The restored pages at chain indices start, start + 1, ...
        without a gap: the usable prefix extension."""
        use = []
        while start + len(use) in restored:
            use.append(restored[start + len(use)])
        return use

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
            logits, cache = _dec.block_step(self.params, self._prompt(suffix),
                                            self.cfg, cache,
                                            last=len(suffix) - 1)
        else:
            cache = _dec.init_cache(self.cfg, 1, s, device=self.device)
            logits, cache = _dec.prefill(self.params,
                                         self._prompt(req.prompt), self.cfg,
                                         cache)
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
        }
        if self.kv_store is not None:
            out.update({k: v for k, v in
                        self.kv_store.stats.snapshot().items()
                        if k.startswith("kv_")})
        return out

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
        finished: Dict[object, List[int]] = {}
        t0 = time.monotonic()
        plans = []
        for slot in range(self.B):
            if (self.slots[slot] is None and self.queue
                    and self._can_admit(self.queue[0])):
                plans.append(self._admit_plan(slot, self.queue.pop(0)))
        restored = (self._restore_prefixes(plans)
                    if plans and self.kv_store is not None else {})
        for plan in plans:
            self._admit_finish(plan, restored.get(plan["slot"], {}))
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
        """Step until every request finished; ``lookahead`` decode steps
        per host readback.  Raises when the queue head can never be
        admitted and nothing in flight can free capacity."""
        if lookahead < 1:
            raise ValueError(f"lookahead must be >= 1, got {lookahead}")
        results: Dict[object, List[int]] = {}
        while not self.idle:
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
                 prefix_cache: bool = True, device=None, kv_store=None):
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
                         kv_store=kv_store)

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
            logits, cache = _dec.block_step(self.params,
                                            self._prompt(suffix), cfg,
                                            cache, last=len(suffix) - 1)
        else:
            logits, cache = _dec.prefill(self.params,
                                         self._prompt(req.prompt), cfg,
                                         cache)
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
            for blk in self.blocks[slot]:
                if not self._pc_release(blk):
                    self.free.append(blk)
            self.blocks[slot] = []
            self._table_dev = None
        return ret

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
