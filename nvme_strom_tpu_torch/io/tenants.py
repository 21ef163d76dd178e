"""Tenant identity and isolation (counterpart of
nvme_strom_tpu/io/tenants.py).

Many tenants share one serving host.  This module carries the identity
that lets each layer below the servers keep them apart:

  Tenant        one tenant's policy: SLO tier, fair-share weight,
                residency quota fraction, admission rate and burst, and
                a decode TTFT p99 target.
  TIER_ORDER    SLO tiers, best first (``gold`` > ``silver`` >
                ``bronze``); under backlog pressure the servers shed the
                worse tiers first (models/serving.py).
  tenant_context / current_tenant
                a contextvar: a server enters a request's tenant scope,
                and the layers below read it without new arguments (the
                QoS scheduler stamps each batch at enqueue, the host
                tier each line at fill, the prefix store each page at
                put).
  TenantRegistry
                the process's table, parsed from ``STROM_TENANT_SPEC``;
                an unknown id registers on first sight with the
                ``STROM_TENANT_*`` defaults.  Reads take no lock.
  TokenBucket   per-tenant admission rate limiting, with an injectable
                clock.

Everything is inert while ``STROM_TENANTS=0`` (the default): no server
enters a tenant scope, ``current_tenant()`` stays None, and every
consumer's tenant branch falls through to the path without tenants.
The registry's locks come from the lock-order witness's constructors
(utils/lockwitness.py).
"""

from __future__ import annotations

import contextlib
import time
from contextvars import ContextVar
from dataclasses import dataclass
from typing import Dict, List, Optional

from nvme_strom_tpu_torch.utils.lockwitness import make_lock

#: SLO tiers, best first: admission sheds from the back of this list
TIER_ORDER = ("gold", "silver", "bronze")

#: the tier of a tenant that declared none
DEFAULT_TIER = "silver"

#: the SLO governor's bound on boost notches (a tenant's
#: ``share_boost``, the decode class's weight), equal to the JAX
#: package's ``SloGovernor._MAX_BOOST``; ``TenantRegistry.restore_state``
#: and models/kv_offload.py ``SloGovernor`` both read it
SLO_MAX_BOOST = 3


def tier_rank(tier: str) -> int:
    """Position in TIER_ORDER (lower is better); an unknown tier ranks
    worst, so a typo never outranks a declared tier."""
    try:
        return TIER_ORDER.index(tier)
    except ValueError:
        return len(TIER_ORDER)


@dataclass
class Tenant:
    """One tenant's isolation policy.  ``share_boost`` is the SLO
    governor's, changed at run time; the rest is configuration.

    ``weight``      fair-share weight inside each QoS class
                    (io/sched.py); the aging bound holds at any weight.
    ``quota_frac``  residency quota as a fraction of the host tier and
                    of the prefix store (0 = a fair share, 1/N of the
                    tenants resident); free space may be borrowed past
                    it, and pressure reclaims over-quota tenants first.
    ``rate``/``burst``
                    admission token bucket (requests/s, depth); rate 0
                    is unlimited.
    ``slo_p99_ms``  decode TTFT p99 target; a violation boosts only
                    this tenant's share.
    """

    id: str
    tier: str = DEFAULT_TIER
    weight: float = 1.0
    quota_frac: float = 0.0
    rate: float = 0.0
    burst: float = 0.0
    slo_p99_ms: float = 0.0
    share_boost: int = 0

    def __post_init__(self):
        if not self.id:
            raise ValueError("tenant id must be non-empty")
        if self.weight <= 0:
            raise ValueError(
                f"tenant {self.id!r}: weight ({self.weight}) must be "
                f"> 0 (the aging bound protects weight-1 tenants; 0 "
                f"would starve without it)")
        if not 0.0 <= self.quota_frac <= 1.0:
            raise ValueError(
                f"tenant {self.id!r}: quota_frac ({self.quota_frac}) "
                f"must be in [0, 1]")
        if self.rate < 0 or self.burst < 0:
            raise ValueError(
                f"tenant {self.id!r}: rate/burst must be >= 0")
        if self.slo_p99_ms < 0:
            raise ValueError(
                f"tenant {self.id!r}: slo_p99_ms must be >= 0")

    @property
    def effective_weight(self) -> float:
        """The fair-share weight with the SLO governor's boost."""
        return self.weight * (1 + self.share_boost)


def parse_tenant_spec(spec: str) -> Dict[str, Tenant]:
    """Parse ``STROM_TENANT_SPEC``: ``;``-separated tenants, each
    ``<id>[:key=value,...]`` with keys ``tier``/``weight``/``quota``/
    ``rate``/``burst``/``slo_ms``, e.g.
    ``gold_t:tier=gold,weight=8,quota=0.5,slo_ms=50;batch:tier=bronze``.
    Raises ValueError on a malformed entry."""
    out: Dict[str, Tenant] = {}
    for part in filter(None, (s.strip() for s in spec.split(";"))):
        tid, _colon, body = part.partition(":")
        tid = tid.strip()
        kw: Dict[str, object] = {}
        for item in filter(None, (s.strip() for s in body.split(","))):
            key, eq, val = item.partition("=")
            key = key.strip()
            if not eq:
                raise ValueError(
                    f"STROM_TENANT_SPEC entry {item!r}: expected "
                    f"key=value")
            if key == "tier":
                if val not in TIER_ORDER:
                    raise ValueError(
                        f"STROM_TENANT_SPEC tenant {tid!r}: tier "
                        f"{val!r} not in {TIER_ORDER}")
                kw["tier"] = val
            elif key in ("weight", "quota", "rate", "burst", "slo_ms"):
                name = {"quota": "quota_frac",
                        "slo_ms": "slo_p99_ms"}.get(key, key)
                kw[name] = float(val)
            else:
                raise ValueError(
                    f"STROM_TENANT_SPEC tenant {tid!r}: unknown key "
                    f"{key!r}")
        if tid in out:
            raise ValueError(
                f"STROM_TENANT_SPEC: duplicate tenant id {tid!r}")
        out[tid] = Tenant(tid, **kw)
    return out


class TokenBucket:
    """Admission rate limiter: ``rate`` tokens/s refill up to ``burst``
    (at least 1).  ``rate <= 0`` is unlimited.  ``clock`` is injectable
    so tests drive time.  One serving loop takes from it; it is not
    thread-safe by itself."""

    __slots__ = ("rate", "burst", "_tokens", "_t", "_clock")

    def __init__(self, rate: float, burst: float, clock=None):
        self.rate = float(rate)
        self.burst = max(float(burst), 1.0)
        self._clock = clock if clock is not None else time.monotonic
        self._tokens = self.burst
        self._t = self._clock()

    def try_take(self, n: float = 1.0) -> bool:
        if self.rate <= 0:
            return True
        now = self._clock()
        self._tokens = min(self.burst,
                           self._tokens + (now - self._t) * self.rate)
        self._t = now
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False


class TenantRegistry:
    """The process's tenant table.  ``get(id)`` reads a dict with no
    lock (the dict is replaced, never changed in place, when a tenant
    registers); only registration takes the lock."""

    def __init__(self, config=None):
        if config is None:
            from nvme_strom_tpu_torch.utils.config import TenantConfig
            config = TenantConfig()
        self.config = config
        self._lock = make_lock("tenants.TenantRegistry._lock")
        self._tenants: Dict[str, Tenant] = dict(
            parse_tenant_spec(config.spec))

    @property
    def enabled(self) -> bool:
        return self.config.enabled

    def get(self, tid) -> Tenant:
        """Resolve a tenant by id, registering it with the defaults on
        first sight; a Tenant passes through."""
        if isinstance(tid, Tenant):
            return tid
        tid = str(tid)
        t = self._tenants.get(tid)
        if t is not None:
            return t
        with self._lock:
            t = self._tenants.get(tid)
            if t is None:
                cfg = self.config
                t = Tenant(tid, rate=cfg.default_rate,
                           burst=cfg.default_burst,
                           quota_frac=cfg.default_quota_frac)
                nxt = dict(self._tenants)
                nxt[tid] = t
                self._tenants = nxt
            return t

    def lookup(self, tid: str) -> Optional[Tenant]:
        """Resolve without registering: None for an unknown id."""
        return self._tenants.get(str(tid))

    def tenants(self) -> List[Tenant]:
        return list(self._tenants.values())

    def export_state(self) -> Dict[str, dict]:
        """Each tenant's run-time state worth handing to a replacement
        server: the SLO governor's ``share_boost``, for tenants that
        have one."""
        return {t.id: {"share_boost": int(t.share_boost)}
                for t in self._tenants.values() if t.share_boost}

    def restore_state(self, state: Dict[str, dict]) -> int:
        """Apply exported state, each boost capped at SLO_MAX_BOOST and
        never lowering a live one.  Malformed entries are skipped.
        Returns the tenants touched."""
        n = 0
        for tid, st in (state or {}).items():
            try:
                boost = int(st.get("share_boost", 0))
            except (AttributeError, TypeError, ValueError):
                continue
            if boost < 1:
                continue
            t = self.get(tid)
            t.share_boost = max(t.share_boost, min(boost, SLO_MAX_BOOST))
            n += 1
        return n


# -- the contextvar ---------------------------------------------------------

_current: ContextVar[Optional[Tenant]] = ContextVar(
    "strom_tenant", default=None)


def current_tenant() -> Optional[Tenant]:
    """The tenant the running code works for (None outside any scope)."""
    return _current.get()


@contextlib.contextmanager
def tenant_context(tenant: Optional[Tenant]):
    """Enter ``tenant``'s scope: the batches the scheduler queues, the
    lines the host tier fills and the pages the prefix store puts inside
    it are charged to that tenant."""
    token = _current.set(tenant)
    try:
        yield tenant
    finally:
        _current.reset(token)


# -- the process's registry -------------------------------------------------

_registry: Optional[TenantRegistry] = None
_registry_lock = make_lock("tenants._registry_lock")


def get_registry() -> TenantRegistry:
    """The process-wide registry, built from the environment on first
    use (``configure`` replaces it, ``reset`` drops it)."""
    global _registry
    r = _registry
    if r is not None:
        return r
    with _registry_lock:
        if _registry is None:
            _registry = TenantRegistry()
        return _registry


def configure(config) -> TenantRegistry:
    """Install a registry built from an explicit TenantConfig."""
    global _registry
    with _registry_lock:
        _registry = TenantRegistry(config)
        return _registry


def reset() -> None:
    """Drop the registry; the next ``get_registry()`` reads the
    environment again."""
    global _registry
    with _registry_lock:
        _registry = None


def tenants_enabled() -> bool:
    """True only under ``STROM_TENANTS=1`` (or a ``configure`` with
    ``enabled=True``); every entry point that would enter a tenant scope
    checks it first."""
    return get_registry().enabled
