"""The port's tenant layer (nvme_strom_tpu_torch/io/tenants.py and its
consumers: the scheduler's tenant level, the host tier's and the prefix
store's quotas, ``SloGovernor`` and the servers' load shedding and
tenant admission) held against the JAX package's on the same inputs:
the cases of tests/test_tenants.py but its flight dump, each run through
both packages, with spec parses, bucket takes, grant logs, tier
counters, governor boosts, server tokens and shed counts compared
exactly.  The aggressor case asserts the steps before each victim's
first token, not a wall-clock bound.  The model is tiny_config in
float32; every token comparison is exact."""

import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvme_strom_tpu.io import hostcache as j_hostcache
from nvme_strom_tpu.io import sched as j_sched
from nvme_strom_tpu.io import tenants as j_tn
from nvme_strom_tpu.io.engine import StromEngine as JaxEngine
from nvme_strom_tpu.models import transformer as jtr
from nvme_strom_tpu.models.kv_offload import PrefixStore as JaxStore
from nvme_strom_tpu.models.kv_offload import SloGovernor as JaxGovernor
from nvme_strom_tpu.models.serving import DecodeServer as JaxDense
from nvme_strom_tpu.models.serving import PagedDecodeServer as JaxPaged
from nvme_strom_tpu.utils import config as j_config
from nvme_strom_tpu.utils.stats import StromStats as JaxStats
from nvme_strom_tpu_torch.convert import params_from_jax
from nvme_strom_tpu_torch.io import hostcache as p_hostcache
from nvme_strom_tpu_torch.io import sched as p_sched
from nvme_strom_tpu_torch.io import tenants as p_tn
from nvme_strom_tpu_torch.io.engine import StromEngine
from nvme_strom_tpu_torch.models import transformer as ttr
from nvme_strom_tpu_torch.models.kv_offload import PrefixStore, SloGovernor
from nvme_strom_tpu_torch.models.serving import (DecodeServer,
                                                 PagedDecodeServer)
from nvme_strom_tpu_torch.utils import config as p_config
from nvme_strom_tpu_torch.utils.stats import StromStats

PKGS = {
    "jax": types.SimpleNamespace(name="jax", tn=j_tn, sched=j_sched,
                                 hc=j_hostcache, config=j_config,
                                 Stats=JaxStats, Gov=JaxGovernor),
    "port": types.SimpleNamespace(name="port", tn=p_tn, sched=p_sched,
                                  hc=p_hostcache, config=p_config,
                                  Stats=StromStats, Gov=SloGovernor),
}
PAGE = 4
LINE = 4096


@pytest.fixture(autouse=True)
def _port_lock_witness():
    """Each test runs under the port's lock-order witness (the
    counterpart of the reference's chaos suites, which tests/conftest.py
    arms): every lock the port builds in the test records its
    acquisition order, and a cycle fails the test even when this run got
    away with it."""
    from nvme_strom_tpu_torch.utils import lockwitness
    with lockwitness.armed_scope() as w:
        yield w
    assert not w.violations, (
        f"the port's lock-order witness recorded {w.violations}")


@pytest.fixture(autouse=True)
def _registries_reset():
    """Both registries are process-global: every case starts and leaves
    them as the environment makes them (STROM_TENANTS unset: off)."""
    j_tn.reset()
    p_tn.reset()
    yield
    j_tn.reset()
    p_tn.reset()


def _both(case):
    """Run ``case(pkg)`` through both packages; their results must be
    equal.  Returns the port's."""
    got = {name: case(pkg) for name, pkg in PKGS.items()}
    assert got["port"] == got["jax"], got
    return got["port"]


# -- primitives: spec, tiers, buckets, registry -----------------------------

def _tenant_fields(t):
    return dataclasses.asdict(t)


def test_spec_parse_round_trip():
    spec = ("gold_t:tier=gold,weight=8,quota=0.5,slo_ms=50;"
            "batch:tier=bronze,rate=10,burst=4; spaced : weight=2 ")
    t = _both(lambda m: {k: _tenant_fields(v) for k, v in
                         m.tn.parse_tenant_spec(spec).items()})
    assert set(t) == {"gold_t", "batch", "spaced"}
    g = t["gold_t"]
    assert (g["tier"], g["weight"], g["quota_frac"], g["slo_p99_ms"]) == \
        ("gold", 8.0, 0.5, 50.0)
    assert (t["batch"]["tier"], t["batch"]["rate"], t["batch"]["burst"]) \
        == ("bronze", 10.0, 4.0)
    assert t["spaced"]["tier"] == p_tn.DEFAULT_TIER == j_tn.DEFAULT_TIER
    assert p_tn.parse_tenant_spec("") == {}


@pytest.mark.parametrize("bad", [
    "x:tier=platinum", "x:weight=0", "x:quota=1.5", "x:rate=-1",
    "x:frobnicate=1", "x:tier", "a:weight=1;a:weight=2",
], ids=["tier", "weight0", "quota", "rate", "key", "noeq", "dup"])
def test_spec_rejects_malformed(bad):
    def case(m):
        with pytest.raises(ValueError) as e:
            m.tn.parse_tenant_spec(bad)
        return str(e.value)
    _both(case)


def test_tier_rank_orders_and_defends_typos():
    tiers = list(p_tn.TIER_ORDER) + ["goldd", "", "platinum"]
    ranks = _both(lambda m: [m.tn.tier_rank(t) for t in tiers])
    assert p_tn.TIER_ORDER == j_tn.TIER_ORDER
    assert ranks[:3] == sorted(ranks[:3])
    assert ranks[3] > ranks[2]


def test_token_bucket_injectable_clock():
    """The same script of clock advances and takes gives the same
    answers in both packages."""
    rng = np.random.default_rng(11)
    script = [(float(rng.choice([0.0, 0.1, 0.25, 0.5])), int(rng.integers(
        1, 3))) for _ in range(40)]

    def case(m):
        clk = [0.0]
        b = m.tn.TokenBucket(rate=2.0, burst=2.0, clock=lambda: clk[0])
        out = [b.try_take(), b.try_take(), b.try_take()]
        for dt, n in script:
            clk[0] += dt
            out.append(b.try_take(n))
        free = m.tn.TokenBucket(0.0, 0.0)
        out.append(all(free.try_take() for _ in range(100)))
        return out
    out = _both(case)
    assert out[:3] == [True, True, False]


def test_registry_lazy_registration_uses_defaults():
    def case(m):
        reg = m.tn.configure(m.config.TenantConfig(
            enabled=True, spec="named:tier=gold,rate=99",
            default_rate=3.0, default_burst=2.0, default_quota_frac=0.25))
        assert m.tn.tenants_enabled()
        assert reg.lookup("stranger") is None
        s = reg.get("stranger")
        assert reg.get(s) is s and reg.lookup("stranger") is s
        assert m.tn.current_tenant() is None
        seen = []
        with m.tn.tenant_context(s):
            seen.append(m.tn.current_tenant().id)
            with m.tn.tenant_context(reg.get("named")):
                seen.append(m.tn.current_tenant().id)
            seen.append(m.tn.current_tenant().id)
        assert m.tn.current_tenant() is None
        return (reg.get("named").rate, _tenant_fields(s), seen,
                sorted(t.id for t in reg.tenants()))
    named_rate, s, seen, ids = _both(case)
    assert named_rate == 99.0
    assert (s["rate"], s["burst"], s["quota_frac"]) == (3.0, 2.0, 0.25)
    assert seen == ["stranger", "named", "stranger"]


def test_tenant_config_reads_the_same_environment(monkeypatch):
    for k, v in {"STROM_TENANTS": "1", "STROM_TENANT_SPEC": "a:tier=gold",
                 "STROM_TENANT_RATE": "4", "STROM_TENANT_BURST": "3",
                 "STROM_TENANT_QUOTA_FRAC": "0.5",
                 "STROM_TENANT_STORM_SHEDS": "7"}.items():
        monkeypatch.setenv(k, v)
    _both(lambda m: dataclasses.asdict(m.config.TenantConfig()))
    monkeypatch.setenv("STROM_TENANT_QUOTA_FRAC", "2")
    for m in PKGS.values():
        with pytest.raises(ValueError):
            m.config.TenantConfig()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_export_restore_state_across_packages(writer):
    """A registry's boosts, exported by one package, restored by the
    other: the same tenants touched, each boost capped at the same
    bound, malformed entries skipped."""
    src, dst = (PKGS["jax"], PKGS["port"]) if writer == "jax" else \
        (PKGS["port"], PKGS["jax"])
    reg = src.tn.configure(src.config.TenantConfig(
        enabled=True, spec="a:tier=gold;b;c"))
    reg.get("a").share_boost = 2
    reg.get("c").share_boost = 1
    state = reg.export_state()
    assert state == {"a": {"share_boost": 2}, "c": {"share_boost": 1}}
    state = {**state, "d": {"share_boost": 99}, "e": "junk",
             "f": {"share_boost": "x"}, "g": {"share_boost": 0}}
    out = reg_out = None
    for m in (dst, src):
        r = m.tn.configure(m.config.TenantConfig(enabled=True))
        n = r.restore_state(state)
        got = {t.id: t.share_boost for t in r.tenants()}
        if m is dst:
            out, reg_out = n, got
        else:
            assert (n, got) == (out, reg_out)
    assert out == 3
    assert reg_out == {"a": 2, "c": 1, "d": 3}


def test_boost_cap_equals_jax():
    assert p_tn.SLO_MAX_BOOST == JaxGovernor._MAX_BOOST
    assert SloGovernor._MAX_BOOST == JaxGovernor._MAX_BOOST
    assert SloGovernor._MIN_INTERVAL_S == JaxGovernor._MIN_INTERVAL_S


# -- scheduler: the tenant level of the fair share --------------------------

class _Fake:
    """Records grants; capacity is a mutable list of free slots."""

    def __init__(self, slots):
        self.slots = list(slots)
        self.granted = []

    def submit_ring(self, spans, ring):
        self.granted.append((tuple(spans), ring))
        return ["pend"] * len(spans)

    def ring_free(self):
        return list(self.slots)


def _sched(m, fake, aging=16, cap=None, stats=None):
    """A scheduler over ``fake`` whose grants, in order, are logged as
    (first span's name, ring, promoted) in ``fake.granted``."""
    s = m.sched.QoSScheduler(fake.submit_ring, fake.ring_free,
                             aging_rounds=aging, ring_cap=cap, stats=stats)
    grant = s._dispatch_one

    def logged(b, ring, promoted=False):
        fake.granted.append((b.spans[0][0], ring, promoted))
        grant(b, ring, promoted)
    s._dispatch_one = logged
    return s


def test_hierarchical_fair_share_splits_class_grants_by_weight():
    """Two tenants saturating one class (restore, weight 4: 4 grants a
    round) split its grants 4:1 by tenant weight, in the same order in
    both packages."""
    def case(m):
        heavy, light = m.tn.Tenant("heavy", weight=4.0), m.tn.Tenant("light")
        fake, stats = _Fake([100]), m.Stats()
        s = _sched(m, fake, cap=100, stats=stats)
        hb, lb = [], []
        for i in range(40):
            with m.tn.tenant_context(heavy):
                hb.append(s.enqueue([("h", i, 1)], "restore"))
            with m.tn.tenant_context(light):
                lb.append(s.enqueue([("l", i, 1)], "restore"))
        acked = set()
        for _ in range(5):
            fake.slots = [100]
            s.step()
            for b in hb + lb:
                if b.granted and id(b) not in acked:
                    acked.add(id(b))
                    s.ack_submitted(b)
        return (sum(b.granted for b in hb), sum(b.granted for b in lb),
                fake.granted, stats.tenant_stats)
    h_n, l_n, _log, per = _both(case)
    assert h_n == 4 * l_n and l_n == 4
    assert per["heavy"]["dispatches"] == h_n


def test_tenant_starvation_bound_survives_any_weight_skew():
    """A weight-1 tenant's batch is granted within K + 1 rounds against
    a weight-1000 tenant: the aging pass runs before the tenant pick."""
    K = 4

    def case(m):
        hog = m.tn.Tenant("hog", weight=1000.0)
        meek = m.tn.Tenant("meek", weight=1.0)
        fake = _Fake([2])
        s = _sched(m, fake, aging=K, cap=2)
        with m.tn.tenant_context(meek):
            b0 = s.enqueue([("m", 0, 1)], "restore")
        s.step()
        assert b0.granted
        s.ack_submitted(b0)
        with m.tn.tenant_context(meek):
            b1 = s.enqueue([("m", 1, 1)], "restore")
        rounds = None
        for rnd in range(K + 2):
            with m.tn.tenant_context(hog):
                s.enqueue([(f"h{rnd}", 0, 1)], "restore")
            fake.slots = [2]
            s.step()
            if b1.granted and rounds is None:
                rounds = rnd + 1
        return (b1.granted, rounds, b1.promoted, s.promotions,
                fake.granted)
    granted, rounds, promoted, promotions, _log = _both(case)
    assert granted and rounds <= K + 1
    assert promoted and promotions == 1


def test_scheduler_without_tenants_is_exact_fifo():
    def case(m):
        fake = _Fake([2])
        s = _sched(m, fake, cap=2)
        bs = [s.enqueue([(f"b{i}", i, 1)], "restore") for i in range(4)]
        order = []
        for _ in range(4):
            fake.slots = [2]
            s.step()
            for i, b in enumerate(bs):
                if b.granted and i not in order:
                    order.append(i)
                    s.ack_submitted(b)
        assert not s._tenant_seen
        return order, fake.granted
    order, _log = _both(case)
    assert order == [0, 1, 2, 3]


def test_top_class_grants_are_tenant_fair():
    """The decode class is never admission-queued, but its grant order
    inside one round follows the tenant banks too."""
    def case(m):
        a, b = m.tn.Tenant("a", weight=1.0), m.tn.Tenant("b", weight=3.0)
        fake = _Fake([64, 64])
        s = _sched(m, fake, cap=64)
        for i in range(6):
            with m.tn.tenant_context(a):
                s.enqueue([("a", i, 1)], "decode")
        for i in range(6):
            with m.tn.tenant_context(b):
                s.enqueue([("b", i, 1)], "decode")
        s.step()
        return [name for name, _ring, _promoted in fake.granted]
    order = _both(case)
    assert sorted(order) == ["a"] * 6 + ["b"] * 6
    assert order[:2] == ["a", "b"]


# -- host tier: per-tenant residency quotas ---------------------------------

def test_hostcache_aggressor_pays_for_its_own_borrowing():
    """An aggressor's fills past its quota are reclaimed from its own
    lines; the victim's set stays resident, with no quota eviction
    charged to it.  Counters, per-tenant tallies and resident lines are
    equal across the packages."""
    def case(m):
        victim = m.tn.Tenant("victim", quota_frac=0.5)
        aggr = m.tn.Tenant("aggr", quota_frac=0.25)
        stats = m.Stats()
        hc = m.hc.HostCache(LINE, 8 * LINE, quotas={"prefetch": 1.0},
                            lock_arena=False)
        pay = np.zeros(LINE, np.uint8)
        fills = []
        with m.tn.tenant_context(victim):
            fills += [hc.fill(("v", 1), i * LINE, pay, "prefetch",
                              stats=stats) for i in range(3)]
        with m.tn.tenant_context(aggr):
            fills += [hc.fill(("a", 2), i * LINE, pay, "prefetch",
                              stats=stats) for i in range(10)]
        snap = stats.snapshot()
        hits = []
        for i in range(3):
            segs, _ = hc.probe_range(("v", 1), i * LINE, LINE, "prefetch")
            hits.append(segs[0][0])
            hc.unpin(segs[0][3])
        out = ({k: snap[k] for k in ("tenant_borrows",
                                     "tenant_quota_evictions",
                                     "cache_evictions", "cache_admissions")},
               stats.tenant_stats, hc.counters()["tenant_slots"],
               sorted(hc._lines), fills, hits)
        hc.close()
        return out
    snap, per, slots, lines, fills, hits = _both(case)
    assert all(fills)
    assert snap["tenant_borrows"] > 0 and snap["tenant_quota_evictions"] > 0
    assert per["aggr"]["quota_evictions"] == snap["tenant_quota_evictions"]
    assert "quota_evictions" not in per.get("victim", {})
    assert hits == ["hit"] * 3
    assert slots["victim"] == 3
    assert [k for k in lines if k[0] == ("v", 1)] == \
        [(("v", 1), i * LINE) for i in range(3)]


def test_hostcache_sticky_line_of_an_over_quota_tenant_is_reclaimed():
    """``hot`` does not protect an over-quota tenant's lines."""
    def case(m):
        aggr = m.tn.Tenant("aggr", quota_frac=0.25)
        victim = m.tn.Tenant("victim", quota_frac=0.75)
        stats = m.Stats()
        hc = m.hc.HostCache(LINE, 4 * LINE, quotas={"prefetch": 1.0},
                            lock_arena=False)
        pay = np.ones(LINE, np.uint8)
        with m.tn.tenant_context(aggr):
            for i in range(3):
                hc.fill(("a", 2), i * LINE, pay, "prefetch", stats=stats,
                        sticky=True)
        with m.tn.tenant_context(victim):
            for i in range(3):
                hc.fill(("v", 1), i * LINE, pay, "prefetch", stats=stats)
        out = (stats.snapshot()["tenant_quota_evictions"],
               hc.counters()["tenant_slots"], sorted(hc._lines))
        hc.close()
        return out
    evicted, slots, _lines = _both(case)
    assert evicted >= 2 and slots["victim"] == 3


def test_hostcache_without_tenant_scope_has_no_tenant_state():
    def case(m):
        hc = m.hc.HostCache(LINE, 4 * LINE, quotas={"prefetch": 1.0},
                            lock_arena=False)
        ok = hc.fill(("p", 3), 0, np.zeros(LINE, np.uint8), "prefetch")
        out = (ok, hc.counters()["tenant_slots"], hc._lines[(("p", 3), 0)]
               .tenant)
        hc.close()
        return out
    assert _both(case) == (True, {}, None)


# -- the SLO governor -------------------------------------------------------

class _Sched:
    def __init__(self, m):
        self.policies = m.sched.default_policies()

    def set_weight(self, klass, weight):
        self.policies[klass] = dataclasses.replace(self.policies[klass],
                                                   weight=weight)


class _Eng:
    """An engine with both levers of the JAX governor (the port's
    engine has only the scheduler; the hedge budget comes with
    resilience)."""

    supervisor = None
    flight = None

    def __init__(self, m, hedge=True):
        self.scheduler = _Sched(m)
        self.hedge_budgets = {"decode": 8}
        self.budget_calls = []
        if not hedge:
            self.set_hedge_budget = None

    def set_hedge_budget(self, klass, n):
        self.budget_calls.append((klass, n))
        self.hedge_budgets[klass] = n


@pytest.mark.parametrize("hedge", [True, False], ids=["levers", "sched"])
def test_slo_governor_boosts_and_decays(hedge):
    """A p99 past the target raises the decode weight (and the hedge
    budget where the engine has one) a notch, capped; under half the
    target it decays back; no target is inert.  The same samples give
    the same weights, budgets and boosts in both packages."""
    samples = [50.0] * 5 + [7.0, 4.0, 1.0, 1.0, 1.0, 1.0]

    def case(m):
        eng, stats = _Eng(m, hedge), m.Stats()
        gov = m.Gov(target_ms=10.0)
        gov._MIN_INTERVAL_S = 0.0
        trace = []
        for p in samples:
            gov.observe(eng, p, stats)
            trace.append((gov.boost,
                          eng.scheduler.policies["decode"].weight,
                          eng.hedge_budgets["decode"]))
        inert = m.Gov(target_ms=0.0)
        inert.observe(eng, 1e9, stats)
        return trace, stats.snapshot()["kv_slo_boosts"], inert.boost
    trace, boosts, inert = _both(case)
    base = p_sched.default_policies()["decode"].weight
    assert trace[0][:2] == (1, 2 * base)
    assert max(b for b, _w, _h in trace) == p_tn.SLO_MAX_BOOST
    assert trace[-1][:2] == (0, base)
    assert boosts == p_tn.SLO_MAX_BOOST and inert == 0


def test_slo_governor_rate_limited():
    def case(m):
        eng = _Eng(m, hedge=False)
        gov = m.Gov(target_ms=10.0)
        gov.observe(eng, 50.0)
        gov.observe(eng, 50.0)       # inside the interval: no-op
        return gov.boost
    assert _both(case) == 1


def test_observe_tenant_boosts_share_only_and_decays():
    def case(m):
        eng, stats = _Eng(m), m.Stats()
        gov = m.Gov(0.0)
        t = m.tn.Tenant("slo_t", slo_p99_ms=50.0)
        trace = []
        gov.observe_tenant(eng, t, 120.0, stats=stats)
        trace.append((t.share_boost, t.effective_weight))
        gov.observe_tenant(eng, t, 120.0, stats=stats)   # rate-limited
        trace.append(t.share_boost)
        for _ in range(5):                               # up to the cap
            gov._tenant_last[t.id] = 0.0
            gov.observe_tenant(eng, t, 120.0, stats=stats)
        trace.append(t.share_boost)
        gov._tenant_last[t.id] = 0.0
        gov.observe_tenant(eng, t, 10.0, stats=stats)    # recovery
        trace.append(t.share_boost)
        return (trace, eng.budget_calls, stats.snapshot()["tenant_slo_boosts"],
                stats.tenant_stats, gov.boost,
                eng.scheduler.policies["decode"].weight)
    trace, calls, boosts, per, dev_boost, _w = _both(case)
    assert trace == [(1, 2.0), 1, p_tn.SLO_MAX_BOOST,
                     p_tn.SLO_MAX_BOOST - 1]
    assert calls == [] and dev_boost == 0
    assert boosts == p_tn.SLO_MAX_BOOST == per["slo_t"]["slo_boosts"]


def test_observe_tenant_gated_by_sick_device():
    def case(m):
        sick = types.SimpleNamespace(
            supervisor=types.SimpleNamespace(unhealthy=lambda: True),
            flight=None)
        gov = m.Gov(0.0)
        t = m.tn.Tenant("gated", slo_p99_ms=50.0)
        gov.observe_tenant(sick, t, 500.0)
        return t.share_boost
    assert _both(case) == 0


def test_kv_p99_target_drives_the_store_governor(monkeypatch, tmp_path):
    """``STROM_KV_P99_MS`` is accepted, as the JAX config accepts it, and
    the factory hands it to the store's governor."""
    from nvme_strom_tpu_torch.models.kv_offload import build_prefix_store
    monkeypatch.setenv("STROM_KV_P99_MS", "5")
    assert p_config.KVServeConfig().p99_target_ms == \
        j_config.KVServeConfig().p99_target_ms == 5.0
    monkeypatch.setenv("STROM_KV_PREFIX", "1")
    cfg = dataclasses.replace(ttr.tiny_config(), dtype=torch.float32)
    eng = StromEngine(p_config.EngineConfig(chunk_bytes=1 << 20,
                                            buffer_pool_bytes=8 << 20))
    st = build_prefix_store(cfg, eng, str(tmp_path / "s.kvstore"), PAGE)
    assert st.slo.target_ms == 5.0
    st.close()
    st = build_prefix_store(cfg, eng, str(tmp_path / "t.kvstore"), PAGE,
                            kvcfg=p_config.KVServeConfig(p99_target_ms=2.0))
    assert st.slo.target_ms == 2.0 and st.slo.boost == 0
    st.close()
    eng.close_all()


def test_governor_fires_through_a_real_restore_on_the_multi_ring_engine(
        tmp_path):
    """A store over the port's two-ring engine with a target no restore
    can meet: the restore batch's p99 raises the decode class's weight
    on the engine's own scheduler."""
    cfg = dataclasses.replace(ttr.tiny_config(), dtype=torch.float32)
    eng = StromEngine(p_config.EngineConfig(
        chunk_bytes=1 << 20, buffer_pool_bytes=16 << 20, n_rings=2))
    assert eng.scheduler is not None
    base = eng.scheduler.policies["decode"].weight
    st = PrefixStore(cfg, eng, str(tmp_path / "g.kvstore"), PAGE, 1 << 20,
                     p99_target_ms=1e-6)
    shape = (cfg.n_layers, cfg.n_kv_heads, PAGE, cfg.head_dim)
    gen = torch.Generator().manual_seed(3)
    keys = st.chain_keys(list(range(2 * PAGE + 1)))
    st.put([(kx, torch.randn(shape, generator=gen),
             torch.randn(shape, generator=gen)) for kx in keys])
    got = st.restore_many({0: (0, keys)}, device="cpu")[0]
    assert sorted(got) == [0, 1]
    assert st.slo.boost == 1
    assert eng.scheduler.policies["decode"].weight == 2 * base
    assert eng.stats.kv_slo_boosts == 1
    st.close()
    eng.close_all()


# -- servers: tier shed, token buckets, shed probe, inert off ---------------

@pytest.fixture(scope="module")
def setup():
    cfg_j = jtr.TransformerConfig(**{**jtr.tiny_config().__dict__,
                                     "dtype": jnp.float32})
    cfg_t = dataclasses.replace(ttr.tiny_config(), dtype=torch.float32)
    pj = jtr.init_params(jax.random.key(0), cfg_j)
    pt = params_from_jax({k: np.asarray(v) for k, v in pj.items()}, cfg_t,
                         "cpu")
    return cfg_j, cfg_t, pj, pt


def _server(setup, pkg, paged=False, **kw):
    cfg_j, cfg_t, pj, pt = setup
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_len", 96)
    if pkg == "jax":
        if paged:
            return JaxPaged(pj, cfg_j, total_blocks=64, block_len=8, **kw)
        return JaxDense(pj, cfg_j, **kw)
    if paged:
        return PagedDecodeServer(pt, cfg_t, total_blocks=64, block_len=8,
                                 device="cpu", **kw)
    return DecodeServer(pt, cfg_t, device="cpu", **kw)


def _configure(pkg, **kw):
    m = PKGS[pkg]
    return m.tn.configure(m.config.TenantConfig(enabled=True, **kw))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_admission_sheds_worst_tier_under_pressure(setup, paged):
    """More queued than free: only the best tier present admits; the
    bronze requests stay queued and finish once the gold backlog
    drains, with tokens equal to an untenanted run and to the JAX
    server's."""
    cfg_t = setup[1]
    rng = np.random.default_rng(5)
    prompts = {f"r{i}": rng.integers(0, cfg_t.vocab, 5 + i).tolist()
               for i in range(4)}

    def case(pkg):
        _configure(pkg, spec="gold_t:tier=gold;bronze_t:tier=bronze")
        srv = _server(setup, pkg, paged=paged)
        srv.submit("r0", prompts["r0"], 4, tenant="bronze_t")
        srv.submit("r1", prompts["r1"], 4, tenant="bronze_t")
        srv.submit("r2", prompts["r2"], 4, tenant="gold_t")
        first = srv.step()
        admitted = sorted(r.rid for r in srv.slots if r is not None)
        sheds, queued = dict(srv.tenant_sheds), len(srv.queue)
        srv.submit("r3", prompts["r3"], 4, tenant="gold_t")
        got = srv.run()
        got.update(first)
        st = srv.stats()
        plain = _server(setup, pkg, paged=paged)
        for rid, p in prompts.items():
            plain.submit(rid, p, 4)
        return (admitted, sheds, queued, got, st["tenant_sheds"],
                st["admissions_shed"], plain.run() == got)
    admitted, sheds, queued, got, st_sheds, shed_n, same = _both(
        lambda m: case(m.name))
    assert admitted == ["r2"] and sheds == {"bronze_t": 2} and queued == 2
    assert set(got) == set(prompts)
    assert st_sheds["bronze_t"] >= 2 and shed_n == sum(st_sheds.values())
    assert same


def test_admission_token_bucket_sheds_without_blocking_queue(setup):
    """An empty bucket passes over its tenant's request; the tenant
    behind it still admits this step."""
    cfg_t = setup[1]
    p = np.random.default_rng(6).integers(0, cfg_t.vocab, 5).tolist()

    def case(pkg):
        _configure(pkg, spec="throttled:rate=0.001,burst=1;other:tier=silver")
        srv = _server(setup, pkg)
        srv.submit("t0", p, 3, tenant="throttled")
        srv.submit("t1", p, 3, tenant="throttled")
        srv.submit("o0", p, 3, tenant="other")
        srv.step()
        return (sorted(r.rid for r in srv.slots if r is not None),
                dict(srv.tenant_sheds), srv.admissions_shed)
    admitted, sheds, n = _both(lambda m: case(m.name))
    assert admitted == ["o0", "t0"]
    assert sheds.get("throttled", 0) >= 1 and "other" not in sheds
    assert n == sum(sheds.values())


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_tenants_off_is_bit_for_bit_inert(setup, paged):
    """STROM_TENANTS unset: tenant tags change nothing, and no tenant
    state appears in the server or its stats."""
    assert not p_tn.tenants_enabled()
    cfg_t = setup[1]
    rng = np.random.default_rng(7)
    reqs = {f"q{i}": rng.integers(0, cfg_t.vocab, 4 + i).tolist()
            for i in range(3)}
    srv_t = _server(setup, "port", paged=paged)
    srv_p = _server(setup, "port", paged=paged)
    for rid, p in reqs.items():
        srv_t.submit(rid, p, 5, tenant="someone")
        srv_p.submit(rid, p, 5)
    assert all(r.tenant is None for r in srv_t.queue)
    assert srv_t.run() == srv_p.run()
    assert srv_t.tenant_sheds == {} and srv_t._buckets == {}
    assert "tenant_sheds" not in srv_t.stats()
    assert set(srv_t.stats()) == set(srv_p.stats())
    assert p_tn.current_tenant() is None


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_shed_probe_defers_then_admits(setup, paged):
    """While the probe says shed, nothing admits and the request waits;
    once it clears the request runs to its end, as on the JAX server."""
    def case(pkg):
        degraded = {"on": True}
        srv = _server(setup, pkg, paged=paged, max_len=32,
                      shed_probe=lambda: degraded["on"])
        srv.submit("r1", [1, 2, 3], 4)
        srv.step()
        held = (all(s is None for s in srv.slots), len(srv.queue),
                srv.admissions_shed, srv.stats()["admissions_shed"])
        degraded["on"] = False
        return held, srv.run()
    held, out = _both(lambda m: case(m.name))
    assert held == (True, 1, 1, 1)
    assert set(out) == {"r1"} and len(out["r1"]) == 4


def test_shed_probe_counts_on_the_store_engine(setup, tmp_path):
    """A shed with a store attached counts ``serve_admissions_shed`` on
    the store's engine."""
    cfg_t = setup[1]
    eng = StromEngine(p_config.EngineConfig(chunk_bytes=1 << 20,
                                            buffer_pool_bytes=8 << 20))
    st = PrefixStore(cfg_t, eng, str(tmp_path / "s.kvstore"), PAGE, 1 << 20)
    gate = {"on": True}
    srv = _server(setup, "port", kv_store=st, shed_probe=lambda: gate["on"])
    srv.submit("a", [1, 2, 3, 4, 5, 6], 2)
    srv.submit("b", [7, 8, 9], 2)
    srv.step()
    srv.step()
    assert eng.stats.serve_admissions_shed == 4 == srv.admissions_shed
    gate["on"] = False
    assert set(srv.run()) == {"a", "b"}
    st.close()
    eng.close_all()


def test_storm_window_closes_at_the_threshold(setup):
    """The storm windows the flight dump will read: a tenant's sheds
    since its window opened, reset when they reach
    STROM_TENANT_STORM_SHEDS; the shed counters as the JAX server's."""
    def case(pkg):
        _configure(pkg, storm_sheds=4)
        srv = _server(setup, pkg)
        stats = PKGS[pkg].Stats()
        srv._engine_stats = lambda: stats
        srv._note_tenant_shed({"noisy": 3})
        w1 = dict(srv._storm_window)
        srv._note_tenant_shed({"noisy": 2, "meek": 1})
        w2 = dict(srv._storm_window)
        snap = stats.snapshot()
        return (w1, w2, dict(srv.tenant_sheds), srv.admissions_shed,
                snap["tenant_admissions_shed"],
                {t: v["admissions_shed"]
                 for t, v in stats.tenant_stats.items()})
    w1, w2, sheds, n, total, per = _both(lambda m: case(m.name))
    assert w1 == {"noisy": 3} and w2 == {"noisy": 0, "meek": 1}
    assert sheds == {"noisy": 5, "meek": 1} == per
    assert n == total == 6


def _first_token_steps(srv, victims):
    """Step to the end; the step count at which each victim's first
    token reached the host."""
    first, got, steps = {}, {}, 0
    while not srv.idle:
        done = srv.step()
        steps += 1
        got.update(done)
        for r in srv.slots:
            if r is not None and r.out and r.rid not in first:
                first[r.rid] = steps
        for rid in done:
            first.setdefault(rid, steps)
        assert steps < 500
    return {r: first[r] for r in victims}, got


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_aggressor_tenant_cannot_move_victim(setup, paged):
    """A bronze tenant floods the server with long prompts ahead of a
    gold victim.  Exact checks instead of a latency bound: the steps
    before each victim's first token are the same as without the
    aggressor, every shed falls on the aggressor, the victim's tokens
    are identical, every aggressor completes; and all of it equals the
    JAX server's."""
    cfg_t = setup[1]
    rng = np.random.default_rng(9)
    victims = {f"v{i}": rng.integers(0, cfg_t.vocab, 6).tolist()
               for i in range(8)}
    aggrs = {f"a{i}": rng.integers(0, cfg_t.vocab, 8).tolist()
             for i in range(5)}

    def run(pkg, with_aggr):
        _configure(pkg, spec="victim:tier=gold;aggr:tier=bronze")
        srv = _server(setup, pkg, paged=paged)
        if with_aggr:
            for rid, p in aggrs.items():
                srv.submit(rid, p, 3, tenant="aggr")
        for rid, p in victims.items():
            srv.submit(rid, p, 4, tenant="victim")
        steps, got = _first_token_steps(srv, victims)
        return steps, got, dict(srv.tenant_sheds)

    def case(pkg):
        return run(pkg, False), run(pkg, True)
    (steps_alone, got_alone, sheds_alone), (steps, got, sheds) = _both(
        lambda m: case(m.name))
    assert sheds_alone == {}
    assert set(sheds) == {"aggr"} and sheds["aggr"] > 0
    assert steps == steps_alone
    for rid in victims:
        assert got[rid] == got_alone[rid], rid
    assert all(rid in got for rid in aggrs)


# -- the prefix store: tenant charge and quota pre-pass ---------------------

def _store_pages(cfg_t, n, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg_t.n_layers, cfg_t.n_kv_heads, PAGE, cfg_t.head_dim)
    return [tuple(rng.standard_normal(shape).astype(np.float32)
                  for _ in range(2)) for _ in range(n)]


def test_prefix_store_tenant_charge_and_quota_prepass(setup, tmp_path):
    """A victim's pages, then an aggressor's past its quota in a full
    store: every eviction is the aggressor's own (``tenant_quota_
    evictions``), the victim's pages stay resident, each entry carries
    its tenant, and the page file and the manifest equal the JAX
    store's byte for byte."""
    cfg_j, cfg_t = setup[0], setup[1]
    pages = _store_pages(cfg_t, 10, 21)
    tokens = list(range(10 * PAGE + 1))
    out = {}
    for pkg in ("jax", "port"):
        m = PKGS[pkg]
        path = str(tmp_path / f"{pkg}.kvstore")
        if pkg == "jax":
            eng = JaxEngine(j_config.EngineConfig(
                chunk_bytes=1 << 20, buffer_pool_bytes=8 << 20),
                stats=JaxStats())
            st = JaxStore(cfg_j, eng, path, PAGE, 6 * _page_bytes(cfg_t))
            wrap = (lambda k, v: (k, v))
        else:
            eng = StromEngine(p_config.EngineConfig(
                chunk_bytes=1 << 20, buffer_pool_bytes=8 << 20))
            st = PrefixStore(cfg_t, eng, path, PAGE, 6 * _page_bytes(cfg_t))
            wrap = (lambda k, v: (torch.from_numpy(k), torch.from_numpy(v)))
        keys = st.chain_keys(tokens)
        victim = m.tn.Tenant("victim", quota_frac=0.5)
        aggr = m.tn.Tenant("aggr", quota_frac=0.25)
        with m.tn.tenant_context(victim):
            st.put([(keys[i], *wrap(*pages[i])) for i in range(3)])
        with m.tn.tenant_context(aggr):
            for i in range(3, 10):
                st.put([(keys[i], *wrap(*pages[i]))])
        st.flush()
        owners = {keys.index(kx): e["tenant"]
                  for kx, e in st._entries.items()}
        per = eng.stats.tenant_stats
        snap = eng.stats.snapshot()
        st.close()
        eng.close_all()
        with open(path, "rb") as f:
            data = f.read()
        with open(path + ".kvman.json", "rb") as f:
            man = f.read()
        out[pkg] = (owners, snap["tenant_quota_evictions"],
                    snap["kv_store_evictions"], per, data, man)
    assert out["port"] == out["jax"]
    owners, quota_ev, ev, per, _data, _man = out["port"]
    assert quota_ev == ev == 4 == per["aggr"]["quota_evictions"]
    assert [owners.get(i) for i in range(3)] == ["victim"] * 3
    assert set(owners.values()) == {"victim", "aggr"}


def _page_bytes(cfg):
    return (2 * cfg.n_layers * cfg.n_kv_heads * PAGE * cfg.head_dim
            * torch.empty(0, dtype=cfg.dtype).element_size())


def test_store_without_tenants_writes_the_same_files(setup, tmp_path):
    """STROM_TENANTS unset, tenant-tagged requests through a server with
    a store: the page file and manifest equal an untagged run's, and no
    entry carries a tenant."""
    cfg_t = setup[1]
    rng = np.random.default_rng(12)
    sys_prompt = rng.integers(0, cfg_t.vocab, 3 * PAGE).tolist()
    reqs = {f"s{i}": sys_prompt + rng.integers(0, cfg_t.vocab, 2 + i)
            .tolist() for i in range(3)}
    files = []
    for tagged in (True, False):
        eng = StromEngine(p_config.EngineConfig(chunk_bytes=1 << 20,
                                                buffer_pool_bytes=8 << 20))
        path = str(tmp_path / f"{tagged}.kvstore")
        st = PrefixStore(cfg_t, eng, path, PAGE, 1 << 20)
        srv = _server(setup, "port", kv_store=st)
        for rid, p in reqs.items():
            srv.submit(rid, p, 3, **({"tenant": "t"} if tagged else {}))
        toks = srv.run()
        assert all(e["tenant"] is None for e in st._entries.values())
        st.close()
        eng.close_all()
        with open(path, "rb") as f, open(path + ".kvman.json", "rb") as g:
            files.append((toks, f.read(), g.read()))
    assert files[0] == files[1]


def test_server_tenant_scope_charges_store_pages(setup, tmp_path):
    """Under STROM_TENANTS=1 the pages an admission puts are charged to
    its tenant, and the restore of a returning request runs in the
    tenant's scope; tokens equal the untenanted run's."""
    cfg_t = setup[1]
    _configure("port", spec="gold_t:tier=gold")
    rng = np.random.default_rng(14)
    prompt = rng.integers(0, cfg_t.vocab, 3 * PAGE + 2).tolist()
    eng = StromEngine(p_config.EngineConfig(chunk_bytes=1 << 20,
                                            buffer_pool_bytes=8 << 20))
    st = PrefixStore(cfg_t, eng, str(tmp_path / "t.kvstore"), PAGE, 1 << 20)
    seen = []
    restore = st.restore_many

    def spy(*a, **k):
        seen.append(p_tn.current_tenant().id)
        return restore(*a, **k)
    st.restore_many = spy
    srv = _server(setup, "port", kv_store=st)
    srv.submit("a", prompt, 3, tenant="gold_t")
    a = srv.run()["a"]
    assert {e["tenant"] for e in st._entries.values()} == {"gold_t"}
    srv.submit("b", prompt, 3, tenant="gold_t")
    assert srv.run()["b"] == a
    assert seen == ["gold_t"]
    assert eng.stats.kv_pages_restored == 3
    assert eng.stats.tenant_stats["gold_t"]["requests_finished"] == 2
    plain = _server(setup, "port")
    plain.submit("a", prompt, 3)
    assert plain.run()["a"] == a
    st.close()
    eng.close_all()


def test_tenant_ttft_feeds_the_governor(setup, tmp_path):
    """Once a tenant has 8 TTFT samples, their p99 goes to the store's
    governor: a target no request can meet boosts the tenant's share,
    with the JAX server's count on the same requests."""
    cfg_t = setup[1]
    rng = np.random.default_rng(15)
    prompts = [rng.integers(0, cfg_t.vocab, 5).tolist() for _ in range(8)]

    def case(pkg):
        reg = _configure(pkg, spec="slo:tier=gold,slo_ms=0.0001")
        m = PKGS[pkg]
        store = types.SimpleNamespace(
            slo=m.Gov(0.0), engine=types.SimpleNamespace(stats=m.Stats()),
            chain_keys=lambda p: [], page_tokens=PAGE, stats=m.Stats())
        srv = _server(setup, pkg, max_batch=8)
        srv.kv_store = store
        for i, p in enumerate(prompts):
            srv.submit(f"x{i}", p, 2, tenant="slo")
        srv.run()
        return (reg.get("slo").share_boost,
                store.engine.stats.snapshot()["tenant_slo_boosts"],
                store.engine.stats.tenant_stats["slo"])
    boost, n, per = _both(lambda m: case(m.name))
    assert boost == 1 == n and per["requests_finished"] == 8
