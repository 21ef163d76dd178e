"""The port's host-DRAM tier (nvme_strom_tpu_torch/io/hostcache.py) and
the tier's planner path (io/plan.py) held against the JAX package's:
tests/test_hostcache.py's cases but those on the resilient engine,
``strom_stat`` and the step watchdog, each run through both packages on
the same seeded file with the line size pinned on both sides (64 KiB;
the JAX default would read a TPU tuning ledger).  Every case asserts the
reference's properties on each package and then compares the two:
bytes read, pieces served, engine submissions and the ``cache_*``
counters, exactly.  Two more cases run the KV prefix store over the
tier: a second restore hits in both packages, and a page rewritten over
a resident line is never served stale."""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvme_strom_tpu.io import engine as j_engine
from nvme_strom_tpu.io import hostcache as j_hostcache
from nvme_strom_tpu.io import plan as j_plan
from nvme_strom_tpu.models import transformer as jtr
from nvme_strom_tpu.models.kv_offload import PrefixStore as JaxStore
from nvme_strom_tpu.utils import checksum as j_checksum
from nvme_strom_tpu.utils import config as j_config
from nvme_strom_tpu.utils.stats import StromStats as JaxStats
from nvme_strom_tpu_torch.io import engine as p_engine
from nvme_strom_tpu_torch.io import hostcache as p_hostcache
from nvme_strom_tpu_torch.io import plan as p_plan
from nvme_strom_tpu_torch.models import transformer as ttr
from nvme_strom_tpu_torch.models.kv_offload import PrefixStore
from nvme_strom_tpu_torch.utils import checksum as p_checksum
from nvme_strom_tpu_torch.utils import config as p_config
from nvme_strom_tpu_torch.utils.stats import StromStats

LINE = 64 << 10
COUNTERS = ("cache_hits", "cache_misses", "bytes_served_cache",
            "cache_admissions", "cache_admission_rejections",
            "cache_fill_failures", "cache_evictions", "cache_invalidations",
            "checksum_failures", "bytes_verified")

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", hc=j_hostcache, plan=j_plan, eng=j_engine,
        config=j_config, checksum=j_checksum, Stats=JaxStats,
        crc32c=j_checksum.crc32c),
    "port": types.SimpleNamespace(
        name="port", hc=p_hostcache, plan=p_plan, eng=p_engine,
        config=p_config, checksum=p_checksum, Stats=StromStats,
        crc32c=p_engine.crc32c),
}


@pytest.fixture()
def data_file(tmp_path):
    payload = np.random.default_rng(13).integers(
        0, 256, 1 << 20, dtype=np.uint8).tobytes()
    path = tmp_path / "hc.bin"
    path.write_bytes(payload)
    return str(path), payload


class Run:
    """One package's tier (16 lines of 64 KiB) and one-ring engine."""

    def __init__(self, P, tier=True):
        self.P = P
        P.hc.reset()
        self.tier = (P.hc.configure(P.config.HostCacheConfig(
            budget_mb=1, line_bytes=LINE)) if tier else None)
        self.eng = P.eng.StromEngine(P.config.EngineConfig(
            chunk_bytes=1 << 20, queue_depth=8, buffer_pool_bytes=16 << 20,
            n_rings=1), stats=P.Stats())

    def close(self):
        self.eng.close_all()
        self.P.hc.reset()

    def submitted(self):
        return self.eng.ring_info(0)["submitted"]

    def counters(self):
        snap = self.eng.stats.snapshot()
        return {k: snap[k] for k in COUNTERS}

    def warm(self, fh, extents, klass=None):
        """Two passes: the ghost note, then admission and fill."""
        for _ in range(2):
            for pieces in self.P.plan.plan_and_submit(
                    self.eng, extents, chunk_bytes=256 << 10, klass=klass):
                for p in pieces:
                    p.wait()
                    p.release()

    def read(self, extents, klass=None, **kw):
        out, kinds = [], []
        views = self.P.plan.plan_and_submit(self.eng, extents,
                                            chunk_bytes=256 << 10,
                                            klass=klass, **kw)
        for pieces in views:
            out.append(b"".join(bytes(self.P.eng.wait_exact(p))
                                for p in pieces))
            kinds.append([type(p).__name__ for p in pieces])
            for p in pieces:
                p.release()
        return out, kinds


def _both(case, *args):
    """Run ``case`` on each package; their records must be equal."""
    recs = {}
    for name, P in PKGS.items():
        run = Run(P, tier=getattr(case, "tier", True))
        try:
            recs[name] = case(run, *args)
        finally:
            run.close()
    assert recs["port"] == recs["jax"]
    return recs["port"]


# -- the tier alone -----------------------------------------------------------

def case_ghost_list_admission_refuses_first_touch(r):
    tier, fkey = r.tier, ("f", 1)
    segs, admitted = tier.probe_range(fkey, 0, LINE, None)
    assert segs == [("miss", 0, LINE)] and admitted == {}
    segs, admitted = tier.probe_range(fkey, 0, LINE, None)
    assert set(admitted) == {(fkey, 0)}
    assert tier.fill(fkey, 0, np.zeros(LINE, np.uint8), None)
    segs, _ = tier.probe_range(fkey, 0, LINE, None)
    assert segs[0][0] == "hit"
    tier.unpin(segs[0][3])
    return tier.counters()["bytes_resident"], [s[:3] for s in segs]


def case_partial_prefix_line_upgrades_on_a_longer_read(r):
    tier, fkey = r.tier, ("f", 8)
    assert tier.fill(fkey, 0, np.zeros(LINE // 2, np.uint8), None)
    segs, admitted = tier.probe_range(fkey, 0, LINE, None)
    assert segs == [("miss", 0, LINE)] and set(admitted) == {(fkey, 0)}
    assert tier.fill(fkey, 0, np.zeros(LINE, np.uint8), None,
                     epoch=admitted[(fkey, 0)])
    segs, _ = tier.probe_range(fkey, 0, LINE, None)
    assert segs[0][0] == "hit"
    tier.unpin(segs[0][3])
    return tier.bytes_resident


def case_epoch_map_eviction_fails_closed(r):
    tier, fkey = r.tier, ("f", 11)
    tier.probe_range(fkey, 0, LINE, None)
    _, admitted = tier.probe_range(fkey, 0, LINE, None)
    epoch0 = admitted[(fkey, 0)]
    assert epoch0 == 0
    tier.invalidate(fkey, 0, 1)
    tier._key_epoch_cap = 0
    tier.invalidate(("other", 1), 0, 1)
    assert (fkey, 0) not in tier._key_epoch and tier._epoch_floor >= 1
    assert not tier.fill(fkey, 0, np.zeros(LINE, np.uint8), None,
                         epoch=epoch0)
    return tier._epoch_floor


def case_write_between_admission_and_fill_voids_the_fill(r):
    tier, fkey = r.tier, ("f", 9)
    tier.probe_range(fkey, 0, LINE, None)
    _, admitted = tier.probe_range(fkey, 0, LINE, None)
    (key, epoch), = admitted.items()
    tier.invalidate(fkey, 0, 1)
    assert not tier.fill(fkey, 0, np.zeros(LINE, np.uint8), None,
                         epoch=epoch)
    assert tier.bytes_resident == 0
    _, admitted = tier.probe_range(fkey, 0, LINE, None)
    assert admitted == {}
    _, admitted = tier.probe_range(fkey, 0, LINE, None)
    assert tier.fill(fkey, 0, np.zeros(LINE, np.uint8), None,
                     epoch=admitted[key])
    return admitted[key]


def case_partial_line_prefix_serves_only_valid_bytes(r):
    tier, fkey = r.tier, ("f", 2)
    assert tier.fill(fkey, 0, np.zeros(100, np.uint8), None)
    segs, _ = tier.probe_range(fkey, 0, 100, None)
    assert segs[0][0] == "hit"
    tier.unpin(segs[0][3])
    segs, _ = tier.probe_range(fkey, 0, 200, None)
    assert [s[0] for s in segs] == ["miss"]
    return segs


def case_write_invalidation_drops_overlapping_lines(r):
    tier, fkey, stats = r.tier, ("f", 4), r.eng.stats
    for i in range(3):
        tier.fill(fkey, i * LINE, np.zeros(LINE, np.uint8), None, stats)
    assert tier.bytes_resident == 3 * LINE
    assert tier.invalidate(fkey, LINE + 7, 1, stats=stats) == 1
    assert tier.bytes_resident == 2 * LINE
    assert stats.cache_invalidations == 1
    segs, _ = tier.probe_range(fkey, LINE, LINE, None)
    assert segs[0][0] == "miss"
    return r.counters()


def _own_cache(r, **kw):
    return r.P.hc.HostCache(line_bytes=LINE, budget_bytes=4 * LINE, **kw)


def case_eviction_falls_back_past_pinned_over_quota_class(r):
    cache = _own_cache(r, quotas={"decode": 1.0, "prefetch": 1.0})
    try:
        fkey = ("f", 10)
        for i in range(3):
            cache.fill(fkey, i * LINE, np.zeros(LINE, np.uint8), "decode")
        cache.fill(fkey, 3 * LINE, np.zeros(LINE, np.uint8), "prefetch")
        pins = [cache.probe_range(fkey, i * LINE, LINE, None)[0][0][3]
                for i in range(3)]
        assert cache.fill(fkey, 9 * LINE, np.zeros(LINE, np.uint8),
                          "prefetch")
        assert cache.bytes_resident == 4 * LINE
        resident = sorted(k[1] for k in cache._lines)
        for line in pins:
            cache.unpin(line)
    finally:
        cache.close()
    return resident


def case_eviction_under_quota_pressure_keeps_bytes_resident_exact(r):
    cache = _own_cache(r, quotas={"decode": 1.0, "prefetch": 1.0})
    try:
        stats, fkey = r.P.Stats(), ("f", 3)
        for i in range(4):
            assert cache.fill(fkey, i * LINE, np.full(LINE, i, np.uint8),
                              "decode", stats)
        assert cache.bytes_resident == 4 * LINE
        for i in range(4, 6):
            assert cache.fill(fkey, i * LINE, np.full(LINE, i, np.uint8),
                              "prefetch", stats)
            resident = sum(ln.valid for ln in cache._lines.values())
            assert cache.bytes_resident == resident == 4 * LINE
        assert stats.cache_evictions == 2
        assert cache.counters()["class_slots"]["prefetch"] == 2
        pins = [cache.probe_range(k[0], k[1], LINE, None)[0][0][3]
                for k in list(cache._lines)]
        assert not cache.fill(fkey, 99 * LINE, np.zeros(LINE, np.uint8),
                              "prefetch", stats)
        lines = sorted(k[1] for k in cache._lines)
        for line in pins:
            cache.unpin(line)
    finally:
        cache.close()
    return lines, stats.cache_evictions, stats.cache_fill_failures


def case_checksum_mismatch_drops_line_and_heals_as_miss(r):
    cache = _own_cache(r, verify=r.P.checksum.VerifyPolicy(mode="full"))
    try:
        stats, fkey = r.P.Stats(), ("f", 5)
        cache.fill(fkey, 0, np.zeros(LINE, np.uint8), None, stats)
        line = cache._lines[(fkey, 0)]
        cache.arena.view[line.slot * LINE] ^= 0xFF
        segs, _ = cache.probe_range(fkey, 0, LINE, None, stats)
        assert segs[0][0] == "miss"
        assert stats.checksum_failures == 1
        assert cache.bytes_resident == 0
    finally:
        cache.close()
    return stats.checksum_failures, stats.bytes_verified


# -- the tier through a real engine ------------------------------------------

def case_write_completion_bumps_epoch_again(r, path, _payload):
    tier, eng = r.tier, r.eng
    fh = eng.open(path, writable=True)
    fkey = eng.file_key(fh)
    w = eng.submit_write(fh, 0, np.zeros(LINE, np.uint8))
    e_submit = tier._key_epoch.get((fkey, 0), 0)
    assert e_submit >= 1
    w.wait()
    assert tier._key_epoch.get((fkey, 0), 0) > e_submit
    assert (fkey, 4 * LINE) not in tier._key_epoch
    eng.close(fh)
    return e_submit, tier._key_epoch.get((fkey, 0), 0)


def case_consumer_checksum_failure_spoils_the_filled_line(r, path, payload):
    tier, eng = r.tier, r.eng
    fh = eng.open(path)
    r.warm(fh, [(fh, 0, LINE)])
    assert tier.bytes_resident >= LINE
    line = tier._lines[(eng.file_key(fh), 0)]
    tier.arena.view[line.slot * tier.line_bytes] ^= 0xFF
    got, _ = r.read([(fh, 0, LINE)])
    assert got[0] != payload[:LINE]
    policy = r.P.checksum.VerifyPolicy(mode="full")
    healed = policy.check_with_reread(
        np.frombuffer(got[0], np.uint8), r.P.crc32c(payload[:LINE]),
        lambda: r.read([(fh, 0, LINE)])[0][0], eng.stats,
        where="spoil test",
        spoil=lambda: r.P.hc.spoil_span(eng, fh, 0, LINE, eng.stats))
    assert bytes(healed) == payload[:LINE]
    eng.close(fh)
    return r.counters(), r.submitted()


def case_extent_fully_cached_serves_zero_copy_hits(r, path, payload):
    eng = r.eng
    fh = eng.open(path)
    exts = [(fh, 0, 2 * LINE)]
    r.warm(fh, exts)
    before = r.submitted()
    got, kinds = r.read(exts)
    assert got[0] == payload[:2 * LINE]
    assert kinds == [["CacheHitRead", "CacheHitRead"]]
    assert r.submitted() == before
    assert eng.stats.bytes_served_cache == 2 * LINE
    eng.close(fh)
    return r.counters(), kinds, before


def case_head_tail_cached_middle_miss(r, path, payload):
    eng, tier = r.eng, r.tier
    fh = eng.open(path)
    fkey = eng.file_key(fh)
    raw = np.frombuffer(payload, np.uint8)
    tier.fill(fkey, 0, raw[:LINE], None)
    tier.fill(fkey, 2 * LINE, raw[2 * LINE:3 * LINE], None)
    before = r.submitted()
    got, kinds = r.read([(fh, 0, 3 * LINE)])
    assert got[0] == payload[:3 * LINE]
    assert kinds == [["CacheHitRead", "SpanView", "CacheHitRead"]]
    assert r.submitted() == before + 1
    eng.close(fh)
    return r.counters(), kinds


def case_line_boundary_straddles(r, path, payload):
    eng, tier = r.eng, r.tier
    fh = eng.open(path)
    fkey = eng.file_key(fh)
    raw = np.frombuffer(payload, np.uint8)
    tier.fill(fkey, 0, raw[:LINE], None)
    a, b = LINE // 2, LINE // 2 + LINE
    got, kinds = r.read([(fh, a, b - a)])
    assert got[0] == payload[a:b]
    assert kinds == [["CacheHitRead", "SpanView"]]
    tier.fill(fkey, LINE, raw[LINE:2 * LINE], None)
    got, kinds2 = r.read([(fh, a, b - a)])
    assert got[0] == payload[a:b]
    assert kinds2 == [["CacheHitRead", "CacheHitRead"]]
    eng.close(fh)
    return r.counters(), kinds, kinds2


def case_fill_on_miss_after_admission(r, path, payload):
    eng, tier = r.eng, r.tier
    fh = eng.open(path)
    exts = [(fh, 0, LINE)]
    r.warm(fh, exts)
    assert eng.stats.cache_admissions >= 1
    assert tier.bytes_resident >= LINE
    got, _ = r.read(exts)
    assert got[0] == payload[:LINE]
    assert eng.stats.cache_hits >= 1
    eng.close(fh)
    return r.counters(), r.submitted()


def case_engine_write_invalidates_through_the_tier(r, path, _payload):
    eng = r.eng
    fh = eng.open(path, writable=True)
    exts = [(fh, 0, LINE)]
    r.warm(fh, exts)
    new = np.random.default_rng(5).integers(0, 256, LINE, dtype=np.uint8)
    eng.submit_write(fh, 0, new).wait()
    assert eng.stats.cache_invalidations == 1
    got, _ = r.read(exts)
    assert got[0] == new.tobytes()
    eng.close(fh)
    return r.counters(), got[0]


def case_stream_span_path_hits_single_line_spans(r, path, payload):
    eng = r.eng
    fh = eng.open(path)
    spans = [(fh, 0, LINE), (fh, 2 * LINE, LINE // 2)]
    for _ in range(2):
        for pr in r.P.plan.submit_spans_tiered(eng, spans):
            pr.wait()
            pr.release()
    before = r.submitted()
    prs = r.P.plan.submit_spans_tiered(eng, spans)
    kinds = [type(p).__name__ for p in prs]
    for (_f, off, ln), pr in zip(spans, prs):
        assert bytes(pr.wait()) == payload[off:off + ln]
        assert pr.is_ready()
        pr.release()
    assert r.submitted() == before
    assert eng.stats.cache_hits >= 2
    eng.close(fh)
    return r.counters(), kinds


def case_join_pieces_gives_single_view_for_split_extents(r, path, payload):
    eng, tier = r.eng, r.tier
    fh = eng.open(path)
    raw = np.frombuffer(payload, np.uint8)
    tier.fill(eng.file_key(fh), 0, raw[:LINE], None)
    a, b = LINE // 2, LINE // 2 + LINE
    (pieces,) = r.P.plan.plan_and_submit(eng, [(fh, a, b - a)],
                                         chunk_bytes=256 << 10)
    assert len(pieces) == 2
    p = r.P.plan.join_pieces(pieces, eng.stats)
    assert p.length == b - a and p.offset == a and p.fh == fh
    assert bytes(p.wait()) == payload[a:b]
    p.release()
    (pieces,) = r.P.plan.plan_and_submit(eng, [(fh, 4 * LINE, LINE)],
                                         chunk_bytes=256 << 10)
    assert r.P.plan.join_pieces(pieces) is pieces[0]
    for pc in pieces:
        pc.release()
    eng.close(fh)
    return r.counters(), eng.stats.bounce_bytes


def case_stream_span_unaligned_spans_never_admit(r, path, _payload):
    eng, tier = r.eng, r.tier
    fh = eng.open(path)
    spans = [(fh, LINE // 2, LINE)]
    for _ in range(4):
        for pr in r.P.plan.submit_spans_tiered(eng, spans):
            pr.wait()
            pr.release()
    assert tier.bytes_resident == 0
    assert eng.stats.cache_admissions == 0 and eng.stats.cache_hits == 0
    eng.close(fh)
    return r.counters()


def case_disabled_budget_restores_pre_tier_path(r, path, payload):
    assert r.P.hc.get_cache() is None
    eng = r.eng
    fh = eng.open(path)
    for _ in range(3):
        for pieces in r.P.plan.plan_and_submit(eng, [(fh, 0, LINE)],
                                               chunk_bytes=256 << 10):
            for p in pieces:
                assert bytes(r.P.eng.wait_exact(p)) == payload[:LINE]
                p.release()
    st = eng.stats
    assert st.cache_hits == 0 and st.cache_misses == 0
    assert st.cache_admissions == 0
    eng.close(fh)
    return r.counters(), r.submitted()


case_disabled_budget_restores_pre_tier_path.tier = False


def case_record_unit_plans_bypass_the_tier(r, path, _payload):
    eng = r.eng
    fh = eng.open(path)
    for _ in range(3):
        for pieces in r.P.plan.plan_and_submit(eng, [(fh, 0, LINE)],
                                               chunk_bytes=256 << 10,
                                               split_unit=96):
            for p in pieces:
                p.wait()
                p.release()
    assert eng.stats.cache_hits == 0 and eng.stats.cache_misses == 0
    eng.close(fh)
    return r.counters(), r.submitted()


UNIT_CASES = {f.__name__[5:]: f for f in (
    case_ghost_list_admission_refuses_first_touch,
    case_partial_prefix_line_upgrades_on_a_longer_read,
    case_epoch_map_eviction_fails_closed,
    case_write_between_admission_and_fill_voids_the_fill,
    case_partial_line_prefix_serves_only_valid_bytes,
    case_write_invalidation_drops_overlapping_lines,
    case_eviction_falls_back_past_pinned_over_quota_class,
    case_eviction_under_quota_pressure_keeps_bytes_resident_exact,
    case_checksum_mismatch_drops_line_and_heals_as_miss)}
ENGINE_CASES = {f.__name__[5:]: f for f in (
    case_write_completion_bumps_epoch_again,
    case_consumer_checksum_failure_spoils_the_filled_line,
    case_extent_fully_cached_serves_zero_copy_hits,
    case_head_tail_cached_middle_miss,
    case_line_boundary_straddles,
    case_fill_on_miss_after_admission,
    case_engine_write_invalidates_through_the_tier,
    case_stream_span_path_hits_single_line_spans,
    case_join_pieces_gives_single_view_for_split_extents,
    case_stream_span_unaligned_spans_never_admit,
    case_disabled_budget_restores_pre_tier_path,
    case_record_unit_plans_bypass_the_tier)}


@pytest.mark.parametrize("name", list(UNIT_CASES))
def test_tier_case_equals_jax(name):
    _both(UNIT_CASES[name])


@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_tier_engine_case_equals_jax(name, data_file):
    _both(ENGINE_CASES[name], *data_file)


def test_line_size_and_quotas_follow_the_engine_and_scheduler(monkeypatch):
    """The default line is the engine's chunk as a power of two, at
    least 64 KiB (the JAX package takes a TPU ledger's chunk there);
    quotas parse like the JAX tier's."""
    eng = types.SimpleNamespace(config=p_config.EngineConfig(
        chunk_bytes=3 << 20))
    assert p_hostcache._default_line_bytes(eng) == 2 << 20
    eng = types.SimpleNamespace(config=p_config.EngineConfig(
        chunk_bytes=4096, buffer_pool_bytes=8192))
    assert p_hostcache._default_line_bytes(eng) == 64 << 10
    for spec in ("", "decode=1", "scrub=0,decode=3.5"):
        assert p_hostcache.parse_class_quotas(spec) == \
            j_hostcache.parse_class_quotas(spec)
    with pytest.raises(ValueError):
        p_config.HostCacheConfig(class_quotas="nope=1")
    with pytest.raises(ValueError):
        p_config.HostCacheConfig(line_bytes=5000)
    monkeypatch.setenv("STROM_HOSTCACHE_MB", "2")
    monkeypatch.setenv("STROM_HOSTCACHE_LINE_BYTES", str(LINE))
    p_hostcache.reset()
    try:
        cache = p_hostcache.get_cache()
        assert cache.line_bytes == LINE and cache.capacity == 32
    finally:
        p_hostcache.reset()


def test_close_refuses_while_a_hit_view_is_out():
    """The line arena is not freed under a pinned hit view, whose bytes
    may be the source of a device copy."""
    cache = p_hostcache.HostCache(line_bytes=LINE, budget_bytes=2 * LINE)
    fkey = ("f", 1)
    cache.fill(fkey, 0, np.ones(LINE, np.uint8), None)
    segs, _ = cache.probe_range(fkey, 0, LINE, None)
    with pytest.raises(RuntimeError, match="pinned"):
        cache.close()
    cache.unpin(segs[0][3])
    cache.close()


# -- the KV prefix store over the tier ----------------------------------------

#: tiny_config pages of 8 tokens: 4 KiB, one O_DIRECT block and one line
PAGE = 8


def _store_models():
    cfg_j = jtr.TransformerConfig(**{**jtr.tiny_config().__dict__,
                                     "dtype": jnp.float32})
    cfg_t = dataclasses.replace(ttr.tiny_config(), dtype=torch.float32)
    return cfg_j, cfg_t


def _store_pages(cfg, n, seed):
    g = np.random.default_rng(seed)
    shape = (cfg.n_layers, cfg.n_kv_heads, PAGE, cfg.head_dim)
    return [(g.standard_normal(shape).astype(np.float32),
             g.standard_normal(shape).astype(np.float32)) for _ in range(n)]


def _page_bytes(cfg):
    return 2 * cfg.n_layers * cfg.n_kv_heads * PAGE * cfg.head_dim * 4


class _StoreRun:
    """One package's tier (line = one page) and engine and store."""

    def __init__(self, name, tmp_path, pages):
        cfg_j, cfg_t = _store_models()
        P = PKGS[name]
        self.name, self.P = name, P
        self.cfg = cfg_t if name == "port" else cfg_j
        pb = _page_bytes(cfg_t)
        P.hc.reset()
        self.tier = P.hc.configure(P.config.HostCacheConfig(
            budget_mb=1, line_bytes=pb))
        self.eng = P.eng.StromEngine(P.config.EngineConfig(
            chunk_bytes=1 << 20, buffer_pool_bytes=16 << 20, n_rings=1),
            stats=P.Stats())
        cls = PrefixStore if name == "port" else JaxStore
        self.store = cls(self.cfg, self.eng, str(tmp_path / f"{name}.kv"),
                         page_tokens=PAGE, capacity_bytes=pages * pb)

    def restore(self, keys):
        if self.name == "port":
            got = self.store.restore_many({0: (0, keys)}, device="cpu")
            return {i: (k.numpy().tobytes(), v.numpy().tobytes())
                    for i, (k, v) in got.get(0, {}).items()}
        got = self.store.restore_many({0: (0, keys)})
        return {i: (np.asarray(k).tobytes(), np.asarray(v).tobytes())
                for i, (k, v) in got.get(0, {}).items()}

    def counters(self):
        snap = self.eng.stats.snapshot()
        return {k: snap[k] for k in COUNTERS + ("kv_pages_restored",
                                                "kv_store_evictions")}

    def close(self):
        self.store.close()
        self.eng.close_all()
        self.P.hc.reset()


def _store_case(tmp_path, body):
    recs = {}
    for name in PKGS:
        run = _StoreRun(name, tmp_path, pages=8)
        try:
            recs[name] = body(run)
        finally:
            run.close()
    assert recs["port"] == recs["jax"]
    return recs["port"]


def test_prefix_store_second_restore_hits_the_tier(tmp_path):
    """``restore_many`` runs as decode, hot: the first restore's pages
    are admitted on first miss, and the second is served from the tier's
    lines, bitwise the pages put, in both packages alike."""
    def body(r):
        pages = _store_pages(r.cfg, 5, seed=1)
        keys = r.store.chain_keys(list(range(5 * PAGE + 1)))
        r.store.put(list(zip(keys, *zip(*pages))))
        r.store.flush()
        want = {i: (k.tobytes(), v.tobytes())
                for i, (k, v) in enumerate(pages)}
        first = r.restore(keys)
        c1 = r.counters()
        second = r.restore(keys)
        c2 = r.counters()
        assert first == second == want
        assert c1["cache_hits"] == 0 and c1["cache_admissions"] == 5
        assert c1["cache_admission_rejections"] == 0
        assert c2["cache_hits"] == 5
        assert c2["bytes_served_cache"] == 5 * _page_bytes(r.cfg)
        assert r.tier.counters()["class_slots"]["decode"] == 5
        return c1, c2
    _store_case(tmp_path, body)


def test_put_over_a_resident_page_is_never_served_stale(tmp_path):
    """A full store evicts a page whose line is resident and writes a
    new page into its slot: the write drops the line, and the new key
    restores the new bytes, never the old line's."""
    def body(r):
        old = _store_pages(r.cfg, 8, seed=2)
        keys = r.store.chain_keys(list(range(9 * PAGE + 1)))
        r.store.put(list(zip(keys[:8], *zip(*old))))
        r.store.flush()
        r.restore(keys[:8])
        assert r.restore(keys[:8]) == {
            i: (k.tobytes(), v.tobytes()) for i, (k, v) in enumerate(old)}
        resident = r.counters()
        new = _store_pages(r.cfg, 1, seed=3)[0]
        assert r.store.put([(keys[8], *new)]) == 1
        r.store.flush()
        after_put = r.counters()
        assert after_put["kv_store_evictions"] == 1
        assert after_put["cache_invalidations"] >= 1
        got = r.store.restore_many({0: (8, [keys[8]])}, **(
            {"device": "cpu"} if r.name == "port" else {}))[0][8]
        k, v = (np.asarray(x) for x in got)
        assert k.tobytes() == new[0].tobytes()
        assert v.tobytes() == new[1].tobytes()
        return resident, after_put, r.counters()
    _store_case(tmp_path, body)
