"""The port's observability analysis (nvme_strom_tpu_torch/obs/:
attrib.py, debugsrv.py, ledger.py's RingTimeLedger and waste charges;
the spans and counter tracks the attribution folds) held against the
JAX package: the item-14 cases of tests/test_obs.py (``strom_top`` and
``bench_gate`` are tools the port does not have yet), the fold on one
span list through both packages, the OpenMetrics text against the JAX
renderer, and both servers' request traces folded under
``STROM_ATTRIB=1``."""

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvme_strom_tpu.obs import attrib as jax_attrib
from nvme_strom_tpu.obs import ledger as jax_ledger
from nvme_strom_tpu.utils.stats import \
    openmetrics_from_snapshot as jax_openmetrics
from nvme_strom_tpu_torch.io.engine import StromEngine
from nvme_strom_tpu_torch.obs import attrib as attrib_mod
from nvme_strom_tpu_torch.obs import debugsrv
from nvme_strom_tpu_torch.obs.attrib import (COMPONENTS, NAME_TO_COMPONENT,
                                             AttributionCollector,
                                             component_of, fold_events)
from nvme_strom_tpu_torch.obs.debugsrv import (DebugServer,
                                               maybe_start_debug_server)
from nvme_strom_tpu_torch.obs.ledger import (RingTimeLedger, charge_waste,
                                             ledger_view)
from nvme_strom_tpu_torch.utils.config import EngineConfig
from nvme_strom_tpu_torch.utils.stats import (StromStats,
                                              openmetrics_from_snapshot)
from nvme_strom_tpu_torch.utils.trace import TraceContext, Tracer, use_context


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


def _cfg(**kw):
    base = dict(chunk_bytes=1 << 20, queue_depth=8,
                buffer_pool_bytes=16 << 20)
    base.update(kw)
    return EngineConfig(**base)


def _fetch(port, route):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                timeout=5) as r:
        assert r.status == 200
        body = r.read().decode()
    return body if route == "/metrics" else json.loads(body)


@pytest.fixture
def no_obs_env(monkeypatch):
    monkeypatch.delenv("STROM_ATTRIB", raising=False)
    monkeypatch.delenv("STROM_DEBUG_PORT", raising=False)
    attrib_mod.reset()
    debugsrv.reset()
    yield
    attrib_mod.reset()
    debugsrv.reset()


# -- fold_events: the conservation contract ----------------------------------

def test_fold_conservation_sequential():
    us = 1000
    spans = [("strom.sched.queue", 0, 100 * us),
             ("strom.read", 100 * us, 600 * us),
             ("strom.bridge.hop", 600 * us, 700 * us)]
    fold = fold_events(spans, 0, 1000 * us)
    comps = fold["components"]
    assert comps["sched_queue"] == pytest.approx(100.0)
    assert comps["nvme_read"] == pytest.approx(500.0)
    assert comps["bridge"] == pytest.approx(100.0)
    total = sum(comps.values()) + fold["unattributed_us"]
    assert total == pytest.approx(fold["wall_us"], rel=0.01)
    assert fold["overlap_us"] == 0.0


def test_fold_interval_union_no_double_count():
    spans = [("strom.read", 0, 800_000), ("strom.read", 200_000, 1_000_000)]
    fold = fold_events(spans, 0, 1_000_000)
    assert fold["components"]["nvme_read"] == pytest.approx(1000.0)
    assert fold["unattributed_us"] == pytest.approx(0.0)


def test_fold_clips_to_window_and_skips_structural():
    spans = [("strom.serve.request", 0, 1_000_000),
             ("strom.serve.admit", 0, 900_000),
             ("strom.read", -500_000, 500_000),
             ("strom.read.degraded", 900_000, 2_000_000)]
    fold = fold_events(spans, 0, 1_000_000)
    assert fold["components"]["nvme_read"] == pytest.approx(500.0)
    assert fold["components"]["degraded"] == pytest.approx(100.0)
    assert fold["unattributed_us"] == pytest.approx(400.0)


def test_fold_equals_the_jax_fold():
    """One seeded span list, overlapping across and within components,
    partly outside the window, through both packages: the same dict."""
    rng = np.random.default_rng(5)
    names = list(NAME_TO_COMPONENT) + ["strom.serve.admit",
                                       "strom.resilient.other", "x.y"]
    spans = []
    for _ in range(200):
        b = int(rng.integers(-50_000, 1_000_000))
        spans.append((names[int(rng.integers(len(names)))], b,
                      b + int(rng.integers(0, 80_000))))
    assert fold_events(spans, 0, 900_000) == \
        jax_attrib.fold_events(spans, 0, 900_000)
    assert COMPONENTS == jax_attrib.COMPONENTS
    assert NAME_TO_COMPONENT == jax_attrib.NAME_TO_COMPONENT


def test_component_mapping():
    for name in ("strom.sched.queue", "strom.cache.hit", "strom.cache.fill",
                 "strom.read", "strom.read.fallback",
                 "strom.resilient.retry", "strom.resilient.hedge",
                 "strom.resilient.future_kind", "strom.read.degraded",
                 "strom.bridge.hop", "strom.h2d.dispatch", "strom.ici.new",
                 "strom.serve.request", "something.else"):
        assert component_of(name) == jax_attrib.component_of(name), name
    assert component_of("strom.h2d.dispatch") == "bridge"
    assert component_of("strom.serve.request") is None


# -- the collector ------------------------------------------------------------

def test_collector_cross_thread_folding(tmp_path):
    tracer = Tracer(str(tmp_path / "t.json"))
    col = AttributionCollector()
    tracer.add_sink(col.sink)
    root = TraceContext.new()
    t0 = time.monotonic_ns()
    threads = [
        threading.Thread(target=tracer.add_span, args=(
            "strom.read", t0 + 100_000, t0 + 400_000),
            kwargs={"ctx": root.child()}),
        threading.Thread(target=tracer.add_span, args=(
            "strom.sched.queue", t0, t0 + 100_000),
            kwargs={"ctx": root.child()}),
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    fold = col.request_retired(root.trace_id, t0, t0 + 1_000_000,
                               klass="decode")
    assert fold["spans"] == 2
    assert fold["components"]["nvme_read"] == pytest.approx(300.0)
    assert fold["components"]["sched_queue"] == pytest.approx(100.0)
    total = sum(fold["components"].values()) + fold["unattributed_us"]
    assert total == pytest.approx(fold["wall_us"], rel=0.01)
    prof = col.profiles()
    assert prof["requests"] == 1
    comps = prof["classes"]["decode"]["components"]
    assert comps["nvme_read"]["p50_us"] > 0
    assert comps["nvme_read"]["p99_us"] >= comps["nvme_read"]["p50_us"]


def test_collector_profiles_equal_the_jax_collectors():
    """The same folds through both collectors: the same profiles and
    summary."""
    ours, theirs = AttributionCollector(), jax_attrib.AttributionCollector()
    rng = np.random.default_rng(2)
    for i in range(20):
        dur = float(rng.integers(1, 900))
        klass = "decode" if i % 3 else "restore"
        for col in (ours, theirs):
            col.sink({"name": "strom.read", "ph": "X", "ts": 0.0,
                      "dur": dur, "args": {"trace": f"{i:x}"}})
            col.request_retired(i, 0, 1_000_000, klass=klass)
    assert ours.profiles() == theirs.profiles()
    assert ours.summary() == theirs.summary()


def test_collector_bounds_and_drop_accounting(tmp_path):
    stats = StromStats()
    col = AttributionCollector(max_traces=2, max_spans=3, stats=stats)
    tracer = Tracer(str(tmp_path / "t.json"))
    tracer.add_sink(col.sink)
    root = TraceContext.new()
    for i in range(5):
        tracer.add_span("strom.read", i * 10, i * 10 + 5, ctx=root.child())
    assert col.dropped == 2
    assert stats.attrib_spans_dropped == 2
    for _ in range(3):
        tracer.add_span("strom.read", 0, 5, ctx=TraceContext.new().child())
    assert len(col._traces) <= 2


def test_collector_sink_only_tracer_keeps_no_events():
    tracer = Tracer()
    col = AttributionCollector()
    tracer.add_sink(col.sink)
    assert tracer.enabled
    tracer.add_span("strom.read", 0, 1000, ctx=TraceContext.new().child())
    assert len(tracer) == 0
    assert len(col._traces) == 1
    tracer.remove_sink(col.sink)
    assert not tracer.enabled


def test_engine_attaches_collector_under_strom_attrib(tmp_data_file,
                                                      monkeypatch):
    path, _ = tmp_data_file
    monkeypatch.setenv("STROM_ATTRIB", "1")
    attrib_mod.reset()
    tracer = Tracer()
    try:
        stats = StromStats()
        with StromEngine(_cfg(), stats=stats, tracer=tracer) as eng:
            col = attrib_mod.get_collector()
            assert col is not None and eng._attrib is col
            assert tracer.enabled
            if eng.flight is not None:
                assert eng.flight.attrib is col
            root = TraceContext.new()
            t0 = time.monotonic_ns()
            fh = eng.open(path)
            with use_context(root):
                for off in (0, 1 << 20):
                    with eng.submit_read(fh, off, 1 << 20) as p:
                        p.wait()
            fold = col.request_retired(root.trace_id, t0,
                                       time.monotonic_ns(), klass="decode")
            eng.close(fh)
        assert fold["spans"] >= 2
        assert fold["components"]["nvme_read"] > 0
        total = sum(fold["components"].values()) + fold["unattributed_us"]
        assert total == pytest.approx(fold["wall_us"], rel=0.01)
        assert stats.attrib_requests == 1
    finally:
        tracer._sinks.clear()
        attrib_mod.reset()


def test_nothing_exists_with_the_switches_unset(no_obs_env, tmp_data_file):
    """No collector, no debug thread, no socket, and a disabled global
    tracer stays disabled."""
    from nvme_strom_tpu_torch.utils.trace import global_tracer
    was = global_tracer.enabled
    with StromEngine(_cfg()) as eng:
        assert eng._attrib is None
        assert eng._debug_srv is None
        assert attrib_mod.get_collector() is None
        assert not any(t.name == "strom-debugsrv"
                       for t in threading.enumerate())
    assert global_tracer.enabled == was


# -- ledger -------------------------------------------------------------------

def test_charge_waste_and_ledger_view():
    stats = StromStats()
    charge_waste(stats, "hedge_loss", 1000)
    charge_waste(stats, "retry_reread", 500)
    charge_waste(stats, "coalesce_gap", 250)
    charge_waste(stats, "evicted_unused", 125)
    charge_waste(stats, "degraded", 100)
    charge_waste(stats, "degraded", 0)
    charge_waste(None, "degraded", 10)
    stats.add(bytes_direct=10_000)
    view = ledger_view(stats.snapshot())
    assert view["delivered_bytes"] == 10_000
    assert view["waste_bytes"] == 1975
    assert view["goodput_bytes"] == 10_000 - 1975
    assert view["waste"]["hedge_loss"] == 1000
    assert 0 < view["goodput_fraction"] < 1


def test_plan_gap_bytes_counted(tmp_data_file):
    from nvme_strom_tpu.io.plan import plan_extents as jax_plan
    from nvme_strom_tpu_torch.io.plan import plan_and_submit, plan_extents
    plan = plan_extents([(0, 0, 4096), (0, 8192, 4096)],
                        chunk_bytes=1 << 20, gap=4096)
    assert len(plan.spans) == 1
    assert plan.gap_bytes == 4096
    plan2 = plan_extents([(0, 0, 4096), (0, 4096, 4096)],
                         chunk_bytes=1 << 20, gap=4096)
    assert plan2.gap_bytes == 0
    rng = np.random.default_rng(7)
    exts = [(int(rng.integers(0, 2)), int(rng.integers(0, 1 << 20)),
             int(rng.integers(1, 9000))) for _ in range(60)]
    assert plan_extents(exts, chunk_bytes=1 << 16, gap=8192).gap_bytes == \
        jax_plan(exts, chunk_bytes=1 << 16, gap=8192).gap_bytes
    path, _ = tmp_data_file
    stats = StromStats()
    with StromEngine(_cfg(), stats=stats) as eng:
        fh = eng.open(path)
        views = plan_and_submit(eng, [(fh, 0, 4096), (fh, 8192, 4096)],
                                gap=4096)
        for pieces in views:
            for p in pieces:
                p.wait()
                p.release()
        eng.close(fh)
    assert stats.waste_coalesce_gap_bytes == 4096


def test_resilient_short_read_charges_retry_reread(tmp_data_file):
    from nvme_strom_tpu_torch.io.faults import FaultPlan, FaultyEngine
    from nvme_strom_tpu_torch.io.resilient import ResilientEngine
    from nvme_strom_tpu_torch.utils.config import ResilientConfig
    path, _ = tmp_data_file
    stats = StromStats()
    plan = FaultPlan.parse("short:every=1:frac=0.5:max_count=1")
    eng = ResilientEngine(
        FaultyEngine(StromEngine(_cfg(), stats=stats), plan),
        ResilientConfig(max_retries=2, backoff_base_s=0.0, hedging=False,
                        stuck_timeout_s=30.0))
    with eng:
        fh = eng.open(path)
        with eng.submit_read(fh, 0, 1 << 20) as p:
            assert p.wait().nbytes == 1 << 20
        eng.close(fh)
    assert stats.waste_retry_reread_bytes == (1 << 20) // 2
    assert stats.resilient_retries == 1


def test_degraded_read_charges_waste(tmp_data_file):
    from nvme_strom_tpu_torch.io.health import DegradedRead
    path, payload = tmp_data_file
    stats = StromStats()
    with StromEngine(_cfg(), stats=stats) as eng:
        fh = eng.open(path)
        d = DegradedRead(eng, fh, 0, 8192, stats)
        assert bytes(d.wait()) == payload[:8192]
        d.release()
        eng.close(fh)
    assert stats.waste_degraded_bytes == 8192
    assert stats.degraded_bytes == 8192


def test_hostcache_evicted_unused_waste():
    """A line filled and evicted before any hit charges
    ``evicted_unused``; a line that served hits does not."""
    import collections
    from nvme_strom_tpu_torch.io import hostcache as hc

    class _FakeCache:
        _clock_evict = hc.HostCache._clock_evict
        _tenant_over = hc.HostCache._tenant_over
        _tenant_drop_locked = hc.HostCache._tenant_drop_locked
        _tenant_slots: dict = {}

    stats = StromStats()
    cache = _FakeCache()
    for hits, charged in ((0, 4096), (3, 4096)):
        line = hc._Line(("fk", hits), hits, "prefetch")
        line.valid = 4096
        line.hits = hits
        cache._clock = {"prefetch": collections.deque([line.key])}
        cache._lines = {line.key: line}
        cache._class_slots = {"prefetch": 1}
        cache.bytes_resident = 4096
        cache._over_quota = lambda k: True
        assert cache._clock_evict("prefetch", stats) == hits
        assert stats.waste_evicted_unused_bytes == charged


def test_ring_time_ledger():
    led = RingTimeLedger(2)
    t0 = time.monotonic()
    led._last = t0
    led.sample([1, 0], None, now=t0 + 1.0)
    led.sample([0, 0], ["open", "closed"], now=t0 + 1.5)
    led.note_restart(0, 0.25)
    snap = led.snapshot()
    assert snap["busy"][0] == pytest.approx(1.0)
    assert snap["idle"][1] == pytest.approx(1.5)
    assert snap["stalled"][0] == pytest.approx(0.5)
    assert snap["restarting"][0] == pytest.approx(0.25)
    stats = StromStats()
    led.export(stats)
    snap2 = stats.snapshot()
    assert "ring_state_s" in snap2
    prom = openmetrics_from_snapshot(snap2)
    assert 'strom_ring_state_seconds{ring="0",state="busy"} 1' in prom
    assert ledger_view(snap2)["ring_state_s"] == \
        jax_ledger.ledger_view(snap2)["ring_state_s"]


def test_engine_exports_ring_state_gauge(tmp_data_file):
    path, _ = tmp_data_file
    stats = StromStats()
    with StromEngine(_cfg(), stats=stats) as eng:
        fh = eng.open(path)
        with eng.submit_read(fh, 0, 4096) as p:
            p.wait()
        time.sleep(0.12)            # past the sample gate
        eng.sync_stats()
        eng.close(fh)
    snap = stats.snapshot()
    total = sum(sum(v) for v in snap["ring_state_s"].values())
    assert total > 0


def test_openmetrics_lines_are_the_jax_renderers():
    """Every line the port renders is one the JAX renderer renders from
    the same snapshot (the JAX block has more counters)."""
    s = StromStats()
    s.add(bytes_direct=5, hedges_issued=2, attrib_requests=1)
    s.add_class_stat("decode", dispatches=3)
    s.class_stat_gauges("decode", queue_wait_s=0.5)
    s.add_tenant_stat("gold", dispatches=1)
    s.set_gauges(ring_depths=[1, 0], ring_health=["closed", "open"],
                 ring_state_s={"busy": [1.0, 0.25], "idle": [0.0, 2.0]},
                 kv_restore_p99_ms=3.5, drain_phase="serving")
    ours = openmetrics_from_snapshot(s.snapshot())
    theirs = set(jax_openmetrics(s.snapshot()).splitlines())
    assert ours.rstrip().endswith("# EOF")
    assert set(ours.splitlines()) <= theirs


# -- debug endpoint -----------------------------------------------------------

def test_debug_server_off_by_default(no_obs_env):
    assert maybe_start_debug_server(StromStats()) is None


def test_debug_server_routes_and_shutdown(no_obs_env, tmp_data_file):
    path, _ = tmp_data_file
    stats = StromStats()
    with StromEngine(_cfg(), stats=stats) as eng:
        fh = eng.open(path)
        with eng.submit_read(fh, 0, 8192) as p:
            p.wait()
        srv = DebugServer(stats, port=0)
        srv.attach_engine(eng)
        try:
            text = _fetch(srv.port, "/metrics")
            assert "# TYPE strom_bytes_direct counter" in text
            assert text.rstrip().endswith("# EOF")
            assert "strom_waste_hedge_loss_bytes_total" in text
            assert "enabled" in _fetch(srv.port, "/attrib")
            ledger = _fetch(srv.port, "/ledger")
            assert ledger["delivered_bytes"] > 0
            assert "waste" in ledger and "goodput_bytes" in ledger
            flight = _fetch(srv.port, "/flight")
            if eng.flight is not None:
                assert flight["enabled"] and flight["n_ops"] >= 1
            health = _fetch(srv.port, "/health")
            for key in ("ring_health", "degraded", "boot_phase",
                        "drain_phase"):
                assert key in health
            index = _fetch(srv.port, "/")
            assert set(index["routes"]) == {"/metrics", "/attrib",
                                            "/ledger", "/flight", "/health",
                                            "/locks"}
            locks = _fetch(srv.port, "/locks")
            assert set(locks) == {"armed", "mode", "edges", "violations"}
            assert locks["violations"] == []
            with pytest.raises(urllib.error.HTTPError):
                _fetch(srv.port, "/nope")
        finally:
            port = srv.port
            srv.close()
        with pytest.raises((urllib.error.URLError, OSError)):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                   timeout=1)
        eng.close(fh)


def test_debug_route_that_raises_answers_with_the_error(no_obs_env):
    class _Broken:
        def snapshot(self):
            raise RuntimeError("boom")

    with DebugServer(_Broken(), port=0) as srv:
        doc = _fetch(srv.port, "/ledger")
    assert "boom" in doc["error"]


def test_maybe_start_debug_server_env(no_obs_env, monkeypatch):
    monkeypatch.setenv("STROM_DEBUG_PORT", "0")
    debugsrv.reset()
    stats = StromStats()
    with StromEngine(_cfg(), stats=stats) as eng:
        srv = eng._debug_srv
        assert srv is not None
        assert _fetch(srv.port, "/health")["degraded"] is False
        assert srv._eng() is eng
    assert srv._eng() is None          # detached at close_all
    assert _fetch(srv.port, "/ledger") is not None


# -- counter tracks -----------------------------------------------------------

def test_tracer_counter_events_export(tmp_path):
    out = tmp_path / "t.json"
    t = Tracer(str(out))
    t.add_counter("strom.ring.inflight", {"0": 3, "1": 1})
    t.add_counter("strom.ring.inflight", {"0": 0, "1": 0})
    t.export()
    cs = [e for e in json.load(open(out))["traceEvents"]
          if e.get("ph") == "C"]
    assert len(cs) == 2
    assert cs[0]["name"] == "strom.ring.inflight"
    assert cs[0]["args"] == {"0": 3.0, "1": 1.0}
    t2 = Tracer()
    t2.add_counter("x", {"a": 1})
    assert len(t2) == 0


def test_sched_emits_queue_depth_counter_and_queue_span(tmp_path):
    from nvme_strom_tpu_torch.io.sched import QoSScheduler
    tracer = Tracer(str(tmp_path / "t.json"))
    sched = QoSScheduler(submit_ring=lambda spans, ring: [object()
                                                          for _ in spans],
                         ring_free=lambda: [4, 4], stats=None,
                         tracer=tracer, ring_cap=4)
    root = TraceContext.new()
    with use_context(root):
        b = sched.enqueue([(0, 0, 4096)], "prefetch")
    sched.step()
    sched.ack_submitted(b)
    evs = tracer.events()
    assert "strom.sched.queue_depth" in [e["name"] for e in evs
                                         if e.get("ph") == "C"]
    (q,) = [e for e in evs if e["name"] == "strom.sched.queue"]
    assert q["args"]["trace"] == f"{root.trace_id:x}"
    assert q["args"]["klass"] == "prefetch"


def test_arena_emits_occupancy_counter(tmp_path, monkeypatch):
    from nvme_strom_tpu_torch.io.arena import PinnedArena
    from nvme_strom_tpu_torch.utils import trace as trace_mod
    t = Tracer(str(tmp_path / "t.json"))
    monkeypatch.setattr(trace_mod, "global_tracer", t)
    arena = PinnedArena(1 << 20, lock_pages=False)
    slab = arena.carve(8192, "staging", lock=False)
    slab.release()
    arena.close()
    cs = [e for e in t.events() if e.get("ph") == "C"]
    assert len(cs) >= 2
    assert cs[0]["name"] == "strom.arena.occupancy"
    assert cs[0]["args"].get("carved_staging", 0) >= 8192


def test_bridge_spans_only_with_the_tracer_on(tmp_data_file, tmp_path):
    """A DeviceStream's copies emit dispatch and sync spans under a live
    tracer, and nothing under a disabled one."""
    from nvme_strom_tpu_torch.ops.bridge import DeviceStream
    path, payload = tmp_data_file
    for on in (False, True):
        tracer = Tracer(str(tmp_path / "b.json") if on else None)
        with StromEngine(_cfg(), tracer=tracer) as eng:
            got = DeviceStream(eng, device="cpu").read_to_device(path)
        assert bytes(got.numpy()) == payload
        names = {e["name"] for e in tracer.events()}
        if on:
            assert {"strom.h2d.dispatch", "strom.h2d.sync"} <= names
            assert names & {"strom.read", "strom.read.fallback"}
        else:
            assert len(tracer) == 0


# -- flight recorder ----------------------------------------------------------

def test_flight_dump_embeds_attrib_summary(tmp_path):
    from nvme_strom_tpu_torch.io.flightrec import FlightRecorder
    from nvme_strom_tpu_torch.utils.config import FlightConfig
    col = AttributionCollector()
    col.request_retired(1, 0, 1_000_000, klass="decode")
    fr = FlightRecorder(FlightConfig(enabled=True, ops=16,
                                     dir=str(tmp_path),
                                     min_interval_s=0.0), StromStats())
    fr.attrib = col
    fr.record("read", "decode", 0, 1, 0, 4096, 10, "ok")
    doc = json.load(open(fr.dump("unit")))
    assert doc["attrib"]["requests"] == 1
    assert "decode" in doc["attrib"]["shares"]
    fr.attrib = None
    assert "attrib" not in json.load(open(fr.dump("unit2")))


# -- both servers' request traces, folded -------------------------------------

@pytest.mark.parametrize("paged", [False, True])
def test_servers_fold_every_retired_request(tmp_path, monkeypatch, paged):
    """Under ``STROM_ATTRIB=1`` each retired request of a prefix-store
    run folds: coverage + unattributed is the wall within 1%, the NVMe
    hit run's restores show in ``nvme_read`` and ``bridge``, and the
    tokens are those of the same server without attribution."""
    from nvme_strom_tpu.models import transformer as jtr
    from nvme_strom_tpu_torch.convert import params_from_jax
    from nvme_strom_tpu_torch.models import transformer as ttr
    from nvme_strom_tpu_torch.models.kv_offload import PrefixStore
    from nvme_strom_tpu_torch.models.serving import (DecodeServer,
                                                     PagedDecodeServer)
    page = 4
    cfg_j = jtr.TransformerConfig(**{**jtr.tiny_config().__dict__,
                                     "dtype": jnp.float32})
    cfg = dataclasses.replace(ttr.tiny_config(), dtype=torch.float32)
    pt = params_from_jax({k: np.asarray(v) for k, v in jtr.init_params(
        jax.random.key(0), cfg_j).items()}, cfg, "cpu")
    sys_prompt = np.random.default_rng(0).integers(
        0, cfg.vocab, 3 * page).tolist()
    reqs = [(f"r{i}", sys_prompt + [7 + i]) for i in range(4)]

    def run(attrib):
        monkeypatch.setenv("STROM_ATTRIB", "1" if attrib else "0")
        attrib_mod.reset()
        tracer = Tracer()
        eng = StromEngine(_cfg(), tracer=tracer)
        store = PrefixStore(cfg, eng, str(tmp_path / f"s{attrib}.kv"),
                            page, 1 << 20)
        make = ((lambda: PagedDecodeServer(pt, cfg, 2, 64, total_blocks=32,
                                           block_len=page, device="cpu",
                                           kv_store=store))
                if paged else
                (lambda: DecodeServer(pt, cfg, 2, 64, device="cpu",
                                      kv_store=store)))
        out = {}
        try:
            for phase in ("cold", "hit"):
                srv = make()      # a new server: the hit run reads NVMe
                for rid, ids in reqs:
                    srv.submit(f"{phase}-{rid}", ids, 4)
                out.update(srv.run())
            col = attrib_mod.get_collector()
            return out, (col.profiles(), list(col._recent)) if col else None
        finally:
            store.close()
            eng.close_all()
            tracer._sinks.clear()
            attrib_mod.reset()

    plain, none = run(False)
    assert none is None
    got, (prof, folds) = run(True)
    assert {k: v for k, v in got.items()} == plain
    assert prof["requests"] == 2 * len(reqs) == len(folds)
    for fold in folds:
        total = fold["coverage_us"] + fold["unattributed_us"]
        assert total == pytest.approx(fold["wall_us"], rel=0.01)
    comps = prof["classes"]["decode"]["components"]
    assert comps["nvme_read"]["total_us"] > 0
    assert comps["bridge"]["total_us"] > 0
