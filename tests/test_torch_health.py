"""Failure-domain supervision and the flight recorder in the port
(nvme_strom_tpu_torch/io/health.py, io/flightrec.py and their hooks in
the engine, the planner, the resilient engine, the host tier, the
servers, the SLO governor and the watchdog) held against the JAX
package's on the CPU.

The cases of tests/test_health.py, the flight cases of
tests/test_observability.py, the tenant-storm dump of
tests/test_tenants.py and the three class cases of tests/test_sched.py
that the supervisor now runs under, each driven through both packages
with the same knobs, files and fault plans.  Breaker states, the
``breaker_trips`` / ``ring_restarts`` / ``extents_requeued`` /
``degraded_*`` counters, payload bytes and attempt histories (kind and
error of each failed attempt) are compared exactly; the bounded chaos
soak runs threads and is held to its invariants on the port alone.
Supervision rounds run when a test calls ``tick(force=True)`` or through
the production hooks, so every arc replays.  The ``strom_stat``
rendering of the health block waits for the port's tools (ROADMAP item
15)."""

import errno
import glob
import io as _io
import json
import os
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nvme_strom_tpu.io as jax_io
from nvme_strom_tpu.io import faults as j_faults
from nvme_strom_tpu.io import flightrec as j_flight
from nvme_strom_tpu.io import health as j_health
from nvme_strom_tpu.io import hostcache as j_hostcache
from nvme_strom_tpu.io import plan as j_plan
from nvme_strom_tpu.io import tenants as j_tn
from nvme_strom_tpu.models import kv_offload as j_kv
from nvme_strom_tpu.models import serving as j_serving
from nvme_strom_tpu.models import transformer as jtr
from nvme_strom_tpu.utils import config as j_config
from nvme_strom_tpu.utils import watchdog as j_watchdog
from nvme_strom_tpu.utils.stats import StromStats as JaxStats
import nvme_strom_tpu_torch.io as port_io
from nvme_strom_tpu_torch.convert import params_from_jax
from nvme_strom_tpu_torch.io import faults as p_faults
from nvme_strom_tpu_torch.io import flightrec as p_flight
from nvme_strom_tpu_torch.io import health as p_health
from nvme_strom_tpu_torch.io import hostcache as p_hostcache
from nvme_strom_tpu_torch.io import plan as p_plan
from nvme_strom_tpu_torch.io import tenants as p_tn
from nvme_strom_tpu_torch.io.health import CLOSED, HALF_OPEN, OPEN
from nvme_strom_tpu_torch.models import kv_offload as p_kv
from nvme_strom_tpu_torch.models import serving as p_serving
from nvme_strom_tpu_torch.models import transformer as ttr
from nvme_strom_tpu_torch.utils import config as p_config
from nvme_strom_tpu_torch.utils import watchdog as p_watchdog
from nvme_strom_tpu_torch.utils.stats import StromStats

MB = 1 << 20
LINE = 64 << 10

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", io=jax_io, faults=j_faults, health=j_health,
        flight=j_flight,
        hc=j_hostcache, plan=j_plan, config=j_config, Stats=JaxStats,
        kv=j_kv, serving=j_serving, tn=j_tn, watchdog=j_watchdog),
    "port": types.SimpleNamespace(
        name="port", io=port_io, faults=p_faults, health=p_health,
        flight=p_flight,
        hc=p_hostcache, plan=p_plan, config=p_config, Stats=StromStats,
        kv=p_kv, serving=p_serving, tn=p_tn, watchdog=p_watchdog),
}

#: the supervisor's counters compared between the packages
HEALTH = ("breaker_trips", "ring_restarts", "extents_requeued",
          "degraded_reads", "degraded_bytes", "degraded_probes",
          "faults_injected", "resilient_retries", "waste_degraded_bytes")


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


def _both(case):
    """``case(pkg)`` through both packages; the results must be equal.
    Returns the port's."""
    got = {name: case(pkg) for name, pkg in PKGS.items()}
    assert got["port"] == got["jax"], got
    return got["port"]


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch, tmp_path):
    """No fault environment leaking in; flight dumps under tmp_path."""
    for k in ("STROM_FAULTS", "STROM_RESILIENT", "STROM_BREAKER",
              "STROM_FLIGHT", "STROM_HOSTCACHE_MB"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("STROM_FLIGHT_DIR", str(tmp_path / "flight"))
    os.makedirs(tmp_path / "flight", exist_ok=True)


@pytest.fixture()
def data_file(tmp_path):
    payload = np.random.default_rng(42).integers(0, 256, MB,
                                                 dtype=np.uint8)
    path = tmp_path / "health.bin"
    path.write_bytes(payload.tobytes())
    return str(path), payload


def _fast_breaker(monkeypatch, **over):
    """Small breaker knobs (read at engine construction), as
    tests/test_health.py sets them."""
    knobs = {"STROM_BREAKER_STALL_S": "0.1",
             "STROM_BREAKER_DRAIN_S": "0.5",
             "STROM_BREAKER_RESTART_S": "0",
             "STROM_BREAKER_HALF_OPEN_S": "0.05",
             "STROM_BREAKER_DEVICE_ERRORS": "3",
             "STROM_DEGRADED_PROBE_S": "0"}
    knobs.update(over)
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)


def _engine(m, stats, n_rings=1, **kw):
    cfg = dict(n_rings=n_rings, chunk_bytes=1 << 16, queue_depth=4,
               buffer_pool_bytes=4 * MB, alignment=4096)
    cfg.update(kw)
    return m.io.StromEngine(m.config.EngineConfig(**cfg), stats=stats)


def _resilient(m, base, **kw):
    cfg = dict(max_retries=6, backoff_base_s=0.0005, backoff_max_s=0.002,
               hedging=False, stuck_timeout_s=30.0)
    cfg.update(kw)
    return m.io.ResilientEngine(base, m.config.ResilientConfig(**cfg))


def _history(pending):
    """(kind, error) of each failed attempt of a ResilientRead."""
    return [(a["kind"], a["error"]) for a in pending._attempts]


def _read_batches(m, eng, extents, payload, klass="prefetch"):
    """One plan_and_submit pass, every extent checked byte for byte;
    the attempt histories of the extents' reads."""
    hist = []
    for (fh, off, ln), views in zip(extents, m.plan.plan_and_submit(
            eng, extents, klass=klass)):
        got = np.concatenate([v.wait(timeout=20.0) for v in views])
        assert np.array_equal(got, payload[off:off + ln]), (off, ln)
        for v in views:
            span = getattr(v, "_span", None)   # a tier hit has none
            p = span.pending if span is not None else v
            hist.append(_history(p) if hasattr(p, "_attempts")
                        else type(p).__name__)
            v.release()
    return hist


def _counters(stats, names=HEALTH):
    snap = stats.snapshot()
    return {k: snap.get(k, 0) for k in names}


# -- units --------------------------------------------------------------------

def test_rolling_window_forgets():
    def case(m):
        w = m.health._Window(0.5)
        now = 100.0
        w.add(now=now)
        w.add(2, now=now + 0.1)
        return [w.count(now + 0.2), w.count(now + 0.55), w.count(now + 2.0)]
    assert _both(case) == [3, 2, 0]


@pytest.mark.parametrize("env", [
    {"STROM_BREAKER_WINDOW_S": "0"}, {"STROM_BREAKER_ERRORS": "0"},
    {"STROM_BREAKER_STALL_S": "0"}, {"STROM_BREAKER_HALF_OPEN_S": "-1"},
    {"STROM_DEGRADED_PROBE_TIMEOUT_S": "0"}],
    ids=["window", "errors", "stall", "half_open", "probe_timeout"])
def test_breaker_config_validates(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)

    def case(m):
        with pytest.raises(ValueError) as e:
            m.config.BreakerConfig()
        return str(e.value)
    _both(case)


def test_breaker_config_defaults_match(monkeypatch):
    import dataclasses
    _both(lambda m: dataclasses.asdict(m.config.BreakerConfig()))
    _both(lambda m: dataclasses.asdict(m.config.FlightConfig()))


def test_estorm_kind_is_consecutive_then_clean():
    def case(m):
        plan = m.io.FaultPlan.parse("estorm:max_count=3")
        return ([k.kind if k else None for k in
                 (plan.decide() for _ in range(6))],
                m.io.FaultPlan.parse("estorm").specs[0].max_count)
    assert _both(case) == (["estorm"] * 3 + [None] * 3, 16)


def test_breaker_disabled_removes_the_layer(monkeypatch, data_file):
    monkeypatch.setenv("STROM_BREAKER", "0")
    path, payload = data_file

    def case(m):
        eng = _engine(m, m.Stats())
        try:
            assert eng.supervisor is None
            fh = eng.open(path)
            pends = m.plan.submit_spans(eng, [(fh, 0, 4096)])
            got = pends[0].wait().tobytes()
            pends[0].release()
            return got == payload[:4096].tobytes()
        finally:
            eng.close_all()
    assert _both(case)


def test_ring_info_carries_health_fields(data_file):
    def case(m):
        eng = _engine(m, m.Stats(), n_rings=2)
        try:
            info = eng.ring_info(0)
            return {k: info[k] for k in ("failed", "restarts", "parked",
                                         "stalled")}
        finally:
            eng.close_all()
    assert _both(case) == {"failed": 0, "restarts": 0, "parked": 0,
                           "stalled": 0}


def test_failed_hedge_submission_returns_its_token(data_file):
    path, _ = data_file

    def case(m):
        base = _engine(m, m.Stats())
        eng = _resilient(m, base, hedging=True)
        try:
            fh = eng.open(path)
            rr = eng.submit_read(fh, 0, 4096, klass="decode")
            rr.wait()

            def boom(*a, **kw):
                raise OSError(errno.ECANCELED, "injected submit refusal")
            orig = base.submit_read
            base.submit_read = boom
            try:
                hedge = rr._submit_hedge()
            finally:
                base.submit_read = orig
            rr.release()
            return hedge, eng.hedges_outstanding("decode")
        finally:
            eng.close_all()
    assert _both(case) == (None, 0)


# -- arc 1: ring stall → trip → hot restart → requeue ------------------------

def test_ring_stall_trips_restarts_and_requeues(monkeypatch, data_file):
    _fast_breaker(monkeypatch)
    monkeypatch.setenv("STROM_SCHED", "0")   # the C round-robin
    path, payload = data_file

    def case(m):
        stats = m.Stats()
        base = _engine(m, stats, n_rings=2)
        eng = _resilient(m, base)
        try:
            fh = eng.open(path)
            m.faults.set_ring_stall(eng, 1, True)   # through the wrappers
            # the first batch lands on ring 0, the second parks on ring 1
            pends = (eng.submit_readv([(fh, 0, 4096), (fh, 8192, 4096)])
                     + eng.submit_readv([(fh, 16384, 4096)]))
            time.sleep(0.25)                     # > STROM_BREAKER_STALL_S
            base.supervisor.tick(force=True)     # trip → restart
            after_restart = base.supervisor.ring_states()
            hist = []
            for p in pends:                      # requeued: no error
                got = p.wait(timeout=10.0)
                assert np.array_equal(got,
                                      payload[p.offset:p.offset + 4096])
                hist.append(_history(p))
                p.release()
            info = base.ring_info(1)
            time.sleep(0.1)
            base.supervisor.tick(force=True)     # half-open → closed
            return {"after_restart": after_restart,
                    "after_clean": base.supervisor.ring_states(),
                    "counters": _counters(stats), "history": hist,
                    "restarts": info["restarts"], "parked": info["parked"],
                    "ring_health": stats.snapshot()["ring_health"]}
        finally:
            eng.close_all()
    got = _both(case)
    assert got["after_restart"] == [CLOSED, HALF_OPEN]
    assert got["after_clean"] == [CLOSED, CLOSED]
    c = got["counters"]
    assert c["breaker_trips"] == 1 and c["ring_restarts"] == 1
    assert c["extents_requeued"] == 1
    assert got["history"][2] and got["history"][2][0][0] == "io"
    assert (got["restarts"], got["parked"]) == (1, 0)


def test_scalar_routing_avoids_open_breaker(data_file):
    path, _ = data_file

    def case(m):
        base = _engine(m, m.Stats(), n_rings=2)
        try:
            sup = base.supervisor
            sup.rings[1].state = m.health.OPEN
            out = [sup.pick_ring(), sup.mask_free_slots([4, 4])]
            fh = base.open(path)
            rings = []
            for _ in range(4):
                p = base.submit_read(fh, 0, 4096)
                rings.append(p.ring)
                p.wait()
                p.release()
            sup.rings[1].state = m.health.HALF_OPEN
            return out + [rings, sup.pick_ring(),
                          sup.mask_free_slots([4, 4])]
        finally:
            base.close_all()
    assert _both(case) == [0, [4, 0], [0, 0, 0, 0], None, [4, 4]]


def test_restart_times_out_on_undrainable_io(monkeypatch, data_file):
    monkeypatch.setenv("STROM_FAULT_READ_DELAY_MS", "400")
    path, _ = data_file

    def case(m):
        base = _engine(m, m.Stats())
        try:
            fh = base.open(path)
            p = base.submit_read(fh, 0, 4096)     # held 400 ms
            with pytest.raises(TimeoutError):
                base.ring_restart(0, drain_timeout_s=0.05)
            n = p.wait(timeout=5.0).nbytes        # goes on untouched
            p.release()
            return n, base.ring_info(0)["restarts"]
        finally:
            base.close_all()
    assert _both(case) == (4096, 0)


def test_restart_timeout_with_stall_still_armed_terminates(monkeypatch,
                                                           data_file):
    """An -ETIMEDOUT restart while the stall is still armed hands the
    requests parked in the restart window back to the park queue."""
    monkeypatch.setenv("STROM_FAULT_READ_DELAY_MS", "500")
    path, payload = data_file

    def case(m):
        base = _engine(m, m.Stats())
        try:
            fh = base.open(path)
            slow = base.submit_read(fh, 0, 4096)
            base.set_ring_stall(0, True)
            result: dict = {}

            def restart():
                t0 = time.monotonic()
                try:
                    base.ring_restart(0, drain_timeout_s=0.2)
                    result["rc"] = "ok"
                except TimeoutError:
                    result["rc"] = "timeout"
                result["dt"] = time.monotonic() - t0

            t = threading.Thread(target=restart)
            t.start()
            time.sleep(0.05)
            parked = base.submit_read(fh, 8192, 4096)
            t.join(timeout=5)
            assert not t.is_alive()
            out = [result["rc"], result["dt"] < 2.0,
                   base.ring_info(0)["parked"]]
            base.set_ring_stall(0, False)
            out.append(np.array_equal(slow.wait(timeout=5.0),
                                      payload[:4096]))
            out.append(np.array_equal(parked.wait(timeout=5.0),
                                      payload[8192:8192 + 4096]))
            slow.release()
            parked.release()
            return out
        finally:
            base.close_all()
    assert _both(case) == ["timeout", True, 1, True, True]


# -- arc 2: EIO storm → degraded buffered mode → probe recovery --------------

def test_estorm_degrades_and_probe_recovers(monkeypatch, data_file):
    _fast_breaker(monkeypatch)
    monkeypatch.setenv("STROM_SCHED", "0")
    path, payload = data_file

    def case(m):
        stats = m.Stats()
        base = _engine(m, stats)
        eng = _resilient(m, m.io.FaultyEngine(base, m.io.FaultPlan.parse(
            "estorm:max_count=6")), max_retries=3)
        try:
            fh = eng.open(path)
            hist = [_read_batches(m, eng, [(fh, 0, 4096)], payload)]
            sup = base.supervisor
            states = [sup.degraded()]
            first = _counters(stats)
            for i in range(1, 6):
                hist.append(_read_batches(m, eng, [(fh, i * 8192, 4096)],
                                          payload))
                states.append(sup.degraded())
            before = stats.degraded_reads
            hist.append(_read_batches(m, eng, [(fh, 512 * 1024, 4096)],
                                      payload))
            return {"hist": hist, "states": states, "first": first,
                    "after": _counters(stats),
                    "restored_stays": stats.degraded_reads == before,
                    "gauge": stats.snapshot().get("engine_degraded")}
        finally:
            eng.close_all()
    got = _both(case)
    assert got["states"][0] and not got["states"][-1]
    assert got["first"]["breaker_trips"] >= 1
    assert got["first"]["degraded_reads"] >= 1
    # the attempt history: three failed attempts, then the brown-out
    assert [k for k, _ in got["hist"][0][0]] == ["io"] * 3
    a = got["after"]
    assert a["degraded_probes"] >= 3 and a["degraded_bytes"] > 0
    assert a["waste_degraded_bytes"] == a["degraded_bytes"]
    assert got["restored_stays"] and got["gauge"] == 0


def test_degraded_read_is_pending_shaped(data_file):
    path, payload = data_file

    def case(m):
        stats = m.Stats()
        base = _engine(m, stats)
        try:
            fh = base.open(path)
            d = m.health.DegradedRead(base, fh, 4096, 8192, stats)
            out = [d.is_ready(), d.was_fallback, d.length]
            out.append(np.array_equal(d.wait(), payload[4096:4096 + 8192]))
            out.append(stats.degraded_bytes)
            d.release()
            tail = m.health.DegradedRead(base, fh, MB - 100, 4096, stats)
            out.append(tail.wait().nbytes)
            tail.release()
            base.sync_stats()
            snap = stats.snapshot()
            # the engine counts the pread as fallback and bounce
            out.append((snap["bytes_fallback"], snap["bounce_bytes"]))
            return out
        finally:
            base.close_all()
    got = _both(case)
    assert got[:6] == [True, True, 8192, True, 8192, 100]
    assert got[6] == (8292, 8292)


def test_degraded_read_to_device_counts_bounce_once(data_file):
    """The port's bridge copies a degraded read to the device without
    counting its bytes a second time: bounce_bytes == degraded_bytes."""
    from nvme_strom_tpu_torch.ops.bridge import host_to_device
    path, payload = data_file
    stats = StromStats()
    base = _engine(PKGS["port"], stats)
    try:
        fh = base.open(path)
        d = base.supervisor.degraded_pending(fh, 4096, 8192, stats)
        t = host_to_device(base, d.wait(), torch.device("cpu"))
        assert np.array_equal(t.tensor.numpy(), payload[4096:4096 + 8192])
        d.release()
        base.sync_stats()
        assert stats.bounce_bytes == stats.degraded_bytes == 8192
        assert stats.degraded_reads == 1
    finally:
        base.close_all()


def test_shed_then_idle_engine_still_recovers(monkeypatch, data_file):
    _fast_breaker(monkeypatch)
    path, payload = data_file

    def case(m):
        stats = m.Stats()
        base = _engine(m, stats)
        eng = _resilient(m, m.io.FaultyEngine(base, m.io.FaultPlan.parse(
            "estorm:max_count=4")), max_retries=3)
        try:
            fh = eng.open(path)
            hist = _read_batches(m, eng, [(fh, 0, 4096)], payload)
            sup = base.supervisor
            deadline = time.monotonic() + 5.0
            while sup.degraded() and time.monotonic() < deadline:
                sup.tick(force=True)
                time.sleep(0.01)
            return hist, sup.degraded(), _counters(stats)
        finally:
            eng.close_all()
    hist, degraded, c = _both(case)
    assert not degraded and c["degraded_probes"] >= 1


# -- the host tier ------------------------------------------------------------

@pytest.fixture()
def tiers():
    for m in PKGS.values():
        m.hc.configure(m.config.HostCacheConfig(budget_mb=1,
                                                line_bytes=LINE))
    yield
    for m in PKGS.values():
        m.hc.reset()


CACHE = ("cache_hits", "cache_misses", "cache_admissions",
         "degraded_reads", "ring_restarts", "breaker_trips")


def test_restart_mid_fill_publishes_no_torn_line(monkeypatch, tiers,
                                                 data_file):
    """A restart that cancels a miss read mid-fill publishes no torn
    line: the line fills from the requeued read's bytes."""
    _fast_breaker(monkeypatch)
    monkeypatch.setenv("STROM_SCHED", "0")
    path, payload = data_file

    def case(m):
        stats = m.Stats()
        base = _engine(m, stats, n_rings=2)
        eng = _resilient(m, base)
        try:
            fh = eng.open(path)
            ext = [(fh, 0, LINE)]
            _read_batches(m, eng, ext, payload)    # ghost-noted
            eng.set_ring_stall(0, True)
            eng.set_ring_stall(1, True)
            views = m.plan.plan_and_submit(eng, ext, klass="prefetch")
            time.sleep(0.25)
            base.supervisor.tick(force=True)
            base.supervisor.tick(force=True)
            got = np.concatenate([v.wait(timeout=20.0) for v in views[0]])
            assert np.array_equal(got, payload[:LINE])
            for v in views[0]:
                v.release()
            hits = stats.cache_hits
            _read_batches(m, eng, ext, payload)    # a hit, exact bytes
            return stats.cache_hits > hits, _counters(stats, CACHE)
        finally:
            eng.close_all()
    hit, c = _both(case)
    assert hit and c["ring_restarts"] >= 1


def test_degraded_reads_still_fill_cache_lines(monkeypatch, tiers,
                                               data_file):
    _fast_breaker(monkeypatch)
    path, payload = data_file

    def case(m):
        stats = m.Stats()
        base = _engine(m, stats)
        eng = _resilient(m, base)
        try:
            fh = eng.open(path)
            sup = base.supervisor
            for _ in range(3):
                sup.note_error(ring=0, err=errno.EIO)
            assert sup.degraded()
            # nothing is faulted, so a probe would heal at once
            sup._maybe_probe = lambda *a, **kw: False
            ext = [(fh, LINE, LINE)]
            hist = [_read_batches(m, eng, ext, payload) for _ in range(2)]
            hits = stats.cache_hits
            _read_batches(m, eng, ext, payload)    # served from the tier
            return hist, stats.cache_hits > hits, _counters(stats, CACHE)
        finally:
            eng.close_all()
    hist, hit, c = _both(case)
    # the admitted pass fills its line from the degraded read
    assert hist == [["DegradedRead"], ["_FillOnWait"]]
    assert hit and c["degraded_reads"] == 2 and c["cache_admissions"] >= 1


# -- chaos soak (the port; threads make the counters run-dependent) ---------

def test_chaos_soak_zero_failures_and_recovery(monkeypatch, data_file):
    """Reader threads in two classes over a 2-ring engine while an
    injector wedges ring 1 (healed by supervised hot restarts) and a
    bounded EIO storm runs: no consumer error, every byte checked, the
    fast path back, every hedge token and staging buffer returned."""
    _fast_breaker(monkeypatch, STROM_BREAKER_ERRORS="4")
    monkeypatch.setenv("STROM_SCHED", "0")
    m = PKGS["port"]
    path, payload = data_file
    stats = StromStats()
    base = _engine(m, stats, n_rings=2, buffer_pool_bytes=8 * MB)
    plan = m.io.FaultPlan.parse("estorm:max_count=8:path=health")
    eng = _resilient(m, m.io.FaultyEngine(base, plan), max_retries=8,
                     hedging=True, hedge_after_s=0.2)
    errors: list = []
    done = threading.Event()

    def reader(seed, klass):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(12):
                fh = eng.open(path)
                exts = [(fh, int(rng.integers(0, MB - (64 << 10))),
                         int(rng.integers(1, 32 << 10)))
                        for _ in range(int(rng.integers(1, 4)))]
                for (_, off, ln), views in zip(
                        exts, m.plan.plan_and_submit(eng, exts,
                                                     klass=klass)):
                    got = np.concatenate([v.wait(timeout=30.0)
                                          for v in views])
                    if not np.array_equal(got, payload[off:off + ln]):
                        errors.append(f"mismatch {off}+{ln}")
                    for v in views:
                        v.release()
                eng.close(fh)
        except Exception as e:   # noqa: BLE001
            errors.append(repr(e))

    def injector():
        while not done.is_set():
            eng.set_ring_stall(1, True)
            time.sleep(0.05)
            base.supervisor.tick(force=True)
            time.sleep(0.03)

    threads = [threading.Thread(target=reader, args=(s, k))
               for s, k in ((1, "decode"), (2, "prefetch"),
                            (3, "prefetch"))]
    inj = threading.Thread(target=injector)
    t0 = time.monotonic()
    for t in threads:
        t.start()
    inj.start()
    for t in threads:
        t.join(timeout=25)
    done.set()
    inj.join(timeout=5)
    try:
        assert time.monotonic() - t0 < 30
        assert not errors, errors[:5]
        assert all(not t.is_alive() for t in threads)
        sup = base.supervisor
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            sup.tick(force=True)
            if not sup.degraded() and all(
                    s == CLOSED for s in sup.ring_states()):
                break
            time.sleep(0.02)
        assert not sup.degraded()
        assert all(s == CLOSED for s in sup.ring_states())
        assert stats.ring_restarts >= 1 and stats.breaker_trips >= 1
        for klass in ("decode", "prefetch", "restore", "scrub"):
            assert eng.hedges_outstanding(klass) == 0, klass
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            eng._reap_zombies(block=True)
            sup.tick(force=True)
            pool = base.pool_info()
            if pool["in_flight"] == 0 and \
                    pool["free_buffers"] == pool["n_buffers"]:
                break
            time.sleep(0.02)
        pool = base.pool_info()
        assert pool["in_flight"] == 0
        assert pool["free_buffers"] == pool["n_buffers"]
        for r in range(base.n_rings):
            assert base.ring_info(r)["parked"] == 0
    finally:
        eng.close_all()


def test_close_releases_a_lost_hedge_parked_on_a_stalled_ring(
        monkeypatch, data_file):
    """A read on the wedged ring 1 is hedged onto ring 0 and the hedge
    wins; its twin stays parked and is released by ``close(fh)``, whose
    wait ticks the supervisor until the ring's restart requeues the
    read, so the close returns and every staging buffer is back.  (The
    port's own: the JAX package's close waits on the parked read with
    no heartbeat.)"""
    _fast_breaker(monkeypatch)
    monkeypatch.setenv("STROM_SCHED", "0")   # the C round-robin
    m = PKGS["port"]
    path, payload = data_file
    stats = StromStats()
    base = _engine(m, stats, n_rings=2)
    eng = _resilient(m, base, hedging=True, hedge_after_s=0.03)
    try:
        fh = eng.open(path)
        m.faults.set_ring_stall(eng, 1, True)
        reads = [eng.submit_read(fh, off, 4096) for off in (0, 8192)]
        assert [r._primary.pending.ring for r in reads] == [0, 1]
        for r in reads:
            got = r.wait(timeout=10.0)
            assert np.array_equal(got, payload[r._offset:r._offset + 4096])
            r.release()
        c = _counters(stats, ("hedges_issued", "hedges_won",
                              "ring_restarts"))
        assert c == {"hedges_issued": 1, "hedges_won": 1,
                     "ring_restarts": 0}
        assert len(eng._zombies) == 1 and base.ring_info(1)["parked"] == 1
        t0 = time.monotonic()
        eng.close(fh)
        assert time.monotonic() - t0 < 5.0
        assert not eng._zombies
        c = _counters(stats, ("breaker_trips", "ring_restarts",
                              "extents_requeued"))
        assert c == {"breaker_trips": 1, "ring_restarts": 1,
                     "extents_requeued": 1}
        pool = base.pool_info()
        assert pool["in_flight"] == 0
        assert pool["free_buffers"] == pool["n_buffers"]
        assert [base.ring_info(r)["parked"] for r in range(2)] == [0, 0]
    finally:
        eng.close_all()


# -- serving: the governor's gate and load shedding ---------------------------

class _FakeSup:
    def __init__(self, bad):
        self.bad = bad

    def degraded(self):
        return self.bad

    def unhealthy(self):
        return self.bad


def test_slo_governor_never_boosts_into_a_sick_device(tmp_path):
    def case(m):
        class _Eng:
            def __init__(self, sup):
                self.supervisor = sup
                self.hedge_budgets = {"decode": 8}
                self.budget_calls = []
                self.stats = m.Stats()
                self.flight = m.flight.FlightRecorder(
                    m.config.FlightConfig(enabled=True, ops=16,
                                          dir=str(tmp_path / m.name),
                                          min_interval_s=0.0), self.stats)

            def set_hedge_budget(self, klass, budget):
                self.budget_calls.append((klass, budget))

        os.makedirs(tmp_path / m.name, exist_ok=True)
        sick = _Eng(_FakeSup(True))
        gov = m.kv.SloGovernor(target_ms=10.0)
        gov.observe(sick, p99_ms=100.0)
        healthy = _Eng(_FakeSup(False))
        gov2 = m.kv.SloGovernor(target_ms=10.0)
        gov2.observe(healthy, p99_ms=100.0)
        dumps = sorted(glob.glob(str(tmp_path / m.name /
                                     "strom_flight_*slo_violation*")))
        doc = json.loads(open(dumps[0]).read())
        return (gov.boost, sick.budget_calls, gov2.boost,
                healthy.budget_calls, len(dumps), doc["extra"],
                healthy.stats.flight_dumps)
    got = _both(case)
    assert got[:5] == (0, [], 1, [("decode", 16)], 1)
    assert got[5] == {"p99_ms": 100.0, "target_ms": 10.0, "boost": 1}


def test_tenant_slo_lane_dumps_and_is_gated(tmp_path):
    def case(m):
        d = tmp_path / f"t-{m.name}"
        os.makedirs(d, exist_ok=True)
        out = []
        for bad in (True, False):
            stats = m.Stats()
            eng = types.SimpleNamespace(
                supervisor=_FakeSup(bad), stats=stats,
                flight=m.flight.FlightRecorder(m.config.FlightConfig(
                    enabled=True, ops=16, dir=str(d), min_interval_s=0.0),
                    stats))
            tenant = m.tn.Tenant("gold", tier="gold", slo_p99_ms=10.0)
            m.kv.SloGovernor(target_ms=10.0).observe_tenant(
                eng, tenant, 50.0, stats)
            out.append((tenant.share_boost, stats.tenant_slo_boosts,
                        stats.flight_dumps))
        doc = json.loads(open(glob.glob(str(d / "*slo_violation*"))[0])
                         .read())
        return out, doc["extra"]
    got = _both(case)
    assert got[0] == [(0, 0, 0), (1, 1, 1)]
    assert got[1]["tenant"] == "gold" and got[1]["share_boost"] == 1


@pytest.fixture(scope="module")
def models():
    import dataclasses
    cfg_j = jtr.TransformerConfig(**{**jtr.tiny_config().__dict__,
                                     "dtype": jnp.float32})
    cfg_t = dataclasses.replace(ttr.tiny_config(), dtype=torch.float32)
    pj = jtr.init_params(jax.random.key(0), cfg_j)
    pt = params_from_jax({k: np.asarray(v) for k, v in pj.items()}, cfg_t,
                         "cpu")
    return {"jax": (cfg_j, pj), "port": (cfg_t, pt)}


def _server(models, pkg, **kw):
    cfg, params = models[pkg]
    extra = {} if pkg == "jax" else {"device": "cpu"}
    return PKGS[pkg].serving.DecodeServer(params, cfg, max_batch=2,
                                          max_len=32, **extra, **kw)


def test_serving_sheds_admissions_while_degraded(models):
    def case(m):
        degraded = {"on": True}
        srv = _server(models, m.name, shed_probe=lambda: degraded["on"])
        srv.submit("r1", [1, 2, 3], 4)
        srv.step()
        out = [all(s is None for s in srv.slots), len(srv.queue),
               srv.admissions_shed, srv.stats()["admissions_shed"]]
        degraded["on"] = False
        res = srv.run()
        return out + [res]
    got = _both(case)
    assert got[:4] == [True, 1, 1, 1] and len(got[4]["r1"]) == 4


def test_serving_shed_probe_auto_wired_to_the_supervisor(models, tmp_path,
                                                         monkeypatch):
    """With no explicit probe, the server sheds while its store engine's
    device is degraded, and admits once a probe has recovered it."""
    monkeypatch.setenv("STROM_DEGRADED_PROBE_S", "0")

    def case(m):
        cfg, _ = models[m.name]
        stats = m.Stats()
        eng = m.io.StromEngine(m.config.EngineConfig(
            chunk_bytes=1 << 20, buffer_pool_bytes=8 << 20), stats=stats)
        try:
            store = m.kv.PrefixStore(cfg, eng,
                                     str(tmp_path / f"{m.name}.kvstore"),
                                     4, 1 << 20)
            srv = _server(models, m.name, kv_store=store)
            sup = eng.supervisor
            for _ in range(sup.cfg.device_errors):
                sup.note_error(ring=0, err=errno.EIO)
            srv.submit("r1", [5, 6, 7, 8, 9], 3)
            srv.step()
            shed = [srv.admissions_shed, len(srv.queue), sup.degraded(),
                    stats.serve_admissions_shed]
            # nothing is faulted: the store's page file is the probe's
            # target once a degraded span names it
            sup.degraded_pending(store._fh, 0, 4096)
            sup.tick(force=True)
            res = srv.run()
            store.close()
            return shed, sup.degraded(), res, stats.breaker_trips
        finally:
            eng.close_all()
    shed, degraded, res, trips = _both(case)
    assert shed == [1, 1, True, 1] and not degraded
    # ring 0's breaker trips, and with no healthy ring left the device's
    assert len(res["r1"]) == 3 and trips == 2


def test_tenant_storm_flight_dump(models, tmp_path):
    def case(m):
        m.tn.configure(m.config.TenantConfig(enabled=True, storm_sheds=4))
        try:
            d = tmp_path / m.name
            os.makedirs(d, exist_ok=True)
            stats = m.Stats()
            flight = m.flight.FlightRecorder(m.config.FlightConfig(
                dir=str(d)), stats=stats)
            srv = _server(models, m.name, kv_store=types.SimpleNamespace(
                engine=types.SimpleNamespace(flight=flight, stats=stats)))
            srv._note_tenant_shed({"noisy": 3})
            out = [stats.snapshot()["tenant_storm_dumps"]]
            srv._note_tenant_shed({"noisy": 2, "meek": 1})
            snap = stats.snapshot()
            out += [snap["tenant_storm_dumps"],
                    snap["tenant_admissions_shed"], stats.tenant_stats]
            paths = glob.glob(str(d / "strom_flight_*tenant_storm*"))
            doc = json.loads(open(paths[0]).read())
            out += [len(paths), doc["reason"], doc["extra"]]
            srv._note_tenant_shed({"noisy": 4})
            out.append(stats.snapshot()["tenant_storm_dumps"])
            return out
        finally:
            m.tn.reset()
    got = _both(case)
    assert got[0] == 0 and got[1] == 1 and got[2] == 6
    assert got[3]["noisy"] == {"admissions_shed": 5, "storm_dumps": 1}
    assert got[4:6] == [1, "tenant_storm"]
    assert got[6]["tenants"] == ["noisy"]
    assert got[6]["sheds"] == {"noisy": 5, "meek": 1}
    assert got[7] == 1


# -- the flight recorder ------------------------------------------------------

def _recorder(m, d, ops=16, min_s=0.0, stats=None):
    return m.flight.FlightRecorder(m.config.FlightConfig(
        enabled=True, ops=ops, dir=str(d), min_interval_s=min_s),
        stats if stats is not None else m.Stats())


def _strip(ops):
    return [{k: v for k, v in o.items() if k != "t_s"} for o in ops]


def test_flight_records_and_bounded_ring(tmp_path):
    def case(m):
        st = m.Stats()
        fr = _recorder(m, tmp_path, stats=st)
        for i in range(40):
            fr.record("read", "decode", i % 4, 1, i * 4096, 4096, 120, "ok")
        path = fr.dump("unit_test", extra={"k": 1})
        doc = json.loads(open(path).read())
        return (len(fr), _strip(fr.snapshot_ops()), doc["reason"],
                doc["n_ops"], doc["extra"], doc["stats"]["flight_dumps"],
                doc["latency_us_p50"], doc["latency_us_p99"],
                st.flight_dumps, _strip(doc["ops"]))
    got = _both(case)
    assert got[0] == 16 and got[1][0]["offset"] == 24 * 4096
    assert got[2:6] == ("unit_test", 16, {"k": 1}, 0)
    assert got[6] > 0 and got[8] == 1


def test_flight_dump_rate_limited_per_reason(tmp_path):
    def case(m):
        fr = _recorder(m, tmp_path / m.name, min_s=60.0)
        os.makedirs(tmp_path / m.name, exist_ok=True)
        fr.record("read", None, 0, 1, 0, 4096, 10, "ok")
        return [fr.dump(r, force=f) is not None for r, f in (
            ("breaker_trip", False), ("breaker_trip", False),
            ("slo_violation", False), ("slo_violation", False),
            ("breaker_trip", True))]
    assert _both(case) == [True, False, True, False, True]


def test_flight_dump_into_a_missing_dir_returns_none(tmp_path):
    def case(m):
        st = m.Stats()
        fr = _recorder(m, tmp_path / "missing" / "dir", stats=st)
        return fr.dump("x"), st.flight_dumps, fr.dumps
    assert _both(case) == (None, 0, 0)


def test_engine_records_ops_with_class_and_ring(data_file, monkeypatch):
    path, _ = data_file

    def case(m):
        eng = m.io.StromEngine(m.config.EngineConfig(
            chunk_bytes=1 << 20, queue_depth=8, buffer_pool_bytes=16 << 20),
            stats=m.Stats())
        try:
            assert eng.flight is not None          # on by default
            fh = eng.open(path)
            with eng.submit_read(fh, 0, 4096, klass="decode") as p:
                p.wait()
            for p in eng.submit_readv([(fh, 0, 4096), (fh, 8192, 4096)],
                                      klass="restore"):
                p.wait()
                p.release()
            eng.close(fh)
            return [(o["kind"], o["klass"], o["ring"] >= 0, o["fh"],
                     o["offset"], o["bytes"], o["outcome"] in
                     ("ok", "fallback"), o["err"])
                    for o in eng.flight.snapshot_ops()]
        finally:
            eng.close_all()
    got = _both(case)
    assert [g[1] for g in got] == ["decode", "restore", "restore"]
    assert all(g[2] and g[5] == 4096 and g[6] for g in got)


def test_engine_records_writes(tmp_path):
    def case(m):
        eng = m.io.StromEngine(m.config.EngineConfig(
            chunk_bytes=1 << 20, queue_depth=8, buffer_pool_bytes=16 << 20),
            stats=m.Stats())
        try:
            fh = eng.open(str(tmp_path / f"{m.name}.w"), writable=True)
            eng.submit_write(fh, 0, np.ones(8192, np.uint8)).wait()
            eng.close(fh)
            return [(o["kind"], o["bytes"], o["outcome"])
                    for o in eng.flight.snapshot_ops()]
        finally:
            eng.close_all()
    assert _both(case) == [("write", 8192, "ok")]


def test_flight_off_switch(monkeypatch, data_file):
    monkeypatch.setenv("STROM_FLIGHT", "0")
    path, _ = data_file

    def case(m):
        eng = m.io.StromEngine(m.config.EngineConfig(
            chunk_bytes=1 << 20, queue_depth=8, buffer_pool_bytes=16 << 20),
            stats=m.Stats())
        try:
            fh = eng.open(path)
            with eng.submit_read(fh, 0, 4096) as p:
                n = p.wait().nbytes
            eng.close(fh)
            return eng.flight, n
        finally:
            eng.close_all()
    assert _both(case) == (None, 4096)


class _FlightEngine:
    def __init__(self, m, d, n_rings):
        self.n_rings = n_rings
        self.stats = m.Stats()
        self.flight = _recorder(m, d, ops=64, stats=self.stats)


def test_breaker_trip_dumps_flight_recorder(tmp_path):
    def case(m):
        d = tmp_path / m.name
        os.makedirs(d, exist_ok=True)
        eng = _FlightEngine(m, d, 2)
        sup = m.health.EngineSupervisor(eng, m.config.BreakerConfig(
            enabled=True, ring_errors=3, device_errors=100))
        for i in range(3):
            eng.flight.record("read", "decode", 0, 1, i * 4096, 0, 0,
                              "error", err=errno.EIO)
            sup.note_error(ring=0, err=errno.EIO)
        dumps = sorted(d.glob("strom_flight_*breaker_trip*.json"))
        doc = json.loads(dumps[0].read_text())
        return (sup.ring_states(), eng.stats.breaker_trips,
                eng.stats.flight_dumps, len(dumps), doc["extra"],
                _strip(doc["ops"]), doc["stats"]["breaker_trips"])
    got = _both(case)
    assert got[0] == [OPEN, CLOSED] and got[1:4] == (1, 1, 1)
    assert got[4]["ring"] == 0 and len(got[5]) == 3


def test_degraded_entry_dumps_and_cancellations_are_not_errors(tmp_path):
    def case(m):
        d = tmp_path / m.name
        os.makedirs(d, exist_ok=True)
        eng = _FlightEngine(m, d, 1)
        sup = m.health.EngineSupervisor(eng, m.config.BreakerConfig(
            enabled=True, ring_errors=100, device_errors=2))
        sup.note_error(ring=0, err=errno.ECANCELED)    # a requeue
        sup.note_error(ring=0, err=errno.EIO, engine_counted=True)
        first = sup.degraded()
        sup.note_error(ring=0, err=errno.EIO)
        sup.note_error(ring=0, err=errno.EIO)
        doc = json.loads(sorted(d.glob(
            "strom_flight_*device_degraded*.json"))[0].read_text())
        return first, sup.degraded(), sup.unhealthy(), doc["extra"], \
            eng.stats.snapshot()["engine_degraded"]
    got = _both(case)
    assert got[:3] == (False, True, True) and got[4] == 1
    assert got[3] == {"device_errors": 2}


def test_watchdog_stall_dumps_flight_recorder(tmp_path):
    def case(m):
        d = tmp_path / m.name
        os.makedirs(d, exist_ok=True)

        class Eng:
            def __init__(self):
                self.stats = m.Stats()
                self.stats.add(trace_spans_dropped=3, breaker_trips=1,
                               ring_restarts=1, degraded_reads=2)
                self.stats.set_gauges(ring_health=["open"],
                                      engine_degraded=1)
                self.flight = _recorder(m, d, stats=self.stats)

            def sync_stats(self):
                return {}

        eng = Eng()
        eng.flight.record("read", "decode", 0, 1, 0, 4096, 999, "ok")
        stream = _io.StringIO()
        wd = m.watchdog.StepWatchdog(deadline_s=0.05, engine=eng,
                                     stream=stream, max_reports=1)
        with wd.step("stalled"):
            time.sleep(0.2)
        wd.close()
        text = stream.getvalue()
        doc = json.loads(sorted(d.glob(
            "strom_flight_*watchdog_stall*.json"))[0].read_text())
        lines = [ln for ln in text.splitlines()
                 if ln.startswith(("health:", "observability:"))]
        return (lines, "flight recorder: dumped" in text,
                doc["extra"]["label"], doc["ops"][0]["latency_us"])
    got = _both(case)
    assert got[0][0].startswith("health: breakers=[open] degraded=1")
    assert "restarts=1" in got[0][0]
    assert got[0][1] == ("observability: trace_spans_dropped=3 "
                         "flight_dumps=0")
    assert got[1:] == (True, "stalled", 999)


def test_ring_stall_chaos_produces_flight_dump(monkeypatch, tmp_path,
                                               data_file):
    monkeypatch.setenv("STROM_FLIGHT_MIN_S", "0")
    monkeypatch.setenv("STROM_BREAKER_STALL_S", "0.1")
    monkeypatch.setenv("STROM_BREAKER_RESTART_S", "3600")
    monkeypatch.setenv("STROM_SCHED", "0")
    path, _ = data_file

    def case(m):
        d = tmp_path / f"c-{m.name}"
        os.makedirs(d, exist_ok=True)
        monkeypatch.setenv("STROM_FLIGHT_DIR", str(d))
        st = m.Stats()
        eng = _engine(m, st, n_rings=2)
        try:
            fh = eng.open(path)
            for p in eng.submit_readv([(fh, 0, 4096), (fh, 8192, 4096)],
                                      klass="decode"):
                p.wait()
                p.release()
            eng.set_ring_stall(1, True)
            pend = eng.submit_readv([(fh, 16384, 4096)])   # parks
            time.sleep(0.25)
            eng.supervisor.tick(force=True)
            states = eng.supervisor.ring_states()
            doc = json.loads(sorted(d.glob(
                "strom_flight_*breaker_trip*.json"))[0].read_text())
            eng.set_ring_stall(1, False)
            errs = []
            for p in pend:
                try:
                    p.wait(timeout=10.0)
                except OSError as e:
                    errs.append(e.errno)
                p.release()
            eng.close(fh)
            return (states, st.breaker_trips, st.flight_dumps >= 1,
                    doc["reason"], doc["n_ops"],
                    sorted({o["klass"] or "" for o in doc["ops"]}),
                    doc["stats"]["breaker_trips"], errs)
        finally:
            eng.close_all()
    got = _both(case)
    assert got[0] != [CLOSED, CLOSED] and got[1] >= 1 and got[2]
    assert got[3] == "breaker_trip" and got[4] >= 2
    assert "decode" in got[5] and got[7] in ([], [errno.ECANCELED])


# -- the three class cases of tests/test_sched.py under the supervisor -------

def _sched_engine(m, n_rings, stats):
    return m.io.StromEngine(m.config.EngineConfig(
        n_rings=n_rings, chunk_bytes=64 << 10, queue_depth=8,
        buffer_pool_bytes=4 << 20, use_io_uring=False), stats=stats)


def test_per_class_retry_config(data_file):
    path, _ = data_file

    def case(m):
        stats = m.Stats()
        base = _sched_engine(m, 1, stats)
        rc = m.config.ResilientConfig
        eng = m.io.ResilientEngine(
            m.io.FaultyEngine(base, m.io.FaultPlan.parse("eio:p=1.0")),
            config=rc(max_retries=2, backoff_base_s=0.0, hedging=False),
            class_configs={"scrub": rc(max_retries=0, backoff_base_s=0.0,
                                       hedging=False)})
        try:
            fh = eng.open(path)
            out = []
            for klass in ("scrub", "prefetch"):
                with pytest.raises(m.io.ReadError) as ei:
                    eng.submit_read(fh, 0, 4096, klass=klass).wait()
                out.append([(a["kind"], a["error"])
                            for a in ei.value.attempts])
            eng.close(fh)
            return out, base.supervisor.ring_states(), \
                _counters(stats, ("breaker_trips", "degraded_reads"))
        finally:
            base.close_all()
    hist, states, c = _both(case)
    assert [len(h) for h in hist] == [1, 3]
    assert states == [CLOSED] and c == {"breaker_trips": 0,
                                        "degraded_reads": 0}


def test_hedge_budget_isolation(data_file):
    path, payload = data_file

    def case(m):
        st = m.Stats()
        base = _sched_engine(m, 1, st)
        eng = m.io.ResilientEngine(
            m.io.FaultyEngine(base, m.io.FaultPlan.parse(
                "delay:p=1.0:delay_s=0.15")),
            config=m.config.ResilientConfig(hedge_after_s=0.02,
                                            hedging=True,
                                            backoff_base_s=0.0),
            hedge_budgets={"scrub": 0, "decode": 4})
        try:
            fh = eng.open(path)
            out = []
            for klass in ("scrub", "decode"):
                p = eng.submit_read(fh, 0, 4096, klass=klass)
                out.append(p.wait().tobytes() == payload[:4096].tobytes())
                p.release()
            out += [st.hedges_denied,
                    st.class_stats["scrub"].get("hedges_issued", 0),
                    st.class_stats["decode"]["hedges_issued"] >= 1,
                    eng.hedges_outstanding("decode"),
                    eng.hedges_outstanding("scrub"),
                    base.supervisor.ring_states()]
            eng.close(fh)
            return out
        finally:
            base.close_all()
    assert _both(case) == [True, True, 1, 0, True, 0, 0, [CLOSED]]


def test_classes_flow_through_wrappers(data_file):
    path, payload = data_file

    def case(m):
        st = m.Stats()
        base = _sched_engine(m, 2, st)
        eng = m.io.ResilientEngine(
            m.io.FaultyEngine(base, m.io.FaultPlan([])),
            config=m.config.ResilientConfig(hedging=False))
        try:
            fh = eng.open(path)
            prs = eng.submit_readv([(fh, 0, 4096), (fh, 4096, 4096)],
                                   klass="decode")
            ok = []
            for i, p in enumerate(prs):
                ok.append(p.wait().tobytes()
                          == payload[i * 4096:(i + 1) * 4096].tobytes())
                p.release()
            eng.close(fh)
            ops = [o["klass"] for o in base.flight.snapshot_ops()]
            return (ok, st.class_stats["decode"]["dispatches"],
                    st.class_stats["decode"]["spans"], ops)
        finally:
            base.close_all()
    assert _both(case) == ([True, True], 1, 2, ["decode", "decode"])
