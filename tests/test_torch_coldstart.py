"""Serve-while-restoring cold start in the port
(nvme_strom_tpu_torch/io/coldstart.py, io/warmup.py,
parallel/weights.py ``FaultingCheckpoint`` and the servers' lazy params)
held against the JAX package's on the CPU: the cases of
tests/test_coldstart.py, each run through both packages where both can
run it, with phases, gauges, counters, dump payloads, manifests and
greedy tokens compared exactly.

The checkpoint is one safetensors file of the JAX tiny model's float32
parameters; the port reads it onto the CPU, the JAX package onto its
CPU device.  ``consume_handoff`` is held against the JAX package in
tests/test_torch_handoff.py; ``strom-scrub --gc`` waits for the port's
tools (ROADMAP item 15), so the orphan sweep is held against the JAX
sweep functions."""

import dataclasses
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

from nvme_strom_tpu.checkpoint.manager import (
    find_orphan_manifests as j_find_orphans)
from nvme_strom_tpu.checkpoint.manager import (
    sweep_orphan_manifests as j_sweep_orphans)
from nvme_strom_tpu.formats import write_safetensors as j_write_st
from nvme_strom_tpu.io import coldstart as j_cs
from nvme_strom_tpu.io import faults as j_faults
from nvme_strom_tpu.io import flightrec as j_flight
from nvme_strom_tpu.io import health as j_health
from nvme_strom_tpu.io import hostcache as j_hc
from nvme_strom_tpu.io import plan as j_plan
from nvme_strom_tpu.io import sched as j_sched
from nvme_strom_tpu.io import warmup as j_warm
from nvme_strom_tpu.io.engine import StromEngine as JaxEngine
from nvme_strom_tpu.io.resilient import ResilientEngine as JaxResilient
from nvme_strom_tpu.models import kv_offload as j_kv
from nvme_strom_tpu.models import serving as j_serving
from nvme_strom_tpu.models import transformer as jtr
from nvme_strom_tpu.parallel import weights as j_weights
from nvme_strom_tpu.utils import config as j_config
from nvme_strom_tpu.utils.stats import StromStats as JaxStats
from nvme_strom_tpu_torch.checkpoint import manager as p_manager
from nvme_strom_tpu_torch.convert import params_from_jax
from nvme_strom_tpu_torch.io import coldstart as p_cs
from nvme_strom_tpu_torch.io import faults as p_faults
from nvme_strom_tpu_torch.io import flightrec as p_flight
from nvme_strom_tpu_torch.io import health as p_health
from nvme_strom_tpu_torch.io import hostcache as p_hc
from nvme_strom_tpu_torch.io import plan as p_plan
from nvme_strom_tpu_torch.io import sched as p_sched
from nvme_strom_tpu_torch.io import warmup as p_warm
from nvme_strom_tpu_torch.io.engine import StromEngine
from nvme_strom_tpu_torch.io.resilient import ResilientEngine
from nvme_strom_tpu_torch.models import kv_offload as p_kv
from nvme_strom_tpu_torch.models import serving as p_serving
from nvme_strom_tpu_torch.models import transformer as ttr
from nvme_strom_tpu_torch.parallel import weights as p_weights
from nvme_strom_tpu_torch.utils import config as p_config
from nvme_strom_tpu_torch.utils.stats import StromStats

MB = 1 << 20

COLDSTART_COUNTERS = (
    "coldstart_faults", "coldstart_fault_bytes", "coldstart_bulk_tensors",
    "coldstart_warm_spans", "coldstart_warm_pages",
    "coldstart_stall_dumps", "coldstart_brownouts")

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", cs=j_cs, flight=j_flight, health=j_health, hc=j_hc,
        plan=j_plan, sched=j_sched, warm=j_warm, kv=j_kv,
        serving=j_serving, weights=j_weights, config=j_config,
        Stats=JaxStats, Engine=JaxEngine, Resilient=JaxResilient,
        faults=j_faults),
    "port": types.SimpleNamespace(
        name="port", cs=p_cs, flight=p_flight, health=p_health, hc=p_hc,
        plan=p_plan, sched=p_sched, warm=p_warm, kv=p_kv,
        serving=p_serving, weights=p_weights, config=p_config,
        Stats=StromStats, Engine=StromEngine, Resilient=ResilientEngine,
        faults=p_faults),
}


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
def _clean_env(monkeypatch):
    for k in ("STROM_COLDSTART", "STROM_COLDSTART_FAULT_SLO_MS",
              "STROM_COLDSTART_WINDOW", "STROM_WARM_HINT_SPANS",
              "STROM_WARM_PAGES", "STROM_FAULTS", "STROM_RESILIENT",
              "STROM_ICI_SCATTER", "STROM_HOSTCACHE_MB"):
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(scope="module")
def models():
    cfg_j = jtr.TransformerConfig(**{**jtr.tiny_config().__dict__,
                                     "dtype": jnp.float32})
    cfg_t = dataclasses.replace(ttr.tiny_config(), dtype=torch.float32)
    pj = jtr.init_params(jax.random.key(0), cfg_j)
    np_params = {k: np.asarray(v) for k, v in pj.items()}
    pt = params_from_jax(np_params, cfg_t, "cpu")
    return {"jax": (cfg_j, pj), "port": (cfg_t, pt), "np": np_params}


@pytest.fixture()
def ckpt(models, tmp_path):
    path = str(tmp_path / "model.safetensors")
    j_write_st(path, models["np"])
    return path


def _engine(m, **kw):
    cfg = dict(chunk_bytes=1 << 20, queue_depth=8,
               buffer_pool_bytes=32 * MB)
    cfg.update(kw)
    return m.Engine(m.config.EngineConfig(**cfg), stats=m.Stats())


def _faulting(m, ckpt, eng, coord=None):
    if m.name == "jax":
        shard = jax.sharding.SingleDeviceSharding(jax.devices()[0])
        return m.weights.FaultingCheckpoint(
            ckpt, lambda name, shape: shard, engine=eng,
            coordinator=coord)
    return m.weights.FaultingCheckpoint(ckpt, device="cpu", engine=eng,
                                        coordinator=coord)


def _serve(m, cfg, params, prompt, max_new):
    extra = {} if m.name == "jax" else {"device": "cpu"}
    srv = m.serving.DecodeServer(params, cfg, max_batch=2, max_len=64,
                                 **extra)
    srv.submit("r", prompt, max_new)
    return srv.run()["r"]


# -- config and the inert default ----------------------------------------------

def test_config_defaults_and_validation(monkeypatch):
    """The port's config is the JAX config: same fields, defaults,
    gate, environment and errors."""
    def case(m):
        out = [dataclasses.asdict(m.config.ColdStartConfig()),
               m.config.coldstart_enabled()]
        for bad in (dict(fault_slo_ms=-1.0), dict(fault_window=4),
                    dict(warm_hint_spans=-1), dict(warm_pages=-1)):
            with pytest.raises(ValueError) as e:
                m.config.ColdStartConfig(**{
                    **dict(enabled=False, fault_slo_ms=0.0,
                           fault_window=64, warm_hint_spans=1,
                           warm_pages=1), **bad})
            out.append(str(e.value))
        return out
    got = _both(case)
    assert got[0] == {"enabled": False, "fault_slo_ms": 0.0,
                      "fault_window": 64, "warm_hint_spans": 1024,
                      "warm_pages": 256}
    assert got[1] is False
    for k, v in (("STROM_COLDSTART", "1"), ("STROM_WARM_HINT_SPANS", "7"),
                 ("STROM_WARM_PAGES", "5")):
        monkeypatch.setenv(k, v)
    got = _both(lambda m: (dataclasses.asdict(m.config.ColdStartConfig()),
                           m.config.coldstart_enabled()))
    assert got == ({"enabled": True, "fault_slo_ms": 0.0,
                    "fault_window": 64, "warm_hint_spans": 7,
                    "warm_pages": 5}, True)


def test_gate_off_is_bit_for_bit_inert(models):
    """A plain params dict is the eager path: no lazy source, no
    cold-start counter, no boot_phase gauge; the tokens are the JAX
    server's."""
    prompt = np.random.default_rng(3).integers(0, 128, 5).tolist()

    def case(m):
        cfg, params = models[m.name]
        extra = {} if m.name == "jax" else {"device": "cpu"}
        srv = m.serving.DecodeServer(params, cfg, max_batch=2, max_len=64,
                                     **extra)
        srv.submit("r", prompt, 6)
        stats = m.Stats()
        return (srv._param_source, srv.run()["r"],
                [getattr(stats, n) for n in COLDSTART_COUNTERS],
                "boot_phase" in stats.snapshot())
    src, toks, ctr, gauge = _both(case)
    assert src is None and len(toks) == 6 and not any(ctr) and not gauge


# -- the coordinator ----------------------------------------------------------

class _FakeEngine:
    """Stats, a flight recorder and a scheduler whose backlog is known."""

    class _Sched:
        def backlog(self):
            return {"restore": {"batches": 2, "spans": 7,
                                "oldest_wait_s": 0.5}}

    def __init__(self, m, d):
        self.stats = m.Stats()
        self.flight = m.flight.FlightRecorder(m.config.FlightConfig(
            enabled=True, ops=16, dir=str(d), min_interval_s=0.0),
            self.stats)
        self.scheduler = self._Sched()
        self.supervisor = None


def test_phase_machine_is_forward_only_and_exports_gauge(tmp_path):
    def case(m):
        eng = _FakeEngine(m, tmp_path)
        coord = m.cs.ColdStartCoordinator(eng)
        out = [coord.phase]
        coord.note_serving_started()
        snap = eng.stats.snapshot()
        out += [coord.phase, snap["boot_phase"], snap["boot_phase_code"]]
        coord.note_weights_resident()      # no warm-ups: to steady
        coord.note_serving_started()       # a late note never rewinds
        times = coord.phase_times()
        out += [coord.phase, eng.stats.snapshot()["boot_phase"],
                sorted(times), times["faulting"] <= times["steady"]]
        return out
    assert _both(case) == ["cold", "faulting", "faulting", 1, "steady",
                           "steady", ["cold", "faulting", "steady",
                                      "warming"], True]
    assert p_cs.PHASES == j_cs.PHASES


def test_warmup_thunks_drain_to_steady(tmp_path):
    def case(m):
        coord = m.cs.ColdStartCoordinator(_FakeEngine(m, tmp_path))
        ran = []
        coord.add_warmup(lambda: ran.append("a"))
        coord.add_warmup(lambda: 1 / 0)    # best effort: never raises
        coord.add_warmup(lambda: ran.append("b"))
        coord.note_serving_started()
        coord.note_weights_resident()
        steady = coord.wait_steady(10.0)
        coord.add_warmup(lambda: ran.append("late"))   # runs at once
        return steady, ran
    assert _both(case) == (True, ["a", "b", "late"])


def test_stall_trigger_dumps_flight_with_backlog(tmp_path):
    def case(m):
        d = tmp_path / m.name
        os.makedirs(d)
        eng = _FakeEngine(m, d)
        coord = m.cs.ColdStartCoordinator(eng, cfg=m.config.ColdStartConfig(
            enabled=True, fault_slo_ms=1.0, fault_window=16,
            warm_hint_spans=1, warm_pages=1))
        coord.note_fault_ms(100.0)         # cold: disarmed
        out = [eng.stats.coldstart_stall_dumps]
        coord.note_serving_started()
        for _ in range(8):
            coord.note_fault_ms(50.0)
        out.append(eng.stats.coldstart_stall_dumps)
        dumps = sorted(d.glob("strom_flight_*coldstart_stall*.json"))
        doc = json.loads(dumps[0].read_text())
        coord.note_weights_resident()
        coord.note_fault_ms(500.0)         # past faulting: disarmed
        return out + [len(dumps), doc["reason"], doc["extra"],
                      eng.stats.coldstart_stall_dumps]
    got = _both(case)
    assert got[:4] == [0, 1, 1, "coldstart_stall"]
    assert got[4] == {"boot_phase": "faulting", "fault_p99_ms": 50.0,
                      "fault_slo_ms": 1.0, "browned_out": False,
                      "backlog": {"restore": {"batches": 2, "spans": 7,
                                              "oldest_wait_s": 0.5}}}
    assert got[5] == 1


def test_supervisor_degraded_listener_and_brownout_counter(tmp_path):
    def case(m):
        sup = m.health.EngineSupervisor.__new__(m.health.EngineSupervisor)
        sup._degraded_listeners = []
        seen = []
        sup.add_degraded_listener(lambda on: seen.append(on))
        sup.add_degraded_listener(lambda on: 1 / 0)   # never wedges
        sup._notify_degraded(True)
        sup._notify_degraded(False)
        eng = _FakeEngine(m, tmp_path)
        coord = m.cs.ColdStartCoordinator(eng)
        coord.note_serving_started()
        coord._on_degraded(True)
        out = [seen, eng.stats.coldstart_brownouts]
        coord._on_degraded(False)          # recovery is no brown-out
        out.append(eng.stats.coldstart_brownouts)
        coord.note_weights_resident()
        coord._on_degraded(True)           # steady: not a boot's
        return out + [eng.stats.coldstart_brownouts]
    assert _both(case) == [[True, False], 1, 1, 1]


def test_coordinator_listens_to_a_real_supervisor(tmp_path, monkeypatch):
    monkeypatch.setenv("STROM_BREAKER_DEVICE_ERRORS", "2")
    monkeypatch.setenv("STROM_FLIGHT_DIR", str(tmp_path))

    def case(m):
        eng = _engine(m)
        try:
            coord = m.cs.ColdStartCoordinator(eng)
            coord.note_serving_started()
            for _ in range(2):
                eng.supervisor.note_error(ring=0, err=5)
            return eng.supervisor.degraded(), eng.stats.coldstart_brownouts
        finally:
            eng.close_all()
    assert _both(case) == (True, 1)


def test_consume_handoff_waits_for_the_handoff_port(tmp_path,
                                                    monkeypatch):
    """The handoff port has landed: a coordinator booting from a missing
    bundle under both gates browns out to the plain cold start, as the
    JAX one does (the whole protocol, and the gates off, are
    tests/test_torch_handoff.py)."""
    monkeypatch.setenv("STROM_COLDSTART", "1")
    monkeypatch.setenv("STROM_HANDOFF", "1")

    def case(m):
        eng = _FakeEngine(m, tmp_path)
        got = m.cs.ColdStartCoordinator(eng).consume_handoff(
            str(tmp_path / "nonexistent"))
        return got, eng.stats.handoff_brownouts, \
            eng.stats.handoff_sessions_restored
    assert _both(case) == (None, 1, 0)


def test_scheduler_backlog_shape():
    def case(m):
        sched = m.sched.QoSScheduler(lambda spans, ring: ["p"] * len(spans),
                                     lambda: [0])   # no slot: stays queued
        out = [sched.backlog()]
        sched.enqueue([("a", 0, 1), ("b", 0, 1)], "restore")
        time.sleep(0.01)
        back = sched.backlog()
        return out + [sorted(back), back["restore"]["batches"],
                      back["restore"]["spans"],
                      back["restore"]["oldest_wait_s"] > 0.0]
    assert _both(case) == [{}, ["restore"], 1, 2, True]


# -- FaultingCheckpoint -------------------------------------------------------

def test_faulting_checkpoint_tokens_identical_to_eager(models, ckpt):
    """A server started before its weights are resident gives the eager
    server's tokens, in both packages and across them; each tensor is
    loaded once across the two lanes; the phases reach steady."""
    prompt = np.random.default_rng(11).integers(0, 128, 5).tolist()

    def case(m):
        cfg, params = models[m.name]
        want = _serve(m, cfg, params, prompt, 8)
        eng = _engine(m)
        try:
            coord = m.cs.ColdStartCoordinator(eng)
            fck = _faulting(m, ckpt, eng, coord)
            cold = fck.resident()
            got = _serve(m, cfg, fck, prompt, 8)
            fck.join_bulk(30.0)
            n = len(list(fck.keys()))
            st = eng.stats
            return {"cold_at_start": cold, "equal": got == want,
                    "tokens": got, "resident": fck.resident(),
                    "loaded_once": st.coldstart_faults
                    + st.coldstart_bulk_tensors == n,
                    "n": n, "phase": coord.phase,
                    "gauge": st.snapshot()["boot_phase"]}
        finally:
            fck.close()
            eng.close_all()
    got = _both(case)
    assert got["equal"] and not got["cold_at_start"] and got["resident"]
    assert got["loaded_once"] and got["phase"] == "steady"
    assert got["n"] == len(models["np"])


def test_faulting_tensors_equal_the_eager_load(models, ckpt):
    eng = _engine(PKGS["port"])
    try:
        want = p_weights.LazyCheckpoint(ckpt).load(eng, device="cpu")
        fck = _faulting(PKGS["port"], ckpt, eng)
        fck.start_bulk()
        got = fck.materialize()
        fck.join_bulk(30.0)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
            assert np.array_equal(got[k].numpy(), models["np"][k])
        assert fck.fault_names() == [
            k for k in want if k in fck.fault_names()]
    finally:
        fck.close()
        eng.close_all()


def test_demand_fault_counts_bytes_and_latency(models, ckpt, tmp_path):
    def case(m):
        eng = _engine(m)
        try:
            coord = m.cs.ColdStartCoordinator(eng)
            coord.note_serving_started()
            fck = _faulting(m, ckpt, eng, coord)
            name = sorted(fck.keys())[0]
            a = fck.get(name)
            out = [eng.stats.coldstart_faults,
                   eng.stats.coldstart_fault_bytes, fck.fault_names(),
                   len(coord._fault_ms)]
            b = fck.get(name)                # resident: no second read
            same = (a is b) if m.name == "jax" else torch.equal(a, b)
            out += [same, eng.stats.coldstart_faults,
                    fck.get(name, klass="restore") is not None,
                    eng.stats.coldstart_faults]
            fck.close()
            return out
        finally:
            eng.close_all()
    got = _both(case)
    assert got[0] == 1 and got[1] > 0 and got[3] == 1
    assert got[4:] == [True, 1, True, 1]


def test_failed_claim_is_reclaimed_at_decode(models, ckpt, monkeypatch):
    """A claim that fails wakes its waiters and is dropped: the next
    caller loads the tensor itself."""
    eng = _engine(PKGS["port"])
    try:
        fck = _faulting(PKGS["port"], ckpt, eng)
        name = sorted(fck.keys())[0]
        real = fck.ckpt._load_tensor
        calls = []

        def flaky(e, n, dev, policy, stamps, klass=None, stream=None):
            calls.append(klass)
            if len(calls) == 1:
                time.sleep(0.05)
                raise OSError(5, "injected bulk failure")
            return real(e, n, dev, policy, stamps, klass=klass,
                        stream=stream)

        monkeypatch.setattr(fck.ckpt, "_load_tensor", flaky)
        errs = []

        def bulk():
            try:
                fck._acquire(name, eng, "restore")
            except OSError as e:
                errs.append(e)

        t = threading.Thread(target=bulk)
        t.start()
        time.sleep(0.01)
        got = fck.get(name)                  # waits, then re-claims
        t.join(5.0)
        assert not t.is_alive() and len(errs) == 1
        assert calls == ["restore", "decode"]
        assert np.array_equal(got.numpy(), models["np"][name])
        assert eng.stats.coldstart_faults == 1
    finally:
        eng.close_all()


def test_lanes_walk_from_opposite_ends(models, ckpt, monkeypatch):
    """A first step that starts with the bulk lane faults the tensors in
    from the first key while the bulk lane loads them from the last: the
    faulted ones are a prefix of the keys, the bulk lane's the rest, each
    loaded once."""
    eng = _engine(PKGS["port"])
    try:
        fck = _faulting(PKGS["port"], ckpt, eng)
        real = fck.ckpt._load_tensor

        def slow(*a, **kw):
            time.sleep(0.02)               # a read the lanes can overlap
            return real(*a, **kw)

        monkeypatch.setattr(fck.ckpt, "_load_tensor", slow)
        keys = list(fck.keys())
        fck.start_bulk()
        got = fck.materialize()
        fck.join_bulk(30.0)
        faulted = fck.fault_names()
        st = eng.stats
        assert faulted == keys[:len(faulted)]
        assert 0 < st.coldstart_faults < len(keys)
        assert st.coldstart_faults + st.coldstart_bulk_tensors == len(keys)
        assert not fck.bulk_errors
        for k in keys:
            assert np.array_equal(got[k].numpy(), models["np"][k]), k
    finally:
        eng.close_all()


def test_bulk_lane_rides_the_scatter_restore(models, ckpt, monkeypatch):
    """Under STROM_ICI_SCATTER=1 the bulk lane reads every tensor from
    the exchange's gathered shares, as LazyCheckpoint.load does; the
    tensors equal the file's."""
    from nvme_strom_tpu_torch.parallel.mesh import exchange_group
    monkeypatch.setenv("STROM_ICI_SCATTER", "1")
    eng = _engine(PKGS["port"])
    try:
        fck = p_weights.FaultingCheckpoint(
            ckpt, device="cpu", engine=eng,
            ici_group=exchange_group(devices=["cpu"] * 4))
        fck.start_bulk()
        fck.join_bulk(30.0)
        assert fck.resident() and not fck.bulk_errors
        got = fck.materialize()
        assert eng.stats.coldstart_bulk_tensors == len(models["np"])
        assert eng.stats.coldstart_faults == 0
        assert eng.stats.ici_bytes_read > 0 and not eng.stats.ici_fallbacks
        for k, a in models["np"].items():
            assert np.array_equal(got[k].numpy(), a), k
    finally:
        eng.close_all()


@pytest.mark.chaos
def test_ring_failure_mid_bulk_restore_zero_consumer_errors(
        models, ckpt, monkeypatch):
    """Ring 1 wedged before the bulk lane streams: the breaker trips, the
    ring restarts, parked reads requeue, demand faults keep the server
    answering, and the tokens are the eager server's in both packages."""
    for k, v in {"STROM_BREAKER_STALL_S": "0.1",
                 "STROM_BREAKER_DRAIN_S": "0.5",
                 "STROM_BREAKER_RESTART_S": "0",
                 "STROM_BREAKER_HALF_OPEN_S": "0.05",
                 "STROM_SCHED": "0"}.items():
        monkeypatch.setenv(k, v)
    prompt = np.random.default_rng(23).integers(0, 128, 5).tolist()

    def case(m):
        cfg, params = models[m.name]
        want = _serve(m, cfg, params, prompt, 8)
        base = _engine(m, n_rings=2, chunk_bytes=1 << 16, queue_depth=4,
                       buffer_pool_bytes=16 * MB)
        eng = m.Resilient(base, m.config.ResilientConfig(
            max_retries=6, backoff_base_s=0.0005, backoff_max_s=0.002,
            hedging=False, stuck_timeout_s=60.0))
        stop = threading.Event()

        def tick():
            while not stop.is_set():
                base.supervisor.tick(force=True)
                time.sleep(0.05)

        ticker = threading.Thread(target=tick, daemon=True)
        fck = None
        try:
            m.faults.set_ring_stall(base, 1, True)
            ticker.start()
            coord = m.cs.ColdStartCoordinator(base)
            fck = _faulting(m, ckpt, eng, coord)
            got = _serve(m, cfg, fck, prompt, 8)
            fck.join_bulk(60.0)
            st = base.stats
            return {"equal": got == want, "tokens": got,
                    "resident": fck.resident(),
                    "loaded_once": st.coldstart_faults
                    + st.coldstart_bulk_tensors == len(list(fck.keys())),
                    "tripped": st.breaker_trips >= 1,
                    "restarted": st.ring_restarts >= 1,
                    "phase": coord.phase}
        finally:
            stop.set()
            ticker.join(2.0)
            if fck is not None:
                fck.close()
            eng.close_all()
    got = _both(case)
    assert got["equal"] and got["resident"] and got["loaded_once"]
    assert got["tripped"] and got["restarted"] and got["phase"] == "steady"


# -- warm-state manifests -----------------------------------------------------

def test_warm_hints_roundtrip_staleness_and_bounds(tmp_path):
    """Each package reads the other's manifests; a rewritten file, a
    span past the end, corrupt JSON and no manifest all load empty."""
    base = tmp_path / "w.bin"
    base.write_bytes(b"x" * 8192)
    st0 = os.stat(base)

    def case(m):
        other = PKGS["jax" if m.name == "port" else "port"]
        os.utime(base, ns=(st0.st_atime_ns, st0.st_mtime_ns))
        st = os.stat(base)
        manifest = m.warm.hint_path(str(base))
        out = [manifest.endswith(m.warm.WARMHINT_SUFFIX)]
        m.warm.write_warm_hints(manifest, [(0, 4096), (4096, 4096)],
                                size=st.st_size, mtime_ns=st.st_mtime_ns)
        out += [m.warm.load_warm_hints(str(base)),
                other.warm.load_warm_hints(str(base)),
                open(manifest).read()]
        os.utime(base, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
        out.append(m.warm.load_warm_hints(str(base)))
        st = os.stat(base)
        m.warm.write_warm_hints(manifest, [(4096, 8192)], size=st.st_size,
                                mtime_ns=st.st_mtime_ns)
        out.append(m.warm.load_warm_hints(str(base)))
        with open(manifest, "w") as f:
            f.write("{not json")
        out.append(m.warm.load_warm_hints(str(base)))
        os.unlink(manifest)
        out.append(m.warm.load_warm_hints(str(base)))
        return out
    got = _both(case)
    assert got[0] and got[1] == got[2] == [(0, 4096), (4096, 4096)]
    assert got[4:] == [[], [], [], []]


def test_orphan_warmhints_swept_by_age_gated_gc(tmp_path):
    def make(root):
        os.makedirs(root)
        gone, live = root / "gone.bin", root / "live.bin"
        for p in (gone, live):
            p.write_bytes(b"y" * 4096)
            p_warm.write_warm_hints(p_warm.hint_path(str(p)), [(0, 4096)],
                                    size=4096,
                                    mtime_ns=os.stat(p).st_mtime_ns)
        (root / "store.kvstore.kvman.json").write_text("{}")
        os.unlink(gone)
        return gone, live

    out = {}
    for name, find, sweep in (("port", p_manager.find_orphan_manifests,
                               p_manager.sweep_orphan_manifests),
                              ("jax", j_find_orphans, j_sweep_orphans)):
        root = tmp_path / name
        gone, live = make(root)
        orphans = find(str(root))
        kept = sweep(orphans, min_age=3600.0)      # too fresh: kept
        removed = sweep(orphans, min_age=0.0)
        out[name] = ([os.path.relpath(p, root) for p in orphans], kept,
                     [os.path.relpath(p, root) for p in removed],
                     os.path.exists(p_warm.hint_path(str(live))))
    assert out["port"] == out["jax"]
    assert out["port"] == (["gone.bin.warmhints.json",
                            "store.kvstore.kvman.json"], [],
                           ["gone.bin.warmhints.json",
                            "store.kvstore.kvman.json"], True)


def test_collect_and_prefetch_hints_through_hostcache(tmp_path):
    LINE = 64 << 10
    path = tmp_path / "hot.bin"
    path.write_bytes(np.random.default_rng(5).integers(
        0, 256, 4 * LINE, dtype=np.uint8).tobytes())

    def case(m):
        m.hc.configure(m.config.HostCacheConfig(budget_mb=1,
                                                line_bytes=LINE))
        try:
            eng = _engine(m, buffer_pool_bytes=16 * MB)
            try:
                fh = eng.open(str(path))
                extents = [(fh, 0, LINE), (fh, 2 * LINE, LINE)]
                for _ in range(2):         # ghost-noted, then filled
                    for pieces in m.plan.plan_and_submit(eng, extents,
                                                         klass="decode"):
                        for p in pieces:
                            p.wait()
                            p.release()
                manifest = m.warm.collect_warm_hints(eng, str(path))
                spans = m.warm.load_warm_hints(str(path))
                warmed = m.warm.prefetch_hints(eng, str(path))
                refreshed = m.warm.refresh_hints(eng, [str(path),
                                                       str(path), ""])
                eng.close(fh)
                return (os.path.basename(manifest), spans, warmed,
                        eng.stats.coldstart_warm_spans,
                        [os.path.basename(p) for p in refreshed])
            finally:
                eng.close_all()
        finally:
            m.hc.reset()
    got = _both(case)
    assert got[0] == "hot.bin.warmhints.json"
    assert got[1] == [(0, LINE), (2 * LINE, LINE)]
    assert got[2] == got[3] == 2 and got[4] == ["hot.bin"]


def test_collect_hints_without_a_tier_writes_nothing(tmp_path):
    path = tmp_path / "cold.bin"
    path.write_bytes(b"z" * 8192)

    def case(m):
        eng = _engine(m)
        try:
            return (m.warm.collect_warm_hints(eng, str(path)),
                    m.warm.prefetch_hints(eng, str(path)),
                    os.path.exists(m.warm.hint_path(str(path))))
        finally:
            eng.close_all()
    assert _both(case) == (None, 0, False)


def test_prefix_store_warm_pages(models, tmp_path):
    PAGE = 4
    prompt = np.random.default_rng(9).integers(0, 128, 2 * PAGE).tolist()

    def case(m):
        cfg, params = models[m.name]
        page_bytes = 2 * cfg.n_layers * cfg.n_kv_heads * PAGE \
            * cfg.head_dim * 4
        eng = _engine(m, buffer_pool_bytes=16 * MB)
        try:
            store = m.kv.PrefixStore(cfg, eng,
                                     str(tmp_path / f"{m.name}.kvstore"),
                                     page_tokens=PAGE,
                                     capacity_bytes=64 * page_bytes)
            extra = {} if m.name == "jax" else {"device": "cpu"}
            srv = m.serving.DecodeServer(params, cfg, max_batch=2,
                                         max_len=64, kv_store=store,
                                         **extra)
            srv.submit("r", prompt + [1, 2], 4)
            toks = srv.run()["r"]
            out = [eng.stats.kv_pages_written, store.warm_pages(0)]
            warmed = store.warm_pages(8)
            out += [warmed, eng.stats.coldstart_warm_pages, toks]
            store.close()
            return out
        finally:
            eng.close_all()
    got = _both(case)
    assert got[0] >= 2 and got[1] == 0 and got[2] >= 2
    assert got[3] == got[2]
