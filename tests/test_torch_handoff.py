"""Drain and warm handoff in the port (nvme_strom_tpu_torch/io/handoff.py,
the servers' drain gate and ``export_sessions``,
``ColdStartCoordinator.consume_handoff`` and checkpoint/manager.py's
orphan sweep) held against the JAX package on the CPU: the cases of
tests/test_handoff.py, each run through both packages where both can run
it, with phases, gauges, counters, dump payloads, bundle documents and
greedy tokens compared exactly.

The model is the JAX fixtures' ``tiny_config()`` in float32; the port's
parameters are the JAX ones converted.  A bundle document is compared
field by field with the JAX bundle's, except its time stamps and paths.
The JAX exit hook also writes a last metrics export
(``STROM_STATS_EXPORT``), which waits for the port's ``strom_stat``
tooling; the forced flight dump is compared."""

import dataclasses
import json
import os
import signal
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
from nvme_strom_tpu.io import flightrec as j_flight
from nvme_strom_tpu.io import handoff as j_ho
from nvme_strom_tpu.io import tenants as j_tenants
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
from nvme_strom_tpu_torch.io import flightrec as p_flight
from nvme_strom_tpu_torch.io import handoff as p_ho
from nvme_strom_tpu_torch.io import tenants as p_tenants
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
MAX_NEW = 10

HANDOFF_COUNTERS = (
    "handoff_drains", "handoff_deferred", "handoff_sessions_exported",
    "handoff_sessions_restored", "handoff_bundles",
    "handoff_bundle_bytes", "handoff_brownouts", "handoff_stall_dumps")

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", ho=j_ho, cs=j_cs, flight=j_flight, tenants=j_tenants,
        warm=j_warm, kv=j_kv, serving=j_serving, weights=j_weights,
        config=j_config, Stats=JaxStats, Engine=JaxEngine,
        Resilient=JaxResilient, find=j_find_orphans,
        sweep=j_sweep_orphans),
    "port": types.SimpleNamespace(
        name="port", ho=p_ho, cs=p_cs, flight=p_flight, tenants=p_tenants,
        warm=p_warm, kv=p_kv, serving=p_serving, weights=p_weights,
        config=p_config, Stats=StromStats, Engine=StromEngine,
        Resilient=ResilientEngine, find=p_manager.find_orphan_manifests,
        sweep=p_manager.sweep_orphan_manifests),
}
PORT, JAX = PKGS["port"], PKGS["jax"]


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


#: the gates the port's handoff reads (the JAX package reads neither:
#: its integrators do)
GATES = ("STROM_HANDOFF", "STROM_COLDSTART")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    """A clean environment with both gates on: the protocol's cases run
    armed; the config and gate-off cases take the gates off."""
    for k in ("STROM_DRAIN_DEADLINE_S",
              "STROM_DRAIN_ON_SIGTERM", "STROM_HANDOFF_MAX_SESSIONS",
              "STROM_DRAIN_POLL_MS", "STROM_FAULTS", "STROM_RESILIENT",
              "STROM_ICI_SCATTER", "STROM_HOSTCACHE_MB", "STROM_TENANTS",
              "STROM_CKPT_GC_AGE_S", "STROM_STATS_EXPORT"):
        monkeypatch.delenv(k, raising=False)
    for k in GATES:
        monkeypatch.setenv(k, "1")


@pytest.fixture(scope="module")
def models():
    cfg_j = jtr.TransformerConfig(**{**jtr.tiny_config().__dict__,
                                     "dtype": jnp.float32})
    cfg_t = dataclasses.replace(ttr.tiny_config(), dtype=torch.float32)
    pj = jtr.init_params(jax.random.key(0), cfg_j)
    np_params = {k: np.asarray(v) for k, v in pj.items()}
    pt = params_from_jax(np_params, cfg_t, "cpu")
    return {"jax": (cfg_j, pj), "port": (cfg_t, pt), "np": np_params}


@pytest.fixture(scope="module")
def ckpt(models, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "model.safetensors")
    j_write_st(path, models["np"])
    return path


def _sessions(cfg, n=3, plen=40, seed=5):
    rng = np.random.default_rng(seed)
    return [(f"s{i}", rng.integers(0, cfg.vocab, plen).tolist())
            for i in range(n)]


def _engine(m):
    stats = m.Stats()
    eng = m.Resilient(m.Engine(
        m.config.EngineConfig(chunk_bytes=1 << 20, queue_depth=8,
                              buffer_pool_bytes=16 * MB, n_rings=0),
        stats=stats))
    return eng, stats


def _faulting(m, ckpt, eng, coord=None):
    if m.name == "jax":
        shard = jax.sharding.SingleDeviceSharding(jax.devices()[0])
        return m.weights.FaultingCheckpoint(
            ckpt, lambda name, shape: shard, engine=eng,
            coordinator=coord)
    return m.weights.FaultingCheckpoint(ckpt, device="cpu", engine=eng,
                                        coordinator=coord)


def _server(m, cfg, params, kind="dense", max_batch=4, **kw):
    if m.name == "port":
        kw["device"] = "cpu"
    if kind == "paged":
        return m.serving.PagedDecodeServer(params, cfg, max_batch=max_batch,
                                           max_len=128, total_blocks=40,
                                           block_len=16, **kw)
    return m.serving.DecodeServer(params, cfg, max_batch=max_batch,
                                  max_len=128, **kw)


@pytest.fixture(scope="module")
def want(models):
    """The JAX server's undisturbed tokens of the three sessions."""
    cfg, params = models["jax"]
    srv = _server(JAX, cfg, params)
    for rid, p in _sessions(cfg):
        srv.submit(rid, p, MAX_NEW)
    return srv.run(2)


class _FakeFlightEngine:
    """Stats, a flight recorder and a scheduler whose backlog is known."""

    class _Sched:
        def backlog(self):
            return {"decode": {"batches": 1, "spans": 3,
                               "oldest_wait_s": 0.2}}

    def __init__(self, m, d):
        os.makedirs(d, exist_ok=True)
        self.stats = m.Stats()
        self.flight = m.flight.FlightRecorder(m.config.FlightConfig(
            enabled=True, ops=16, dir=str(d), min_interval_s=0.0),
            self.stats)
        self.scheduler = self._Sched()
        self.supervisor = None


# -- config and the inert default ---------------------------------------------

#: the JAX config's fields the port keeps (``poll_ms`` paces a loop the
#: port's serving steps pace themselves)
HANDOFF_FIELDS = ("enabled", "deadline_s", "drain_on_sigterm",
                  "max_sessions")


def test_config_defaults_and_validation(monkeypatch):
    for k in GATES:
        monkeypatch.delenv(k)

    def case(m):
        cfg = dataclasses.asdict(m.config.HandoffConfig())
        out = [{k: cfg[k] for k in HANDOFF_FIELDS},
               m.config.handoff_enabled()]
        for bad in (dict(deadline_s=-1.0), dict(max_sessions=-1)):
            with pytest.raises(ValueError) as e:
                m.config.HandoffConfig(enabled=False, **bad)
            out.append(str(e.value))
        return out
    got = _both(case)
    assert got[0] == {"enabled": False, "deadline_s": 30.0,
                      "drain_on_sigterm": False, "max_sessions": 256}
    assert got[1] is False
    assert tuple(dataclasses.asdict(p_config.HandoffConfig())) == \
        HANDOFF_FIELDS
    for k, v in (("STROM_HANDOFF", "1"), ("STROM_DRAIN_DEADLINE_S", "2.5"),
                 ("STROM_DRAIN_ON_SIGTERM", "1"),
                 ("STROM_HANDOFF_MAX_SESSIONS", "7")):
        monkeypatch.setenv(k, v)
    got = _both(lambda m: ({k: v for k, v in dataclasses.asdict(
        m.config.HandoffConfig()).items() if k in HANDOFF_FIELDS},
        m.config.handoff_enabled()))
    assert got == ({"enabled": True, "deadline_s": 2.5,
                    "drain_on_sigterm": True, "max_sessions": 7}, True)


def test_gate_off_is_bit_for_bit_inert(models, tmp_path, monkeypatch):
    """Plain serving with the gate off: the drain flag never sets,
    stats() has no drain key, no handoff counter moves and no drain
    gauge appears; the tokens are the JAX server's.  Then the port's
    machinery with its gates off: a coordinator asked to drain stays in
    ``serving`` and leaves the server's admission open, so the server
    still gives the JAX server's undisturbed tokens; no signal handler
    is installed; a valid bundle is neither replayed nor counted as a
    brown-out, whichever of the two gates is off."""
    for k in GATES:
        monkeypatch.delenv(k)

    def case(m):
        cfg, params = models[m.name]
        srv = _server(m, cfg, params)
        for rid, p in _sessions(cfg, n=2):
            srv.submit(rid, p, MAX_NEW)
        out = srv.run(2)
        st = srv.stats()
        stats = m.Stats()
        snap = stats.snapshot()
        return (out, srv.draining, srv.admissions_deferred,
                "draining" in st or "admissions_deferred" in st,
                [getattr(stats, n) for n in HANDOFF_COUNTERS],
                "drain_phase" in snap or "handoff_source" in snap)
    out, draining, deferred, keys, ctr, gauge = _both(case)
    assert all(len(v) == MAX_NEW for v in out.values())
    assert (draining, deferred, keys, any(ctr), gauge) == (
        False, 0, False, False, False)

    cfg, params = models["port"]
    eng, stats = _engine(PORT)
    try:
        srv = _server(PORT, cfg, params)
        for rid, p in _sessions(cfg, n=2):
            srv.submit(rid, p, MAX_NEW)
        base = tmp_path / "pages.kvstore"
        coord = p_ho.DrainCoordinator(
            eng, server=srv, bundle=p_ho.bundle_path(str(base)),
            cfg=p_config.HandoffConfig(drain_on_sigterm=True))
        before = signal.getsignal(signal.SIGTERM)
        assert p_ho.install_drain_signals(coord) is None
        assert signal.getsignal(signal.SIGTERM) is before
        assert coord.begin_drain() is False
        assert coord.drain(deadline_s=0.0) == {"results": {},
                                               "bundle": None}
        assert coord.publish_bundle() is None
        assert coord.phase == "serving" and not srv.draining
        assert srv.run(2) == out and srv.idle
        base.write_bytes(b"x" * 64)
        p_ho.write_handoff_bundle(str(base), {"sessions": [
            {"rid": "a", "prompt": [1, 2, 3], "max_new": 2}]})
        assert p_ho.consume_bundle(str(base), engine=eng,
                                   server=srv) is None
        assert p_cs.ColdStartCoordinator(eng).consume_handoff(
            str(base), server=srv) is None
        monkeypatch.setenv("STROM_HANDOFF", "1")   # one gate of two
        assert p_cs.ColdStartCoordinator(eng).consume_handoff(
            str(base), server=srv) is None
        monkeypatch.delenv("STROM_HANDOFF")
        monkeypatch.setenv("STROM_COLDSTART", "1")
        assert p_cs.ColdStartCoordinator(eng).consume_handoff(
            str(base), server=srv) is None
        assert srv.idle and p_ho.load_handoff_bundle(str(base))
        snap = stats.snapshot()
        assert not any(getattr(stats, n) for n in HANDOFF_COUNTERS)
        assert "drain_phase" not in snap and "handoff_source" not in snap
    finally:
        eng.close_all()


# -- the coordinator: phase machine, drain gate, stall dump --------------------

def test_phase_machine_is_forward_only_and_exports_gauge(tmp_path):
    def case(m):
        eng = _FakeFlightEngine(m, tmp_path / m.name)
        coord = m.ho.DrainCoordinator(eng)
        out = [coord.phase, m.ho.DRAIN_PHASES, coord.begin_drain(),
               coord.phase]
        snap = eng.stats.snapshot()
        out += [snap["drain_phase"], snap["drain_phase_code"],
                eng.stats.handoff_drains, coord.begin_drain(),
                eng.stats.handoff_drains, coord._advance("retired"),
                coord._advance("handing_off"), coord.phase,
                eng.stats.snapshot()["drain_phase"]]
        times = coord.phase_times()
        out += [sorted(times), times["draining"] <= times["retired"]]
        return out
    got = _both(case)
    assert got == ["serving", ("serving", "draining", "handing_off",
                               "retired"), True, "draining", "draining", 1,
                   1, False, 1, True, False, "retired", "retired",
                   ["draining", "retired", "serving"], True]


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_drain_defers_admissions_and_nothing_drops(models, kind):
    """A draining server defers new admissions (they stay queued for
    export), its in-flight slots finish, ``run`` does not spin on the
    closed gate, and the export takes the queued request off it."""
    def case(m):
        cfg, params = models[m.name]
        sessions = _sessions(cfg, n=2)
        srv = _server(m, cfg, params, kind, max_batch=2)
        for rid, p in sessions:
            srv.submit(rid, p, MAX_NEW)
        srv.step_many(1)                     # both admitted
        srv.begin_drain()
        srv.submit("late", sessions[0][1], MAX_NEW)
        out = {}
        for _ in range(MAX_NEW + 2):
            out.update(srv.step_many(1))
        st = srv.stats()
        res = [out, [r.rid for r in srv.queue], srv.admissions_deferred,
               st["draining"], st["admissions_deferred"], srv.run(1)]
        exported = srv.export_sessions(8, pop=True)
        res += [exported, srv.idle]
        if kind == "paged":
            res.append(len(srv.free) + len(srv._pc_lru))
        return res
    got = _both(case)
    out, queue, deferred, draining, st_deferred, ran, exported, idle = \
        got[:8]
    assert sorted(out) == ["s0", "s1"] and "late" not in out
    assert all(len(v) == MAX_NEW for v in out.values())
    assert queue == ["late"] and deferred > 0 and draining is True
    assert st_deferred == deferred and ran == {}
    assert [s["rid"] for s in exported] == ["late"] and idle
    if kind == "paged":
        assert got[8] == 40                  # every block back


def test_drain_deadline_stall_dump_carries_backlog(models, tmp_path):
    """A drain past its deadline with sessions decoding dumps
    ``handoff_stall`` with the phase and the backlog, and still
    publishes (without a store nothing anchors a bundle)."""
    def case(m):
        cfg, params = models[m.name]
        srv = _server(m, cfg, params, max_batch=2)
        for rid, p in _sessions(cfg, n=2):
            srv.submit(rid, p, MAX_NEW)
        srv.step_many(1)
        d = tmp_path / m.name
        eng = _FakeFlightEngine(m, d)
        coord = m.ho.DrainCoordinator(eng, server=srv)
        res = coord.drain(deadline_s=0.0)
        dumps = sorted(d.glob("strom_flight_*handoff_stall*.json"))
        doc = json.loads(dumps[0].read_text())
        extra = doc["extra"]
        return (coord.phase, res["bundle"], res["results"],
                eng.stats.handoff_stall_dumps, len(dumps), doc["reason"],
                extra["drain_phase"], extra["deadline_s"],
                extra["slots_busy"], extra["queued"], extra["backlog"],
                srv.idle)
    got = _both(case)
    assert got[:10] == ("retired", None, {}, 1, 1, "handoff_stall",
                        "draining", 0.0, 2, 0)
    assert got[10]["decode"]["spans"] == 3
    # with nothing to anchor a bundle nothing is exported: the sessions
    # stay on the server
    assert got[11] is False


# -- the bundle: atomic publish, staleness, the brown-out ladder ---------------

def test_bundle_roundtrip_staleness_and_corruption(tmp_path):
    def case(m):
        d = tmp_path / m.name
        d.mkdir()
        base = d / "pages.kvstore"
        base.write_bytes(b"x" * 8192)
        sess = [{"rid": "a", "prompt": [1, 2, 3], "emitted": [4],
                 "max_new": 5, "eos_id": None, "temperature": 0.0,
                 "top_p": 1.0, "seed": 0, "tenant": None, "kv_keys": []}]
        out = m.ho.write_handoff_bundle(str(base), {
            "sessions": sess, "warm_hints": [], "hot_tensors": ["w.a"],
            "tenants": {}, "checkpoint": None, "kv_manifest": None})
        res = [out == m.ho.bundle_path(str(base)),
               out.endswith(m.ho.HANDOFF_SUFFIX)]
        doc = m.ho.load_handoff_bundle(str(base))
        res.append({k: v for k, v in doc.items() if k != "base"})
        res.append(doc["base"]["size"])
        st = os.stat(base)
        os.utime(base, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
        res.append(m.ho.load_handoff_bundle(str(base)))       # stale
        for bad in ([{"prompt": []}], [{"prompt": [1], "max_new": 0}],
                    [{"prompt": [1.5], "max_new": 2}], "nope"):
            m.ho.write_handoff_bundle(str(base), {"sessions": bad})
            res.append(m.ho.load_handoff_bundle(str(base)))
        ck = d / "w.safetensors"
        ck.write_bytes(b"w" * 64)
        cst = os.stat(ck)
        m.ho.write_handoff_bundle(str(base), {
            "sessions": [], "checkpoint": {"path": str(ck),
                                           "size": cst.st_size,
                                           "mtime_ns": cst.st_mtime_ns}})
        res.append(m.ho.load_handoff_bundle(str(base)) is not None)
        os.utime(ck, ns=(cst.st_atime_ns, cst.st_mtime_ns + 1_000_000))
        res.append(m.ho.load_handoff_bundle(str(base)))   # other weights
        with open(m.ho.bundle_path(str(base)), "w") as f:
            f.write('{"version": 1, "base"')
        res.append(m.ho.load_handoff_bundle(str(base)))   # torn
        os.unlink(m.ho.bundle_path(str(base)))
        res.append(m.ho.load_handoff_bundle(str(base)))   # missing
        res.append(m.ho.write_handoff_bundle(str(d / "gone"), {}))
        return res
    got = _both(case)
    assert got[:2] == [True, True]
    assert got[2]["sessions"][0]["rid"] == "a" and got[2]["version"] == 1
    assert got[3] == 8192
    assert got[4:9] == [None] * 5
    assert got[9] is True and got[10:] == [None] * 4


def test_consume_rejects_bad_bundle_counts_one_brownout(tmp_path):
    def case(m):
        d = tmp_path / m.name
        d.mkdir()
        base = d / "pages.kvstore"
        base.write_bytes(b"x" * 64)
        with open(m.ho.bundle_path(str(base)), "w") as f:
            f.write("{torn")
        stats = m.Stats()
        got = m.ho.consume_bundle(str(base), stats=stats)
        snap = stats.snapshot()
        return (got, stats.handoff_brownouts,
                stats.handoff_sessions_restored, "handoff_source" in snap)
    assert _both(case) == (None, 1, 0, False)


def test_tenant_state_export_restore_bounded(monkeypatch):
    monkeypatch.setenv("STROM_TENANTS", "1")

    def case(m):
        T = m.tenants
        T.reset()
        try:
            reg = T.get_registry()
            reg.get("bronze").share_boost = 2
            out = [reg.export_state()]
            T.reset()
            reg = T.get_registry()
            out.append(reg.get("bronze").share_boost)
            out.append(reg.restore_state({"bronze": {"share_boost": 99},
                                          "junk": "not-a-dict",
                                          "zero": {"share_boost": 0}}))
            out += [reg.get("bronze").share_boost,
                    reg.get("zero").share_boost,
                    m.kv.SloGovernor._MAX_BOOST]
            # the receiving side: boosts re-applied, ledgers folded in
            T.reset()
            stats = m.Stats()
            m.ho._restore_tenants({"gold": {"share_boost": 1,
                                            "ledger": {"requests": 3}}},
                                  stats)
            out += [T.get_registry().get("gold").share_boost,
                    stats.tenant_stats]
            return out
        finally:
            T.reset()
    got = _both(case)
    assert got[:3] == [{"bronze": {"share_boost": 2}}, 0, 1]
    assert got[3] == got[5] and got[4] == 0
    assert got[6:] == [1, {"gold": {"requests": 3}}]


# -- the whole protocol: drain → bundle → consume ------------------------------

def _old_replica(m, models, ckpt, store_path, kind="dense", steps=4):
    """A replica on a FaultingCheckpoint and a PrefixStore, serving the
    sessions for ``steps`` steps: (engine, stats, server, store,
    checkpoint, tokens finished so far)."""
    cfg = models[m.name][0]
    eng, stats = _engine(m)
    fck = _faulting(m, ckpt, eng)
    # two tensors demand-faulted before the bulk lane exists: the claim
    # table's residue is never empty
    for name in sorted(fck.keys())[:2]:
        fck.get(name)
    store = m.kv.PrefixStore(cfg, eng, store_path, page_tokens=16,
                             capacity_bytes=16 * MB)
    srv = _server(m, cfg, fck, kind, kv_store=store)
    for rid, p in _sessions(cfg):
        srv.submit(rid, p, MAX_NEW)
    early = {}
    for _ in range(steps):
        early.update(srv.step_many(1))
    return eng, stats, srv, store, fck, early


def _replacement(m, models, ckpt, store_path, kind="dense", consume=True):
    cfg = models[m.name][0]
    eng, stats = _engine(m)
    coord = m.cs.ColdStartCoordinator(eng)
    fck = _faulting(m, ckpt, eng, coord)
    store = m.kv.PrefixStore(cfg, eng, store_path, page_tokens=16,
                             capacity_bytes=16 * MB)
    srv = _server(m, cfg, fck, kind, kv_store=store)
    consumed = (coord.consume_handoff(store_path, server=srv,
                                      checkpoint=fck)
                if consume else None)
    return eng, stats, srv, store, fck, consumed


def _close(eng, fck, store=None, consumed=None):
    if store is not None:
        store.close()
    if consumed and consumed.get("prefault_thread"):
        consumed["prefault_thread"].join(60.0)
    fck.join_bulk(60.0)
    eng.close_all()


def _handoff(m, models, ckpt, d, kind="dense"):
    """Retire a replica mid-decode and boot its replacement from the
    bundle: (final tokens, the bundle, the old replica's fault names,
    the ready keys, both snapshots, what the replacement consumed, the
    paged pool's free blocks after the export)."""
    os.makedirs(d, exist_ok=True)
    store_path = os.path.join(d, "pages.kvstore")
    eng, stats, srv, store, fck, early = _old_replica(m, models, ckpt,
                                                      store_path, kind)
    try:
        coord = m.ho.DrainCoordinator(eng, server=srv, checkpoint=ckpt)
        res = coord.drain(deadline_s=0.0)   # sessions export mid-decode
        early.update(res["results"])
        assert coord.phase == "retired" and srv.idle
        assert res["bundle"] == m.ho.bundle_path(store_path)
        free = (len(srv.free) + len(srv._pc_lru) if kind == "paged"
                else None)
        doc = m.ho.load_handoff_bundle(store_path)
        ready = set(store.ready_keys())
        faults = fck.fault_names()
        snap_a = stats.snapshot()
        store.close()
    finally:
        _close(eng, fck)
    eng, stats, srv, store, fck, consumed = _replacement(
        m, models, ckpt, store_path, kind)
    try:
        cont = srv.run(2)
        final = dict(early)
        for rid, c in cont.items():
            final[rid] = list(consumed["sessions"][rid]) + list(c)
        snap_b = stats.snapshot()
        info = {k: consumed[k] for k in ("restored", "hot_tensors",
                                         "hints", "sessions")}
    finally:
        _close(eng, fck, store, consumed)
    return final, doc, faults, ready, snap_a, snap_b, info, free


@pytest.fixture(scope="module")
def jax_handoff(models, ckpt, tmp_path_factory):
    return _handoff(JAX, models, ckpt, str(tmp_path_factory.mktemp("jho")))


def _comparable(doc):
    """The bundle less its time stamps and paths (the anchor's and the
    checkpoint's stat keep their sizes)."""
    out = {k: v for k, v in doc.items()
           if k not in ("base", "checkpoint", "kv_manifest", "hot_tensors")}
    out["base_size"] = doc["base"]["size"]
    out["checkpoint_size"] = doc["checkpoint"]["size"]
    out["kv_manifest"] = os.path.basename(doc["kv_manifest"])
    return out


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_full_handoff_is_token_identical_and_audited(
        models, ckpt, want, jax_handoff, tmp_path, kind):
    """Retire mid-decode (deadline 0), boot the replacement from the
    bundle: every session finishes with the JAX server's undisturbed
    tokens and the JAX handoff's, the bundle equals the JAX bundle field
    by field, every shipped page key was proven written, and the claim
    table's residue rides along."""
    final, doc, faults, ready, snap_a, snap_b, info, free = _handoff(
        PORT, models, ckpt, str(tmp_path / "port"), kind)
    j_final, j_doc, j_faults, _j_ready, j_snap_a, j_snap_b, j_info, _ = \
        jax_handoff
    n = len(want)
    assert final == want == j_final           # token-identical, no drop
    assert _comparable(doc) == _comparable(j_doc)
    assert doc["checkpoint"]["path"] == ckpt
    # the flush audit: a session ships only proven-written page keys
    for s in doc["sessions"]:
        assert s["kv_keys"] and set(s["kv_keys"]) <= ready
    # the residue: the old replica's demand faults, the two faulted
    # before any lane first
    assert doc["hot_tensors"] == faults and len(faults) >= 2
    assert faults[:2] == j_faults[:2] == doc["hot_tensors"][:2]
    for key, val in (("handoff_drains", 1), ("handoff_bundles", 1),
                     ("handoff_sessions_exported", n),
                     ("drain_phase", "retired")):
        assert snap_a[key] == j_snap_a[key] == val, key
    assert snap_a["handoff_bundle_bytes"] > 0
    assert snap_b["handoff_sessions_restored"] == n
    assert snap_b["handoff_brownouts"] == 0
    assert snap_b["handoff_source"] == j_snap_b["handoff_source"] == "bundle"
    # exported sessions restored their prompt pages from the store
    assert snap_b["kv_pages_restored"] > 0
    assert info["restored"] == j_info["restored"] == n
    assert info["hot_tensors"] == len(faults)
    assert info["sessions"] == j_info["sessions"]
    if kind == "paged":
        assert free == 40                     # exported slots freed


def test_flush_for_handoff_is_proven_drained_flush(models, ckpt, tmp_path):
    """flush_for_handoff stamps the same clean manifest as flush() and
    returns exactly the stamped (ready) key set."""
    def case(m):
        d = tmp_path / m.name
        d.mkdir()
        eng, _stats, _srv, store, fck, _early = _old_replica(
            m, models, ckpt, str(d / "pages.kvstore"), steps=2)
        try:
            stamped = store.flush_for_handoff()
            with open(store.manifest_path) as f:
                man = json.load(f)
            out = (stamped, stamped == store.ready_keys(), man["clean"],
                   {row["key"] for row in man["pages"].values()}
                   == set(stamped))
            store.close()
            return out
        finally:
            _close(eng, fck)
    stamped, same, clean, listed = _both(case)
    assert stamped and same and clean and listed


def test_consume_warm_hints_through_the_warming_phase(tmp_path):
    """A bundle's warm hints queue on the coordinator's warming phase and
    replay at prefetch class through ``prefetch_hints`` once the
    weights are resident."""
    def case(m):
        d = tmp_path / m.name
        d.mkdir()
        base = d / "pages.kvstore"
        base.write_bytes(b"x" * 8192)
        hot = d / "hot.bin"
        hot.write_bytes(bytes(range(256)) * 64)
        st = os.stat(hot)
        m.warm.write_warm_hints(m.warm.hint_path(str(hot)),
                                [(0, 4096), (8192, 4096)],
                                size=st.st_size, mtime_ns=st.st_mtime_ns)
        m.ho.write_handoff_bundle(str(base), {
            "sessions": [], "warm_hints": [str(hot)], "hot_tensors": []})
        eng = m.Engine(m.config.EngineConfig(
            chunk_bytes=1 << 16, queue_depth=4, buffer_pool_bytes=1 * MB),
            stats=m.Stats())
        try:
            coord = m.cs.ColdStartCoordinator(eng)
            coord.note_serving_started()
            got = coord.consume_handoff(str(base))
            out = [got["hints"], eng.stats.coldstart_warm_spans]
            coord.note_weights_resident()
            out += [coord.wait_steady(30.0),
                    eng.stats.coldstart_warm_spans,
                    eng.stats.snapshot()["handoff_source"]]
            return out
        finally:
            eng.close_all()
    assert _both(case) == [1, 0, True, 2, "bundle"]


# -- the SIGTERM hook -----------------------------------------------------------

def test_sigterm_hook_drains_and_flushes_final_snapshot(
        models, tmp_path, monkeypatch):
    """With the switch off nothing installs; on, SIGTERM drains,
    retires and writes the forced ``handoff_exit`` dump, and the
    uninstall puts the old handler back."""
    def case(m):
        cfg, params = models[m.name]
        d = tmp_path / m.name
        eng = _FakeFlightEngine(m, d)
        srv = _server(m, cfg, params, max_batch=2)
        monkeypatch.delenv("STROM_DRAIN_ON_SIGTERM", raising=False)
        out = [m.ho.install_drain_signals(
            m.ho.DrainCoordinator(eng, server=srv))]
        monkeypatch.setenv("STROM_DRAIN_ON_SIGTERM", "1")
        monkeypatch.setenv("STROM_STATS_EXPORT", str(d / "final.json"))
        before = signal.getsignal(signal.SIGTERM)
        coord = m.ho.DrainCoordinator(eng, server=srv,
                                      cfg=m.config.HandoffConfig())
        prev = m.ho.install_drain_signals(coord, chain=False)
        try:
            out.append(sorted(int(s) for s in prev))
            os.kill(os.getpid(), signal.SIGTERM)
            for _ in range(100):      # the handler runs at a bytecode
                if coord.phase == "retired":    # boundary of this thread
                    break
                time.sleep(0.01)
            dumps = sorted(d.glob("strom_flight_*handoff_exit*"))
            out += [coord.phase, eng.stats.handoff_drains, len(dumps),
                    json.loads(dumps[0].read_text())["extra"]]
        finally:
            m.ho.uninstall_drain_signals(prev)
        out.append(signal.getsignal(signal.SIGTERM) is before)
        return out
    got = _both(case)
    assert got == [None, sorted([int(signal.SIGTERM), int(signal.SIGINT)]),
                   "retired", 1, 1,
                   {"drain_phase": "retired",
                    "reason": f"signal {int(signal.SIGTERM)}"}, True]


# -- the rolling-restart drill: the old replica killed at every phase ----------

@pytest.mark.chaos
@pytest.mark.parametrize("kill_at", ["serving", "draining", "handing_off",
                                     "retired"])
def test_rolling_restart_drill_zero_errors_token_identical(
        models, ckpt, want, tmp_path, kill_at):
    """Killed before the bundle is published (serving, draining) or with
    it torn (handing_off), the replacement browns out to a plain cold
    start and the client's retry recomputes; killed after (retired), it
    boots from the bundle.  Either way no error, and the JAX server's
    undisturbed tokens."""
    store_path = str(tmp_path / "pages.kvstore")
    eng, _stats, srv, _store, fck, early = _old_replica(
        PORT, models, ckpt, store_path)
    try:
        coord = p_ho.DrainCoordinator(eng, server=srv, checkpoint=ckpt)
        if kill_at == "draining":
            coord.begin_drain()             # killed before publishing
        elif kill_at != "serving":
            res = coord.drain(deadline_s=0.0)
            early.update(res["results"])
            assert res["bundle"]
            if kill_at == "handing_off":
                # the torn write a non-atomic publisher would leave: the
                # worst a crash can do to an atomic rename
                with open(res["bundle"], "w") as f:
                    f.write('{"version": 1, ')
        # the kill: no store.close(), only what reached the disk
    finally:
        _close(eng, fck)
    eng, stats, srv, store, fck, consumed = _replacement(
        PORT, models, ckpt, store_path)
    try:
        if kill_at == "retired":
            assert consumed is not None and stats.handoff_brownouts == 0
            final = dict(early)
            for rid, c in srv.run(2).items():
                final[rid] = list(consumed["sessions"][rid]) + list(c)
        else:
            assert consumed is None and stats.handoff_brownouts == 1
            for rid, p in _sessions(models["port"][0]):
                srv.submit(rid, p, MAX_NEW)
            final = srv.run(2)
        assert final == want
    finally:
        _close(eng, fck, store, consumed)


# -- the orphan sweep of all three sidecars -----------------------------------

def test_orphan_handoff_bundles_swept_by_age_gated_gc(tmp_path, monkeypatch):
    """Bundles, store manifests and warm hints whose base file is gone
    are orphans; the age gate keeps fresh ones, and the manager's
    startup sweep removes the stale ones at its top level."""
    def make(m, root):
        root.mkdir()
        for stem in ("gone", "live"):
            base = root / f"{stem}.kvstore"
            base.write_bytes(b"y" * 4096)
            m.ho.write_handoff_bundle(str(base), {"sessions": []})
        (root / "gone.kvstore.kvman.json").write_text("{}")
        (root / "gone.bin.warmhints.json").write_text("{}")
        os.makedirs(root / "nested")
        (root / "nested" / "x.kvstore.handoff.json").write_text("{}")
        os.unlink(root / "gone.kvstore")

    def case(m):
        root = tmp_path / m.name
        make(m, root)
        orphans = m.find(str(root))
        kept = m.sweep(orphans, min_age=3600.0)     # too fresh
        removed = m.sweep(orphans, min_age=0.0)
        rel = [os.path.relpath(p, root) for p in orphans]
        return (rel, kept, [os.path.relpath(p, root) for p in removed],
                os.path.exists(root / "live.kvstore.handoff.json"))
    got = _both(case)
    assert got == (["gone.bin.warmhints.json", "gone.kvstore.handoff.json",
                    "gone.kvstore.kvman.json", "nested/x.kvstore.handoff.json"],
                   [], ["gone.bin.warmhints.json", "gone.kvstore.handoff.json",
                        "gone.kvstore.kvman.json",
                        "nested/x.kvstore.handoff.json"], True)
    # the manager's startup sweep: top level only, under
    # STROM_CKPT_GC_AGE_S
    root = tmp_path / "manager"
    make(PORT, root)
    mgr = p_manager.CheckpointManager(root)
    assert mgr.manifest_gc == []              # the default gate: too fresh
    monkeypatch.setenv("STROM_CKPT_GC_AGE_S", "0")
    mgr = p_manager.CheckpointManager(root)
    assert sorted(os.path.relpath(p, root) for p in mgr.manifest_gc) == [
        "gone.bin.warmhints.json", "gone.kvstore.handoff.json",
        "gone.kvstore.kvman.json"]
    assert (root / "nested" / "x.kvstore.handoff.json").exists()
    assert (root / "live.kvstore.handoff.json").exists()
