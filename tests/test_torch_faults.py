"""Fault injection and recovery in the port (nvme_strom_tpu_torch/io/
faults.py, io/resilient.py, the loader's shard quarantine, the
checkpoint's crash windows and restore step-back, the write mirror under
the KV eviction writes) held against the JAX package's on the CPU.

Parity is exact where the two can be compared: the same plan text and
seed give the same ``FaultPlan.decide`` sequence and the same corrupted
byte; the same plan over the same file through both packages' stacks
(``ResilientEngine(FaultyEngine(StromEngine))``) gives the same payload,
the same attempt history (kind and error of every failed attempt, in
order) and the same recovery counters; the KV page file written under
write faults is the JAX cache's byte for byte; the loader quarantines
the same shard.  Both packages run with their failure-domain supervisor
(io/health.py) on, its default: every failed attempt reaches the same
breakers on both sides.

Every other case of tests/test_faults.py that the port's modules can run
has a counterpart here; the ``strom_stat`` rendering case waits for the
port's tools (ROADMAP item 15), and the ring-stall cases are in
tests/test_torch_health.py.  Stuck and delay faults are tens of
milliseconds."""

import dataclasses
import errno
import io
import json
import os
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

import nvme_strom_tpu.io as jax_io
from nvme_strom_tpu.utils import config as jax_config
from nvme_strom_tpu.utils.stats import StromStats as JaxStats
from nvme_strom_tpu.utils.trace import Tracer as JaxTracer
import nvme_strom_tpu_torch.io as port_io
from nvme_strom_tpu_torch.io import (FaultPlan, FaultSpec, FaultyEngine,
                                     ReadError, ResilientEngine,
                                     StromEngine, WriteError, build_engine)
from nvme_strom_tpu_torch.io.engine import wait_exact
from nvme_strom_tpu_torch.io.plan import plan_and_submit
from nvme_strom_tpu_torch.utils import config as port_config
from nvme_strom_tpu_torch.utils.config import LoaderConfig, ResilientConfig
from nvme_strom_tpu_torch.utils.stats import StromStats
from nvme_strom_tpu_torch.utils.trace import Tracer

_SIZES = dict(chunk_bytes=1 << 20, queue_depth=8, buffer_pool_bytes=16 << 20)

PKGS = {
    "port": types.SimpleNamespace(io=port_io, config=port_config,
                                  Stats=StromStats, Tracer=Tracer),
    "jax": types.SimpleNamespace(io=jax_io, config=jax_config,
                                 Stats=JaxStats, Tracer=JaxTracer),
}

#: the recovery counters compared between the packages
RECOVERY = ("faults_injected", "resilient_retries", "hedges_issued",
            "hedges_won", "hedges_denied", "stuck_cancelled",
            "write_retries", "waste_hedge_loss_bytes",
            "waste_retry_reread_bytes")


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
def _no_fault_env(monkeypatch):
    """No fault environment leaking in (the supervisors stay at their
    default, on)."""
    for k in ("STROM_FAULTS", "STROM_RESILIENT", "STROM_CRASH_POINT"):
        monkeypatch.delenv(k, raising=False)


def _cfg(pkg="port", **kw):
    return PKGS[pkg].config.EngineConfig(**{**_SIZES, **kw})


def _rcfg(pkg="port", **kw):
    base = dict(backoff_base_s=0.001, backoff_max_s=0.01, hedging=False)
    return PKGS[pkg].config.ResilientConfig(**{**base, **kw})


def _stack(plan_text, tmp_path, rconfig=None, seed=0, pkg="port", **rkw):
    """StromEngine ← FaultyEngine(plan) ← ResilientEngine of ``pkg``, a
    fresh stats block and a tracer exporting under tmp_path."""
    m = PKGS[pkg]
    stats = m.Stats()
    tracer = m.Tracer(str(tmp_path / f"{pkg}-trace.json"))
    plan = m.io.FaultPlan.parse(plan_text, seed=seed)
    eng = m.io.ResilientEngine(
        m.io.FaultyEngine(m.io.StromEngine(_cfg(pkg), stats=stats,
                                           tracer=tracer), plan),
        rconfig or _rcfg(pkg), **rkw)
    return eng, stats, plan, tracer


def _trace_names(tracer):
    names = [ev["name"] for ev in tracer.events()]
    tracer.disable()
    return names


def _counters(stats):
    snap = stats.snapshot()
    return {k: snap[k] for k in RECOVERY}


def _history(e):
    """(kind, error) of each failed attempt; a stuck attempt's error
    carries its elapsed time, so only its kind."""
    return [(a["kind"], None if a["kind"] == "stuck" else a["error"])
            for a in e.attempts]


@pytest.fixture()
def data_file(tmp_path):
    payload = np.random.default_rng(0).integers(
        0, 256, 256 << 10, dtype=np.uint8).tobytes()
    path = tmp_path / "data.bin"
    path.write_bytes(payload)
    return str(path), payload


# -- plan semantics ---------------------------------------------------------

def test_fault_plan_parse_and_validation():
    plan = FaultPlan.parse(
        "eio:p=0.25, short:every=3:frac=0.25, delay:delay_s=0.2, "
        "stuck:max_count=1, bitflip:path=shard-00")
    kinds = [s.kind for s in plan.specs]
    assert kinds == ["eio", "short", "delay", "stuck", "bitflip"]
    assert plan.specs[0].p == 0.25
    assert plan.specs[1].every == 3 and plan.specs[1].frac == 0.25
    assert plan.specs[3].delay_s == 300.0   # stuck default: far + finite
    assert plan.specs[4].path_substr == "shard-00"
    assert FaultSpec("estorm").max_count == 16
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultPlan.parse("enospc")
    with pytest.raises(ValueError, match="key=value"):
        FaultPlan.parse("eio:p")
    with pytest.raises(ValueError, match="unknown key"):
        FaultPlan.parse("eio:bogus=1")
    with pytest.raises(ValueError):
        FaultSpec(kind="short", frac=1.5)


_PLANS = [
    "eio:p=0.4",
    "eio:every=3, short:every=2:frac=0.25, delay:p=0.5",
    "short:p=0.3:max_count=5, eio:p=0.2:path=shard-00001, bitflip:p=0.1",
    "estorm:max_count=3, eio:every=4",
    "weio:every=2, wenospc:max_count=1, wshort:p=0.5:frac=0.25, "
    "wdelay:delay_s=0.2, eio:p=0.3, stuck:every=5",
]


@pytest.mark.parametrize("text", _PLANS)
@pytest.mark.parametrize("seed", [0, 7])
def test_fault_plan_decisions_match_jax(text, seed):
    """The same text and seed: the same specs, the same decision for
    every request in order (reads and writes interleaved, two paths),
    the same tallies and the same corrupted bytes."""
    plans = {n: m.io.FaultPlan.parse(text, seed=seed)
             for n, m in PKGS.items()}
    assert [dataclasses.astuple(s) for s in plans["port"].specs] == \
        [dataclasses.astuple(s) for s in plans["jax"].specs]
    rng = np.random.default_rng(seed)
    seq = {n: [] for n in plans}
    for _ in range(200):
        path = ["/d/shard-00000.tar", "/d/shard-00001.tar"][
            int(rng.integers(2))]
        op = "write" if rng.random() < 0.3 else "read"
        for n, plan in plans.items():
            spec = plan.decide(path, op=op)
            seq[n].append(None if spec is None else spec.kind)
            if spec is not None and spec.kind == "bitflip":
                seq[n].append(plan.corrupt_byte(4096))
    assert seq["port"] == seq["jax"]
    assert plans["port"].injected == plans["jax"].injected


def test_fault_plan_deterministic_by_seed():
    def decisions(seed):
        plan = FaultPlan.parse("eio:p=0.4", seed=seed)
        return [plan.decide() is not None for _ in range(64)]

    assert decisions(7) == decisions(7)
    assert decisions(7) != decisions(8)
    plan = FaultPlan.parse("eio:every=3")
    got = [plan.decide() is not None for _ in range(9)]
    assert got == [False, False, True] * 3


def test_fault_plan_from_env(monkeypatch):
    assert FaultPlan.from_env() is None
    monkeypatch.setenv("STROM_FAULTS", "eio:every=2")
    monkeypatch.setenv("STROM_FAULTS_SEED", "5")
    plan = FaultPlan.from_env()
    assert plan.specs[0].every == 2 and plan.seed == 5


# -- recovery, through both packages' stacks -------------------------------

#: name → (plan, ResilientConfig fields, seed, reads); each read is
#: (offset, length)
_SCENARIOS = {
    "eio": ("eio:max_count=2", dict(max_retries=3), 0, [(4096, 8192)]),
    "eio exhausted": ("eio", dict(max_retries=2), 0, [(0, 4096)]),
    "short": ("short:max_count=1:frac=0.5", dict(max_retries=2), 0,
              [(0, 16384)]),
    "short exhausted": ("short:frac=0.5", dict(max_retries=1), 0,
                        [(0, 4096)]),
    "delay hedged": ("delay:max_count=1:delay_s=0.3",
                     dict(hedging=True, hedge_after_s=0.03), 0,
                     [(0, 4096)]),
    "stuck cancelled": ("stuck:max_count=1:delay_s=5",
                        dict(stuck_timeout_s=0.05, max_retries=2), 0,
                        [(0, 4096)]),
    "stuck exhausted": ("stuck:delay_s=5",
                        dict(stuck_timeout_s=0.04, max_retries=1), 0,
                        [(0, 4096)]),
    "hedge capped": ("delay:max_count=1:delay_s=0.2, eio",
                     dict(hedging=True, hedge_after_s=0.03,
                          max_retries=0), 0, [(0, 4096)]),
    "mixed every": ("eio:every=3, short:every=2:frac=0.25",
                    dict(max_retries=4), 0,
                    [(i * 8192, 8192) for i in range(8)]),
    "seeded p": ("eio:p=0.3, short:p=0.2:frac=0.5", dict(max_retries=2),
                 5, [(i * 4096, 4096 + 512 * i) for i in range(16)]),
    "past eof": ("short:every=2:frac=0.5", dict(max_retries=2), 0,
                 [((256 << 10) - 1000, 4096), (0, 4096)]),
}


def _run_scenario(pkg, name, data_file, tmp_path):
    text, rkw, seed, reads = _SCENARIOS[name]
    path, _ = data_file
    eng, stats, _, tracer = _stack(text, tmp_path, _rcfg(pkg, **rkw),
                                   seed=seed, pkg=pkg)
    out = []
    with eng:
        fh = eng.open(path)
        for off, ln in reads:
            try:
                out.append(("ok", eng.read(fh, off, ln).tobytes()))
            except PKGS[pkg].io.ReadError as e:
                out.append(("error", _history(e)))
        eng.close(fh)
    names = sorted(n for n in _trace_names(tracer)
                   if n.startswith(("strom.fault", "strom.resilient")))
    return out, _counters(stats), names


@pytest.mark.parametrize("name", list(_SCENARIOS))
def test_recovery_matches_jax(name, data_file, tmp_path):
    """Payloads, attempt histories, recovery counters and the fault and
    recovery spans equal the JAX stack's; every payload that came back
    is the file's."""
    got = _run_scenario("port", name, data_file, tmp_path)
    want = _run_scenario("jax", name, data_file, tmp_path)
    assert got == want
    _, payload = data_file
    for (kind, val), (off, ln) in zip(got[0], _SCENARIOS[name][3]):
        if kind == "ok":
            assert val == payload[off:off + ln]


def test_eio_recovered_then_loud(data_file, tmp_path):
    path, payload = data_file
    eng, stats, plan, tracer = _stack("eio:max_count=2", tmp_path,
                                      _rcfg(max_retries=3))
    with eng:
        fh = eng.open(path)
        out = eng.read(fh, 4096, 8192)
    assert out.tobytes() == payload[4096:4096 + 8192]
    assert stats.faults_injected == 2 and plan.injected == {"eio": 2}
    assert stats.resilient_retries == 2
    names = _trace_names(tracer)
    assert names.count("strom.fault.eio") == 2
    assert names.count("strom.resilient.retry") == 2

    eng2, stats2, _, _ = _stack("eio", tmp_path, _rcfg(max_retries=2))
    with eng2:
        fh = eng2.open(path)
        with pytest.raises(ReadError, match="after 3 attempts") as ei:
            eng2.read(fh, 0, 4096)
    assert len(ei.value.attempts) == 3
    assert all(a["kind"] == "io" for a in ei.value.attempts)
    assert stats2.resilient_retries == 2
    assert stats2.faults_injected == 3


def test_short_read_recovered_then_loud(data_file, tmp_path):
    path, payload = data_file
    eng, stats, _, tracer = _stack("short:max_count=1:frac=0.5",
                                   tmp_path, _rcfg(max_retries=2))
    with eng:
        fh = eng.open(path)
        out = eng.read(fh, 0, 16384)
    assert out.tobytes() == payload[:16384]     # full payload, not half
    assert stats.resilient_retries == 1
    assert stats.waste_retry_reread_bytes == 8192
    assert "strom.resilient.retry" in _trace_names(tracer)

    eng2, _, _, _ = _stack("short:frac=0.5", tmp_path, _rcfg(max_retries=1))
    with eng2:
        fh = eng2.open(path)
        with pytest.raises(ReadError, match="still short") as ei:
            eng2.read(fh, 0, 4096)
    assert [a["kind"] for a in ei.value.attempts] == ["short", "short"]


def test_latency_spike_hedged_then_timeout(data_file, tmp_path):
    path, payload = data_file
    eng, stats, _, tracer = _stack(
        "delay:max_count=1:delay_s=0.4", tmp_path,
        _rcfg(hedging=True, hedge_after_s=0.03))
    with eng:
        fh = eng.open(path)
        t0 = time.monotonic()
        out = eng.read(fh, 0, 4096)
        dt = time.monotonic() - t0
    assert out.tobytes() == payload[:4096]
    assert dt < 0.35, f"hedge did not rescue the straggler ({dt:.3f}s)"
    assert stats.hedges_issued == 1 and stats.hedges_won == 1
    assert stats.waste_hedge_loss_bytes == 4096
    names = _trace_names(tracer)
    assert "strom.resilient.hedge" in names
    assert "strom.resilient.hedge_won" in names

    # hedging off: the caller's own deadline raises with the read live
    eng2, _, _, _ = _stack("delay:max_count=1:delay_s=0.15", tmp_path)
    with eng2:
        fh = eng2.open(path)
        r = eng2.submit_read(fh, 0, 4096)
        with pytest.raises(TimeoutError):
            r.wait(timeout=0.03)
        assert r.wait().tobytes() == payload[:4096]
        r.release()


def test_stuck_request_cancelled_then_loud(data_file, tmp_path):
    path, payload = data_file
    eng, stats, _, _ = _stack("stuck:max_count=1:delay_s=5", tmp_path,
                              _rcfg(stuck_timeout_s=0.06, max_retries=2))
    with eng:
        fh = eng.open(path)
        t0 = time.monotonic()
        out = eng.read(fh, 0, 4096)
        dt = time.monotonic() - t0
    assert out.tobytes() == payload[:4096]
    assert 0.05 < dt < 2.0   # at ~stuck_timeout, not delay_s
    assert stats.stuck_cancelled == 1 and stats.resilient_retries == 1

    eng2, stats2, _, _ = _stack("stuck:delay_s=5", tmp_path,
                                _rcfg(stuck_timeout_s=0.04, max_retries=1))
    with eng2:
        fh = eng2.open(path)
        with pytest.raises(ReadError) as ei:
            eng2.read(fh, 0, 4096)
    assert [a["kind"] for a in ei.value.attempts] == ["stuck", "stuck"]
    assert stats2.stuck_cancelled == 1


def test_bitflip_matches_jax_byte(data_file, tmp_path):
    """One byte flipped in the staging view, replayable under the seed
    and at the same index and bit as the JAX plan's."""
    path, payload = data_file

    def corrupted(pkg, seed):
        eng, stats, _, _ = _stack("bitflip", tmp_path, seed=seed, pkg=pkg)
        with eng:
            fh = eng.open(path)
            out = eng.read(fh, 0, 4096)
        assert stats.faults_injected == 1
        a = np.frombuffer(out.tobytes(), np.uint8)
        b = np.frombuffer(payload[:4096], np.uint8)
        return [(int(i), int(a[i] ^ b[i])) for i in np.flatnonzero(a != b)]

    d1 = corrupted("port", 3)
    assert len(d1) == 1
    assert d1 == corrupted("port", 3) == corrupted("jax", 3)
    assert corrupted("port", 4) == corrupted("jax", 4)


def test_hedge_capped_at_one_per_attempt(data_file, tmp_path):
    path, payload = data_file
    eng, stats, _, _ = _stack(
        "delay:max_count=1:delay_s=0.2, eio", tmp_path,
        _rcfg(hedging=True, hedge_after_s=0.02, max_retries=0))
    with eng:
        fh = eng.open(path)
        out = eng.read(fh, 0, 4096)   # the primary still wins
    assert out.tobytes() == payload[:4096]
    assert stats.hedges_issued == 1 and stats.hedges_won == 0


def test_hedge_budget_per_class(data_file, tmp_path):
    """A class out of hedge tokens is denied (counted once a read) while
    another class hedges; ``set_hedge_budget`` moves a budget; both
    packages count alike.  The stock budgets are io/sched.py's."""
    path, payload = data_file
    assert ResilientEngine(StromEngine(_cfg())).hedge_budgets == {
        "decode": 8, "restore": 4, "prefetch": 2, "scan": 2, "scrub": 1}
    res = {}
    for pkg in PKGS:
        eng, stats, _, _ = _stack(
            "delay:max_count=2:delay_s=0.15", tmp_path,
            _rcfg(pkg, hedging=True, hedge_after_s=0.02), pkg=pkg)
        eng.set_hedge_budget("scrub", 0)
        with pytest.raises(ValueError):
            eng.set_hedge_budget("scrub", -1)
        with eng:
            fh = eng.open(path)
            for klass in ("scrub", "decode"):
                r = eng.submit_read(fh, 0, 4096, klass=klass)
                assert r.wait().tobytes() == payload[:4096]
                r.release()
            assert eng.hedges_outstanding("decode") == 0
            eng.close(fh)
        res[pkg] = (_counters(stats), stats.class_stats)
    assert res["port"] == res["jax"]
    counters, per_class = res["port"]
    assert counters["hedges_denied"] == 1 and counters["hedges_won"] == 1
    assert per_class["scrub"] == {"hedges_denied": 1}
    assert per_class["decode"]["hedges_won"] == 1


def test_class_retry_budget_from_policy(data_file, tmp_path, monkeypatch):
    """A ClassPolicy's max_retries is its class's retry budget; an
    explicit class config wins over it."""
    from nvme_strom_tpu_torch.io import sched
    real = sched.default_policies

    def policies(weights=""):
        pol = real(weights)
        pol["scrub"] = dataclasses.replace(pol["scrub"], max_retries=0)
        return pol
    monkeypatch.setattr(sched, "default_policies", policies)
    path, _ = data_file
    eng, _, _, _ = _stack("eio:max_count=1", tmp_path, _rcfg(max_retries=3))
    assert eng.config_for("scrub").max_retries == 0
    assert eng.config_for("decode").max_retries == 3
    with eng:
        fh = eng.open(path)
        with pytest.raises(ReadError, match="after 1 attempts"):
            r = eng.submit_read(fh, 0, 4096, klass="scrub")
            r.wait()
        eng.close(fh)
    eng2, _, _, _ = _stack("eio", tmp_path, _rcfg(max_retries=3),
                           class_configs={"scrub": _rcfg(max_retries=1)})
    assert eng2.config_for("scrub").max_retries == 1
    eng2.close_all()


def test_derived_hedge_threshold_after_reads(data_file):
    """With ``hedge_after_s`` 0 the threshold comes from the engine's
    latency histogram: None while it is empty, a value at least
    ``hedge_min_s`` once reads have completed."""
    path, _ = data_file
    cfg = ResilientConfig(hedging=True, hedge_after_s=0.0, hedge_min_s=0.001)
    with ResilientEngine(StromEngine(_cfg()), cfg) as eng:
        assert eng._hedge_after("restore") is None
        fh = eng.open(path)
        for i in range(32):
            eng.read(fh, i * 4096, 4096)
        pct = eng.latency_percentiles("read", ps=(99,))
        assert pct[99] > 0
        got = eng._hedge_after("decode")
        assert got == max(0.001, pct[99] / 1e9 * cfg.hedge_multiplier)
        assert ResilientEngine(eng._engine, dataclasses.replace(
            cfg, hedging=False))._hedge_after("decode") is None
        eng.close(fh)


def test_resilient_read_contract(data_file, tmp_path):
    """fh, offset, length and was_fallback as the bridge reads them;
    is_ready; release idempotent; the view is the staging buffer's own
    memory, never a copy."""
    path, payload = data_file
    eng, _, _, _ = _stack("short:max_count=1:frac=0.5", tmp_path)
    with eng:
        fh = eng.open(path)
        r = eng.submit_read(fh, 8192, 4096)
        assert (r.fh, r.offset, r.length) == (fh, 8192, 4096)
        view = r.wait()
        assert r.is_ready() and view.tobytes() == payload[8192:12288]
        assert isinstance(r.was_fallback, bool)
        pool = eng.pool_info()
        addr = view.ctypes.data
        assert pool["pool_base"] <= addr < pool["pool_base"] + \
            pool["pool_bytes"]
        r.release()
        r.release()
        eng.close(fh)


def test_c_level_fault_hooks(data_file, monkeypatch):
    """STROM_FAULT_READ_EIO_EVERY below ctypes: the C completion path
    fails, the resilient engine recovers, the engine counts it."""
    path, payload = data_file
    monkeypatch.setenv("STROM_FAULT_READ_EIO_EVERY", "2")
    stats = StromStats()
    eng = ResilientEngine(StromEngine(_cfg(), stats=stats),
                          _rcfg(max_retries=2))
    with eng:
        fh = eng.open(path)
        for i in range(4):
            out = eng.read(fh, i * 4096, 4096)
            assert out.tobytes() == payload[i * 4096:(i + 1) * 4096]
    assert stats.resilient_retries >= 1
    assert stats.requests_failed >= 1


def test_c_level_short_read_hook(data_file, monkeypatch):
    path, payload = data_file
    monkeypatch.setenv("STROM_FAULT_READ_SHORT_EVERY", "2")
    stats = StromStats()
    eng = ResilientEngine(StromEngine(_cfg(), stats=stats),
                          _rcfg(max_retries=2))
    with eng:
        fh = eng.open(path)
        for i in range(4):
            out = eng.read(fh, i * 8192, 8192)
            assert out.tobytes() == payload[i * 8192:(i + 1) * 8192]
    assert stats.resilient_retries >= 1


def test_vectored_submit_injects_per_extent(data_file, tmp_path):
    """The planner's batch gets a decision per extent, and only the
    faulted extents are resubmitted, alone."""
    path, payload = data_file
    eng, stats, _, tracer = _stack("eio:every=2:max_count=2", tmp_path,
                                   _rcfg(max_retries=3))
    with eng:
        fh = eng.open(path)
        extents = [(fh, 0, 1024), (fh, 8192, 2048),
                   (fh, 65536, 512), (fh, 131072, 4096)]
        views = plan_and_submit(eng, extents, chunk_bytes=1 << 20,
                                klass="restore")
        for (_, off, ln), pieces in zip(extents, views):
            got = b"".join(bytes(wait_exact(p)) for p in pieces)
            assert got == payload[off:off + ln], (off, ln)
            for p in pieces:
                p.release()
        eng.close(fh)
    assert stats.faults_injected == 2
    assert stats.resilient_retries == 2
    assert stats.class_stats["restore"]["retries"] == 2
    names = _trace_names(tracer)
    assert names.count("strom.fault.eio") == 2
    assert names.count("strom.resilient.retry") == 2


def test_vectored_submit_short_read_retried_per_extent(data_file,
                                                       tmp_path):
    path, payload = data_file
    eng, stats, _, _ = _stack("short:every=3:max_count=1:frac=0.25",
                              tmp_path, _rcfg(max_retries=2))
    with eng:
        fh = eng.open(path)
        extents = [(fh, 0, 4096), (fh, 16384, 4096), (fh, 40960, 4096)]
        views = plan_and_submit(eng, extents, chunk_bytes=1 << 20)
        for (_, off, ln), pieces in zip(extents, views):
            got = b"".join(bytes(wait_exact(p)) for p in pieces)
            assert got == payload[off:off + ln]
            for p in pieces:
                p.release()
        eng.close(fh)
    assert stats.faults_injected == 1 and stats.resilient_retries == 1


def test_faulty_engine_vectored_counts_and_taxonomy(data_file):
    """FaultyEngine alone: the faulted extent raises, its batch
    siblings complete clean."""
    path, payload = data_file
    stats = StromStats()
    eng = FaultyEngine(StromEngine(_cfg(), stats=stats),
                       FaultPlan.parse("eio:every=2"))
    try:
        fh = eng.open(path)
        spans = [(0, 512), (4096, 512), (8192, 512), (12288, 512)]
        prs = eng.submit_readv([(fh, o, n) for o, n in spans])
        failures = 0
        for (off, ln), p in zip(spans, prs):
            try:
                got = bytes(wait_exact(p))
            except OSError:
                failures += 1
            else:
                assert got == payload[off:off + ln]
            p.release()
        assert failures == 2 and stats.faults_injected == 2
        eng.close(fh)
    finally:
        eng._engine.close_all()


def test_host_tier_hits_bypass_the_wrappers(data_file, tmp_path):
    """With the host tier on, a hit span never reaches FaultyEngine (no
    decision is drawn for it) while misses do and recover; the tier
    found through the wrapper stack is the process's one."""
    from nvme_strom_tpu_torch.io import hostcache
    from nvme_strom_tpu_torch.io.plan import submit_spans_tiered
    from nvme_strom_tpu_torch.utils.config import HostCacheConfig
    path, payload = data_file
    eng, stats, plan, _ = _stack("eio:every=2", tmp_path,
                                 _rcfg(max_retries=3))
    try:
        cache = hostcache.configure(HostCacheConfig(
            budget_mb=4, line_bytes=64 << 10), engine=eng)
        assert hostcache.get_cache(eng) is cache
        assert hostcache.get_cache(eng._engine._engine) is cache
        fh = eng.open(path)
        spans = [(fh, 0, 64 << 10), (fh, 64 << 10, 64 << 10)]
        drawn = []      # (decisions drawn, hits) a round
        for _ in range(4):
            before, hits = plan._reads, stats.cache_hits
            prs = submit_spans_tiered(eng, spans, klass="decode")
            for (_, off, ln), p in zip(spans, prs):
                assert p.wait().tobytes() == payload[off:off + ln]
                p.release()
            drawn.append((plan._reads - before, stats.cache_hits - hits))
        # misses draw a decision each, their retries one more; once both
        # lines are resident a round draws none
        assert drawn[0][0] >= 2 and drawn[0][1] == 0, drawn
        assert drawn[-1] == (0, 2), drawn
        assert stats.resilient_retries >= 1
        eng.close(fh)
    finally:
        hostcache.reset()
        eng.close_all()


# -- the write mirror --------------------------------------------------------

def test_write_fault_plan_parse_and_taxonomy():
    plan = FaultPlan.parse(
        "weio:every=2, wenospc:max_count=1, wshort:frac=0.25, "
        "wdelay:delay_s=0.2")
    assert [s.kind for s in plan.specs] == ["weio", "wenospc", "wshort",
                                            "wdelay"]
    assert plan.specs[1].err == errno.ENOSPC   # the kind is the errno
    assert all(s.is_write for s in plan.specs)
    assert plan.decide(op="read") is None
    assert plan.decide(op="write") is not None


def _write_file(tmp_path, name="w.bin"):
    p = tmp_path / name
    p.write_bytes(b"")
    return str(p)


def _write_run(pkg, text, tmp_path, data, rkw, name):
    path = _write_file(tmp_path, f"{pkg}-{name}.bin")
    eng, stats, _, tracer = _stack(text, tmp_path, _rcfg(pkg, **rkw),
                                   pkg=pkg)
    with eng:
        fh = eng.open(path, writable=True)
        try:
            out = ("ok", eng.submit_write(fh, 0, data).wait())
        except PKGS[pkg].io.WriteError as e:
            out = ("error", _history(e))
        eng.close(fh)
    names = sorted(n for n in _trace_names(tracer)
                   if n.startswith(("strom.fault", "strom.resilient")))
    with open(path, "rb") as f:
        return out, _counters(stats), names, f.read()


@pytest.mark.parametrize("text,rkw", [
    ("weio:max_count=2", dict(max_retries=3)),
    ("weio", dict(max_retries=2)),
    ("wshort:max_count=1:frac=0.5", dict(max_retries=2)),
    ("wshort:frac=0.5", dict(max_retries=3)),
    ("wenospc", dict(max_retries=1)),
    ("weio:every=2, wshort:every=3:frac=0.25", dict(max_retries=5)),
])
def test_write_recovery_matches_jax(text, rkw, tmp_path):
    """The same write plan through both stacks: the same result, attempt
    history, counters, spans and file bytes."""
    data = (np.arange(96 << 10, dtype=np.uint8) % 251)
    got = _write_run("port", text, tmp_path, data, rkw, "w")
    want = _write_run("jax", text, tmp_path, data, rkw, "w")
    assert got == want
    if got[0][0] == "ok":
        assert got[0][1] == data.nbytes and got[3] == data.tobytes()


def test_write_eio_recovered_then_loud(tmp_path):
    path = _write_file(tmp_path)
    data = (np.arange(128 << 10, dtype=np.uint8) % 251)
    eng, stats, _, tracer = _stack("weio:max_count=2", tmp_path,
                                   _rcfg(max_retries=3))
    with eng:
        fh = eng.open(path, writable=True)
        n = eng.submit_write(fh, 0, data).wait()
        eng.close(fh)
    assert n == data.nbytes
    assert stats.write_retries == 2 and stats.faults_injected == 2
    with open(path, "rb") as f:
        assert f.read() == data.tobytes()
    names = _trace_names(tracer)
    assert names.count("strom.fault.weio") == 2
    assert names.count("strom.resilient.write_retry") == 2

    eng2, stats2, _, _ = _stack("weio", tmp_path, _rcfg(max_retries=2))
    with eng2:
        fh = eng2.open(path, writable=True)
        with pytest.raises(WriteError, match="after 3 attempts") as ei:
            eng2.submit_write(fh, 0, data[:4096]).wait()
        eng2.close(fh)
    assert len(ei.value.attempts) == 3
    assert all(a["kind"] == "io" for a in ei.value.attempts)
    assert stats2.write_retries == 2


def test_short_write_resubmits_remaining_span(tmp_path):
    path = _write_file(tmp_path)
    data = (np.arange(64 << 10, dtype=np.uint8) % 113)
    eng, stats, _, _ = _stack("wshort:max_count=1:frac=0.5", tmp_path,
                              _rcfg(max_retries=2))
    with eng:
        fh = eng.open(path, writable=True)
        w = eng.submit_write(fh, 0, data)
        assert (w.fh, w.offset, w.length) == (fh, 0, data.nbytes)
        assert w.wait() == data.nbytes
        assert w.wait() == data.nbytes       # done: the total again
        eng.close(fh)
    assert stats.write_retries == 1
    with open(path, "rb") as f:
        assert f.read() == data.tobytes()


def test_write_enospc_is_loud_with_errno(tmp_path):
    path = _write_file(tmp_path)
    eng, _, _, _ = _stack("wenospc", tmp_path, _rcfg(max_retries=1))
    with eng:
        fh = eng.open(path, writable=True)
        with pytest.raises(WriteError, match="No space left") as ei:
            eng.submit_write(fh, 0, np.zeros(4096, np.uint8)).wait()
        eng.close(fh)
    assert "No space left" in ei.value.attempts[0]["error"]


def test_write_delay_honors_wait_timeout(tmp_path):
    """wdelay holds the completion; a bounded wait times out with the
    write still live, and the next wait finishes it.  The port's
    PendingWrite takes the same timeout."""
    path = _write_file(tmp_path)
    eng, _, _, _ = _stack("wdelay:max_count=1:delay_s=0.15", tmp_path)
    with eng:
        fh = eng.open(path, writable=True)
        w = eng.submit_write(fh, 0, np.ones(4096, np.uint8))
        with pytest.raises(TimeoutError):
            w.wait(timeout=0.02)
        assert w.wait() == 4096
        plain = eng._engine._engine.submit_write(fh, 4096,
                                                 np.ones(4096, np.uint8))
        assert plain.wait(timeout=5.0) == 4096
        aborted = eng._engine._engine.submit_write(fh, 8192,
                                                   np.ones(4096, np.uint8))
        aborted.release()
        aborted.release()
        eng.close(fh)


def test_c_level_write_fault_hooks(tmp_path, monkeypatch):
    monkeypatch.setenv("STROM_FAULT_WRITE_EIO_EVERY", "2")
    path = _write_file(tmp_path)
    stats = StromStats()
    eng = ResilientEngine(StromEngine(_cfg(), stats=stats),
                          _rcfg(max_retries=3))
    data = (np.arange(32 << 10, dtype=np.uint8) % 7)
    with eng:
        fh = eng.open(path, writable=True)
        for i in range(4):
            assert eng.submit_write(fh, i * data.nbytes,
                                    data).wait() == data.nbytes
        eng.close(fh)
    assert stats.write_retries >= 1 and stats.requests_failed >= 1
    with open(path, "rb") as f:
        back = np.frombuffer(f.read(), np.uint8).reshape(4, -1)
    assert np.array_equal(back, np.tile(data, (4, 1)))


def test_c_level_short_write_hook(tmp_path, monkeypatch):
    monkeypatch.setenv("STROM_FAULT_WRITE_SHORT_EVERY", "2")
    path = _write_file(tmp_path)
    stats = StromStats()
    eng = ResilientEngine(StromEngine(_cfg(), stats=stats),
                          _rcfg(max_retries=3))
    data = (np.arange(32 << 10, dtype=np.uint8) % 11)
    with eng:
        fh = eng.open(path, writable=True)
        for i in range(4):
            assert eng.submit_write(fh, i * data.nbytes,
                                    data).wait() == data.nbytes
        eng.close(fh)
    assert stats.write_retries >= 1
    with open(path, "rb") as f:
        back = np.frombuffer(f.read(), np.uint8).reshape(4, -1)
    assert np.array_equal(back, np.tile(data, (4, 1)))


# -- checkpoints -------------------------------------------------------------

def _ckpt_state(v: float):
    return {"w": np.full((4, 4), v, dtype=np.float32), "step": int(v)}


def _manager(path, eng, **kw):
    from nvme_strom_tpu_torch.checkpoint.manager import CheckpointManager
    return CheckpointManager(path, engine=eng, **kw)


def test_checkpoint_save_survives_write_faults(tmp_path):
    stats = StromStats()
    plan = FaultPlan.parse("weio:every=3:max_count=2, "
                           "wshort:every=4:max_count=1:frac=0.5")
    eng = ResilientEngine(FaultyEngine(StromEngine(_cfg(), stats=stats),
                                       plan), _rcfg(max_retries=3))
    mgr = _manager(tmp_path / "ckpt", eng)
    state = {"w": np.arange(64, dtype=np.float32).reshape(8, 8), "step": 7}
    mgr.save(7, state)
    assert stats.write_retries >= 1, "no write fault was recovered"
    got = mgr.restore({"w": np.zeros((8, 8), np.float32), "step": 0})
    np.testing.assert_array_equal(got["w"], state["w"])
    assert got["step"] == 7
    eng.close_all()


def test_restore_falls_back_to_previous_intact_step(tmp_path):
    """Step 2's data file gone: restores read step 1 through a faulty,
    resilient engine, count each fallback, and fail fast without one."""
    stats = StromStats()
    eng = ResilientEngine(FaultyEngine(
        StromEngine(_cfg(), stats=stats),
        FaultPlan.parse("eio:every=2:max_count=4")), _rcfg(max_retries=2))
    mgr = _manager(tmp_path / "ckpt", eng)
    mgr.save(1, _ckpt_state(1.0))
    mgr.save(2, _ckpt_state(2.0))
    os.unlink(os.path.join(mgr.step_dir(2), "state-00000.safetensors"))
    got = mgr.restore(_ckpt_state(0.0))
    np.testing.assert_array_equal(got["w"], _ckpt_state(1.0)["w"])
    assert got["step"] == 1 and mgr.last_restore_step == 1
    assert stats.restore_fallbacks == 1
    got = mgr.restore(_ckpt_state(0.0), step=2)
    assert mgr.last_restore_step == 1 and stats.restore_fallbacks == 2
    with pytest.raises((OSError, ValueError, KeyError)):
        mgr.restore(_ckpt_state(0.0), step=2, fallback=False)
    assert stats.resilient_retries >= 1
    eng.close_all()


def test_restore_truncated_tile_falls_back(tmp_path):
    stats = StromStats()
    eng = StromEngine(_cfg(), stats=stats)
    mgr = _manager(tmp_path / "ckpt", eng)
    mgr.save(1, _ckpt_state(1.0))
    mgr.save(2, _ckpt_state(2.0))
    tile = os.path.join(mgr.step_dir(2), "state-00000.safetensors")
    with open(tile, "r+b") as f:   # chop the payload mid-tensor
        f.truncate(os.path.getsize(tile) - 40)
    got = mgr.restore(_ckpt_state(0.0))
    np.testing.assert_array_equal(got["w"], _ckpt_state(1.0)["w"])
    assert mgr.last_restore_step == 1 and stats.restore_fallbacks == 1
    eng.close_all()


def test_restore_all_candidates_damaged_raises(tmp_path):
    eng = StromEngine(_cfg(), stats=StromStats())
    mgr = _manager(tmp_path / "ckpt", eng)
    mgr.save(1, _ckpt_state(1.0))
    os.unlink(os.path.join(mgr.step_dir(1), "state-00000.safetensors"))
    with pytest.raises(OSError):
        mgr.restore(_ckpt_state(0.0))
    eng.close_all()


def test_restore_nonexistent_step_is_fatal(tmp_path):
    eng = StromEngine(_cfg(), stats=StromStats())
    mgr = _manager(tmp_path / "ckpt", eng)
    mgr.save(1, _ckpt_state(1.0))
    with pytest.raises(FileNotFoundError, match="12000"):
        mgr.restore(_ckpt_state(0.0), step=12000)
    eng.close_all()


def test_restore_schema_mismatch_never_falls_back(tmp_path):
    from nvme_strom_tpu_torch.checkpoint.manager import TargetMismatchError
    stats = StromStats()
    eng = StromEngine(_cfg(), stats=stats)
    mgr = _manager(tmp_path / "ckpt", eng)
    mgr.save(1, _ckpt_state(1.0))
    mgr.save(2, _ckpt_state(2.0))
    with pytest.raises(TargetMismatchError):
        mgr.restore({"w": np.zeros((3, 3), np.float32), "step": 0})
    with pytest.raises(KeyError):
        mgr.restore({"nope": np.zeros((4, 4), np.float32)})
    assert stats.restore_fallbacks == 0
    eng.close_all()


@pytest.mark.parametrize("persistent", [True, False])
def test_restore_bit_flipped_tile(tmp_path, monkeypatch, persistent):
    """STROM_VERIFY=full catches a bitflip plan on the tile reads: a
    flip on every read of step 2 steps back to step 1; a one-time flip
    heals on the re-read and step 2 restores."""
    monkeypatch.setenv("STROM_VERIFY", "full")
    stats = StromStats()
    text = "bitflip:path=step_00000002" + ("" if persistent
                                           else ":max_count=1")
    eng = FaultyEngine(StromEngine(_cfg(), stats=stats),
                       FaultPlan.parse(text))
    mgr = _manager(tmp_path / "ckpt", eng)
    mgr.save(1, _ckpt_state(1.0))
    mgr.save(2, _ckpt_state(2.0))
    got = mgr.restore(_ckpt_state(0.0))
    want = 1 if persistent else 2
    np.testing.assert_array_equal(got["w"], _ckpt_state(float(want))["w"])
    assert mgr.last_restore_step == want
    if persistent:
        assert stats.checksum_failures >= 2
        assert stats.restore_fallbacks == 1
    else:
        assert stats.checksum_failures == 1
        assert stats.restore_fallbacks == 0
    assert stats.bytes_verified > 0
    eng.close_all()


_CRASH_CHILD = r"""
import os, sys
import numpy as np
sys.path.insert(0, {repo!r})
from nvme_strom_tpu_torch.checkpoint.manager import CheckpointManager
from nvme_strom_tpu_torch.io import StromEngine
from nvme_strom_tpu_torch.utils.config import EngineConfig

eng = StromEngine(EngineConfig(chunk_bytes=1 << 20, queue_depth=8,
                               buffer_pool_bytes=16 << 20))
mgr = CheckpointManager({ckpt!r}, engine=eng)
mgr.save(1, {{"w": np.full((4, 4), 1.0, np.float32), "step": 1}})
os.environ["STROM_CRASH_POINT"] = {point!r}
mgr.save(2, {{"w": np.full((4, 4), 2.0, np.float32), "step": 2}})
print("CRASH POINT NEVER FIRED", file=sys.stderr)
sys.exit(3)
"""


@pytest.mark.parametrize("point", ["ckpt.tiles", "ckpt.meta",
                                   "ckpt.rename"])
def test_crash_at_point_leaves_restorable_previous_step(tmp_path, point):
    """A crash at each window of the save leaves step 1 restorable,
    step 2 invisible and only its staging dir as debris, which the next
    manager (age gate 0) removes."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ckpt = str(tmp_path / "ckpt")
    child = _CRASH_CHILD.format(repo=repo, ckpt=ckpt, point=point)
    r = subprocess.run([sys.executable, "-c", child], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 137, (
        f"crash point {point} did not fire: rc={r.returncode} "
        f"stderr={r.stderr[-500:]}")
    assert not os.path.isdir(os.path.join(ckpt, "step_00000002"))
    debris = [n for n in os.listdir(ckpt) if n.startswith(".tmp_step_")]
    assert debris == [".tmp_step_00000002"]
    eng = StromEngine(_cfg())
    mgr = _manager(ckpt, eng, gc_min_age_s=0)
    assert mgr.tmp_gc == [os.path.join(ckpt, ".tmp_step_00000002")]
    assert mgr.all_steps() == [1]
    got = mgr.restore({"w": np.zeros((4, 4), np.float32), "step": 0})
    np.testing.assert_array_equal(got["w"],
                                  np.full((4, 4), 1.0, np.float32))
    assert got["step"] == 1
    eng.close_all()


def test_crash_point_is_inert_unless_named(monkeypatch):
    from nvme_strom_tpu_torch.io.faults import crash_point
    crash_point("ckpt.tiles")                 # unset: nothing
    monkeypatch.setenv("STROM_CRASH_POINT", "ckpt.meta")
    crash_point("ckpt.tiles")                 # another point: nothing


def test_crash_gc_age_gate_spares_fresh_staging(tmp_path):
    ckpt = tmp_path / "ckpt"
    live = ckpt / ".tmp_step_00000007"
    cold = ckpt / ".tmp_step_00000003"
    os.makedirs(live)
    os.makedirs(cold)
    hour_ago = time.time() - 7200
    os.utime(cold, (hour_ago, hour_ago))
    mgr = _manager(ckpt, None)
    assert mgr.tmp_gc == [str(cold)]
    assert live.is_dir() and not cold.exists()


# -- the loader's shard quarantine -------------------------------------------

def _write_shards(tmp_path, n_shards=2, per_shard=16, item=64,
                  stamped=False):
    from nvme_strom_tpu_torch.formats.wds import write_wds_shard
    from nvme_strom_tpu_torch.utils.checksum import stamp_wds
    paths = []
    for s in range(n_shards):
        samples = [{"bin": np.full(item, s * 100 + i,
                                   dtype=np.uint8).tobytes()}
                   for i in range(per_shard)]
        p = tmp_path / f"shard-{s:05d}.tar"
        write_wds_shard(p, samples)
        if stamped:
            stamp_wds(str(p))
        paths.append(str(p))
    return paths


def _checking_decode(parts):
    arr = np.frombuffer(parts["bin"], dtype=np.uint8)
    if arr.size and not (arr == arr[0]).all():
        raise ValueError("corrupt sample payload")
    return arr


def _loader(paths, eng, budget=1, decode=_checking_decode):
    from nvme_strom_tpu_torch.data.loader import ShardedLoader
    return ShardedLoader(paths, global_batch=8, decode=decode, engine=eng,
                         config=LoaderConfig(shard_error_budget=budget),
                         device="cpu")


def _jax_rows(paths, eng, budget=1, decode=_checking_decode):
    """The JAX loader's epoch on a one-device mesh: (rows, quarantined)."""
    import jax
    from jax.sharding import Mesh
    from nvme_strom_tpu.data import ShardedLoader as JaxLoader
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1), ("dp",))
    with JaxLoader(paths, mesh, global_batch=8, fmt="wds", decode=decode,
                   engine=eng, config=jax_config.LoaderConfig(
                       batch_size=8, shard_error_budget=budget)) as dl:
        rows = [bytes(r.tobytes()) for b in dl for r in np.asarray(b)]
        return rows, list(dl.quarantined)


@pytest.mark.parametrize("plan_text", [
    "bitflip:path=shard-00000:max_count=1",
    "eio:path=shard-00001:max_count=1",
    "eio:path=shard-00000:every=3"])
def test_loader_quarantines_corrupt_shard_under_budget(tmp_path,
                                                       plan_text):
    """A faulted shard is skipped, the rest of the epoch arrives, and
    the JAX loader under the same plan quarantines the same shard and
    yields the same rows."""
    paths = _write_shards(tmp_path)
    stats = StromStats()
    eng = FaultyEngine(StromEngine(_cfg(), stats=stats),
                       FaultPlan.parse(plan_text))
    tracer = Tracer(str(tmp_path / "t.json"))
    eng._engine.tracer = tracer
    with _loader(paths, eng) as dl:
        rows = [bytes(r.numpy().tobytes()) for b in dl for r in b]
        quarantined = list(dl.quarantined)
    eng.close_all()
    jeng = jax_io.FaultyEngine(jax_io.StromEngine(_cfg("jax"),
                                                  stats=JaxStats()),
                               jax_io.FaultPlan.parse(plan_text))
    want_rows, want_q = _jax_rows(paths, jeng)
    jeng.close_all()
    assert len(quarantined) == 1 and quarantined == want_q
    assert rows == want_rows and len(rows) == 16
    if "max_count=1" in plan_text:   # the shard's first read failed
        bad = int(quarantined[0][-5])
        assert all(r[0] // 100 != bad for r in rows)
    assert stats.shards_quarantined == 1
    (ev,) = [e for e in tracer.events()
             if e["name"] == "strom.loader.quarantine"]
    assert ev["args"]["shard"] == quarantined[0]
    tracer.disable()


def test_loader_quarantined_shard_stays_out_across_epochs(tmp_path):
    paths = _write_shards(tmp_path)
    with open(paths[0], "r+b") as f:
        f.write(b"\xff" * 600)   # a damaged first header
    eng = FaultyEngine(StromEngine(_cfg(), stats=StromStats()),
                       FaultPlan([]))
    with _loader(paths, eng, decode=None) as dl:
        for _ in range(2):
            rows = [r for b in dl for r in b]
            assert len(rows) == 16
        assert dl.quarantined == [paths[0]]
    assert eng.stats.shards_quarantined == 1   # once, not per epoch
    eng.close_all()


def test_loader_budget_zero_raises_with_shard_path(tmp_path):
    from nvme_strom_tpu_torch.data.loader import ShardReadError
    paths = _write_shards(tmp_path)
    eng = ResilientEngine(
        FaultyEngine(StromEngine(_cfg(), stats=StromStats()),
                     FaultPlan.parse("eio:path=shard-00001")),
        _rcfg(max_retries=1))
    with _loader(paths, eng, budget=0) as dl:
        with pytest.raises(ShardReadError, match="shard-00001") as ei:
            list(dl)
    assert isinstance(ei.value.__cause__, ReadError)
    eng.close_all()


def test_loader_budget_exhausted_raises_with_quarantine_list(tmp_path):
    from nvme_strom_tpu_torch.data.loader import ShardReadError
    paths = _write_shards(tmp_path, n_shards=3)
    for p in paths[:2]:
        with open(p, "r+b") as f:
            f.write(b"\xff" * 600)
    eng = FaultyEngine(StromEngine(_cfg(), stats=StromStats()),
                       FaultPlan([]))
    with _loader(paths, eng, decode=None) as dl:
        with pytest.raises(ShardReadError,
                           match="budget .1. exhausted") as ei:
            list(dl)
    assert paths[0] in str(ei.value)
    eng.close_all()


def test_loader_errors_aggregate():
    from nvme_strom_tpu_torch.data.loader import LoaderErrors
    errs = [ValueError("first"), OSError(5, "second")]
    g = LoaderErrors(errs)
    assert g.errors == errs
    assert "first" in str(g) and "second" in str(g)
    assert "2 loader errors" in str(g)


def test_mid_sample_failure_releases_sibling_reads(tmp_path):
    """A two-part sample whose first part fails hands every staging
    buffer back: after the quarantined epoch the pool is whole."""
    from nvme_strom_tpu_torch.formats.wds import write_wds_shard
    paths = []
    for s in range(2):
        p = str(tmp_path / f"shard-{s:05d}.tar")
        write_wds_shard(p, [{"a": bytes([s]) * 512, "b": bytes([s]) * 512}
                            for _ in range(8)])
        paths.append(p)
    base = StromEngine(_cfg(), stats=StromStats())
    eng = FaultyEngine(base, FaultPlan.parse(
        "eio:path=shard-00000:max_count=1"))

    def decode(parts):
        return np.frombuffer(parts["a"] + parts["b"], np.uint8)
    with _loader(paths, eng, decode=decode) as dl:
        rows = [b for b in dl]
        assert dl.quarantined == [paths[0]]
    assert len(rows) == 1            # shard 1's 8 samples
    info = base.pool_info()
    assert info["free_buffers"] == info["n_buffers"], info
    eng.close_all()


@pytest.mark.parametrize("persistent", [True, False])
def test_loader_bitflip_under_verify(tmp_path, monkeypatch, persistent):
    """STROM_VERIFY=full: a flipped byte on disk survives the re-read and
    the shard is quarantined; a one-time flip in flight heals on the
    re-read and nothing is.  No corrupt row escapes either way."""
    monkeypatch.setenv("STROM_VERIFY", "full")
    paths = _write_shards(tmp_path, stamped=True)
    stats = StromStats()
    if persistent:
        with open(paths[0], "r+b") as f:
            f.seek(520)
            b = f.read(1)
            f.seek(520)
            f.write(bytes([b[0] ^ 0x20]))
        plan = FaultPlan([])
    else:
        plan = FaultPlan.parse("bitflip:path=shard-00000:max_count=1")
    eng = FaultyEngine(StromEngine(_cfg(), stats=stats), plan)
    with _loader(paths, eng, decode=None) as dl:
        rows = [bytes(r.numpy().tobytes()) for b in dl for r in b]
        quarantined = list(dl.quarantined)
    eng.close_all()
    assert all(len(set(r)) == 1 for r in rows), "corrupt row escaped"
    if persistent:
        assert quarantined == [paths[0]] and len(rows) == 16
        assert stats.checksum_failures >= 2
        assert stats.shards_quarantined == 1
    else:
        assert quarantined == [] and len(rows) == 32
        assert stats.checksum_failures == 1
        assert stats.shards_quarantined == 0
    assert stats.bytes_verified > 0


def test_loader_verify_off_is_zero_cost(tmp_path):
    paths = _write_shards(tmp_path, stamped=True)
    stats = StromStats()
    eng = FaultyEngine(StromEngine(_cfg(), stats=stats), FaultPlan([]))
    with _loader(paths, eng, budget=0, decode=None) as dl:
        rows = [r for b in dl for r in b]
    eng.close_all()
    assert len(rows) == 32
    assert stats.bytes_verified == 0 == stats.checksum_failures


# -- the watchdog -------------------------------------------------------------

def test_watchdog_dump_fires_and_resilient_recovers(data_file, tmp_path):
    from nvme_strom_tpu_torch.utils.watchdog import StepWatchdog
    path, payload = data_file
    eng, stats, _, _ = _stack("stuck:max_count=1:delay_s=5", tmp_path,
                              _rcfg(stuck_timeout_s=0.3, max_retries=2))
    buf = io.StringIO()
    with eng, StepWatchdog(deadline_s=0.1, engine=eng, stream=buf) as wd:
        fh = eng.open(path)
        with wd.step("stuck-read"):
            out = eng.read(fh, 0, 4096)
    assert out.tobytes() == payload[:4096]
    assert stats.stuck_cancelled == 1
    dump = buf.getvalue()
    assert wd.timeouts >= 1
    assert "'stuck-read'" in dump and "exceeded" in dump
    assert "resilience:" in dump and "faults_injected=1" in dump


# -- counters, build_engine, the consumers -----------------------------------

def test_stats_counters_roundtrip():
    s = StromStats()
    s.add(resilient_retries=2, hedges_issued=1, faults_injected=4,
          shards_quarantined=1, restore_fallbacks=1, stuck_cancelled=1,
          hedges_won=1, hedges_denied=1, write_retries=3)
    snap = s.snapshot()
    for k in ("resilient_retries", "hedges_issued", "hedges_won",
              "stuck_cancelled", "shards_quarantined", "restore_fallbacks",
              "faults_injected", "hedges_denied", "write_retries"):
        assert snap[k] >= 1
    assert set(RECOVERY) <= set(JaxStats().snapshot())
    assert set(RECOVERY) <= set(snap)


def test_build_engine_honors_env(monkeypatch):
    eng = build_engine(_cfg())
    assert type(eng) is StromEngine          # bare: no indirection
    eng.close_all()
    monkeypatch.setenv("STROM_FAULTS", "eio:every=2")
    monkeypatch.setenv("STROM_FAULTS_SEED", "3")
    monkeypatch.setenv("STROM_RESILIENT", "1")
    monkeypatch.setenv("STROM_RETRY_MAX", "5")
    monkeypatch.setenv("STROM_HEDGE_AFTER_S", "0.25")
    eng = build_engine(_cfg())
    assert isinstance(eng, ResilientEngine)
    assert isinstance(eng._engine, FaultyEngine)
    assert eng._engine.plan.specs[0].every == 2
    assert eng._engine.plan.seed == 3
    assert eng.rconfig.max_retries == 5
    assert eng.rconfig.hedge_after_s == 0.25
    eng.close_all()
    monkeypatch.delenv("STROM_FAULTS")
    eng = build_engine(_cfg())
    assert isinstance(eng._engine, StromEngine)
    eng.close_all()


def test_consumers_build_their_engine_from_the_env(tmp_path, monkeypatch):
    """The loader, the checkpoint manager and the weight loader build
    their own engine through build_engine: with STROM_FAULTS and
    STROM_RESILIENT set, a load of faulted reads still returns the
    right bytes."""
    from nvme_strom_tpu_torch.parallel.weights import (LazyCheckpoint,
                                                       save_checkpoint)
    from nvme_strom_tpu_torch.data import loader as loader_mod
    monkeypatch.setenv("STROM_FAULTS", "eio:every=5, short:every=7")
    monkeypatch.setenv("STROM_RESILIENT", "1")
    monkeypatch.setenv("STROM_RETRY_BACKOFF_S", "0.001")
    w = {"a": torch.arange(4096, dtype=torch.float32).reshape(64, 64),
         "b": torch.ones(7, dtype=torch.float32)}
    save_checkpoint(tmp_path / "m.safetensors", w)
    got = LazyCheckpoint(str(tmp_path / "m.safetensors")).load(
        device="cpu")
    for k, t in w.items():
        assert torch.equal(got[k], t)
    paths = _write_shards(tmp_path)
    dl = loader_mod.ShardedLoader(paths, global_batch=8, device="cpu")
    assert isinstance(dl._engine, ResilientEngine)
    with dl:
        assert sum(b.shape[0] for b in dl) == 32
    mgr = _manager(tmp_path / "ckpt", None)
    mgr.save(1, _ckpt_state(1.0))
    assert mgr.restore(_ckpt_state(0.0))["step"] == 1


# -- KV eviction writes under the write mirror --------------------------------

def test_kv_offload_write_faults_recovered(tmp_path):
    """PagedKVCache eviction writes retry under the resilient mirror;
    the page file is the JAX cache's under the same plan, byte for byte,
    with the same recovery counters, and attention over the streamed
    pages equals the JAX cache's."""
    import jax.numpy as jnp
    from nvme_strom_tpu.models import kv_offload as jk
    from nvme_strom_tpu.models import transformer as jtr
    from nvme_strom_tpu_torch.models import kv_offload as tk
    from nvme_strom_tpu_torch.models import transformer as ttr
    cfg_j = jtr.TransformerConfig(**{**jtr.tiny_config().__dict__,
                                     "dtype": jnp.float32})
    cfg_t = dataclasses.replace(ttr.tiny_config(), dtype=torch.float32)
    rng = np.random.default_rng(3)
    L, nkv, hd = cfg_t.n_layers, cfg_t.n_kv_heads, cfg_t.head_dim
    S, b = 19, 1
    k = rng.standard_normal((L, b, nkv, S, hd)).astype(np.float32)
    v = rng.standard_normal((L, b, nkv, S, hd)).astype(np.float32)
    q = rng.standard_normal((b, cfg_t.n_heads, 1, hd)).astype(np.float32)
    text = "weio:every=2:max_count=3, wshort:every=3:max_count=2:frac=0.5"
    res = {}
    for pkg in PKGS:
        eng, stats, _, _ = _stack(text, tmp_path, _rcfg(pkg, max_retries=3),
                                  pkg=pkg)
        path = str(tmp_path / f"{pkg}-kv.bin")
        if pkg == "port":
            cache = tk.PagedKVCache(cfg_t, tk.OffloadConfig(
                path=path, page_len=4, window_pages=2), eng, b,
                device="cpu")
            with cache:
                cache.append(torch.from_numpy(k), torch.from_numpy(v))
                cache.flush()
                n_cold = cache.n_cold
                out = cache.attend(0, torch.from_numpy(q)).numpy()
        else:
            cache = jk.PagedKVCache(cfg_j, jk.OffloadConfig(
                path=path, page_len=4, window_pages=2), eng, batch=b)
            with cache:
                cache.append(jnp.asarray(k), jnp.asarray(v))
                cache.flush()
                n_cold = cache.n_cold
                out = np.asarray(cache.attend(0, jnp.asarray(q)))
        eng.close_all()
        with open(path, "rb") as f:
            res[pkg] = (n_cold, _counters(stats), f.read(), out)
    assert res["port"][0] == res["jax"][0] >= 2
    assert res["port"][1] == res["jax"][1]
    assert res["port"][1]["write_retries"] >= 1
    assert res["port"][2] == res["jax"][2]
    np.testing.assert_allclose(res["port"][3], res["jax"][3], atol=1e-5,
                               rtol=1e-5)


def test_governor_hedge_lever_acts_as_jax():
    """The SLO governor doubles the decode class's hedge budget a boost
    and halves it back as it decays, on a resilient engine of either
    package, in step."""
    from nvme_strom_tpu.models.kv_offload import SloGovernor as JaxGov
    from nvme_strom_tpu_torch.models.kv_offload import SloGovernor
    engines = {
        "port": ResilientEngine(StromEngine(_cfg()), _rcfg()),
        "jax": jax_io.ResilientEngine(jax_io.StromEngine(_cfg("jax")),
                                      _rcfg("jax")),
    }
    budgets = {}
    for pkg, (gov, eng) in {"port": (SloGovernor(10.0), engines["port"]),
                            "jax": (JaxGov(10.0), engines["jax"])}.items():
        gov._MIN_INTERVAL_S = 0.0
        seen = [eng.hedge_budgets["decode"]]
        for p99 in (50, 50, 50, 50, 1, 1, 1, 1, 1):
            gov.observe(eng, p99)
            seen.append(eng.hedge_budgets["decode"])
        budgets[pkg] = seen
        eng.close_all()
    assert budgets["port"] == budgets["jax"]
    assert budgets["port"][0] == budgets["port"][-1] == 8
    assert max(budgets["port"]) == 8 * 2 ** SloGovernor._MAX_BOOST


def test_concurrent_waits_on_one_resilient_engine(data_file, tmp_path):
    """Readers on four threads under a faulty plan: every payload right,
    every buffer back.  The plan injects 8 faults in all and each read
    may retry 8 times, so however the threads' attempts interleave no
    read can run out of retries."""
    path, payload = data_file
    eng, stats, _, _ = _stack("eio:every=5:max_count=4, "
                              "short:every=7:frac=0.5:max_count=4",
                              tmp_path, _rcfg(max_retries=8))
    errs = []

    def reader(t):
        try:
            for i in range(16):
                off = ((t * 16 + i) % 60) * 4096
                assert eng.read(fh, off, 4096).tobytes() == \
                    payload[off:off + 4096]
        except BaseException as e:   # re-raised below
            errs.append(e)
    with eng:
        fh = eng.open(path)
        ts = [threading.Thread(target=reader, args=(t,)) for t in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        eng.close(fh)
        info = eng.pool_info()
        assert info["free_buffers"] == info["n_buffers"]
    assert not errs, errs
    assert stats.faults_injected == 8
    assert stats.resilient_retries == 8


def test_read_spans_of_a_recovered_read(data_file, tmp_path):
    """Under a request context, the fault and retry spans join the
    request's tree."""
    from nvme_strom_tpu_torch.utils import trace
    path, _ = data_file
    eng, _, _, tracer = _stack("eio:max_count=1", tmp_path)
    root = trace.TraceContext.new()
    with eng:
        fh = eng.open(path)
        with trace.use_context(root):
            r = eng.submit_read(fh, 0, 4096)
        r.wait()
        r.release()
        eng.close(fh)
    evs = tracer.events()
    names = [e["name"] for e in evs]
    assert "strom.resilient.retry" in names
    assert any(n.startswith("strom.read") for n in names)
    retry = evs[names.index("strom.resilient.retry")]
    assert retry["args"]["trace"] == f"{root.trace_id:x}"
    assert trace.connected_tree(evs, f"{root.trace_id:x}")
    tracer.disable()
    json.dumps(evs)
