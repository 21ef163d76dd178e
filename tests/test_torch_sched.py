"""The port's QoS scheduler and multi-ring engine
(nvme_strom_tpu_torch/io/sched.py, io/engine.py) held against the JAX
package's: the cases of tests/test_sched.py that need neither fault
injection nor the resilient engine, each run through both packages, and
the grant log of every scripted enqueue/step sequence over fake rings
compared between them exactly (which batch, which ring, promoted or
not, after how many rounds)."""

import errno
import threading

import numpy as np
import pytest

from nvme_strom_tpu.io import engine as jax_engine_mod
from nvme_strom_tpu.io import sched as jax_sched
from nvme_strom_tpu.io.plan import plan_and_submit as jax_plan_and_submit
from nvme_strom_tpu.utils.config import EngineConfig as JaxEngineConfig
from nvme_strom_tpu.utils.stats import StromStats as JaxStats
from nvme_strom_tpu_torch.io import engine as port_engine_mod
from nvme_strom_tpu_torch.io import sched as port_sched
from nvme_strom_tpu_torch.io.plan import plan_and_submit
from nvme_strom_tpu_torch.utils.config import EngineConfig
from nvme_strom_tpu_torch.utils.stats import StromStats

PKGS = {"jax": (jax_sched, JaxStats), "port": (port_sched, StromStats)}


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


def _sched(mod, fake, policies=None, aging=16, stats=None, cap=None):
    return mod.QoSScheduler(fake.submit_ring, fake.ring_free,
                            policies=policies, aging_rounds=aging,
                            stats=stats, ring_cap=cap)


def _state(batches):
    return [(b.granted, b.ring, b.promoted, b.rounds) for b in batches]


# -- the scheduler core against fakes: each case returns its grant trace ----

def case_priority_ordering(mod, _stats):
    fake = _Fake([2])
    s = _sched(mod, fake, cap=2)
    bs = s.enqueue([("scrub", 0, 1)], "scrub")
    bp = s.enqueue([("prefetch", 0, 1)], "prefetch")
    br = s.enqueue([("restore", 0, 1)], "restore")
    trace = []
    assert s.step()
    assert br.granted and not bp.granted and not bs.granted
    trace.append(_state([bs, bp, br]))
    s.ack_submitted(br)
    fake.slots = [2]
    assert s.step()
    assert bp.granted and not bs.granted
    trace.append(_state([bs, bp, br]))
    s.ack_submitted(bp)
    fake.slots = [2]
    assert s.step()
    assert bs.granted
    trace.append(_state([bs, bp, br]))
    return trace


def case_decode_never_admission_queued(mod, _stats):
    fake = _Fake([0, 0])
    s = _sched(mod, fake, cap=4)
    bd = s.enqueue([("decode", 0, 1)], "decode")
    bp = s.enqueue([("prefetch", 0, 1)], "prefetch")
    assert s.step()
    assert bd.granted and bd.ring is not None
    assert not bp.granted
    return _state([bd, bp])


def case_fair_share_weights(mod, _stats):
    fake = _Fake([100])
    s = _sched(mod, fake, cap=100)
    restore = [s.enqueue([("restore", i, 1)], "restore") for i in range(40)]
    scrub = [s.enqueue([("scrub", i, 1)], "scrub") for i in range(40)]
    acked = set()
    trace = []
    for _ in range(5):
        fake.slots = [100]
        s.step()
        for b in restore + scrub:
            if b.granted and id(b) not in acked:
                acked.add(id(b))
                s.ack_submitted(b)
        trace.append(_state(restore + scrub))
    restore_n = sum(1 for b in restore if b.granted)
    scrub_n = sum(1 for b in scrub if b.granted)
    assert restore_n == 4 * scrub_n, (restore_n, scrub_n)
    assert scrub_n == 5
    return trace


def case_aging_starvation_bound(mod, _stats):
    K = 4
    pol = mod.default_policies()
    pol["restore"] = mod.ClassPolicy("restore", 1, weight=1000.0)
    fake = _Fake([2])
    s = _sched(mod, fake, policies=pol, aging=K, cap=2)
    scrub = s.enqueue([("scrub", 0, 1)], "scrub")
    rounds_to_grant = None
    batches = [scrub]
    for rnd in range(K + 2):
        batches.append(s.enqueue([(f"restore{rnd}", 0, 1)], "restore"))
        fake.slots = [2]
        s.step()
        if scrub.granted and rounds_to_grant is None:
            rounds_to_grant = rnd + 1
    assert scrub.granted and rounds_to_grant <= K + 1
    assert scrub.promoted and s.promotions == 1
    return _state(batches), rounds_to_grant


def case_zero_capacity_round_does_not_age(mod, _stats):
    fake = _Fake([0])
    s = _sched(mod, fake, aging=3, cap=2)
    b = s.enqueue([("scrub", 0, 1)], "scrub")
    for _ in range(10):
        s.step()
    assert b.rounds == 0 and not b.granted
    return _state([b])


def case_urgent_ring_reservation(mod, _stats):
    fake = _Fake([3, 4])
    s = _sched(mod, fake, cap=4)
    bp = s.enqueue([("prefetch", 0, 1)], "prefetch")
    s.step()
    assert bp.granted and bp.ring == 1
    fake2 = _Fake([4, 1])
    s2 = _sched(mod, fake2, cap=4)
    bp2 = s2.enqueue([("prefetch", 0, 1)], "prefetch")
    s2.step()
    assert bp2.granted and bp2.ring == 0
    return _state([bp, bp2])


def case_cap_one_stays_work_conserving(mod, _stats):
    fake = _Fake([1] * 8)
    s = _sched(mod, fake, cap=1)
    b = s.enqueue([("prefetch", 0, 1)], "prefetch")
    assert s.step()
    assert b.granted and not b.promoted and b.rounds == 0
    return _state([b])


def case_close_unblocks_grant_waiter(mod, _stats):
    fake = _Fake([0])
    s = _sched(mod, fake, cap=4)
    err = []

    def blocked():
        try:
            s.submit([("prefetch", 0, 1)], "prefetch")
        except OSError as e:
            err.append(e)

    t = threading.Thread(target=blocked)
    t.start()
    t.join(timeout=0.2)
    assert t.is_alive()
    s.close()
    t.join(timeout=5.0)
    assert not t.is_alive() and err
    assert err[0].errno == errno.ECANCELED
    with pytest.raises(OSError):
        s.submit([("x", 0, 1)], "prefetch")
    return err[0].errno


def case_sched_counters_flow_to_stats(mod, stats_cls):
    st = stats_cls()
    fake = _Fake([10])
    s = _sched(mod, fake, stats=st, cap=10)
    assert s.submit([("x", 0, 1), ("y", 0, 1)], "restore") == ["pend"] * 2
    snap = st.snapshot()
    assert snap["sched_enqueued"] == 1 and snap["sched_dispatches"] == 1
    cls = snap["class_stats"]["restore"]
    assert cls["dispatches"] == 1 and cls["spans"] == 2
    assert cls["queue_wait_s_n"] == 1
    return (snap["sched_enqueued"], snap["sched_dispatches"],
            snap["sched_promotions"], cls["dispatches"], cls["spans"],
            fake.granted)


def case_unknown_class_rides_default(mod, stats_cls):
    fake = _Fake([10])
    st = stats_cls()
    s = _sched(mod, fake, stats=st, cap=10)
    s.submit([("x", 0, 1)], "no-such-class")
    assert "prefetch" in st.snapshot()["class_stats"]
    return sorted(st.snapshot()["class_stats"])


CORE_CASES = {f.__name__[5:]: f for f in (
    case_priority_ordering, case_decode_never_admission_queued,
    case_fair_share_weights, case_aging_starvation_bound,
    case_zero_capacity_round_does_not_age, case_urgent_ring_reservation,
    case_cap_one_stays_work_conserving, case_close_unblocks_grant_waiter,
    case_sched_counters_flow_to_stats, case_unknown_class_rides_default)}


@pytest.mark.parametrize("pkg", list(PKGS))
@pytest.mark.parametrize("name", list(CORE_CASES))
def test_scheduler_case(name, pkg):
    """The reference test's case, asserted on one package."""
    CORE_CASES[name](*PKGS[pkg])


@pytest.mark.parametrize("name", list(CORE_CASES))
def test_scheduler_case_trace_equals_jax(name):
    """Every batch's grant, ring, promotion and rounds over the case's
    scripted sequence are the JAX scheduler's (exact)."""
    assert CORE_CASES[name](*PKGS["port"]) == CORE_CASES[name](*PKGS["jax"])


def _scripted_log(mod, seed, n_rings, cap, aging, steps):
    """A seeded sequence of enqueues of every class and batch size,
    rounds against changing ring headroom and acks: the grant log."""
    rng = np.random.default_rng(seed)
    fake = _Fake([cap] * n_rings)
    s = _sched(mod, fake, aging=aging, cap=cap)
    classes = list(mod.CLASS_ORDER) + [None, "unknown"]
    live, log = [], []
    for step in range(steps):
        for _ in range(int(rng.integers(0, 4))):
            k = classes[int(rng.integers(len(classes)))]
            n = int(rng.integers(1, 4))
            b = s.enqueue([(step, i, 1) for i in range(n)], k)
            live.append((len(live), b))
        fake.slots = [int(x) for x in rng.integers(-1, cap + 1, n_rings)]
        s.step()
        for i, b in live:
            if b.granted and b.ring is not None and (i, "acked") not in log:
                log.append((i, b.klass, b.ring, b.promoted, b.rounds))
                log.append((i, "acked"))
                if rng.random() < 0.7:
                    s.ack_submitted(b)
    log.append(("queued", s.queued()))
    log.append(("counts", s.dispatches, s.promotions, s.enqueued))
    return log


@pytest.mark.parametrize("seed,n_rings,cap,aging", [
    (0, 1, 2, 16), (1, 2, 2, 4), (2, 4, 4, 3), (3, 8, 1, 2), (4, 3, 6, 8)])
def test_scripted_grant_order_equals_jax(seed, n_rings, cap, aging):
    """Random enqueue/step/ack scripts over fake rings: the port grants
    the same batches to the same rings in the same order as the JAX
    scheduler."""
    got = _scripted_log(port_sched, seed, n_rings, cap, aging, 60)
    want = _scripted_log(jax_sched, seed, n_rings, cap, aging, 60)
    assert got == want
    assert any(isinstance(e[0], int) and len(e) == 5 for e in got)


def test_set_weight_and_backlog_equal_jax():
    """A weight changed at run time reshapes the grants as in the JAX
    scheduler, priorities and the aging bound untouched; ``backlog`` and
    ``queued`` report the same queues."""
    logs = {}
    for name, (mod, _stats) in PKGS.items():
        fake = _Fake([6])
        s = _sched(mod, fake, cap=6, aging=5)
        for i in range(12):
            s.enqueue([(i, 0, 1)], "scrub" if i % 2 else "scan")
        s.set_weight("scrub", 4.0)
        with pytest.raises(KeyError):
            s.set_weight("nope", 1.0)
        log = []
        for _ in range(6):
            s.step()
            for k in mod.CLASS_ORDER:
                log.append((k, s.queued()[k]))
            log.append(sorted((k, v["batches"], v["spans"])
                              for k, v in s.backlog().items()))
            fake.slots = [6]
            for b in list(s._granted_out):
                s._granted_out[b] = 0
        log.append((s.dispatches, s.promotions))
        logs[name] = log
    assert logs["port"] == logs["jax"]


def test_policies_and_weights_parse_like_jax():
    for spec in ("", "decode=16,scrub=0.5", " restore = 3 "):
        ours = port_sched.default_policies(spec)
        theirs = jax_sched.default_policies(spec)
        assert {k: (p.priority, p.weight, p.hedge_budget, p.max_retries)
                for k, p in ours.items()} == \
            {k: (p.priority, p.weight, p.hedge_budget, p.max_retries)
             for k, p in theirs.items()}
    for bad in ("nope=1", "decode"):
        with pytest.raises(ValueError):
            port_sched.default_policies(bad)
    assert port_sched.CLASS_ORDER == jax_sched.CLASS_ORDER
    assert port_sched.DEFAULT_CLASS == jax_sched.DEFAULT_CLASS


# -- the real multi-ring engine: both packages on the same file -------------

def _cfg(cls, **kw):
    base = dict(chunk_bytes=1 << 20, queue_depth=8,
                buffer_pool_bytes=16 << 20)
    base.update(kw)
    return cls(**base)


@pytest.fixture
def data_file(tmp_path):
    path = tmp_path / "sched.bin"
    payload = np.random.default_rng(7).integers(
        0, 256, 4 << 20, dtype=np.uint8).tobytes()
    path.write_bytes(payload)
    return path, payload


def _engines(**kw):
    return (port_engine_mod.StromEngine(
                _cfg(EngineConfig, use_io_uring=False, **kw),
                stats=StromStats()),
            jax_engine_mod.StromEngine(
                _cfg(JaxEngineConfig, use_io_uring=False, **kw),
                stats=JaxStats()))


def test_multi_ring_reads_all_classes(data_file):
    """Every class tag reads the same bytes as the JAX engine on two
    rings; the rings account every submission, and the pool is one."""
    path, payload = data_file
    eng, jeng = _engines(n_rings=2)
    with eng, jeng:
        assert eng.n_rings == jeng.n_rings == 2
        assert eng.scheduler is not None
        assert eng.n_buffers == jeng.n_buffers
        fh, jfh = eng.open(path), jeng.open(path)
        submitted = 0
        for klass in ("decode", "restore", "prefetch", "scrub", None):
            exts = [(fh, i * 100_000, 50_000) for i in range(6)]
            planned = plan_and_submit(eng, exts, klass=klass)
            jplanned = jax_plan_and_submit(
                jeng, [(jfh, o, n) for _f, o, n in exts], klass=klass)
            for i, (pieces, jpieces) in enumerate(zip(planned, jplanned)):
                got = b"".join(p.wait().tobytes() for p in pieces)
                want = b"".join(p.wait().tobytes() for p in jpieces)
                assert got == want == \
                    payload[i * 100_000:i * 100_000 + 50_000]
                for p in pieces + jpieces:
                    p.release()
        submitted = eng.sync_stats()["requests_submitted"]
        infos = [eng.ring_info(r) for r in range(eng.n_rings)]
        assert sum(i["submitted"] for i in infos) == submitted == 30
        assert all(i["inflight_io"] == 0 for i in infos)
        assert len(eng.ring_depths()) == 2
        pi = eng.pool_info()
        assert pi["n_buffers"] == eng.n_buffers
        assert pi["free_buffers"] == pi["n_buffers"]
        assert eng.stats.class_stats.keys() == \
            jeng.stats.class_stats.keys()
        for k, blk in jeng.stats.class_stats.items():
            assert eng.stats.class_stats[k]["spans"] == blk["spans"]
        eng.close(fh)
        jeng.close(jfh)


def test_ring_pinned_submission(data_file):
    """``ring=`` pins a batch to one ring and bypasses the scheduler."""
    path, payload = data_file
    eng, jeng = _engines(n_rings=2)
    with eng, jeng:
        fh = eng.open(path)
        before = eng.ring_info(1)["submitted"]
        prs = eng.submit_readv([(fh, 0, 4096), (fh, 8192, 4096)], ring=1)
        assert [bytes(p.wait()) for p in prs] == [payload[:4096],
                                                  payload[8192:12288]]
        for p in prs:
            p.release()
        assert eng.ring_info(1)["submitted"] == before + 2
        assert eng.stats.sched_dispatches == 0
        eng.close(fh)


def test_single_ring_degenerate_mode(data_file, monkeypatch):
    """``STROM_RINGS=1``: no scheduler, one ring, tagged and untagged
    batches read and count alike, no class accounting."""
    path, payload = data_file
    monkeypatch.setenv("STROM_RINGS", "1")
    with port_engine_mod.StromEngine(_cfg(EngineConfig),
                                     stats=StromStats()) as eng:
        assert eng.n_rings == 1 and eng.scheduler is None
        fh = eng.open(path)
        tagged = eng.submit_readv([(fh, 0, 8192)], klass="decode")
        plain = eng.submit_readv([(fh, 0, 8192)])
        assert tagged[0].wait().tobytes() == plain[0].wait().tobytes() \
            == payload[:8192]
        tagged[0].release()
        plain[0].release()
        snap = eng.sync_stats()
        assert snap["requests_submitted"] == 2
        assert snap["submit_batches"] == 2
        assert eng.stats.sched_enqueued == 0
        assert eng.stats.snapshot().get("class_stats") is None
        eng.close(fh)


def test_tiny_engine_stays_single_ring():
    """A pool of 2 buffers cannot feed two rings: auto resolves to 1,
    as in the JAX engine."""
    kw = dict(chunk_bytes=16 << 10, buffer_pool_bytes=32 << 10,
              queue_depth=2, use_io_uring=False)
    with port_engine_mod.StromEngine(EngineConfig(**kw),
                                     stats=StromStats()) as eng, \
            jax_engine_mod.StromEngine(JaxEngineConfig(**kw),
                                       stats=JaxStats()) as jeng:
        assert eng.n_rings == jeng.n_rings == 1
        assert eng.scheduler is None and jeng.scheduler is None


def test_auto_ring_count_caps(monkeypatch):
    """A power of two in [1, 8], the JAX package's count on this host,
    and the quarter-of-the-CPUs rule under a patched CPU count."""
    n = port_engine_mod.auto_ring_count()
    assert 1 <= n <= 8 and n & (n - 1) == 0
    assert n == jax_engine_mod.auto_ring_count()
    for cpus, want in ((1, 1), (8, 2), (12, 2), (16, 4), (64, 8)):
        monkeypatch.setattr("os.cpu_count", lambda c=cpus: c)
        monkeypatch.setattr(port_engine_mod, "_nvme_hw_queues", lambda: 0)
        monkeypatch.setattr(jax_engine_mod, "_nvme_hw_queues", lambda: 0)
        assert port_engine_mod.auto_ring_count() == want == \
            jax_engine_mod.auto_ring_count()


def test_concurrent_classes_never_deadlock(data_file):
    """A bulk storm on several threads and a decode reader share one
    two-ring engine; every thread ends within its timeout with the right
    bytes, and the engine closes with no read in flight."""
    path, payload = data_file
    eng = port_engine_mod.StromEngine(
        _cfg(EngineConfig, n_rings=2, queue_depth=4, use_io_uring=False),
        stats=StromStats())
    fh = eng.open(path)
    errors, done = [], []

    def reader(klass, seed, n):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(n):
                offs = rng.integers(0, (4 << 20) - 200_000, 4)
                exts = [(fh, int(o), 150_000) for o in offs]
                for (f, o, ln), pieces in zip(
                        exts, plan_and_submit(eng, exts, klass=klass)):
                    got = b"".join(p.wait().tobytes() for p in pieces)
                    for p in pieces:
                        p.release()
                    if got != payload[o:o + ln]:
                        errors.append((klass, o))
            done.append(klass)
        except Exception as e:   # reported below, with the thread's class
            errors.append((klass, repr(e)))

    threads = [threading.Thread(target=reader, args=(k, i, 40))
               for i, k in enumerate(["prefetch", "prefetch", "scrub",
                                      "decode", "restore"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    alive = [t for t in threads if t.is_alive()]
    eng.close(fh)
    eng.close_all()
    assert not alive and not errors and len(done) == 5
    assert eng.stats.sched_dispatches == eng.stats.sched_enqueued == 200
