"""The port's tracer, latency histogram and waste ledger
(nvme_strom_tpu_torch/utils/trace.py, io/engine.py, obs/ledger.py)
held against the JAX package's: every case of tests/test_trace.py, run
through the port's engine and, where the two can be compared, through
the JAX engine on the same file (span names, counts and byte args
exactly; percentiles of the same histogram exactly), plus the causal
context helpers and ``connected_tree`` on the same event lists."""

import json

import numpy as np
import pytest

from nvme_strom_tpu.io import StromEngine as JaxEngine
from nvme_strom_tpu.obs import ledger as jax_ledger
from nvme_strom_tpu.utils import trace as jax_trace
from nvme_strom_tpu.utils.config import EngineConfig as JaxEngineConfig
from nvme_strom_tpu.utils.stats import StromStats as JaxStats
from nvme_strom_tpu.utils.stats import \
    percentiles_from_log2_hist as jax_percentiles
from nvme_strom_tpu_torch.io import StromEngine
from nvme_strom_tpu_torch.obs import ledger
from nvme_strom_tpu_torch.utils import trace
from nvme_strom_tpu_torch.utils.config import EngineConfig
from nvme_strom_tpu_torch.utils.stats import (StromStats,
                                              percentiles_from_log2_hist)
from nvme_strom_tpu_torch.utils.trace import Tracer

_SIZES = dict(chunk_bytes=1 << 20, queue_depth=4, buffer_pool_bytes=8 << 20)


def _engine(tracer=None):
    return StromEngine(EngineConfig(**_SIZES), stats=StromStats(),
                       tracer=tracer)


def _jax_engine(tracer=None):
    return JaxEngine(JaxEngineConfig(**_SIZES), stats=JaxStats(),
                     tracer=tracer)


def _read_all(eng, path, size):
    fh = eng.open(path)
    for off in range(0, size, 1 << 20):
        p = eng.submit_read(fh, off, min(1 << 20, size - off))
        p.wait()
        p.release()
    eng.close(fh)


def test_read_spans_recorded(tmp_data_file, tmp_path):
    """One ``strom.read`` span a chunk with its bytes; the same names and
    byte args as the JAX engine's spans over the same file."""
    path, payload = tmp_data_file
    docs = {}
    for name, make in (("port", _engine), ("jax", _jax_engine)):
        out = tmp_path / f"{name}.json"
        tracer = (Tracer if name == "port" else jax_trace.Tracer)(str(out))
        with make(tracer) as eng:
            _read_all(eng, path, len(payload))
        n_chunks = (len(payload) + (1 << 20) - 1) // (1 << 20)
        assert len(tracer) == n_chunks
        assert tracer.export() == str(out)
        docs[name] = json.loads(out.read_text())["traceEvents"]
    for ev in docs["port"]:
        assert ev["ph"] == "X" and ev["dur"] >= 0 and ev["ts"] > 0
        assert ev["name"].startswith("strom.read")
        assert ev["args"]["bytes"] > 0
    assert [e["args"]["bytes"] for e in docs["port"]] == \
        [e["args"]["bytes"] for e in docs["jax"]]
    assert sorted({e["name"] for e in docs["port"]}) == \
        sorted({e["name"] for e in docs["jax"]})


def test_write_spans_recorded(tmp_path):
    tracer = Tracer(str(tmp_path / "t.json"))
    with _engine(tracer) as eng:
        fh = eng.open(tmp_path / "out.bin", writable=True)
        eng.submit_write(fh, 0, np.zeros(4096, np.uint8)).wait()
        eng.close(fh)
    (ev,) = tracer.events()
    assert ev["name"] == "strom.write" and ev["args"]["bytes"] == 4096


def test_disabled_tracer_records_nothing(tmp_data_file):
    path, _ = tmp_data_file
    tracer = Tracer()  # no path -> disabled
    with _engine(tracer) as eng:
        fh = eng.open(path)
        p = eng.submit_read(fh, 0, 4096)
        p.wait()
        p.release()
        eng.close(fh)
    assert len(tracer) == 0
    assert tracer.export() is None


def test_span_context_manager(tmp_path):
    tracer = Tracer(str(tmp_path / "t.json"))
    with tracer.span("unit.work", items=3):
        pass
    assert len(tracer) == 1
    tracer.export()
    ev = json.loads((tmp_path / "t.json").read_text())["traceEvents"][0]
    assert ev["name"] == "unit.work" and ev["args"]["items"] == 3


def test_latency_histogram_counts_requests(tmp_data_file):
    """Eight reads land in the read histogram, none in the write one;
    the port's percentiles of it equal the JAX function's."""
    path, _ = tmp_data_file
    with _engine() as eng:
        fh = eng.open(path)
        n_reqs = 8
        for _ in range(n_reqs):
            p = eng.submit_read(fh, 0, 4096)
            p.wait()
            p.release()
        hist = eng.latency_histogram()
        assert sum(hist["read"]) == n_reqs
        assert sum(hist["write"]) == 0
        pct = eng.latency_percentiles("read")
        assert pct[50] > 0 and pct[99] >= pct[50]
        assert pct == jax_percentiles(hist["read"], ps=(50, 90, 99))
        eng.close(fh)


def test_sync_stats_drains_counters_as_the_jax_engine(tmp_data_file):
    """After the same reads, both engines' drained counter blocks agree
    on the bytes read and on ``requests_failed``."""
    path, payload = tmp_data_file
    keys = ("bytes_direct", "bytes_fallback", "requests_failed")
    got = {}
    for name, make in (("port", _engine), ("jax", _jax_engine)):
        with make() as eng:
            _read_all(eng, path, len(payload))
            eng.sync_stats()
            snap = eng.stats.snapshot()
            got[name] = {k: snap[k] for k in keys}
    assert got["port"] == got["jax"]
    assert (got["port"]["bytes_direct"] + got["port"]["bytes_fallback"]
            == len(payload))
    assert got["port"]["requests_failed"] == 0


_GM = 2 ** 0.5   # per-bucket geometric mean factor (utils/stats.py)


@pytest.mark.parametrize("hist,expect", [
    ([0] * 64, {50: 0, 90: 0, 99: 0}),
    ([0, 0, 4], {50: int(4 * _GM), 90: int(4 * _GM), 99: int(4 * _GM)}),
])
def test_percentiles_from_log2_hist(hist, expect):
    assert percentiles_from_log2_hist(hist, ps=(50, 90, 99)) == expect
    assert jax_percentiles(hist, ps=(50, 90, 99)) == expect


def test_percentiles_spread():
    hist = [0] * 64
    hist[10] = 90   # 90 fast requests ~1µs
    hist[20] = 10   # 10 slow ~1ms
    pct = percentiles_from_log2_hist(hist, ps=(50, 99))
    assert pct[50] == int(2 ** 10 * _GM)
    assert pct[99] == int(2 ** 20 * _GM)
    assert pct == jax_percentiles(hist, ps=(50, 99))


# -- beyond tests/test_trace.py: the causal context, the cap, the ledger ----

def test_engine_spans_carry_the_submit_context(tmp_data_file, tmp_path):
    """A read submitted under a request's context and waited outside it
    is that context's child; the tree is connected, as the JAX
    package's ``connected_tree`` judges it too."""
    path, _ = tmp_data_file
    tracer = Tracer(str(tmp_path / "t.json"))
    root = trace.TraceContext.new()
    with _engine(tracer) as eng:
        fh = eng.open(path)
        with trace.use_context(root):
            with tracer.span("request"):
                p = eng.submit_read(fh, 0, 4096)
        p.wait()            # no context current here
        p.release()
        q = eng.submit_read(fh, 0, 4096)   # outside any request
        q.wait()
        q.release()
        eng.close(fh)
    evs = tracer.events()
    request, read, flat = evs          # the request span ends first
    assert read["args"]["trace"] == f"{root.trace_id:x}"
    assert read["args"]["parent"] == request["args"]["span"]
    assert request["args"]["parent"] == root.span_id
    assert "trace" not in flat.get("args", {})
    for fn in (trace.connected_tree, jax_trace.connected_tree):
        assert fn(evs)
        assert fn([read, request])
        assert fn([read])       # its parent not emitted: one implicit root
        # two roots of one trace are two trees
        assert not fn([request, {**request,
                                 "args": {**request["args"], "span": -1,
                                          "parent": None}},
                       {**read, "args": {**read["args"], "parent": None}}])


def test_connected_tree_matches_the_jax_package():
    """Tagged event lists of every shape judged alike by both."""
    def ev(span, parent, tr="a"):
        args = {"trace": tr, "span": span}
        if parent is not None:
            args["parent"] = parent
        return {"name": "x", "args": args}
    cases = [[], [ev(1, None)], [ev(1, None), ev(2, 1), ev(3, 2)],
             [ev(2, 9), ev(3, 9)], [ev(2, 9), ev(3, 8)],
             [ev(1, None), ev(2, None)], [ev(1, None), ev(2, 7)],
             [ev(1, None, "b"), ev(2, 1, "b"), ev(5, None, "a")],
             [{"name": "flat"}]]
    for c in cases:
        assert trace.connected_tree(c) == jax_trace.connected_tree(c), c
        assert trace.connected_tree(c, "b") == \
            jax_trace.connected_tree(c, "b"), c


def test_attach_context_and_no_context():
    assert trace.attach_context() is trace.NO_CONTEXT
    root = trace.TraceContext.new()
    with trace.use_context(root):
        c = trace.attach_context()
        assert (c.trace_id, c.parent_id) == (root.trace_id, root.span_id)
        assert trace.current_context() is root
        with trace.use_context(None):
            assert trace.current_context() is None
    assert trace.current_context() is None
    tracer = Tracer()
    tracer.enable("/nonexistent/never-written.json")
    with trace.use_context(root):
        tracer.add_span("x", 0, 1, ctx=trace.NO_CONTEXT)
    (e,) = tracer.events()
    assert "args" not in e
    tracer.disable()


def test_span_cap_counts_drops(tmp_path):
    stats = StromStats()
    tracer = Tracer(str(tmp_path / "t.json"), max_events=2, stats=stats)
    for i in range(5):
        tracer.add_span(f"s{i}", 0, 1)
    assert len(tracer) == 2 and tracer.dropped == 3
    assert stats.trace_spans_dropped == 3
    tracer.export()
    doc = json.loads((tmp_path / "t.json").read_text())
    assert doc["metadata"] == {"strom_dropped_events": 3}
    tracer.disable()


def test_counter_track_needs_an_export_path(tmp_path):
    tracer = Tracer()
    tracer.add_sink(lambda ev: None)          # sink-only: enabled
    tracer.add_counter("depth", {"r0": 1})
    assert len(tracer) == 0
    tracer.enable(str(tmp_path / "t.json"))
    tracer.add_counter("depth", {"r0": 2})
    (ev,) = tracer.events()
    assert ev["ph"] == "C" and ev["args"] == {"r0": 2.0}
    tracer.disable()


def test_sinks_see_spans_without_keeping_them():
    seen = []
    tracer = Tracer()
    tracer.add_sink(seen.append)
    tracer.add_span("a", 0, 5)
    assert [e["name"] for e in seen] == ["a"] and len(tracer) == 0
    tracer.remove_sink(seen.append)
    assert not tracer.enabled


@pytest.mark.parametrize("charges", [
    {}, {"hedge_loss": 4096}, {"retry_reread": 100, "hedge_loss": 7},
    {"coalesce_gap": 1, "evicted_unused": 2, "degraded": 3,
     "retry_reread": 0}])
def test_waste_ledger_matches_the_jax_package(charges):
    """The same charges on both packages' counter blocks give the same
    counters and the same goodput/waste view."""
    ours, theirs = StromStats(), JaxStats()
    for s in (ours, theirs):
        s.add(bytes_direct=1 << 20, bytes_fallback=4096,
              bytes_served_cache=8192)
    for kind, n in charges.items():
        ledger.charge_waste(ours, kind, n)
        jax_ledger.charge_waste(theirs, kind, n)
    ledger.charge_waste(None, "hedge_loss", 5)     # no block: nothing
    a, b = ours.snapshot(), theirs.snapshot()
    for counter in ledger.WASTE_COUNTERS.values():
        assert a[counter] == b[counter]
    view = ledger.ledger_view(a)
    want = jax_ledger.ledger_view(b)
    want.pop("ring_state_s", None)
    assert view == want
    assert ledger.ledger_view({})["goodput_fraction"] == 1.0


def test_ici_exchange_span_on_the_cpu(tmp_path):
    """The exchange's span goes to the tracer it is handed (default: the
    process's global tracer, disabled, which records nothing)."""
    from nvme_strom_tpu_torch.ops.ici import IciExchange
    from nvme_strom_tpu_torch.parallel.mesh import exchange_group
    tracer = Tracer(str(tmp_path / "t.json"))
    rows = np.arange(4 * 100, dtype=np.uint8).reshape(4, 100)
    got = IciExchange(exchange_group(devices=["cpu"] * 4),
                      tracer=tracer).all_gather(rows)
    assert np.array_equal(got.numpy(), rows)
    (ev,) = tracer.events()
    assert ev["name"] == "strom.ici.exchange"
    assert ev["args"]["hosts"] == 4 and ev["args"]["bytes"] == 400
    tracer.disable()
    before = len(trace.global_tracer)
    IciExchange(exchange_group(devices=["cpu"] * 4)).all_gather(rows)
    assert len(trace.global_tracer) == before
