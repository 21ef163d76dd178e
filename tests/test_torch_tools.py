"""The port's operator tools (nvme_strom_tpu_torch/tools/) and its stats
export (utils/stats.py ``maybe_export``, the engine's ``sync_stats``, the
drain exit hook) held against the JAX package's on the same inputs:

- ``strom_stat.render`` of one snapshot gives the JAX tool's text for
  every line both packages have (exact); every port counter renders and
  reaches ``--json`` and ``--prom`` (tests/test_observability.py:345);
- ``STROM_STATS_EXPORT`` / ``STROM_METRICS_FILE`` behave as
  tests/test_observability.py:271-320 has them;
- ``strom_top.render_frame`` of the same documents equals the JAX
  tool's (exact), and the tool runs live against the port's debug
  server;
- ``ssd2gpu_test`` gives the exit codes and byte counts of
  tests/test_tools.py:29-66 and of the JAX ``ssd2tpu_test`` on the same
  file, ``--ceilings`` runs its three legs, and a flipped byte fails it;
- ``transfer_diag``'s alias proof against the JAX tool's on the same
  bytes (its timings have no JAX output to compare with);
  ``stream_probe``'s records, and ``DeviceStream``'s two drains against
  the JAX ``DeviceStream``'s chunks (exact);
- ``kernel_probe``'s out, lse, dQ, dK and dV against the JAX package's
  flash attention on the same seeded inputs (float32: 2e-5 on out and
  lse, 1e-4 on the gradients, the JAX flash suite's own), and the
  probe's records at a small shape;
- ``profile_report.classify`` against the JAX tool's on the kernel
  names both class alike, its documented differences held as they are,
  its first-match-wins table and the report's sums."""

import json
import os
import time

import numpy as np
import pytest
import torch

from nvme_strom_tpu.tools import profile_report as jax_profile
from nvme_strom_tpu.tools import ssd2tpu_test as jax_ssd
from nvme_strom_tpu.tools import strom_stat as jax_stat
from nvme_strom_tpu.tools import strom_top as jax_top
from nvme_strom_tpu.tools import transfer_diag as jax_diag
from nvme_strom_tpu.utils.stats import COUNTER_FIELDS as JAX_COUNTERS
from nvme_strom_tpu_torch.io.engine import StromEngine
from nvme_strom_tpu_torch.tools import (kernel_probe, profile_report,
                                        ssd2gpu_test, stream_probe,
                                        strom_stat, strom_top,
                                        transfer_diag)
from nvme_strom_tpu_torch.utils import stats as stats_mod
from nvme_strom_tpu_torch.utils.config import EngineConfig
from nvme_strom_tpu_torch.utils.stats import (COUNTERS, MetricsSnapshotter,
                                              StromStats,
                                              openmetrics_from_snapshot,
                                              write_openmetrics_file)


@pytest.fixture(autouse=True)
def no_export_env(monkeypatch):
    for k in ("STROM_STATS_EXPORT", "STROM_METRICS_FILE",
              "STROM_METRICS_INTERVAL_S", "STROM_FAULTS"):
        monkeypatch.delenv(k, raising=False)


@pytest.fixture
def data_file(tmp_path):
    path = tmp_path / "payload.bin"
    rng = np.random.default_rng(7)
    path.write_bytes(rng.integers(0, 256, 3 * (1 << 20) + 777,
                                  dtype=np.uint8).tobytes())
    return path


def _full_snapshot():
    """Every port counter nonzero (a distinct value each) with the
    gauges and breakdowns the blocks render."""
    snap = {n: (i + 1) * 4099 for i, n in enumerate(COUNTERS)}
    snap.update({
        "lat_read_p50_us": 46.34, "lat_read_p99_us": 92.681,
        "ring_depths": [3, 0], "ring_health": ["closed", "open"],
        "engine_degraded": 1, "kv_store_pages_resident": 12,
        "kv_restore_p99_ms": 3.25, "cache_bytes_resident": 1 << 22,
        "cache_lines_resident": 4, "boot_phase": "warming",
        "drain_phase": "draining",
        "ring_state_s": {"busy": [1.5, 0.25], "idle": [3.0, 4.0],
                         "stalled": [0.0, 0.5], "restarting": [0.0, 0.0]},
        "class_stats": {
            "decode": {"dispatches": 9, "spans": 12, "promotions": 1,
                       "queue_wait_s_max": 0.004, "queue_wait_s_sum": 0.01,
                       "queue_wait_s_n": 5, "hedges_issued": 2,
                       "hedges_won": 1, "cache_hits": 3,
                       "cache_misses": 1, "bytes_served_cache": 8192},
            "prefetch": {"dispatches": 20, "spans": 40}},
        "tenant_stats": {"victim": {"requests_finished": 4, "dispatches": 9},
                         "aggr": {"admissions_shed": 7, "borrows": 2}},
    })
    return snap


def _jax_only_line(line: str) -> bool:
    """A line of the JAX table that shows a counter the port does not
    have (its headline block lists them even at zero): the counter's
    name, then its value (``bytes_resident (lines)`` is the host tier's
    gauge, which both have)."""
    words = line.split()
    return (len(words) >= 2 and not words[1].startswith("(")
            and words[0] in set(JAX_COUNTERS) - set(COUNTERS))


@pytest.mark.parametrize("which", ["full", "zero", "engine"])
def test_render_matches_jax(which, tmp_path, data_file):
    if which == "full":
        snap = _full_snapshot()
    elif which == "zero":
        snap = {n: 0 for n in COUNTERS}
    else:
        with StromEngine(EngineConfig(chunk_bytes=1 << 20,
                                      buffer_pool_bytes=8 << 20)) as eng:
            fh = eng.open(data_file)
            with eng.submit_read(fh, 0, 4096) as p:
                p.wait()
            eng.close(fh)
            eng.sync_stats()
            snap = eng.stats.snapshot()
    snap = json.loads(json.dumps(snap))      # the exported file's types
    ours = strom_stat.render(snap).splitlines()
    theirs = [ln for ln in jax_stat.render(snap).splitlines()
              if not _jax_only_line(ln)]
    assert ours == theirs
    prev = dict(snap, bytes_direct=snap["bytes_direct"] // 2,
                faults_injected=0)
    ours = strom_stat.render(snap, prev, 2.0).splitlines()
    theirs = [ln for ln in jax_stat.render(snap, prev, 2.0).splitlines()
              if not _jax_only_line(ln)]
    assert ours == theirs


def test_every_counter_in_a_block_json_and_prom(tmp_path, capsys):
    blocks = [n for blk in strom_stat.ALL_COUNTER_BLOCKS for n in blk]
    assert sorted(blocks) == sorted(COUNTERS)        # each exactly once
    snap = _full_snapshot()
    text = strom_stat.render(snap)
    for n in COUNTERS:
        assert n in text, n
    path = tmp_path / "s.json"
    path.write_text(json.dumps(snap))
    assert strom_stat.main([str(path), "--json"]) == 0
    assert set(COUNTERS) <= set(json.loads(capsys.readouterr().out))
    assert strom_stat.main([str(path), "--prom"]) == 0
    prom = capsys.readouterr().out
    for n in COUNTERS:
        assert f"strom_{n}_total {snap[n]}" in prom, n
    assert prom == openmetrics_from_snapshot(snap)
    assert prom.rstrip().endswith("# EOF")


def test_strom_stat_usage(tmp_path, capsys):
    assert strom_stat.main([str(tmp_path / "missing.json")]) == 2
    assert "cannot read" in capsys.readouterr().err
    assert strom_stat.main([]) == 2
    assert strom_stat.main(["--device", str(tmp_path)]) == 0
    assert "device topology for" in capsys.readouterr().out


def test_maybe_export_and_prom_flag(tmp_path, capsys, monkeypatch):
    st = StromStats()
    st.add(bytes_direct=123, kv_prefix_hits=2)
    export = tmp_path / "s.json"
    monkeypatch.setenv("STROM_STATS_EXPORT", str(export))
    st.maybe_export()
    doc = json.loads(export.read_text())
    assert doc["bytes_direct"] == 123 and doc["_pid"] == os.getpid()
    assert abs(doc["_exported_at"] - time.time()) < 60
    assert strom_stat.main([str(export), "--prom"]) == 0
    out = capsys.readouterr().out
    assert "strom_bytes_direct_total 123" in out
    assert "strom_kv_prefix_hits_total 2" in out
    assert "_exported_at" not in out and "# EOF" in out
    assert strom_stat.main([str(export)]) == 0
    assert "exported " in capsys.readouterr().out


def test_metrics_file_written_at_export(tmp_path, monkeypatch):
    mfile = tmp_path / "metrics.prom"
    monkeypatch.setenv("STROM_STATS_EXPORT", str(tmp_path / "s.json"))
    monkeypatch.setenv("STROM_METRICS_FILE", str(mfile))
    st = StromStats()
    st.add(bytes_direct=7)
    st.maybe_export()
    text = mfile.read_text()
    assert "strom_bytes_direct_total 7" in text
    assert text.rstrip().endswith("# EOF")


def test_metrics_file_standalone_without_stats_export(tmp_path,
                                                      monkeypatch):
    mfile = tmp_path / "metrics.prom"
    monkeypatch.setenv("STROM_METRICS_FILE", str(mfile))
    st = StromStats()
    st.add(bytes_direct=9)
    st.maybe_export()
    assert "strom_bytes_direct_total 9" in mfile.read_text()


def test_metrics_snapshotter_series_and_file(tmp_path):
    st = StromStats()
    mfile = tmp_path / "m.prom"
    with MetricsSnapshotter(st, interval_s=0.05, path=str(mfile)) as snap:
        st.add(bytes_direct=100)
        deadline = time.monotonic() + 5
        while not snap.series and time.monotonic() < deadline:
            time.sleep(0.02)
    assert snap.series and snap.series[-1]["bytes_direct"] == 100
    assert all("_t" in s for s in snap.series)
    assert "strom_bytes_direct_total 100" in mfile.read_text()


def test_write_openmetrics_file_atomic(tmp_path):
    p = tmp_path / "out.prom"
    write_openmetrics_file(str(p), {"bytes_direct": 5})
    assert "strom_bytes_direct_total 5" in p.read_text()
    assert not list(tmp_path.glob("out.prom.tmp*"))


def test_engine_exports_at_every_sync(tmp_path, data_file, monkeypatch):
    """Each sync_stats writes $STROM_STATS_EXPORT, with the interval
    read-latency gauges after a read; the first engine under
    STROM_METRICS_FILE starts the process's writer, which drains the
    engine's counters before each snapshot until it closes."""
    export = tmp_path / "s.json"
    mfile = tmp_path / "m.prom"
    monkeypatch.setenv("STROM_STATS_EXPORT", str(export))
    monkeypatch.setenv("STROM_METRICS_FILE", str(mfile))
    monkeypatch.setenv("STROM_METRICS_INTERVAL_S", "0.05")
    monkeypatch.setattr(stats_mod, "_writer", None)
    try:
        with StromEngine(EngineConfig(chunk_bytes=1 << 20,
                                      buffer_pool_bytes=8 << 20)) as eng:
            writer = stats_mod._writer
            assert writer is not None and eng._metrics_writer is writer
            fh = eng.open(data_file)
            for off in range(0, 3 << 20, 1 << 20):
                with eng.submit_read(fh, off, 1 << 20) as p:
                    p.wait()
            eng.close(fh)
            eng.sync_stats()
            doc = json.loads(export.read_text())
            assert doc["bytes_direct"] + doc["bytes_fallback"] == 3 << 20
            assert doc["lat_read_p50_us"] > 0 and doc["lat_read_p99_us"] > 0
            assert doc["lat_read_p99_us"] >= doc["lat_read_p50_us"]
            t0 = doc["_exported_at"]
            eng.sync_stats()       # an idle interval keeps the gauges
            doc = json.loads(export.read_text())
            assert doc["_exported_at"] >= t0 and doc["lat_read_p99_us"] > 0
            deadline = time.monotonic() + 5
            while not writer.series and time.monotonic() < deadline:
                time.sleep(0.02)
            assert writer.series
        assert writer._sync is None      # detached before the handle died
        assert "strom_lat_read_p99_us" in mfile.read_text()
        assert "lat_read_p99_us" in strom_stat.render(
            json.loads(export.read_text()))
    finally:
        w = stats_mod._writer
        stats_mod._writer = None
        if w is not None:
            w.close()


def test_drain_exit_hook_exports(tmp_path, monkeypatch):
    from nvme_strom_tpu_torch.io.handoff import DrainCoordinator
    export = tmp_path / "s.json"
    st = StromStats()
    st.add(handoff_drains=1)

    class _Eng:
        stats = st
        flight = None

    monkeypatch.setenv("STROM_STATS_EXPORT", str(export))
    DrainCoordinator(engine=_Eng()).final_snapshot(reason="test")
    assert json.loads(export.read_text())["handoff_drains"] == 1


def _frames():
    attrib = {"enabled": True, "requests": 12, "spans_dropped": 3,
              "classes": {"decode": {
                  "n": 12, "wall_p50_us": 1800, "wall_p99_us": 5000,
                  "components": {"nvme_read": {"share": 0.61},
                                 "bridge": {"share": 0.2},
                                 "unattributed": {"share": 0.19}}}}}
    ledger = {"delivered_bytes": 3 << 20, "goodput_bytes": 2 << 20,
              "goodput_fraction": 0.6667, "waste_bytes": 1 << 20,
              "waste": {"hedge_loss": 1 << 20, "degraded": 0},
              "ring_state_s": {"busy": [1.0, 2.0], "idle": [3.0, 2.0],
                               "stalled": [0.0, 0.0],
                               "restarting": [0.0, 0.0]}}
    health = {"ring_health": ["closed", "half_open"], "degraded": True,
              "boot_phase": "warming", "drain_phase": "draining"}
    return [(attrib, ledger, health),
            ({"enabled": False}, {}, {}),
            ({"enabled": True, "classes": {}, "requests": 0},
             {"delivered_bytes": 0}, {"boot_phase": "steady",
                                      "drain_phase": "serving"})]


@pytest.mark.parametrize("k", [0, 1, 2])
def test_strom_top_frame_matches_jax(k):
    a, l, h = _frames()[k]
    assert strom_top.render_frame(a, l, h) == jax_top.render_frame(a, l, h)


def test_strom_top_live_against_debug_server(data_file, capsys):
    from nvme_strom_tpu_torch.obs.debugsrv import DebugServer
    with StromEngine(EngineConfig(chunk_bytes=1 << 20,
                                  buffer_pool_bytes=8 << 20)) as eng:
        srv = DebugServer(eng.stats, port=0)
        srv.attach_engine(eng)
        try:
            fh = eng.open(data_file)
            with eng.submit_read(fh, 0, 1 << 20) as p:
                p.wait()
            eng.close(fh)
            assert strom_top.main(["--port", str(srv.port), "--once"]) == 0
            out = capsys.readouterr().out
            assert "ledger — goodput vs waste" in out
            assert "attribution off" in out or "class" in out
        finally:
            srv.close()
    assert strom_top.main(["--port", str(srv.port), "--once"]) == 2


def _ssd(capsys, tool, argv):
    rc = tool.main(argv)
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("argv", [
    ["--chunk-bytes", str(1 << 20), "--depth", "3", "--verify"],
    ["--chunk-bytes", str(1 << 20), "--verify-pread", "--depth", "2"],
    ["--dest", "device", "--chunk-bytes", str(1 << 20), "--verify"],
    ["--total-bytes", str(1 << 20), "--chunk-bytes", str(256 << 10)],
    ["--dest", "null", "--chunk-bytes", str(1 << 20)],
    ["--force-buffered", "--chunk-bytes", str(1 << 20), "--verify"],
])
def test_ssd2gpu_matches_jax(capsys, data_file, argv):
    rc, res = _ssd(capsys, ssd2gpu_test,
                   [str(data_file), "--device", "cpu"] + argv)
    rc_j, res_j = _ssd(capsys, jax_ssd, [str(data_file)] + argv)
    assert rc == rc_j == 0
    for k in ("bytes", "verify", "dest", "chunk_bytes", "depth"):
        assert res[k] == res_j[k], k
    assert res["stats"]["requests_failed"] == 0
    if "--total-bytes" not in argv:
        assert res["bytes"] == data_file.stat().st_size
    if "--dest" in argv and "device" in argv:
        assert res["stats"]["bytes_to_device"] >= data_file.stat().st_size
        assert res["chunks_verified"] == res["chunks"] == 4
    if "--force-buffered" in argv:
        assert res["bytes_direct"] == 0
        assert res["bytes_fallback"] == data_file.stat().st_size


def test_ssd2gpu_generates_file(capsys, tmp_path):
    rc, res = _ssd(capsys, ssd2gpu_test, ["--make-bytes", str(1 << 20),
                                          "--tmpdir", str(tmp_path),
                                          "--verify"])
    assert rc == 0 and res["verify"] == "ok"
    assert not os.path.exists(res["file"])


def test_ssd2gpu_ceilings_and_a_flipped_byte(capsys, data_file,
                                             monkeypatch):
    rc, res = _ssd(capsys, ssd2gpu_test,
                   [str(data_file), "--ceilings", "--trials", "2",
                    "--device", "cpu", "--chunk-bytes", str(1 << 20),
                    "--verify"])
    assert rc == 0 and res["ceilings"]
    assert len(res["trials"]) == 2
    for t in res["trials"]:
        assert set(t) == {"ssd", "h2d", "stream"}
        assert t["stream"]["verify"] == "ok"
        assert t["stream"]["bytes"] == t["ssd"]["bytes"] == \
            data_file.stat().st_size
    assert res["lower_ceiling"] in ("ssd", "h2d")
    assert res["stream_share_of_lower_ceiling"] > 0
    # a flipped byte from the engine fails the check
    monkeypatch.setenv("STROM_FAULTS", "bitflip:every=1")
    rc, res = _ssd(capsys, ssd2gpu_test,
                   [str(data_file), "--device", "cpu", "--dest", "device",
                    "--chunk-bytes", str(1 << 20), "--verify"])
    assert rc == 1 and res["verify"] == "FAILED"


@pytest.mark.parametrize("cold", [False, True])
def test_ssd2gpu_window_allocator(capsys, data_file, monkeypatch, cold):
    """``--dest device --verify`` takes every chunk the window keeps
    from the allocator before the clock; ``--cold-alloc`` takes none.
    Both check every chunk."""
    taken = []
    monkeypatch.setattr(ssd2gpu_test, "_warm_allocator",
                        lambda dev, sizes: taken.append(list(sizes)))
    rc, res = _ssd(capsys, ssd2gpu_test,
                   [str(data_file), "--device", "cpu", "--dest", "device",
                    "--chunk-bytes", str(1 << 20), "--verify"]
                   + (["--cold-alloc"] if cold else []))
    assert rc == 0 and res["verify"] == "ok"
    assert res["chunks_verified"] == res["chunks"] == 4
    assert res["warm_alloc"] is (not cold)
    assert taken == ([] if cold else [[1 << 20] * 3 + [777]])


def test_device_dest_needs_the_card(data_file):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ssd2gpu_test.main([str(data_file), "--dest", "device"])


def test_transfer_diag_alias_proof(capsys):
    assert transfer_diag.main(["--bytes", str(1 << 20), "--repeats", "2",
                               "--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["view_in_pool"] and res["view_aligned"]
    assert res["view_registered"] is None        # no card to register
    for k in ("t_staging_s", "t_heap_s", "t_copy_heap_s"):
        assert res[k] > 0
    # the JAX tool's alias proof on the same request: equal verdicts
    # (the timings are each package's own device boundary)
    want = jax_diag.run(1 << 20, repeats=2)
    for k in ("bytes", "pool_locked", "view_in_pool", "view_aligned",
              "alignment"):
        assert res[k] == want[k], k


def test_stream_probe_records(tmp_path, capsys):
    assert stream_probe.main(["--bytes", str(8 << 20), "--dir",
                              str(tmp_path), "--repeats", "1",
                              "--device", "cpu"]) == 0
    recs = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [(r["probe"], r.get("depth"), r.get("drain")) for r in recs] == [
        ("depth", d, drain) for d in (4, 8, 16, 32)
        for drain in ("blocking", "ready")] + [
        ("chunk", 16, "ready"), ("chunk", 8, "ready"), ("chunk", 4, "ready"),
        ("boundary", None, None)]
    for r in recs[:-1]:
        assert r["stream_gibs"] > 0 and r["link_gibs"] > 0
        assert r["raw_gibs"] > 0
        # 3 x depth staging buffers past the 64-buffer cap: the stage
        assert r["overlap"] == (r["depth"] == 32)
    assert not list(tmp_path.iterdir())          # its files removed


def _jax_stream_chunks(path, drain):
    """The chunks the JAX ``DeviceStream`` yields for ``path`` on the
    CPU device, as bytes."""
    import jax
    from nvme_strom_tpu.io.engine import StromEngine as JaxEngine
    from nvme_strom_tpu.ops.bridge import DeviceStream as JaxStream
    from nvme_strom_tpu.utils.config import EngineConfig as JaxConfig
    with JaxEngine(JaxConfig(chunk_bytes=1 << 20,
                             buffer_pool_bytes=16 << 20)) as eng:
        ds = JaxStream(eng, device=jax.devices("cpu")[0], depth=2,
                       drain=drain)
        return [np.asarray(a).tobytes() for a in ds.stream_file(str(path))]


def test_device_stream_drain_policies_same_bytes(data_file):
    from nvme_strom_tpu_torch.ops.bridge import DeviceStream
    with StromEngine(EngineConfig(chunk_bytes=1 << 20,
                                  buffer_pool_bytes=16 << 20)) as eng:
        want = data_file.read_bytes()
        for drain in ("blocking", "ready"):
            ds = DeviceStream(eng, device="cpu", depth=2, drain=drain)
            got = [t.numpy().tobytes() for t in ds.stream_file(data_file)]
            assert b"".join(got) == want, drain
            assert got == _jax_stream_chunks(data_file, drain), drain
        with pytest.raises(ValueError, match="drain"):
            DeviceStream(eng, device="cpu", drain="eager")


@pytest.mark.parametrize("b,h,hkv,s,d", [(1, 4, 2, 128, 32),
                                        (2, 2, 1, 96, 16)])
def test_kernel_probe_grads_match_jax_flash(b, h, hkv, s, d):
    """The probe's kernel calls (kernels 4-6 as the train step calls
    them; their plain versions on the CPU) against the JAX package's
    flash attention in interpret mode, on the same seeded q, K/V at
    ``hkv`` heads expanded to ``h``, and dO: out and lse within 2e-5,
    dQ, dK and dV within 1e-4 (float32, the JAX flash suite's own)."""
    import jax
    from nvme_strom_tpu.ops import flash_attention as jfa
    rng = np.random.default_rng(11)
    q = rng.standard_normal((b, h, s, d), dtype=np.float32)
    k, v = (np.repeat(rng.standard_normal((b, hkv, s, d), dtype=np.float32),
                      h // hkv, axis=1) for _ in range(2))
    do = rng.standard_normal((b, h, s, d), dtype=np.float32)
    scale = d ** -0.5
    got, delta = kernel_probe.kernel_grads(
        *(torch.from_numpy(a) for a in (q, k, v, do)), scale)
    (out, lse), vjp = jax.vjp(
        lambda q_, k_, v_: jfa.flash_attention_lse(
            q_, k_, v_, causal=True, scale=scale, block_q=32, block_k=32),
        q, k, v)
    dq, dk, dv = vjp((do, np.zeros(lse.shape, np.float32)))
    for n, want, tol in (("out", out, 2e-5), ("lse", lse, 2e-5),
                         ("dq", dq, 1e-4), ("dk", dk, 1e-4),
                         ("dv", dv, 1e-4)):
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want),
                                   rtol=tol, atol=tol, err_msg=n)
    np.testing.assert_allclose(
        delta.numpy(), (do * np.asarray(out)).sum(-1), rtol=1e-5, atol=1e-5)
    plain = kernel_probe.plain_reference(
        *(torch.from_numpy(a) for a in (q, k, v, do)), delta, scale)
    assert all(e <= 1.0 for e in kernel_probe.check_errors(got,
                                                           plain).values())


def test_kernel_probe_small_shape(capsys):
    assert kernel_probe.main(["--device", "cpu", "--shapes", "",
                              "--shape", "1,4,2,128,64", "--roof-n", "128",
                              "--iters", "1"]) == 0
    recs = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    flash, sdpa, roof = recs
    assert flash["impl"] == "flash" and flash["within_tol"]
    assert sdpa["impl"] == "sdpa"
    assert flash["bound_fwd_ms"] * 4.5 == pytest.approx(
        flash["bound_fwdbwd_ms"])
    assert roof["probe"] == "matmul_roof" and roof["finite"]


#: the JAX tool's class → the port's, for kernels both class alike
_JAX_TO_PORT_CLASS = {"matmul": "matmul", "attention-kernel": "attention",
                      "copy": "copy", "reduce": "elementwise",
                      "elementwise-fusion": "elementwise", "other": "other"}


@pytest.mark.parametrize("name", [
    "void flash_fwd_tc<64>(CUtensorMap, CUtensorMap, FwdArgs)",
    "void flash_dkv_kernel<float>(BwdArgs)",
    "void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits>",
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
    "void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_relu>",
    "void at::native::elementwise_kernel<128, 2, direct_copy_kernel>",
    "void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>",
    "void transpose_kernel<float>",
    "void at::native::vectorized_elementwise_kernel<4, AddFunctor>",
    "void at::native::unrolled_elementwise_kernel<MulFunctor<float>>",
    "void at::native::index_elementwise_kernel<128, 4>",
    "void at::native::reduce_kernel<512, 1, ReduceOp<float, sum>>",
    "void at::native::scatter_gather_elementwise_kernel<128, 4>",
    "aten::matmul", "aten::copy_", "aten::add", "some_custom_kernel",
])
def test_profile_classify_matches_jax(name):
    assert profile_report.classify(name) == _JAX_TO_PORT_CLASS[
        jax_profile.classify(name)]


@pytest.mark.parametrize("name,jax_cls,port_cls", [
    # the JAX tool has no collective class: XLA's all-gather and
    # all-reduce keyword-match "reduce"; the ring kernel 7 is a TPU
    # custom call there
    ("ncclDevKernel_AllGather_RING_LL(ncclDevComm*, unsigned long)",
     "reduce", "collective"),
    ("ici_ring_kernel(RingArgs)", "other", "collective"),
    # the port's attention kernels run GEMM tiles, and the decode and
    # paged kernels (2, 3) are custom calls, unnamed, in the JAX trace
    ("void flash_dq_tc<64>(gemm_tile_args)", "matmul", "attention"),
    ("void decode_split<__nv_bfloat16, 64>(SplitArgs)", "other",
     "attention"),
    ("aten::_scaled_dot_product_flash_attention", "matmul", "attention"),
    # CUDA's own names, which XLA never gives an op
    ("Memcpy HtoD (Pinned -> Device)", "other", "copy"),
    ("void h2d_words<2>(unsigned char const*, unsigned char*)", "other",
     "copy"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_TNT", "other", "matmul"),
    ("void cublasLt::splitKreduce_kernel<32, 16, int, float>", "reduce",
     "matmul"),
    ("aten::addmm", "elementwise-fusion", "matmul"),
    ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4>",
     "other", "elementwise"),
])
def test_profile_classify_differs_from_jax_as_documented(name, jax_cls,
                                                         port_cls):
    assert jax_profile.classify(name) == jax_cls
    assert profile_report.classify(name) == port_cls


@pytest.mark.parametrize("name,cls", [
    ("ncclDevKernel_AllGather_RING_LL(ncclDevComm*, unsigned long)",
     "collective"),
    ("ici_ring_kernel(RingArgs)", "collective"),
    ("void flash_fwd_tc<64>(CUtensorMap, CUtensorMap, FwdArgs)",
     "attention"),
    ("void flash_dq_tc<64>(gemm_tile_args)", "attention"),
    ("void flash_dkv_kernel<float>(BwdArgs)", "attention"),
    ("void decode_split<__nv_bfloat16, 64>(SplitArgs)", "attention"),
    ("void paged_combine<float>(SplitArgs, int)", "attention"),
    ("void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits>",
     "attention"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
     "matmul"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_relu>",
     "matmul"),
    ("Memcpy HtoD (Pinned -> Device)", "copy"),
    ("void h2d_words<2>(unsigned char const*, unsigned char*)", "copy"),
    ("void at::native::elementwise_kernel<128, 2, direct_copy_kernel>",
     "copy"),
    ("void at::native::vectorized_elementwise_kernel<4, AddFunctor>",
     "elementwise"),
    ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4>",
     "elementwise"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_TNT", "matmul"),
    ("void cublasLt::splitKreduce_kernel<32, 16, int, float>", "matmul"),
    ("void at::native::multi_tensor_apply_kernel<TensorListMetadata<4>>",
     "elementwise"),
    ("aten::addmm", "matmul"),
    ("some_custom_kernel", "other"),
])
def test_profile_classify_first_match_wins(name, cls):
    assert profile_report.classify(name) == cls


def test_profile_summary_sums_to_busy():
    events = [("void flash_fwd_tc<64>", 3.0, 2),
              ("sm90_xmma_gemm_bf16", 5.0, 10),
              ("Memcpy HtoD", 0.5, 2), ("vectorized_elementwise_kernel",
                                         1.5, 30)]
    rep = profile_report.summarize(events, wall_ms=20.0, steps=2)
    assert rep["device_busy_ms"] == pytest.approx(10.0)
    assert rep["busy_frac"] == pytest.approx(0.5)
    assert sum(rep["category_frac"].values()) == pytest.approx(
        rep["busy_frac"])
    assert list(rep["category_ms"]) == ["matmul", "attention",
                                        "elementwise", "copy"]
    assert next(iter(rep["top_ops_ms"])) == "sm90_xmma_gemm_bf16"


def test_profile_report_cpu_capture(capsys):
    assert profile_report.main(["--device", "cpu", "--batch", "1",
                                "--seq", "32"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["steps_traced"] == 2 and rep["device"] == "cpu"
    assert rep["category_ms"].get("matmul", 0) > 0
    assert sum(rep["category_frac"].values()) == pytest.approx(
        rep["busy_frac"])
    assert all(np.isfinite(rep["losses"]))
