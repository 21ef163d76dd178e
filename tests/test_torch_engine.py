"""The port's engine binding (nvme_strom_tpu_torch/io/engine.py) against
the JAX package's: the same C structs, the same bytes off disk.  Reads
are compared exactly; the CPU device path must count its protective
copy as bounce."""

import ctypes

import numpy as np
import pytest
import torch

from nvme_strom_tpu.io import engine as jax_engine
from nvme_strom_tpu_torch.device import resolve_device
from nvme_strom_tpu_torch.io import engine as port_engine
from nvme_strom_tpu_torch.io.engine import StromEngine, check_file, \
    wait_exact
from nvme_strom_tpu_torch.ops.bridge import DeviceStream
from nvme_strom_tpu_torch.utils.config import EngineConfig

STRUCTS = ["_FileInfo", "_PoolInfo", "_StatsBlk", "_RdExt", "_Completion"]


@pytest.fixture()
def engine():
    cfg = EngineConfig(chunk_bytes=1 << 20, queue_depth=8,
                       buffer_pool_bytes=16 << 20)
    with StromEngine(cfg) as e:
        yield e


@pytest.mark.parametrize("name", STRUCTS)
def test_struct_layout_matches_jax_binding(name):
    """Field names, offsets and sizes equal the JAX binding's
    (exact)."""
    ours, theirs = getattr(port_engine, name), getattr(jax_engine, name)
    assert ctypes.sizeof(ours) == ctypes.sizeof(theirs)
    assert [f[0] for f in ours._fields_] == [f[0] for f in theirs._fields_]
    for fname, _ in ours._fields_:
        a, b = getattr(ours, fname), getattr(theirs, fname)
        assert (a.offset, a.size) == (b.offset, b.size), fname


def test_stream_file_cpu_bytes_and_bounce(engine, tmp_data_file):
    """Byte-identical chunks through DeviceStream(device='cpu'); the
    alias-protecting copy is counted as bounce, every byte reached the
    device."""
    path, payload = tmp_data_file
    ds = DeviceStream(engine, device="cpu", depth=3)
    before = engine.stats.snapshot()
    got = b"".join(c.numpy().tobytes() for c in ds.stream_file(path))
    assert got == payload
    engine.sync_stats()
    after = engine.stats.snapshot()
    assert after["bytes_to_device"] - before["bytes_to_device"] == \
        len(payload)
    # the host copy is bounce; engine fallback reads (filesystems that
    # refuse O_DIRECT) add their own
    assert after["bounce_bytes"] - before["bounce_bytes"] >= len(payload)
    assert after["bytes_direct"] + after["bytes_fallback"] == len(payload)


def test_reads_match_jax_engine(tmp_data_file):
    """The same ranges read through both engines are the same bytes."""
    path, _payload = tmp_data_file
    ranges = [(0, 4096), (12345, 70000), ((1 << 20) - 3, 9)]
    cfg_j = jax_engine.EngineConfig(chunk_bytes=1 << 20, queue_depth=4,
                                    buffer_pool_bytes=8 << 20)
    with jax_engine.StromEngine(cfg_j) as ej, \
            StromEngine(EngineConfig(chunk_bytes=1 << 20, queue_depth=4,
                                     buffer_pool_bytes=8 << 20)) as ep:
        fj, fp = ej.open(path), ep.open(path)
        try:
            for off, ln in ranges:
                p = ep.submit_read(fp, off, ln)
                got = wait_exact(p).tobytes()
                p.release()
                assert got == ej.read(fj, off, ln).tobytes()
        finally:
            ej.close(fj)
            ep.close(fp)


def test_pending_read_views_and_release(engine, tmp_data_file):
    path, payload = tmp_data_file
    fh = engine.open(path)
    try:
        prs = engine.submit_readv([(fh, 0, 1000), (fh, 4096, 5000)])
        views = [wait_exact(p) for p in prs]
        assert views[0].tobytes() == payload[:1000]
        assert views[1].tobytes() == payload[4096:9096]
        assert all(p.is_ready() for p in prs)
        for p in prs:
            p.release()
            p.release()                      # idempotent
        info = engine.pool_info()
        assert info["free_buffers"] == info["n_buffers"]
        # a read past EOF comes back short: wait_exact raises
        size = engine.file_size(fh)
        p = engine.submit_read(fh, size - 10, 100)
        with pytest.raises(OSError, match="short read"):
            wait_exact(p)
        with pytest.raises(ValueError, match="exceeds chunk_bytes"):
            engine.submit_read(fh, 0, (1 << 20) + 1)
    finally:
        engine.close(fh)


def test_check_file_and_config(tmp_data_file):
    path, payload = tmp_data_file
    info = check_file(path)
    assert info["size"] == len(payload)
    with pytest.raises(ValueError, match="multiple of alignment"):
        EngineConfig(chunk_bytes=1000)
    assert EngineConfig(buffer_pool_bytes=1 << 30).n_buffers == 64


def test_cuda_entry_points_raise_without_a_card(engine):
    """The card is the default: with no GPU the entry points raise
    instead of running somewhere else."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceStream(engine)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


@pytest.mark.parametrize("chunk", [4096, 1 << 16])
def test_plan_matches_jax_planner(chunk):
    """Coalescing and splitting of random extents over two files equal
    the JAX planner's (default gap, no record unit)."""
    from nvme_strom_tpu.io import plan as jax_plan
    from nvme_strom_tpu_torch.io import plan as port_plan
    rng = np.random.default_rng(chunk)
    extents = [(int(rng.integers(0, 2)), int(rng.integers(0, 1 << 18)),
                int(rng.integers(0, 3 * chunk))) for _ in range(200)]
    ours = port_plan.plan_extents(extents, chunk_bytes=chunk)
    theirs = jax_plan.plan_extents(extents, chunk_bytes=chunk,
                                   gap=jax_plan.DEFAULT_COALESCE_GAP)
    assert ours.spans == theirs.spans
    assert ours.placements == theirs.placements
    assert ours.spans_coalesced == theirs.spans_coalesced
    assert port_plan.split_spans([(0, 10), (5, 0), (7, 9)], 4) == \
        jax_plan.split_spans([(0, 10), (5, 0), (7, 9)], 4)


def test_plan_and_submit_views(engine, tmp_data_file):
    """Adjacent extents share one read; every view holds its bytes and
    the staging buffers all return."""
    from nvme_strom_tpu_torch.io.plan import join_pieces, plan_and_submit
    path, payload = tmp_data_file
    fh = engine.open(path)
    try:
        extents = [(fh, 0, 100), (fh, 100, 50), (fh, 9000, 3 << 20),
                   (fh, 5, 0)]
        planned = plan_and_submit(engine, extents)
        assert [len(p) for p in planned] == [1, 1, 3, 0]
        for (_, off, ln), pieces in zip(extents[:3], planned):
            p = join_pieces(pieces, engine.stats)
            assert wait_exact(p).tobytes() == payload[off:off + ln]
            p.release()
    finally:
        engine.close(fh)
    info = engine.pool_info()
    assert info["free_buffers"] == info["n_buffers"]
    assert engine.stats.bounce_bytes == 3 << 20   # the one host join
