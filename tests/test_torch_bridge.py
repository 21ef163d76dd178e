"""The port's bridge (nvme_strom_tpu_torch/ops/bridge.py) on the CPU:
the overlap stage's slab rotation, the retire pool's order, and the
bytes of every stream path.  A fake transfer stands in for the device
copy, as in tests/test_bridge.py; bytes are compared exactly."""

import numpy as np
import pytest
import torch

from nvme_strom_tpu_torch.io.engine import StromEngine
from nvme_strom_tpu_torch.ops.bridge import (DeviceStream,
                                             StagingRetirePool, h2d_copy,
                                             h2d_copy_plain, host_to_device)
from nvme_strom_tpu_torch.utils.config import EngineConfig


def _engine(n_buffers):
    # one ring: a multi-ring pool rounds an odd count down to a multiple
    # of the ring count, and these tests pick a path by the exact count
    return StromEngine(EngineConfig(chunk_bytes=1 << 20, queue_depth=8,
                                    buffer_pool_bytes=n_buffers << 20,
                                    n_rings=1))


@pytest.fixture()
def engine():
    """16 staging buffers: a stream of depth <= 5 copies in place."""
    with _engine(16) as e:
        yield e


@pytest.fixture()
def small_engine():
    """4 staging buffers: a stream of depth >= 2 takes the overlap
    stage."""
    with _engine(4) as e:
        yield e


class _FakeTransfer:
    """Injectable transfer recording the slab bytes at launch; its
    copies complete only when synchronized."""

    def __init__(self):
        self.launched = []

    def __call__(self, host_view, dtype, shape):
        t = _FakeCopy(host_view)
        self.launched.append(t)
        return t


class _FakeCopy:
    def __init__(self, host_view):
        self._src = host_view
        self.snapshot = host_view.copy()
        self.tensor = torch.from_numpy(self.snapshot)
        self.ready = False
        self.waited = 0

    def synchronize(self):
        # the first wait is the completion moment: the slab must still
        # hold the launch-time bytes now
        if not self.ready:
            assert np.array_equal(self._src, self.snapshot), \
                "slab overwritten before its transfer completed"
            self.ready = True
        self.waited += 1

    def is_ready(self):
        return self.ready


def test_overlap_slab_rotation(small_engine, tmp_data_file):
    """Slab k's reuse waits on the copy it sourced; every chunk's bytes
    equal the file's."""
    engine = small_engine
    path, payload = tmp_data_file
    fake = _FakeTransfer()
    ds = DeviceStream(engine, device="cpu", depth=3,
                      overlap_transfer=fake)
    assert ds.overlap
    fh = engine.open(path)
    try:
        out = list(ds.stream_ranges(fh, [(i << 20, 1 << 20)
                                         for i in range(6)]))
    finally:
        engine.close(fh)
    assert len(out) == 6
    for i, t in enumerate(out):
        assert t.numpy().tobytes() == payload[i << 20:(i + 1) << 20]
    assert all(t.waited >= 1 for t in fake.launched)
    assert engine.stats.overlap_chunks == 6
    assert engine.stats.overlap_bytes == 6 << 20


def test_overlap_odd_tail_chunk(small_engine, tmp_data_file):
    engine = small_engine
    path, payload = tmp_data_file
    ds = DeviceStream(engine, device="cpu", depth=2,
                      overlap_transfer=_FakeTransfer())
    fh = engine.open(path)
    try:
        out = list(ds.stream_ranges(fh, [(0, 1 << 20),
                                         (1 << 20, 12_345)]))
    finally:
        engine.close(fh)
    assert out[1].numel() == 12_345
    assert out[1].numpy().tobytes() == payload[1 << 20:(1 << 20) + 12_345]


@pytest.mark.parametrize("fail_at", [0, 2])
def test_failed_transfer_aborts_and_returns_staging(small_engine,
                                                    tmp_data_file, fail_at):
    """A transfer that raises aborts the stream, and every staging buffer
    goes back to the pool: the failed chunk's, the reads still pending
    and the copies still in flight."""
    engine = small_engine
    path, _ = tmp_data_file
    launched = []

    def transfer(host_view, dtype, shape):
        if len(launched) == fail_at:
            raise ValueError("synthetic transfer failure")
        t = _FakeCopy(host_view)
        launched.append(t)
        return t

    ds = DeviceStream(engine, device="cpu", depth=2,
                      overlap_transfer=transfer)
    fh = engine.open(path)
    try:
        with pytest.raises(ValueError, match="synthetic transfer failure"):
            list(ds.stream_ranges(fh, [(i << 20, 1 << 20)
                                       for i in range(4)]))
    finally:
        engine.close(fh)
    assert len(launched) == fail_at
    assert all(t.waited >= 1 for t in launched)
    info = engine.pool_info()
    assert info["free_buffers"] == info["n_buffers"]


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("overlap", [False, True])
def test_stream_paths_bytes(tmp_data_file, overlap, depth):
    """stream_file, stream_ranges (shapes, dtype) and read_to_device give
    the file's bytes on every path; the staging pool's size picks the
    path."""
    path, payload = tmp_data_file
    with _engine(3 * depth - 1 if overlap else 3 * depth) as engine:
        ds = DeviceStream(engine, device="cpu", depth=depth)
        assert ds.overlap == overlap
        assert b"".join(c.numpy().tobytes()
                        for c in ds.stream_file(path)) == payload
        fh = engine.open(path)
        try:
            ranges = [(0, 1000), (500000, 2048), (7, 4096), (1 << 20, 128)]
            outs = list(ds.stream_ranges(fh, ranges))
            typed = list(ds.stream_ranges(fh, [(8, 2048), (1 << 20, 128)],
                                          dtype=torch.int32,
                                          shapes=[(2, 256), (32,)]))
        finally:
            engine.close(fh)
        whole = ds.read_to_device(path, dtype=torch.int64)
        overlap_chunks = engine.stats.overlap_chunks
    for (off, ln), out in zip(ranges, outs):
        assert out.numpy().tobytes() == payload[off:off + ln]
    assert typed[0].shape == (2, 256) and typed[0].dtype == torch.int32
    assert typed[0].numpy().tobytes() == payload[8:8 + 2048]
    assert typed[1].numpy().tobytes() == payload[1 << 20:(1 << 20) + 128]
    assert whole.numpy().tobytes() == payload
    assert (overlap_chunks > 0) == overlap


def test_retire_pool_order_and_depth():
    released = []

    class Done:
        def is_ready(self):
            return False

        def synchronize(self):
            pass

    pool = StagingRetirePool(depth=2)
    for i in range(4):
        pool.push(lambda i=i: released.append(i), [Done()])
    assert released == [0, 1]          # at most 2 outstanding
    pool.flush()
    assert released == [0, 1, 2, 3]
    pool.flush()
    assert released == [0, 1, 2, 3]
    pool.push(None, [Done()])
    pool.flush()
    assert released == [0, 1, 2, 3]

    class Ready(Done):
        def is_ready(self):
            return True

    pool = StagingRetirePool(depth=3)
    pool.push(lambda: released.append("a"), [Ready()])
    assert released[-1] == "a"          # completed heads retire at once


def test_host_to_device_cpu_accounting(engine):
    data = np.arange(1000, dtype=np.uint8)
    t = host_to_device(engine, data, torch.device("cpu"))
    assert t.is_ready()
    data[0] = 99                        # no alias of the source
    assert t.tensor[0].item() == 0
    assert engine.stats.bounce_bytes == 1000
    assert engine.stats.bytes_to_device == 1000


def test_h2d_copy_cpu_and_checks():
    """On a CPU destination the wrapper runs its plain version and
    launches nothing; bad destinations raise."""
    src = np.random.default_rng(0).integers(0, 256, 4099, dtype=np.uint8)
    dst = torch.empty(4099, dtype=torch.uint8)
    before = h2d_copy.launches
    h2d_copy(src, dst)
    assert dst.numpy().tobytes() == src.tobytes()
    assert h2d_copy.launches == before
    ref = torch.empty(4099, dtype=torch.uint8)
    assert torch.equal(h2d_copy_plain(src, ref), dst)
    with pytest.raises(ValueError, match="bytes"):
        h2d_copy(src, torch.empty(10, dtype=torch.uint8))
    with pytest.raises(ValueError, match="uint8"):
        h2d_copy(src, torch.empty(4099, dtype=torch.int16))
    with pytest.raises(ValueError, match="unsupported device"):
        h2d_copy(src, torch.empty(4099, dtype=torch.uint8, device="meta"))
