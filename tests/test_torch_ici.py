"""The port's read-once scatter restore (ops/ici.py, io/scatter.py,
checkpoint/scatter.py, parallel/mesh.py) on the CPU, case by case
against tests/test_ici.py and the JAX package on its 8-device CPU mesh.

The port's group is ``["cpu"] * 8``: every rank's buffers on the CPU, the
ring's plain version doing the pushes.  The JAX side runs as its own
tests run it, through ``lax.all_gather``.  Everything compared is bytes:
no tolerance.
"""

import numpy as np
import pytest
import torch

from nvme_strom_tpu.io.scatter import partition_files as jax_partition
from nvme_strom_tpu.ops.ici import IciExchange as JaxExchange
from nvme_strom_tpu.parallel.mesh import exchange_mesh
from nvme_strom_tpu.parallel.mesh import local_batch_slice as jax_slice
from nvme_strom_tpu_torch.checkpoint.scatter import build_restore_manifest
from nvme_strom_tpu_torch.io.engine import StromEngine, wait_exact
from nvme_strom_tpu_torch.io.scatter import partition_files
from nvme_strom_tpu_torch.ops import ici as ici_mod
from nvme_strom_tpu_torch.ops.ici import (IciExchange, ici_ring_gather,
                                          ici_ring_gather_plain, ring_chunks,
                                          scatter_engine)
from nvme_strom_tpu_torch.parallel.mesh import (exchange_group,
                                                local_batch_slice)
from nvme_strom_tpu_torch.utils.config import EngineConfig

UNIT = 1 << 16          # small partition unit so 8 hosts all get shares
N = 8
SIZES = [1_000_000, 3_000, UNIT, 1, 5 * UNIT + 17]


@pytest.fixture()
def engine():
    cfg = EngineConfig(chunk_bytes=1 << 20, queue_depth=8,
                       buffer_pool_bytes=8 << 20)
    with StromEngine(cfg) as e:
        yield e


@pytest.fixture()
def group():
    return exchange_group(devices=["cpu"] * N)


def _write_files(tmp_path, sizes, seed=0):
    rng = np.random.default_rng(seed)
    paths, datas = [], []
    for i, sz in enumerate(sizes):
        p = tmp_path / f"w{i}.safetensors"
        data = rng.integers(0, 256, size=sz, dtype=np.uint8)
        p.write_bytes(data.tobytes())
        paths.append(str(p))
        datas.append(data)
    return paths, datas


# -- partitioning ------------------------------------------------------------


def test_partition_covers_every_byte_exactly_once_as_jax_does():
    man = partition_files(SIZES, N, UNIT)
    ref = jax_partition(SIZES, N, UNIT)
    assert (man.units, man.host_bytes, man.sizes) == \
        (ref.units, ref.host_bytes, ref.sizes)
    assert man.total_bytes == sum(SIZES) == sum(man.host_bytes)
    cover = [np.zeros(sz, np.int32) for sz in SIZES]
    for h in range(N):
        for fi, off, ln in man.units_for(h):
            assert ln > 0 and off % UNIT == 0 and off + ln <= SIZES[fi]
            cover[fi][off:off + ln] += 1
    assert all((c == 1).all() for c in cover)


def test_partition_balance_within_unit_slack():
    man = partition_files(SIZES, N, UNIT)
    assert max(man.host_bytes) <= sum(SIZES) / N + len(SIZES) * UNIT
    for h in range(N):
        assert sum(ln for _, _, ln in man.units_for(h)) == man.host_bytes[h]


# -- the exchange ------------------------------------------------------------


@pytest.mark.parametrize("row_bytes", [1, 4096, 12_345])
def test_exchange_roundtrip_unaligned_rows_matches_jax(group, row_bytes):
    rows = np.random.default_rng(row_bytes).integers(
        0, 256, size=(N, row_bytes), dtype=np.uint8)
    got = IciExchange(group).all_gather(rows)
    want = JaxExchange(exchange_mesh(N)).all_gather(rows)
    assert tuple(got.shape) == rows.shape
    assert got.numpy().tobytes() == np.asarray(want).tobytes() \
        == rows.tobytes()


@pytest.mark.parametrize("bad", [np.zeros((N - 1, 64), np.uint8),
                                 np.zeros((N, 64), np.int32),
                                 np.zeros(64, np.uint8)])
def test_exchange_rejects_bad_shape(group, bad):
    with pytest.raises(ValueError):
        IciExchange(group).all_gather(bad)
    with pytest.raises(ValueError):
        JaxExchange(exchange_mesh(N)).all_gather(
            np.zeros((N - 1, 64), np.uint8))


class _Recorder:
    """Stands in for one rank's output and logs each slot copy as
    (from rank, to rank, source slot, destination slot)."""

    def __init__(self, rank, log):
        self.rank, self.log = rank, log

    def __getitem__(self, slot):
        rec = self

        class _Slot:
            def copy_(self, other):
                rec.log.append((other.rank, rec.rank, other.slot, slot))

        s = _Slot()
        s.rank, s.slot = self.rank, slot
        return s


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_plain_ring_gathers_every_row_as_jax_does(n):
    """The plain ring follows the reference kernel's schedule (step k:
    rank r pushes slot (r + n - k) mod n into rank r+1's same slot) and
    lands every row where JAX's all-gather does."""
    log: list = []
    ici_ring_gather_plain([_Recorder(r, log) for r in range(n)])
    assert log == [(r, (r + 1) % n, (r + n - k) % n, (r + n - k) % n)
                   for k in range(n - 1) for r in range(n)]
    width = 48
    rows = np.random.default_rng(n).integers(0, 256, (n, width),
                                             dtype=np.uint8)
    slots = [torch.zeros(n, width, dtype=torch.uint8) for _ in range(n)]
    for r in range(n):
        slots[r][r] = torch.from_numpy(rows[r])
    ici_ring_gather_plain(slots)
    want = np.asarray(JaxExchange(exchange_mesh(n)).all_gather(rows))
    for s in slots:
        assert s.numpy().tobytes() == want.tobytes()
    # the wrapper takes the plain version for CPU tensors only
    group = exchange_group(devices=["cpu"] * n)
    again = [torch.zeros(n, width, dtype=torch.uint8) for _ in range(n)]
    for r in range(n):
        again[r][r] = torch.from_numpy(rows[r])
    ici_ring_gather(again, group)
    assert all(torch.equal(a, slots[0]) for a in again)
    assert ici_ring_gather.launches == 0


#: the ring kernel's chunk (csrc/ici_ring.cu kChunk)
CHUNK = 48 << 10


def ring_plan(n: int, width: int, blocks: int, base: int = 0):
    """Kernel 7's schedule over one call, as csrc/ici_ring.cu runs it:
    ``(C, owned, waits)``.  ``owned[b]`` lists the slot chunks block b
    owns, b, b + blocks, ... (None for one past the slot's end, which
    the block signals without moving); the block takes each through
    steps 0..n-2 before the next, so chunk j of step k is its move
    i = j·(n-1) + k, and each move releases the right neighbour's flag
    once.  ``waits[b]`` lists the flag values it waits for, in order:
    before move i at a step k >= 1, base + i (its left neighbour's block
    b has made move i - 1, landing chunk j of step k - 1), then
    base + (n-1)·C, when every move of the left block has landed."""
    C = ring_chunks(width, blocks, CHUNK)
    chunks = -(-width // CHUNK)
    owned = [[c if c < chunks else None
              for c in range(b, b + C * blocks, blocks)]
             for b in range(blocks)]
    waits = [[(base + j * (n - 1) + k) & 0xFFFFFFFF
              for j, c in enumerate(own) if c is not None
              for k in range(1, n - 1)]
             + [(base + (n - 1) * C) & 0xFFFFFFFF]
             for own in owned]
    return C, owned, waits


@pytest.mark.parametrize("n,width,blocks,base", [
    (4, 137_363_456, 165, 0),           # the restore's slots
    (2, 4096, 528, 7),                   # one chunk, most blocks empty
    (3, 3 * CHUNK + 16, 2, 2 ** 32 - 5),   # base wraps
    (8, 5 * CHUNK, 5, 100),   # one round of the blocks
])
def test_ring_plan_owns_each_chunk_once_and_waits_grow(n, width, blocks,
                                                       base):
    """Kernel 7's schedule: every chunk of a slot has exactly one owner
    block, block b owning chunks b, b + B, ...; each block waits for
    strictly growing flag values (modulo 2**32, from base), the last
    being base + (n-1)·C, what one call adds to every flag."""
    C, owned, waits = ring_plan(n, width, blocks, base)
    chunks = -(-width // CHUNK)
    assert sorted(c for own in owned for c in own if c is not None) == \
        list(range(chunks))
    for b, (own, w) in enumerate(zip(owned, waits)):
        assert len(own) == C and None not in own[:-1]
        assert all(c is None or (c % blocks, c // blocks) == (b, j)
                   for j, c in enumerate(own))
        # a wait for each owned chunk of steps 1..n-2, then the last
        assert len(w) == (n - 2) * (C - own.count(None)) + 1
        rel = [(t - base) % 2 ** 32 for t in w]
        assert all(x < y for x, y in zip(rel, rel[1:]))
        assert w[-1] == (base + (n - 1) * C) % 2 ** 32


def test_ring_rejects_what_it_does_not_take(group):
    ok = [torch.zeros(N, 32, dtype=torch.uint8) for _ in range(N)]
    with pytest.raises(ValueError, match="group of"):
        ici_ring_gather(ok[:-1], group)
    with pytest.raises(ValueError, match="multiple of 16"):
        ici_ring_gather([torch.zeros(N, 24, dtype=torch.uint8)] * N, group)
    with pytest.raises(ValueError, match="uint8"):
        ici_ring_gather([t.int() for t in ok], group)


def test_exchange_group_and_local_batch_slice():
    g = exchange_group(3, devices=["cpu"] * 5)
    assert g.n == 3 and not g.is_cuda
    with pytest.raises(ValueError):
        exchange_group(6, devices=["cpu"] * 5)
    with pytest.raises(ValueError):
        exchange_group(devices=["cpu", "meta"])
    for pi in range(4):
        assert local_batch_slice(32, pi, 4) == jax_slice(32, pi, 4)
    assert local_batch_slice(32) == slice(0, 32)
    with pytest.raises(ValueError):
        local_batch_slice(30, 0, 4)


# -- scatter_engine: read-once + bit-identical serving -----------------------


def test_scatter_serves_bit_identical_and_reads_one_nth(tmp_path, engine,
                                                        group):
    sizes = [1_000_000, 3_000, 7 * UNIT + 123]
    paths, datas = _write_files(tmp_path, sizes)
    served = scatter_engine(engine, paths, group=group, unit_bytes=UNIT)
    assert served is not None
    store = served.scatter_store
    total = sum(sizes)
    assert store.manifest == partition_files(sizes, N, UNIT)
    assert sum(store.host_bytes_read.values()) == total
    for got in store.host_bytes_read.values():
        assert got <= total / N + len(sizes) * UNIT
    st = engine.stats
    assert (st.ici_bytes_read, st.ici_bytes_received, st.ici_fallbacks) \
        == (total, 0, 0)
    # the share rows' host packing is a copy, counted
    assert st.bounce_bytes == total
    for fi, (off, ln) in [(0, (0, sizes[0])), (0, (UNIT - 9, 3 * UNIT)),
                          (1, (17, 2_000)), (2, (6 * UNIT, UNIT + 123))]:
        fh = served.open(paths[fi])
        pend = served.submit_read(fh, off, ln)
        assert np.array_equal(pend.wait(10.0), datas[fi][off:off + ln])
        pend.release()
        served.close(fh)


def test_scatter_readv_mixes_store_hits_and_misses(tmp_path, engine, group):
    paths, datas = _write_files(tmp_path, [3 * UNIT, 2 * UNIT + 77])
    other = tmp_path / "outside.bin"
    other.write_bytes(bytes(range(256)) * 64)
    served = scatter_engine(engine, paths, group=group, unit_bytes=UNIT)
    fh0 = served.open(paths[0])
    fho = served.open(str(other))           # NOT in the scattered set
    reads = [(fh0, 0, 1000), (fho, 256, 512), (fh0, UNIT - 5, 100)]
    pends = served.submit_readv(reads)
    want = [datas[0][0:1000].tobytes(), other.read_bytes()[256:768],
            datas[0][UNIT - 5:UNIT + 95].tobytes()]
    for p, w in zip(pends, want):
        assert np.asarray(wait_exact(p)).tobytes() == w
        p.release()
    served.close(fh0)
    served.close(fho)


def test_serve_engine_close_all_clears_handle_tracking(tmp_path, group):
    paths, _ = _write_files(tmp_path, [2 * UNIT])
    eng = StromEngine(EngineConfig(chunk_bytes=1 << 20,
                                   buffer_pool_bytes=8 << 20))
    served = scatter_engine(eng, paths, group=group, unit_bytes=UNIT)
    served.open(paths[0])
    assert served._paths
    served.close_all()
    assert served._paths == {}


def test_scatter_store_view_outside_files_is_none(tmp_path, engine, group):
    paths, datas = _write_files(tmp_path, [2 * UNIT])
    store = scatter_engine(engine, paths, group=group,
                           unit_bytes=UNIT).scatter_store
    assert store.view(paths[0], 0, 2 * UNIT + 1) is None   # past EOF
    assert store.view(str(tmp_path / "nope"), 0, 10) is None
    assert np.array_equal(store.view(paths[0], 5, 100), datas[0][5:105])


# -- brown-outs: every failure keeps the caller on read-all ------------------


class _FailingReads:
    """An engine whose reads fail (a device that went bad)."""

    def __init__(self, inner):
        self._inner = inner

    def submit_readv(self, reads):
        raise OSError(5, "device gone")

    def __getattr__(self, name):
        return getattr(self._inner, name)


@pytest.mark.parametrize("case", ["one_rank", "failing_engine"])
def test_scatter_declines(tmp_path, engine, case):
    paths, _ = _write_files(tmp_path, [2 * UNIT])
    if case == "one_rank":
        eng, group = engine, exchange_group(devices=["cpu"])
    else:
        eng, group = _FailingReads(engine), exchange_group(
            devices=["cpu"] * N)
    assert scatter_engine(eng, paths, group=group, unit_bytes=UNIT) is None
    assert engine.stats.ici_fallbacks == 1
    assert engine.stats.ici_bytes_read == 0


def test_scatter_rejects_corrupted_exchange(tmp_path, engine, group,
                                            monkeypatch):
    paths, _ = _write_files(tmp_path, [2 * UNIT])
    real = ici_mod.IciExchange.all_gather

    def corrupt(self, rows):
        got = real(self, rows).clone()
        got[0, 0] ^= 1
        return got

    monkeypatch.setattr(ici_mod.IciExchange, "all_gather", corrupt)
    assert scatter_engine(engine, paths, group=group,
                          unit_bytes=UNIT) is None
    assert engine.stats.ici_fallbacks == 1


def test_scatter_falls_back_on_exchange_failure(tmp_path, engine, group,
                                                monkeypatch):
    paths, _ = _write_files(tmp_path, [2 * UNIT])

    def boom(self, rows):
        raise RuntimeError("link down")

    monkeypatch.setattr(ici_mod.IciExchange, "all_gather", boom)
    assert scatter_engine(engine, paths, group=group,
                          unit_bytes=UNIT) is None
    assert engine.stats.ici_fallbacks == 1


def test_restore_manifest_matches_jax(tmp_path):
    from nvme_strom_tpu.checkpoint import build_restore_manifest as jax_build
    _write_files(tmp_path, [3 * UNIT + 5, UNIT])
    (tmp_path / "meta.json").write_text("{}")
    man = build_restore_manifest(str(tmp_path), N, UNIT)
    ref = jax_build(str(tmp_path), N, UNIT)
    assert man.paths == ref.paths and len(man.paths) == 2
    assert man.shares.units == ref.shares.units
    assert man.host_bytes == ref.host_bytes
    assert man.total_bytes == ref.total_bytes == 4 * UNIT + 5
