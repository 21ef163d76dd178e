"""The port's pinned arena (nvme_strom_tpu_torch/io/arena.py) held
against the JAX package's: tests/test_arena.py's seven cases, each run
through both packages, and the allocator's carve offsets and free list
over a seeded carve/release sequence compared exactly."""

import numpy as np
import pytest

from nvme_strom_tpu.io import arena as jax_arena
from nvme_strom_tpu.io import hostcache as jax_hostcache
from nvme_strom_tpu.io.engine import StromEngine as JaxEngine
from nvme_strom_tpu.utils.config import EngineConfig as JaxEngineConfig
from nvme_strom_tpu.utils.config import HostCacheConfig as JaxHCConfig
from nvme_strom_tpu.utils.stats import StromStats as JaxStats
from nvme_strom_tpu_torch.io import arena as port_arena
from nvme_strom_tpu_torch.io import hostcache as port_hostcache
from nvme_strom_tpu_torch.io.engine import StromEngine
from nvme_strom_tpu_torch.utils.config import EngineConfig, HostCacheConfig
from nvme_strom_tpu_torch.utils.stats import StromStats

ARENA = {"jax": jax_arena, "port": port_arena}
ENGINE = {"jax": (JaxEngine, JaxEngineConfig, JaxStats),
          "port": (StromEngine, EngineConfig, StromStats)}
TIER = {"jax": (jax_hostcache, JaxHCConfig),
        "port": (port_hostcache, HostCacheConfig)}


@pytest.fixture()
def fresh_arena_env(monkeypatch):
    """Both packages' arenas re-read the environment around each test."""
    for mod in ARENA.values():
        mod.reset()
    yield monkeypatch
    for mod in ARENA.values():
        mod.reset()


@pytest.mark.parametrize("pkg", list(ARENA))
def test_carves_are_disjoint_and_sum_to_arena(pkg):
    a = ARENA[pkg].PinnedArena(1 << 20, lock_pages=False)
    slabs = [a.carve(100_000, t) for t in ("staging", "hostcache",
                                           "bridge", "bridge")]
    assert all(s is not None for s in slabs)
    ranges = sorted((s.offset, s.offset + s.nbytes) for s in slabs)
    for (_lo1, hi1), (lo2, _hi2) in zip(ranges, ranges[1:]):
        assert hi1 <= lo2
    carves = a.carves()
    assert carves["staging"] == slabs[0].nbytes
    assert carves["hostcache"] == slabs[1].nbytes
    assert carves["bridge"] == slabs[2].nbytes + slabs[3].nbytes
    assert a.bytes_carved + a.bytes_free == a.nbytes
    for s in slabs:
        assert s.offset % ARENA[pkg].CARVE_ALIGN == 0
        assert s.addr % ARENA[pkg].CARVE_ALIGN == 0
    a.close()


@pytest.mark.parametrize("pkg", list(ARENA))
def test_release_coalesces_and_recycles(pkg):
    a = ARENA[pkg].PinnedArena(256 << 10, lock_pages=False)
    s1 = a.carve(64 << 10, "x")
    s2 = a.carve(64 << 10, "x")
    s3 = a.carve(64 << 10, "x")
    assert a.carve(256 << 10, "big") is None
    s2.release()
    s1.release()
    s3.release()
    assert a.bytes_carved == 0
    big = a.carve(256 << 10, "big")
    assert big is not None and big.nbytes == 256 << 10
    big.release()
    a.close()


@pytest.mark.parametrize("pkg", list(ARENA))
def test_slab_release_is_idempotent_and_views_are_zero_copy(pkg):
    a = ARENA[pkg].PinnedArena(128 << 10, lock_pages=False)
    s = a.carve(4096, "x")
    s.view[:] = 7
    assert a.view[s.offset] == 7
    s.release()
    s.release()
    assert a.bytes_carved == 0
    a.close()


@pytest.mark.parametrize("pkg", list(ARENA))
def test_env_off_switch_disables_singleton(fresh_arena_env, pkg):
    fresh_arena_env.setenv("STROM_ARENA", "0")
    assert ARENA[pkg].get_arena() is None
    assert ARENA[pkg].carve_or_none(4096, "x") is None


def test_allocator_state_equals_jax():
    """A seeded sequence of carves and releases of mixed sizes leaves
    the same offsets, tags and free list in both allocators."""
    rng = np.random.default_rng(3)
    arenas = {k: m.PinnedArena(1 << 20, lock_pages=False)
              for k, m in ARENA.items()}
    live = {k: [] for k in arenas}
    logs = {k: [] for k in arenas}
    for step in range(200):
        if live["port"] and rng.random() < 0.45:
            i = int(rng.integers(len(live["port"])))
            for k in arenas:
                live[k].pop(i).release()
        else:
            n = int(rng.integers(1, 300_000))
            tag = ("staging", "hostcache", "bridge")[step % 3]
            for k, a in arenas.items():
                s = a.carve(n, tag)
                logs[k].append(None if s is None else (s.offset, s.nbytes))
                if s is not None:
                    live[k].append(s)
        for k, a in arenas.items():
            logs[k].append((a.carves(), a.bytes_free,
                            list(a._free_list)))
    assert logs["port"] == logs["jax"]
    assert any(e is None for e in logs["port"])   # exhaustion was hit
    for k, a in arenas.items():
        for s in live[k]:
            s.release()
        a.close()


@pytest.mark.parametrize("pkg", list(ENGINE))
def test_engine_pool_carves_from_arena(fresh_arena_env, tmp_data_file, pkg):
    """The staging pool is an arena carve (tag ``staging``), reads are
    the file's bytes, and the carve recycles at ``close_all``."""
    engine_cls, cfg_cls, stats_cls = ENGINE[pkg]
    fresh_arena_env.setenv("STROM_ARENA_MB", "64")
    path, payload = tmp_data_file
    cfg = cfg_cls(chunk_bytes=1 << 20, queue_depth=4,
                  buffer_pool_bytes=4 << 20)
    arena_mod = ARENA[pkg]
    with engine_cls(cfg, stats=stats_cls()) as e:
        assert e._pool_slab is not None
        assert arena_mod.get_arena().carves().get("staging", 0) \
            == e._pool_slab.nbytes
        fh = e.open(path)
        p = e.submit_read(fh, 12345, 100_000)
        assert p.wait().tobytes() == payload[12345:12345 + 100_000]
        p.release()
        e.close(fh)
    assert arena_mod.get_arena().carves().get("staging", 0) == 0


def test_engine_pool_carves_equal_jax(fresh_arena_env):
    """The same geometry carves the same staging bytes in both."""
    fresh_arena_env.setenv("STROM_ARENA_MB", "64")
    kw = dict(chunk_bytes=1 << 20, queue_depth=8,
              buffer_pool_bytes=16 << 20, n_rings=2)
    with StromEngine(EngineConfig(**kw), stats=StromStats()) as e, \
            JaxEngine(JaxEngineConfig(**kw), stats=JaxStats()) as je:
        assert e._pool_slab.nbytes == je._pool_slab.nbytes
        assert e.pool_info()["pool_base"] == e._pool_slab.addr


@pytest.mark.parametrize("pkg", list(ENGINE))
def test_engine_falls_back_when_arena_exhausted(fresh_arena_env,
                                                tmp_data_file, pkg):
    engine_cls, cfg_cls, stats_cls = ENGINE[pkg]
    fresh_arena_env.setenv("STROM_ARENA_MB", "1")
    path, payload = tmp_data_file
    stats = stats_cls()
    cfg = cfg_cls(chunk_bytes=1 << 20, queue_depth=4,
                  buffer_pool_bytes=8 << 20)
    with engine_cls(cfg, stats=stats) as e:
        assert e._pool_slab is None
        assert stats.arena_fallbacks >= 1
        fh = e.open(path)
        p = e.submit_read(fh, 0, 4096)
        assert p.wait().tobytes() == payload[:4096]
        p.release()
        e.close(fh)


@pytest.mark.parametrize("pkg", list(TIER))
def test_hostcache_arena_rides_the_process_arena(fresh_arena_env, pkg):
    hostcache, hc_cfg = TIER[pkg]
    fresh_arena_env.setenv("STROM_ARENA_MB", "32")
    hostcache.reset()
    try:
        cache = hostcache.configure(hc_cfg(budget_mb=2, line_bytes=1 << 20))
        assert cache is not None
        assert ARENA[pkg].get_arena().carves().get("hostcache", 0) \
            == cache.arena.nbytes
        fkey = (1, 2, 3, 4)
        payload = np.arange(cache.line_bytes, dtype=np.uint8) % 251
        assert cache.fill(fkey, 0, payload, "decode")
        line = cache._lines[(fkey, 0)]
        got = cache.line_view(line, 0, cache.line_bytes)
        assert np.array_equal(got, payload)
    finally:
        hostcache.reset()
    assert ARENA[pkg].get_arena().carves().get("hostcache", 0) == 0
