"""The port's WebDataset loader (data/loader.py, data/sharding.py,
formats/wds.py, data/prefetch.py) against the JAX package's: the same
shards give the same batches, in the same order, as the JAX
``ShardedLoader`` on a one-device CPU mesh, with and without
``shuffle_buffer``, epoch after epoch."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from nvme_strom_tpu.data import ShardedLoader as JaxLoader
from nvme_strom_tpu.data import sharding as jsharding
from nvme_strom_tpu.formats.wds import WdsShardIndex as JaxIndex
from nvme_strom_tpu.utils.config import LoaderConfig as JaxLoaderConfig
from nvme_strom_tpu_torch.data import sharding as tsharding
from nvme_strom_tpu_torch.data.loader import ShardReadError, ShardedLoader
from nvme_strom_tpu_torch.data.prefetch import prefetch_to_device
from nvme_strom_tpu_torch.formats.wds import WdsShardIndex, write_wds_shard
from nvme_strom_tpu_torch.io.engine import StromEngine
from nvme_strom_tpu_torch.utils.config import EngineConfig, LoaderConfig


def _shards(tmp_path, n_shards=3, per_shard=10, seq=24):
    """Token samples (int32) plus a label part, seeded."""
    rng = np.random.default_rng(0)
    paths = []
    for s in range(n_shards):
        samples = [{"bin": rng.integers(0, 1000, seq,
                                        dtype=np.int32).tobytes(),
                    "cls": bytes([s, i])} for i in range(per_shard)]
        p = tmp_path / f"shard-{s:03d}.tar"
        write_wds_shard(p, samples)
        paths.append(str(p))
    return paths


def _decode(parts):
    return {"tokens": np.frombuffer(parts["bin"], np.int32),
            "cls": np.frombuffer(parts["cls"], np.uint8)}


@pytest.fixture()
def engine():
    with StromEngine(EngineConfig(chunk_bytes=1 << 20,
                                  buffer_pool_bytes=8 << 20)) as eng:
        yield eng


def test_sharding_helpers_match_jax():
    paths = [f"s{i:03d}.tar" for i in range(10)]
    for pi in range(3):
        assert tsharding.assign_shards(paths, pi, 3) == \
            jsharding.assign_shards(paths, pi, 3)
    with pytest.raises(ValueError):
        tsharding.assign_shards(["one.tar"], 0, 2)
    for seed, epoch in ((7, 0), (7, 3), (1, 2)):
        np.testing.assert_array_equal(
            tsharding.shuffled_indices(50, seed, epoch),
            jsharding.shuffled_indices(50, seed, epoch))


def test_index_matches_jax(tmp_path):
    (path,) = _shards(tmp_path, n_shards=1)
    mine, theirs = WdsShardIndex(path), JaxIndex(path)
    assert mine.order == theirs.order
    assert mine.samples == theirs.samples
    assert [(e.key, e.offset, e.length)
            for e in mine.plan(exts=["bin"]).entries] == \
        [(e.key, e.offset, e.length)
         for e in theirs.plan(exts=["bin"]).entries]


@pytest.mark.parametrize("shuffle", [0, 64])
def test_batches_match_jax_loader(tmp_path, engine, shuffle):
    paths = _shards(tmp_path)
    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    jcfg = JaxLoaderConfig(batch_size=4, shuffle_buffer=shuffle, seed=3)
    tcfg = LoaderConfig(shuffle_buffer=shuffle, seed=3)
    with JaxLoader(paths, mesh, 4, fmt="wds", decode=_decode,
                   config=jcfg) as jl, \
            ShardedLoader(paths, 4, decode=_decode, engine=engine,
                          config=tcfg, device="cpu") as tl:
        for _epoch in range(2):
            want = [{k: np.asarray(v) for k, v in b.items()} for b in jl]
            got = list(tl)
            assert len(got) == len(want) == 7      # 30 samples, drop 2
            for g, w in zip(got, want):
                assert g["tokens"].dtype == torch.int32
                np.testing.assert_array_equal(g["tokens"].numpy(),
                                              w["tokens"])
                np.testing.assert_array_equal(g["cls"].numpy(), w["cls"])
    if shuffle:
        # the order is the seed's, not the archive's
        assert [int(c) for c in got[0]["cls"][:, 1]] != [0, 1, 2, 3]


def test_default_decode_and_prefetch(tmp_path, engine):
    paths = _shards(tmp_path, n_shards=1)
    with ShardedLoader(paths, 2, exts=["bin"], engine=engine,
                       device="cpu") as tl:
        batches = list(prefetch_to_device(iter(tl), size=2))
    assert len(batches) == 5
    assert batches[0].dtype == torch.uint8 and batches[0].shape == (2, 96)
    host = [np.arange(6, dtype=np.int32).reshape(2, 3)]
    (moved,) = prefetch_to_device(host, size=3, device="cpu")
    assert moved.dtype == torch.int32 and moved.tolist() == host[0].tolist()
    with pytest.raises(ValueError):
        prefetch_to_device(host, size=0)


def test_abandoned_iterator_stops_the_producer(tmp_path, engine):
    paths = _shards(tmp_path)
    with ShardedLoader(paths, 2, decode=_decode, engine=engine,
                       device="cpu") as tl:
        it = iter(tl)
        next(it)
        it.close()
        assert len(list(tl)) == 15        # the next epoch runs whole


def test_loader_validation(tmp_path, engine):
    paths = _shards(tmp_path, n_shards=1)
    with pytest.raises(NotImplementedError, match="wds"):
        ShardedLoader(paths, 4, fmt="tfrecord", engine=engine,
                      device="cpu")
    with ShardedLoader(paths, 4, engine=engine, device="cpu") as tl:
        # two parts, no decode=: the shard fails, and with no error
        # budget the epoch raises naming it, the ValueError its cause
        with pytest.raises(ShardReadError, match="decode") as ei:
            list(tl)
        assert isinstance(ei.value.__cause__, ValueError)
