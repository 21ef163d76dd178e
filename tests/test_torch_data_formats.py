"""The port's data formats and data path against the JAX package on the
CPU: TFRecord and fixedrec files (formats/tfrecord.py, fixedrec.py;
the cases of tests/test_formats.py, each file written by one package
and read by the other), the loader's tfrecord, fixedrec and wds_raw
paths and ``drop_remainder`` (the cases of tests/test_loader.py on one
device, batches equal to the JAX loader's), ``MixtureLoader`` (the
cases of tests/test_mixture.py, its source sequence equal to the JAX
one's) and ``prefetch_to_device``'s order and close.  Batches and bytes
must be equal exactly."""

import io
import tarfile

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from nvme_strom_tpu.data import MixtureLoader as JaxMixture
from nvme_strom_tpu.data import ShardedLoader as JaxLoader
from nvme_strom_tpu.formats import fixedrec as jfix
from nvme_strom_tpu.formats import tfrecord as jtfr
from nvme_strom_tpu.utils.config import LoaderConfig as JaxLoaderConfig
from nvme_strom_tpu_torch.data.loader import ShardedLoader
from nvme_strom_tpu_torch.data.mixture import MixtureLoader
from nvme_strom_tpu_torch.data.prefetch import prefetch_to_device
from nvme_strom_tpu_torch.formats import fixedrec, tfrecord
from nvme_strom_tpu_torch.formats.wds import write_wds_shard
from nvme_strom_tpu_torch.io.engine import StromEngine
from nvme_strom_tpu_torch.utils.config import EngineConfig, LoaderConfig
from nvme_strom_tpu_torch.utils.stats import StromStats


@pytest.fixture(scope="module")
def mesh1():
    return Mesh(np.array(jax.devices()[:1]).reshape(1), ("dp",))


def _loader(paths, batch, **kw):
    return ShardedLoader(paths, batch, device="cpu", **kw)


def _jax_rows(paths, mesh, batch, **kw):
    with JaxLoader(paths, mesh, batch, **kw) as dl:
        return [jax.tree.map(np.asarray, b) for b in dl]


# -- tfrecord -----------------------------------------------------------------

def test_crc32c_known_vectors():
    assert tfrecord.crc32c(b"\x00" * 32) == 0x8A9136AA
    assert tfrecord.crc32c(b"123456789") == 0xE3069283
    assert tfrecord.masked_crc(b"abc") == jtfr.masked_crc(b"abc")


def test_tfrecord_files_cross_packages(tmp_path):
    """The port's file equals the JAX writer's byte for byte; each index
    reads the other's, payloads planned through the engine."""
    rng = np.random.default_rng(2)
    payloads = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
                for n in rng.integers(1, 5000, size=20)]
    tfrecord.write_tfrecords(tmp_path / "t.tfrecord", payloads)
    jtfr.write_tfrecords(tmp_path / "j.tfrecord", payloads)
    assert (tmp_path / "t.tfrecord").read_bytes() == \
        (tmp_path / "j.tfrecord").read_bytes()
    assert list(tfrecord.read_records(tmp_path / "j.tfrecord")) == payloads
    idx = tfrecord.TFRecordIndex(tmp_path / "j.tfrecord",
                                 verify_framing_crc=True)
    jidx = jtfr.TFRecordIndex(tmp_path / "t.tfrecord")
    assert (idx.offsets, idx.lengths) == (jidx.offsets, jidx.lengths)
    with StromEngine(EngineConfig(chunk_bytes=1 << 20,
                                  buffer_pool_bytes=8 << 20)) as eng:
        fh = eng.open(str(tmp_path / "j.tfrecord"))
        try:
            for e in idx.plan().entries:
                with eng.submit_read(fh, e.offset, e.length) as r:
                    assert r.wait().tobytes() == payloads[int(e.key)]
        finally:
            eng.close(fh)
    plan = tfrecord.TFRecordIndex(tmp_path / "t.tfrecord").plan([2, 0])
    assert [e.length for e in plan.entries] == [len(payloads[2]),
                                                len(payloads[0])]


def test_tfrecord_corrupt_crc_and_truncation(tmp_path):
    path = tmp_path / "bad.tfrecord"
    tfrecord.write_tfrecords(path, [b"hello world"])
    raw = bytearray(path.read_bytes())
    raw[14] ^= 0xFF
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="payload crc"):
        list(tfrecord.read_records(path))
    path.write_bytes(bytes(raw[:-6]))
    with pytest.raises(ValueError, match="truncated"):
        tfrecord.TFRecordIndex(path)


# -- fixedrec -----------------------------------------------------------------

def test_fixedrec_files_cross_packages(tmp_path):
    rec = np.arange(6 * 4 * 4, dtype=np.int16).reshape(6, 4, 4)
    assert fixedrec.write_fixedrec(tmp_path / "t.sfr", rec) == 6
    jfix.write_fixedrec(tmp_path / "j.sfr", rec)
    assert (tmp_path / "t.sfr").read_bytes() == \
        (tmp_path / "j.sfr").read_bytes()
    ix = fixedrec.FixedRecIndex(tmp_path / "j.sfr")
    assert (ix.count, ix.dtype, ix.shape) == (6, np.dtype(np.int16), (4, 4))
    assert ix.record_bytes == 32
    off, ln = ix.span(2, 3)
    with open(tmp_path / "j.sfr", "rb") as f:
        f.seek(off)
        got = np.frombuffer(f.read(ln), np.int16).reshape(3, 4, 4)
    np.testing.assert_array_equal(got, rec[2:5])
    fixedrec.write_fixedrec(tmp_path / "c.sfr", rec, checksums=True)
    jfix.write_fixedrec(tmp_path / "jc.sfr", rec, checksums=True)
    assert (tmp_path / "c.sfr.crc.json").read_text() == \
        (tmp_path / "jc.sfr.crc.json").read_text()


def test_fixedrec_bytes_records_and_errors(tmp_path):
    p = tmp_path / "b.sfr"
    fixedrec.write_fixedrec(p, [b"abcd", b"efgh"])
    ix = jfix.FixedRecIndex(p)
    assert ix.record_bytes == 4 and ix.dtype == np.uint8
    with pytest.raises(IndexError):
        fixedrec.FixedRecIndex(p).span(1, 2)
    with pytest.raises(ValueError, match="fixed size"):
        fixedrec.write_fixedrec(tmp_path / "c.sfr", [b"ab", b"abc"])
    (tmp_path / "d.sfr").write_bytes(b"not a fixedrec file....")
    with pytest.raises(ValueError, match="magic"):
        fixedrec.FixedRecIndex(tmp_path / "d.sfr")


# -- the loader ---------------------------------------------------------------

def _fixedrec_shards(tmp_path, n_shards, per_shard):
    rng = np.random.default_rng(0)
    paths, rows = [], []
    for s in range(n_shards):
        rec = rng.integers(0, 256, (per_shard, 8, 8), dtype=np.uint8)
        p = str(tmp_path / f"fr-{s:03d}.sfr")
        fixedrec.write_fixedrec(p, rec)
        paths.append(p)
        rows.extend(rec)
    return paths, rows


def _raw_wds_shards(tmp_path, n_shards=2, per_shard=8, mlen=4096):
    rng = np.random.default_rng(3)
    paths, rows = [], []
    for s in range(n_shards):
        samples = []
        for _ in range(per_shard):
            payload = rng.integers(0, 256, mlen, dtype=np.uint8)
            samples.append({"bin": payload.tobytes()})
            rows.append(payload)
        p = str(tmp_path / f"raw-{s:03d}.tar")
        write_wds_shard(p, samples)
        paths.append(p)
    return paths, rows


@pytest.mark.parametrize("shuffle", [0, 8])
def test_tfrecord_loader_matches_jax(tmp_path, mesh1, shuffle):
    paths = []
    for s in range(2):
        p = str(tmp_path / f"d{s}.tfrecord")
        tfrecord.write_tfrecords(p, [np.full(32, 12 * s + i, np.uint8)
                                     .tobytes() for i in range(12)])
        paths.append(p)
    want = _jax_rows(paths, mesh1, 8, fmt="tfrecord",
                     config=JaxLoaderConfig(batch_size=8,
                                            shuffle_buffer=shuffle))
    with _loader(paths, 8, fmt="tfrecord",
                 config=LoaderConfig(shuffle_buffer=shuffle)) as dl:
        got = [b.numpy() for b in dl]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_custom_decode_matches_jax(tmp_path, mesh1):
    p = str(tmp_path / "s.tar")
    write_wds_shard(p, [{"x": np.float32(i).tobytes(),
                         "y": np.int32(i * 2).tobytes()} for i in range(16)])

    def decode(parts):
        return {"x": np.frombuffer(parts["x"], dtype=np.float32),
                "y": np.frombuffer(parts["y"], dtype=np.int32)}

    want = _jax_rows([p], mesh1, 8, fmt="wds", decode=decode)
    with _loader([p], 8, fmt="wds", decode=decode) as dl:
        got = list(dl)
    assert set(got[0]) == {"x", "y"} and got[0]["x"].shape == (8, 1)
    for g, w in zip(got, want):
        for k in ("x", "y"):
            np.testing.assert_array_equal(g[k].numpy(), w[k])


def test_fixedrec_batches_match_jax_and_count_one_copy(tmp_path, mesh1,
                                                       monkeypatch):
    """Batches straight from staging views: equal to the JAX loader's,
    one piece a batch, and the CPU path's one counted copy a byte."""
    monkeypatch.setenv("STROM_NO_RESIDENCY_PROBE", "1")
    paths, rows = _fixedrec_shards(tmp_path, 2, 8)
    want = _jax_rows(paths, mesh1, 4, fmt="fixedrec")
    stats = StromStats()
    with StromEngine(EngineConfig(), stats=stats) as eng:
        with _loader(paths, 4, fmt="fixedrec", engine=eng) as dl:
            got = [b.numpy() for b in dl]
            assert dl.pieces_copied == 4
        eng.sync_stats()
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (4, 8, 8) and g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, np.stack(rows[4 * i:4 * i + 4]))
    assert stats.bytes_to_device == 16 * 64
    assert stats.bounce_bytes == 16 * 64


def test_drop_remainder_false_raises_where_jax_raises(tmp_path, mesh1):
    paths, rows = _fixedrec_shards(tmp_path, 1, 6)
    cfgs = (JaxLoaderConfig(batch_size=4, drop_remainder=False),
            LoaderConfig(drop_remainder=False))
    with JaxLoader(paths, mesh1, 4, fmt="fixedrec", config=cfgs[0]) as dl:
        with pytest.raises(ValueError, match="drop_remainder"):
            list(dl)
    with _loader(paths, 4, fmt="fixedrec", config=cfgs[1]) as dl:
        with pytest.raises(ValueError, match="drop_remainder"):
            list(dl)
    with _loader(paths, 4, fmt="fixedrec") as dl:
        (b,) = list(dl)
    np.testing.assert_array_equal(b.numpy(), np.stack(rows[:4]))
    # the per-sample path the same way
    p = str(tmp_path / "r.tfrecord")
    tfrecord.write_tfrecords(p, [bytes([i]) * 8 for i in range(6)])
    with JaxLoader([p], mesh1, 4, fmt="tfrecord", config=cfgs[0]) as dl:
        with pytest.raises(ValueError, match="drop_remainder"):
            list(dl)
    with _loader([p], 4, fmt="tfrecord", config=cfgs[1]) as dl:
        with pytest.raises(ValueError, match="drop_remainder"):
            list(dl)


def test_zero_copy_formats_refuse_decode_and_budget(tmp_path):
    paths, _ = _fixedrec_shards(tmp_path, 1, 4)
    for fmt in ("fixedrec", "wds_raw"):
        with pytest.raises(ValueError, match="zero-copy raw path"):
            ShardedLoader(paths, 2, fmt=fmt, decode=lambda p: p,
                          device="cpu")
        with pytest.raises(ValueError, match="shard_error_budget"):
            ShardedLoader(paths, 2, fmt=fmt, device="cpu",
                          config=LoaderConfig(shard_error_budget=1))
    with pytest.raises(ValueError, match="unknown fmt"):
        ShardedLoader(paths, 2, fmt="parquet", device="cpu")


def test_wds_raw_matches_standard_path_and_jax(tmp_path, mesh1):
    paths, rows = _raw_wds_shards(tmp_path)
    want = _jax_rows(paths, mesh1, 4, fmt="wds_raw")
    with _loader(paths, 4, fmt="wds_raw") as dl:
        got = [b.numpy() for b in dl]
        assert len(list(dl)) == 4        # a second epoch
    assert len(got) == 4
    np.testing.assert_array_equal(np.concatenate(got), np.stack(rows))
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))


def test_wds_raw_nonuniform_stride_falls_back(tmp_path, mesh1):
    """A GNU long-name member breaks the constant stride: the per-member
    reads give the same rows as the JAX loader."""
    rng = np.random.default_rng(7)
    rows = []
    p = str(tmp_path / "odd.tar")
    with tarfile.open(p, "w", format=tarfile.GNU_FORMAT) as tf:
        for i in range(8):
            payload = rng.integers(0, 256, 4096, dtype=np.uint8)
            rows.append(payload)
            ti = tarfile.TarInfo((("x" * 120) if i == 3 else f"{i:05d}")
                                 + ".bin")
            ti.size = 4096
            tf.addfile(ti, io.BytesIO(payload.tobytes()))
    with _loader([p], 4, fmt="wds_raw") as dl:
        got = [b.numpy() for b in dl]
        assert dl.pieces_copied == 8     # one read a member
    np.testing.assert_array_equal(np.concatenate(got), np.stack(rows))
    np.testing.assert_array_equal(
        np.concatenate(got),
        np.concatenate(_jax_rows([p], mesh1, 4, fmt="wds_raw")))


def test_wds_raw_many_tiny_shards(tmp_path):
    """A batch over 8 shards opens one strided group a shard; the pool
    fit counts them."""
    rng = np.random.default_rng(11)
    paths, rows = [], []
    for s in range(16):
        samples = []
        for _ in range(2):
            r = rng.integers(0, 256, 4096, dtype=np.uint8)
            samples.append({"bin": r.tobytes()})
            rows.append(r)
        sp = str(tmp_path / f"tiny-{s:03d}.tar")
        write_wds_shard(sp, samples)
        paths.append(sp)
    with _loader(paths, 16, fmt="wds_raw") as dl:
        got = [b.numpy() for b in dl]
        assert dl.pieces_copied == 16
    np.testing.assert_array_equal(np.concatenate(got), np.stack(rows))


def test_wds_index_cached_across_epochs(tmp_path, monkeypatch):
    import nvme_strom_tpu_torch.data.loader as loader_mod
    paths, _ = _raw_wds_shards(tmp_path, n_shards=2, per_shard=8, mlen=8192)
    built = []
    orig = loader_mod.WdsShardIndex

    class Counting(orig):
        def __init__(self, path):
            built.append(str(path))
            super().__init__(path)

    monkeypatch.setattr(loader_mod, "WdsShardIndex", Counting)
    with _loader(paths, 8, fmt="wds_raw") as dl:
        for _ in range(2):
            assert len(list(dl)) == 2
    assert sorted(built) == sorted(paths)


def test_wds_raw_bounce_accounting(tmp_path, monkeypatch):
    """No host-side payload copy: the CPU path's one copy a byte carries
    each member's strided span (header included).  The standard path
    counts the payload twice: its per-member host copy, then the host
    batch's copy to the device (a pinned bounce buffer on a card)."""
    monkeypatch.setenv("STROM_NO_RESIDENCY_PROBE", "1")
    paths, rows = _raw_wds_shards(tmp_path, n_shards=1, per_shard=8,
                                  mlen=8192)

    def run(fmt):
        stats = StromStats()
        with StromEngine(stats=stats) as eng:
            fh = eng.open(paths[0])
            direct = eng.file_is_direct(fh)
            eng.close(fh)
            with _loader(paths, 8, fmt=fmt, engine=eng) as dl:
                out = [b.numpy().reshape(8, -1) for b in dl]
            eng.sync_stats()
        return out, stats.bounce_bytes, direct

    raw_out, raw_bounce, direct = run("wds_raw")
    std_out, std_bounce, _ = run("wds")
    np.testing.assert_array_equal(raw_out[0], std_out[0])
    np.testing.assert_array_equal(raw_out[0], np.stack(rows))
    if not direct:
        pytest.skip("this file system rejects O_DIRECT")
    from nvme_strom_tpu_torch.formats.wds import WdsShardIndex
    idx = WdsShardIndex(paths[0])
    offs = [idx.samples[k]["bin"][0] for k in idx.order]
    assert raw_bounce == 8 * (offs[1] - offs[0])
    assert std_bounce == 2 * 8 * 8192


def test_wds_raw_validation(tmp_path):
    p = str(tmp_path / "multi.tar")
    write_wds_shard(p, [{"a": b"x" * 512, "b": b"y" * 512}])
    with _loader([p], 2, fmt="wds_raw") as dl:
        with pytest.raises(ValueError, match="single-part"):
            list(dl)
    p2 = str(tmp_path / "uneq.tar")
    write_wds_shard(p2, [{"bin": b"x" * 512}, {"bin": b"y" * 1024}])
    with _loader([p2], 2, fmt="wds_raw") as dl:
        with pytest.raises(ValueError, match="length"):
            list(dl)


# -- MixtureLoader ------------------------------------------------------------

def _mk_dataset(tmp_path, tag: int, n_shards=2, per_shard=8, item=32):
    paths = []
    for s in range(n_shards):
        p = tmp_path / f"d{tag}-{s:05d}.tar"
        write_wds_shard(p, [{"bin": np.full(item, tag, np.uint8).tobytes()}
                            for _ in range(per_shard)])
        paths.append(str(p))
    return paths


def test_draws_equal_jax_and_are_seed_deterministic():
    srcs = [(range(5), 1.0), (range(5), 3.0)]
    a = MixtureLoader(srcs, seed=11)
    j = JaxMixture(srcs, seed=11)
    assert [a._draw(t) for t in range(200)] == \
        [j._draw(t) for t in range(200)]
    c = MixtureLoader(srcs, seed=12)
    assert [a._draw(t) for t in range(50)] != [c._draw(t) for t in range(50)]


def test_weighted_mixture_over_real_loaders(tmp_path):
    dec = lambda parts: np.frombuffer(next(iter(parts.values())), np.uint8)
    p1 = _mk_dataset(tmp_path, tag=1)
    p2 = _mk_dataset(tmp_path, tag=2)
    with _loader(p1, 8, decode=dec) as l1, _loader(p2, 8, decode=dec) as l2:
        mix = MixtureLoader([(l1, 1.0), (l2, 3.0)], seed=0)
        seen = []
        for batch, src in mix:
            assert int(batch[0, 0]) == src + 1
            seen.append(src)
            if len(seen) == 64:
                break
    want = JaxMixture([(None, 1.0), (None, 3.0)], seed=0)
    assert seen == [want._draw(t) for t in range(64)]
    assert mix.counts == [seen.count(0), seen.count(1)]
    assert mix.counts[1] > 2        # restarts: 2 batches an epoch


def test_empty_source_raises():
    with pytest.raises(ValueError, match="no batches"):
        next(iter(MixtureLoader([(iter(()), 1.0)], seed=0)))


def test_max_restarts_bounds_the_stream():
    mix = MixtureLoader([(range(2), 1.0)], seed=0, max_restarts=2)
    assert [b for b, _ in mix] == [0, 1] * 3


def test_bad_weights_refused():
    with pytest.raises(ValueError, match="positive"):
        MixtureLoader([(range(2), 0.0)], seed=0)
    with pytest.raises(ValueError, match="at least one"):
        MixtureLoader([], seed=0)


def test_abandoned_mixture_closes_sources():
    closed = []

    class Src:
        def __iter__(self):
            def gen():
                try:
                    while True:
                        yield 1
                finally:
                    closed.append(True)
            return gen()

    it = iter(MixtureLoader([(Src(), 1.0)], seed=0))
    assert next(it) == (1, 0)
    it.close()
    assert closed == [True]


# -- prefetch_to_device -------------------------------------------------------

def test_prefetch_order_copy_and_close():
    """Order kept, numpy leaves moved to the device when pulled, the
    wrapped iterator closed with the generator."""
    closed = []

    def batches():
        try:
            for i in range(5):
                yield {"t": np.full((2, 3), i, np.int32), "k": i}
        finally:
            closed.append(True)

    it = prefetch_to_device(batches(), size=2, device="cpu")
    got = [next(it) for _ in range(3)]
    for i, b in enumerate(got):
        assert isinstance(b["t"], torch.Tensor) and b["k"] == i
        assert torch.equal(b["t"], torch.full((2, 3), i, dtype=torch.int32))
    it.close()
    assert closed == [True]
    assert [b for b in prefetch_to_device(iter(range(4)), size=3)] == \
        [0, 1, 2, 3]
    with pytest.raises(ValueError, match="size"):
        prefetch_to_device([], size=0)
