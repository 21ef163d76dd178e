"""``STROM_VERIFY`` on the port's weight loads and WebDataset loader
(nvme_strom_tpu_torch/parallel/weights.py, data/loader.py,
utils/checksum.py) held against the JAX package's: offset-keyed
sidecars written by either package are read by the other, a flipped
payload byte in a safetensors file raises in the port's load where the
JAX load raises, a clean load verifies the same bytes as the JAX load,
and the loader's cases of tests/test_faults.py but quarantine (which
comes with resilience): a transient flip healed by one re-read, a
lasting one raising, and no CRC work with the switch off.  Tolerance:
exact."""

import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from nvme_strom_tpu.formats.safetensors import \
    write_safetensors as jax_write_safetensors
from nvme_strom_tpu.formats.wds import write_wds_shard as jax_write_wds
from nvme_strom_tpu.io.engine import StromEngine as JaxEngine
from nvme_strom_tpu.parallel.weights import LazyCheckpoint as JaxCheckpoint
from nvme_strom_tpu.utils import checksum as j_checksum
from nvme_strom_tpu.utils.config import EngineConfig as JaxEngineConfig
from nvme_strom_tpu.utils.stats import StromStats as JaxStats
from nvme_strom_tpu_torch.data import loader as p_loader
from nvme_strom_tpu_torch.data.loader import ShardedLoader
from nvme_strom_tpu_torch.formats.safetensors import write_safetensors
from nvme_strom_tpu_torch.formats.wds import write_wds_shard
from nvme_strom_tpu_torch.io.engine import StromEngine
from nvme_strom_tpu_torch.parallel.mesh import exchange_group
from nvme_strom_tpu_torch.parallel.weights import LazyCheckpoint
from nvme_strom_tpu_torch.utils import checksum as p_checksum
from nvme_strom_tpu_torch.utils.checksum import ChecksumError
from nvme_strom_tpu_torch.utils.config import EngineConfig


def _engine():
    return StromEngine(EngineConfig(chunk_bytes=1 << 20, queue_depth=8,
                                    buffer_pool_bytes=16 << 20))


def _jengine():
    return JaxEngine(JaxEngineConfig(chunk_bytes=1 << 20, queue_depth=8,
                                     buffer_pool_bytes=16 << 20),
                     stats=JaxStats())


def _flip(path, at, bit=0x01):
    with open(path, "r+b") as f:
        f.seek(at)
        b = f.read(1)
        f.seek(at)
        f.write(bytes([b[0] ^ bit]))


# -- sidecars across the packages -------------------------------------------

def _samples(n=6, item=64, seed=0):
    rng = np.random.default_rng(seed)
    return [{"bin": rng.integers(0, 256, item, dtype=np.uint8).tobytes(),
             "cls": bytes([i])} for i in range(n)]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_wds_sidecar_read_by_the_other_package(tmp_path, writer):
    """``stamp_wds`` of one package, ``load_sidecar`` of the other: the
    same spans and stamps, and each stamp is the CRC32C of the member's
    bytes."""
    path = tmp_path / "shard.tar"
    write_wds_shard(path, _samples())
    w, r = (j_checksum, p_checksum) if writer == "jax" else \
        (p_checksum, j_checksum)
    out = w.stamp_wds(str(path))
    assert out == r.sidecar_path(str(path)) == str(path) + ".crc.json"
    sc = r.load_sidecar(str(path))
    other = w.load_sidecar(str(path))
    assert sc.spans == other.spans and len(sc) == 12
    data = path.read_bytes()
    for off, (ln, crc) in sc.spans.items():
        assert sc.lookup(off, ln) == crc == j_checksum.crc32c(
            np.frombuffer(data[off:off + ln], np.uint8))
        assert sc.lookup(off, ln + 1) is None


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_write_sidecar_files_equal(tmp_path, writer):
    """``write_sidecar`` of either package writes the same document."""
    spans = [(0, 3, b"abc"), (512, 5, np.frombuffer(b"hello", np.uint8)),
             (4096, 0, b"")]
    docs = []
    for m in (j_checksum, p_checksum):
        p = tmp_path / f"{m.__name__.split('.')[0]}.bin"
        m.write_sidecar(str(p), spans)
        docs.append(json.loads((tmp_path / (p.name + ".crc.json"))
                               .read_text()))
    assert docs[0] == docs[1]
    src = j_checksum if writer == "jax" else p_checksum
    dst = p_checksum if writer == "jax" else j_checksum
    p = tmp_path / "x.bin"
    src.write_sidecar(str(p), spans)
    sc = dst.load_sidecar(str(p))
    assert sc.lookup(512, 5) == j_checksum.crc32c(
        np.frombuffer(b"hello", np.uint8))


def test_jax_stamped_shard_verifies_in_the_port(tmp_path, monkeypatch):
    """A shard the JAX writer stamps at write time is checked by the
    port's loader: every part verified, none failing."""
    monkeypatch.setenv("STROM_VERIFY", "full")
    path = tmp_path / "j.tar"
    jax_write_wds(path, _samples(8), checksums=True)
    eng = _engine()
    with ShardedLoader([str(path)], global_batch=4, engine=eng,
                       device="cpu",
                       decode=lambda parts: np.frombuffer(
                           parts["bin"] + parts["cls"], np.uint8)) as dl:
        rows = [r for b in dl for r in b]
    assert len(rows) == 8
    assert eng.stats.bytes_verified == 8 * 65
    assert eng.stats.checksum_failures == 0
    eng.close_all()


def test_sidecar_unreadable_is_none(tmp_path):
    path = tmp_path / "bad.tar"
    path.write_bytes(b"x")
    (tmp_path / "bad.tar.crc.json").write_text("{not json")
    assert p_checksum.load_sidecar(str(path)) is None
    (tmp_path / "bad.tar.crc.json").write_text(json.dumps(
        {"version": 1, "algo": "md5", "spans": {}}))
    assert p_checksum.load_sidecar(str(path)) is None
    assert p_checksum.load_sidecar(str(tmp_path / "none.tar")) is None


def test_rewriting_a_shard_drops_its_sidecar(tmp_path):
    path = tmp_path / "s.tar"
    write_wds_shard(path, _samples())
    p_checksum.stamp_wds(str(path))
    write_wds_shard(path, _samples(seed=1))
    assert p_checksum.load_sidecar(str(path)) is None


# -- weight loads -----------------------------------------------------------

def _weights(tmp_path, name="model.safetensors"):
    rng = np.random.default_rng(0)
    tensors = {"w": rng.standard_normal((32, 16)).astype(np.float32),
               "b": rng.standard_normal(16).astype(np.float32),
               "s": np.asarray(3.5, np.float32)}
    path = tmp_path / name
    jax_write_safetensors(path, tensors)
    return path, tensors


def _jax_load(path, eng):
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1), ("dp",))
    sh = NamedSharding(mesh, PartitionSpec())
    ck = JaxCheckpoint(str(path))
    return ck.load_sharded({n: sh for n in ck.keys()}, engine=eng)


def test_clean_load_verifies_what_the_jax_load_verifies(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("STROM_VERIFY", "full")
    path, tensors = _weights(tmp_path)
    eng, jeng = _engine(), _jengine()
    got = LazyCheckpoint(str(path)).load(eng, device="cpu")
    _jax_load(path, jeng)
    for n, a in tensors.items():
        np.testing.assert_array_equal(got[n].numpy(), a)
    payload = sum(a.nbytes for a in tensors.values())
    assert eng.stats.bytes_verified == jeng.stats.bytes_verified == payload
    assert eng.stats.checksum_failures == 0
    eng.close_all()
    jeng.close_all()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_weights_bit_flip_detected(tmp_path, monkeypatch, writer):
    """A flipped payload byte: both packages' loads raise, each counts
    one failure; the clean file loads in both first."""
    monkeypatch.setenv("STROM_VERIFY", "full")
    rng = np.random.default_rng(0)
    w = rng.standard_normal((32, 16)).astype(np.float32)
    path = tmp_path / "model.safetensors"
    if writer == "jax":
        jax_write_safetensors(path, {"w": w})
    else:
        write_safetensors(path, {"w": torch.from_numpy(w)})
    eng, jeng = _engine(), _jengine()
    got = LazyCheckpoint(str(path)).load(eng, device="cpu")
    np.testing.assert_array_equal(got["w"].numpy(), w)
    assert eng.stats.bytes_verified >= w.nbytes
    size = path.stat().st_size
    _flip(path, size - 7)
    with pytest.raises(ChecksumError, match="corrupt weights"):
        LazyCheckpoint(str(path)).load(eng, device="cpu")
    with pytest.raises(j_checksum.ChecksumError, match="corrupt weights"):
        _jax_load(path, jeng)
    assert eng.stats.checksum_failures == 1
    assert jeng.stats.checksum_failures == 1
    eng.close_all()
    jeng.close_all()


def test_verify_off_loads_the_flipped_file(tmp_path, monkeypatch):
    """With the switch off the load does no CRC work (and so cannot see
    the flip), as the JAX load."""
    monkeypatch.delenv("STROM_VERIFY", raising=False)
    path, tensors = _weights(tmp_path)
    _flip(path, path.stat().st_size - 7)
    eng = _engine()
    got = LazyCheckpoint(str(path)).load(eng, device="cpu")
    assert any(not np.array_equal(got[n].numpy(), a)
               for n, a in tensors.items())
    assert eng.stats.bytes_verified == 0 == eng.stats.checksum_failures
    eng.close_all()


def test_scatter_load_verifies(tmp_path, monkeypatch):
    """The read-once scatter path checks as the direct path does: the
    clean file verifies its payload, a flipped byte raises."""
    monkeypatch.setenv("STROM_VERIFY", "full")
    monkeypatch.setenv("STROM_ICI_SCATTER", "1")
    path, tensors = _weights(tmp_path)
    group = exchange_group(devices=["cpu"] * 4)
    eng = _engine()
    got = LazyCheckpoint(str(path)).load(eng, device="cpu", ici_group=group)
    for n, a in tensors.items():
        np.testing.assert_array_equal(got[n].numpy(), a)
    assert eng.stats.ici_fallbacks == 0
    payload = sum(a.nbytes for a in tensors.values())
    assert eng.stats.bytes_verified == payload
    _flip(path, path.stat().st_size - 7)
    with pytest.raises(ChecksumError, match="corrupt weights"):
        LazyCheckpoint(str(path)).load(eng, device="cpu", ici_group=group)
    assert eng.stats.checksum_failures == 1
    eng.close_all()


# -- the WebDataset loader --------------------------------------------------

def _stamped_shards(tmp_path, n_shards=2, per_shard=16, item=64):
    paths = []
    for s in range(n_shards):
        samples = [{"bin": np.full(item, s * 100 + i,
                                   dtype=np.uint8).tobytes()}
                   for i in range(per_shard)]
        p = tmp_path / f"shard-{s:05d}.tar"
        write_wds_shard(p, samples)
        p_checksum.stamp_wds(str(p))
        paths.append(str(p))
    return paths


def _epoch(paths, eng):
    with ShardedLoader(paths, global_batch=8, engine=eng,
                       device="cpu") as dl:
        return [b.clone() for b in dl]


class _FlipOnce:
    """A read whose view comes back with one byte flipped."""

    def __init__(self, p):
        self._p, self.length, self.fh, self.offset = \
            p, p.length, p.fh, p.offset

    def wait(self, timeout=None):
        v = self._p.wait(timeout).copy()
        v[3] ^= 0x20
        return v

    def release(self):
        self._p.release()


def test_loader_transient_bitflip_healed_by_reread(tmp_path, monkeypatch):
    """One in-flight flip on a part of shard 0: caught by the sidecar
    check, healed by the one re-read; the epoch equals the unverified
    one bitwise, and the catch is counted."""
    paths = _stamped_shards(tmp_path)
    eng = _engine()
    clean = _epoch(paths, eng)
    assert len(clean) == 4
    monkeypatch.setenv("STROM_VERIFY", "full")
    real = p_loader.plan_and_submit
    left = [1]

    def flaky(engine, spans, **kw):
        # shards are read in order: the first read is shard 0's
        planned = real(engine, spans, **kw)
        if left[0]:
            left[0] -= 1
            planned[0] = [_FlipOnce(planned[0][0])] + planned[0][1:]
        return planned
    monkeypatch.setattr(p_loader, "plan_and_submit", flaky)
    before = eng.stats.snapshot()
    healed = _epoch(paths, eng)
    after = eng.stats.snapshot()
    assert left[0] == 0
    assert len(healed) == len(clean)
    for a, b in zip(healed, clean):
        assert torch.equal(a, b)
    assert after["checksum_failures"] - before["checksum_failures"] == 1
    assert after["bytes_verified"] - before["bytes_verified"] == \
        2 * 16 * 64 + 64
    eng.close_all()


def test_loader_persistent_corruption_raises(tmp_path, monkeypatch):
    """On-disk damage survives the re-read: with the default shard error
    budget of 0 the epoch raises a ShardReadError naming the shard, its
    cause the ChecksumError (tests/test_torch_faults.py holds the
    quarantine under a budget)."""
    from nvme_strom_tpu_torch.data.loader import ShardReadError
    monkeypatch.setenv("STROM_VERIFY", "full")
    paths = _stamped_shards(tmp_path)
    _flip(paths[0], 520, 0x20)        # the first member's payload
    eng = _engine()
    with pytest.raises(ShardReadError, match="shard-00000") as ei:
        _epoch(paths, eng)
    assert isinstance(ei.value.__cause__, ChecksumError)
    assert "shard-00000" in str(ei.value.__cause__)
    assert eng.stats.checksum_failures == 2
    eng.close_all()


def test_loader_verify_off_is_zero_cost(tmp_path, monkeypatch):
    """Stamped shards with the switch off: no verified byte, and the
    sidecars are never read."""
    monkeypatch.delenv("STROM_VERIFY", raising=False)
    paths = _stamped_shards(tmp_path)
    eng = _engine()
    with ShardedLoader(paths, global_batch=8, engine=eng,
                       device="cpu") as dl:
        rows = [r for b in dl for r in b]
        assert dl._sidecars == {}
    assert len(rows) == 32
    assert eng.stats.bytes_verified == 0 == eng.stats.checksum_failures
    eng.close_all()


def test_loader_unstamped_shard_verifies_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv("STROM_VERIFY", "full")
    path = tmp_path / "u.tar"
    write_wds_shard(path, [{"bin": bytes([i]) * 64} for i in range(8)])
    eng = _engine()
    assert len(_epoch([str(path)], eng)) == 1
    assert eng.stats.bytes_verified == 0
    eng.close_all()
