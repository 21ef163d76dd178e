"""The port's ``STROM_VERIFY`` policy (nvme_strom_tpu_torch/utils/
checksum.py) against the JAX package's, and on checkpoint restore
(nvme_strom_tpu_torch/checkpoint/manager.py): a persistent on-disk flip
steps back one step, a one-time flip heals on the re-read, ``full``
widens a partial-row read to the whole tile, and ``off`` does no CRC
work.  Restored tensors are compared bitwise."""

import json

import numpy as np
import pytest
import torch

from nvme_strom_tpu.utils import checksum as jcs
from nvme_strom_tpu_torch.checkpoint.manager import CheckpointManager
from nvme_strom_tpu_torch.io.engine import StromEngine
from nvme_strom_tpu_torch.utils import checksum as tcs
from nvme_strom_tpu_torch.utils.checksum import ChecksumError, VerifyPolicy
from nvme_strom_tpu_torch.utils.config import EngineConfig
from nvme_strom_tpu_torch.utils.stats import StromStats


def test_verify_policy_modes(monkeypatch):
    monkeypatch.delenv("STROM_VERIFY", raising=False)
    assert VerifyPolicy().mode == "off"
    assert not VerifyPolicy().want()
    monkeypatch.setenv("STROM_VERIFY", "full")
    p = VerifyPolicy()
    assert all(p.want() for _ in range(10))
    monkeypatch.setenv("STROM_VERIFY", "sample")
    monkeypatch.setenv("STROM_VERIFY_SAMPLE", "4")
    p = VerifyPolicy()
    assert [p.want() for _ in range(8)] == [False, False, False, True,
                                            False, False, False, True]
    monkeypatch.setenv("STROM_VERIFY", "bogus")
    with pytest.raises(ValueError, match="STROM_VERIFY"):
        VerifyPolicy()
    stats = StromStats()
    pol = VerifyPolicy("full")
    pol.check(b"payload", tcs.crc32c(np.frombuffer(b"payload", np.uint8)),
              stats)
    assert stats.bytes_verified == 7 and stats.checksum_failures == 0
    with pytest.raises(ChecksumError):
        pol.check(b"payload", 12345, stats)
    assert stats.checksum_failures == 1
    assert issubclass(ChecksumError, OSError)


@pytest.mark.parametrize("env", [
    {}, {"STROM_VERIFY": "full"}, {"STROM_VERIFY": "1"},
    {"STROM_VERIFY": "no"}, {"STROM_VERIFY": "sample"},
    {"STROM_VERIFY": "sample", "STROM_VERIFY_SAMPLE": "3"},
    {"STROM_VERIFY": "sample", "STROM_VERIFY_SAMPLE": "junk"}])
def test_policy_matches_jax(monkeypatch, env):
    """The same environment gives both packages' policies the same mode
    and the same sequence of verified spans; CRC32C values agree."""
    for k in ("STROM_VERIFY", "STROM_VERIFY_SAMPLE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jp, tp = jcs.VerifyPolicy(), VerifyPolicy()
    assert tp.mode == jp.mode and tp.enabled == jp.enabled
    assert [tp.want() for _ in range(40)] == [jp.want() for _ in range(40)]
    data = np.random.default_rng(1).integers(0, 256, 9999, dtype=np.uint8)
    assert tcs.crc32c(data) == jcs.crc32c(data)


def test_check_with_reread_heals_once_then_raises():
    stats = StromStats()
    pol = VerifyPolicy("full")
    good = np.arange(64, dtype=np.uint8)
    bad = good.copy()
    bad[3] ^= 1
    crc = tcs.crc32c(good)
    spoiled = []
    got = pol.check_with_reread(bad, crc, lambda: good, stats,
                                spoil=lambda: spoiled.append(1))
    assert got is good and spoiled == [1]
    assert stats.checksum_failures == 1 and stats.bytes_verified == 128
    with pytest.raises(ChecksumError, match="after a re-read"):
        pol.check_with_reread(bad, crc, lambda: bad, stats)
    assert stats.checksum_failures == 3


# -- checkpoint restore -----------------------------------------------------

def _state(v):
    g = torch.Generator().manual_seed(int(v))
    return {"w": torch.randn(64, 33, generator=g) + v,
            "b": torch.randn(40, generator=g).bfloat16(), "step": int(v)}


def _engine():
    return StromEngine(EngineConfig(chunk_bytes=1 << 20,
                                    buffer_pool_bytes=8 << 20))


class _FlipOnce:
    """A test-local engine wrapper: the first read of ``needle``'s data
    comes back with one byte flipped (in the staging buffer), as an
    in-flight corruption would; every later read is clean."""

    def __init__(self, eng, needle):
        self._eng, self._needle = eng, needle
        self._paths = {}
        self.flips = 0

    def __getattr__(self, name):
        return getattr(self._eng, name)

    def open(self, path, writable=False):
        fh = self._eng.open(path, writable)
        self._paths[fh] = str(path)
        return fh

    def submit_readv(self, reads):
        pend = self._eng.submit_readv(reads)
        return [self._Flip(p, self) if self._needle in
                self._paths.get(p.fh, "") else p for p in pend]

    class _Flip:
        def __init__(self, inner, owner):
            self._inner, self._owner = inner, owner

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def wait(self, timeout=None):
            view = self._inner.wait(timeout)
            if self._owner.flips == 0 and view.nbytes:
                self._owner.flips += 1
                view[view.nbytes // 2] ^= 0x10
            return view


def _flip_on_disk(mgr, step):
    from nvme_strom_tpu_torch.formats.safetensors import SafetensorsFile
    path = f"{mgr.step_dir(step)}/state-00000.safetensors"
    t = SafetensorsFile(path).tensors["w"]
    with open(path, "r+b") as f:
        f.seek(t["offset"] + 5)
        b = f.read(1)
        f.seek(t["offset"] + 5)
        f.write(bytes([b[0] ^ 0x01]))


def test_restore_persistent_flip_steps_back(tmp_path, monkeypatch):
    """A byte flipped on disk in step 2 fails the check and its re-read:
    the restore reads step 1 and counts one fallback."""
    monkeypatch.setenv("STROM_VERIFY", "full")
    with _engine() as eng:
        mgr = CheckpointManager(tmp_path / "ck", engine=eng)
        mgr.save(1, _state(1.0))
        mgr.save(2, _state(2.0))
        _flip_on_disk(mgr, 2)
        got = mgr.restore(_state(0.0))
        assert mgr.last_restore_step == 1
        for k in ("w", "b"):
            assert torch.equal(got[k], _state(1.0)[k])
        assert got["step"] == 1
        assert eng.stats.restore_fallbacks == 1
        assert eng.stats.checksum_failures == 2     # first read + re-read
        assert eng.stats.bytes_verified > 0


def test_restore_one_time_flip_heals_on_reread(tmp_path, monkeypatch):
    monkeypatch.setenv("STROM_VERIFY", "full")
    with _engine() as eng:
        CheckpointManager(tmp_path / "ck", engine=eng).save(2, _state(2.0))
        flip = _FlipOnce(eng, "step_00000002")
        mgr = CheckpointManager(tmp_path / "ck", engine=flip)
        got = mgr.restore(_state(0.0))
        assert flip.flips == 1
        assert mgr.last_restore_step == 2
        for k in ("w", "b"):
            assert torch.equal(got[k], _state(2.0)[k])
        assert eng.stats.checksum_failures == 1
        assert eng.stats.restore_fallbacks == 0


def test_restore_without_verify_takes_the_flip(tmp_path, monkeypatch):
    """``off``: no CRC work at all, so the same one-time flip reaches
    the restored tensor (what the check is for)."""
    monkeypatch.delenv("STROM_VERIFY", raising=False)

    def no_crc(*a, **kw):
        raise AssertionError("CRC computed with STROM_VERIFY off")

    monkeypatch.setattr(tcs, "crc32c", no_crc)
    with _engine() as eng:
        CheckpointManager(tmp_path / "ck", engine=eng).save(2, _state(2.0))
        flip = _FlipOnce(eng, "step_00000002")
        got = CheckpointManager(tmp_path / "ck", engine=flip).restore()
        assert flip.flips == 1
        assert eng.stats.bytes_verified == 0
        assert eng.stats.checksum_failures == 0
        changed = [k for k, v in _state(2.0).items()
                   if isinstance(v, torch.Tensor)
                   and not torch.equal(got[k], v)]
        assert len(changed) == 1


@pytest.mark.parametrize("mode,verified", [("full", 64 * 33 * 4),
                                           ("sample", 0)])
def test_full_widens_partial_rows_to_the_whole_tile(tmp_path, monkeypatch,
                                                    mode, verified):
    """Rows 10..20 of a stamped one-tile tensor: ``full`` reads and checks
    the whole tile, then takes the rows; ``sample`` reads the rows alone,
    which carry no stamp of their own."""
    monkeypatch.setenv("STROM_VERIFY", mode)
    monkeypatch.setenv("STROM_VERIFY_SAMPLE", "1")
    with _engine() as eng:
        mgr = CheckpointManager(tmp_path / "ck", engine=eng)
        state = _state(3.0)
        mgr.save(3, state)
        with open(f"{mgr.step_dir(3)}/meta.json") as f:
            info = json.load(f)["tensors"]["w"]
        read = mgr._region_reader(eng, mgr.step_dir(3), {}, "w", info)
        rows = read(((10, 20), (0, 33)))
        assert torch.equal(rows, state["w"][10:20])
        assert eng.stats.bytes_verified == verified
