"""The port's weight loader (nvme_strom_tpu_torch/parallel/weights.py)
against the JAX package's: the same safetensors file gives the same
bytes in both, and files written by either package load in both
(compared exactly)."""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
from nvme_strom_tpu.formats.safetensors import \
    write_safetensors as jax_write
from nvme_strom_tpu.io import StromEngine as JaxEngine
from nvme_strom_tpu.parallel.weights import LazyCheckpoint as JaxCheckpoint
from nvme_strom_tpu.utils.config import EngineConfig as JaxConfig
from nvme_strom_tpu_torch.io.engine import StromEngine
from nvme_strom_tpu_torch.parallel.weights import (LazyCheckpoint,
                                                   save_checkpoint)
from nvme_strom_tpu_torch.utils.config import EngineConfig

CHUNK = 64 << 10     # small staging buffers: multi-chunk tensors and rows
#                      larger than one buffer both occur below


def _tensors():
    rng = np.random.default_rng(3)
    return {
        "emb": rng.standard_normal((300, 96)).astype(np.float32),
        "w_bf16": rng.standard_normal((130, 64)).astype(ml_dtypes.bfloat16),
        "wide_row": rng.standard_normal((3, 20000)).astype(np.float32),
        "ids": rng.integers(-5, 5, (17,), dtype=np.int32),
        "scalar": np.asarray(2.5, np.float32),
        "norm": np.ones((96,), np.float32),
    }


def _jax_load(path):
    cfg = JaxConfig(chunk_bytes=CHUNK, queue_depth=8,
                    buffer_pool_bytes=4 << 20)
    with JaxEngine(cfg) as eng:
        arrs = JaxCheckpoint(path).load_sharded(
            lambda n, s: jax.sharding.SingleDeviceSharding(
                jax.devices()[0]), engine=eng)
    return {n: np.asarray(a) for n, a in arrs.items()}


def _port_load(path):
    cfg = EngineConfig(chunk_bytes=CHUNK, queue_depth=8,
                       buffer_pool_bytes=4 << 20)
    with StromEngine(cfg) as eng:
        out = LazyCheckpoint(path).load(eng, device="cpu")
        eng.sync_stats()
        return out, eng.stats.snapshot()


def _bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def test_jax_written_file_loads_byte_identical(tmp_path):
    path = tmp_path / "j.safetensors"
    tensors = _tensors()
    jax_write(path, tensors)
    ours, stats = _port_load(path)
    theirs = _jax_load(path)
    assert set(ours) == set(theirs) == set(tensors)
    for name, arr in tensors.items():
        assert tuple(ours[name].shape) == arr.shape, name
        assert _bytes(ours[name]) == theirs[name].tobytes() == \
            arr.tobytes(), name
    assert ours["w_bf16"].dtype == torch.bfloat16
    assert ours["ids"].dtype == torch.int32
    total = sum(a.nbytes for a in tensors.values())
    assert stats["bytes_to_device"] == total


def test_plan_and_slice_plan_match_jax(tmp_path):
    from nvme_strom_tpu.formats.safetensors import \
        SafetensorsFile as JaxFile
    from nvme_strom_tpu_torch.formats.safetensors import SafetensorsFile
    path = tmp_path / "j.safetensors"
    jax_write(path, _tensors())
    ours, theirs = SafetensorsFile(path), JaxFile(path)

    def fields(e):
        return e.key, e.offset, e.length, e.dtype, e.shape

    assert [fields(e) for e in ours.plan().entries] == \
        [fields(e) for e in theirs.plan().entries]
    for name, r0, n in [("emb", 7, 100), ("wide_row", 1, 2),
                        ("w_bf16", 0, 130)]:
        assert fields(ours.slice_plan(name, r0, n)) == \
            fields(theirs.slice_plan(name, r0, n))
    with pytest.raises(ValueError, match="out of bounds"):
        ours.slice_plan("emb", 250, 51)


def test_port_written_checkpoint_loads_in_both(tmp_path):
    path = tmp_path / "p.safetensors"
    tensors = _tensors()
    params = {n: torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
              if a.dtype == ml_dtypes.bfloat16 else torch.from_numpy(a)
              for n, a in tensors.items()}
    save_checkpoint(path, params)
    ours, _ = _port_load(path)
    theirs = _jax_load(path)
    for name, arr in tensors.items():
        assert _bytes(ours[name]) == arr.tobytes(), name
        assert theirs[name].tobytes() == arr.tobytes(), name
        assert str(theirs[name].dtype) == str(arr.dtype), name


def test_directory_of_shards(tmp_path):
    """A directory of shards loads as one namespace (with a temporary
    engine); duplicate names raise."""
    a, b = tmp_path / "a.safetensors", tmp_path / "b.safetensors"
    save_checkpoint(a, {"x": torch.arange(6, dtype=torch.float32)})
    save_checkpoint(b, {"y": torch.ones(2, 3)})
    ck = LazyCheckpoint(tmp_path)
    assert sorted(ck.keys()) == ["x", "y"]
    out = ck.load(device="cpu")
    assert out["x"].tolist() == [0, 1, 2, 3, 4, 5]
    assert out["y"].shape == (2, 3)
    save_checkpoint(tmp_path / "c.safetensors", {"x": torch.zeros(1)})
    with pytest.raises(ValueError, match="duplicate tensor x"):
        LazyCheckpoint(tmp_path)
    with pytest.raises(ValueError, match="no safetensors"):
        LazyCheckpoint([])
