"""The port's checkpointing (checkpoint/manager.py, the engine writer in
formats/safetensors.py, ops/bridge.py write_from_device) on the CPU, and
a params-only checkpoint written by either package restored
byte-identical by the other."""

import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvme_strom_tpu.checkpoint import CheckpointManager as JaxManager
from nvme_strom_tpu.formats import safetensors as jst
from nvme_strom_tpu.utils.checksum import crc32c as jax_crc32c
from nvme_strom_tpu_torch.checkpoint.manager import (CheckpointManager,
                                                     flatten_with_names)
from nvme_strom_tpu_torch.formats.safetensors import (
    SafetensorsFile, tensor_checksums, write_safetensors_engine)
from nvme_strom_tpu_torch.io.engine import StromEngine
from nvme_strom_tpu_torch.ops.bridge import write_from_device
from nvme_strom_tpu_torch.utils.config import EngineConfig


@pytest.fixture()
def engine():
    with StromEngine(EngineConfig(chunk_bytes=1 << 20,
                                  buffer_pool_bytes=8 << 20)) as eng:
        yield eng


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return ({"tok_embed": torch.randn(70, 33, generator=g),
             "layers.0.wq": torch.randn(33, 5000, generator=g).bfloat16(),
             "final_norm": torch.ones(33)},
            {"exp_avg": {"tok_embed": torch.randn(70, 33, generator=g)},
             "step": {"tok_embed": torch.tensor(3.0)}},
            7, 0.5)


def test_flatten_names_join_keys_with_bar():
    names = flatten_with_names(_state())
    assert set(names) == {"0|tok_embed", "0|layers.0.wq", "0|final_norm",
                          "1|exp_avg|tok_embed", "1|step|tok_embed", "2",
                          "3"}
    assert flatten_with_names(torch.zeros(2)).keys() == {"_root"}


def test_roundtrip(tmp_path, engine):
    state = _state()
    mgr = CheckpointManager(tmp_path / "ck", engine=engine)
    path = mgr.save(7, state)
    assert os.path.basename(path) == "step_00000007"
    assert sorted(os.listdir(path)) == ["meta.json",
                                        "state-00000.safetensors"]
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    assert meta["format"] == 2 and meta["step"] == 7
    assert meta["tensors"]["0|layers.0.wq"]["dtype"] == "bfloat16"
    target = _state(seed=1)
    got = mgr.restore(target)
    for name, t in flatten_with_names(state).items():
        g = flatten_with_names(got)[name]
        if isinstance(t, torch.Tensor):
            assert g.dtype == t.dtype and torch.equal(g, t), name
        else:
            assert type(g) is type(t) and g == t, name
    flat = mgr.restore()           # no target: every tensor by name
    assert torch.equal(flat["0|tok_embed"], state[0]["tok_embed"])
    with pytest.raises(FileExistsError):
        mgr.save(7, state)
    mgr.save(7, _state(seed=2), force=True)
    assert not torch.equal(mgr.restore()["0|tok_embed"],
                           state[0]["tok_embed"])


def test_save_async_snapshots_now(tmp_path, engine):
    mgr = CheckpointManager(tmp_path / "ck", engine=engine)
    params = {"w": torch.arange(4096, dtype=torch.float32)}
    want = params["w"].clone()
    fut = mgr.save_async(1, params)
    params["w"].add_(1.0)          # the train loop moves on at once
    mgr.wait_pending()
    assert fut.done() and mgr.latest_step() == 1
    assert torch.equal(mgr.restore({"w": torch.zeros(4096)})["w"], want)
    mgr.close()


def test_torn_tmp_dir_ignored_and_collected(tmp_path, engine):
    mgr = CheckpointManager(tmp_path / "ck", engine=engine)
    mgr.save(1, {"w": torch.ones(3)})
    torn = tmp_path / "ck" / ".tmp_step_00000002"
    torn.mkdir()
    (torn / "state-00000.safetensors").write_bytes(b"partial")
    # a torn step directory without a readable manifest is no step
    (tmp_path / "ck" / "step_00000003").mkdir()
    assert mgr.all_steps() == [1] and mgr.latest_step() == 1
    # young debris may be a live save of another process: kept
    assert CheckpointManager(tmp_path / "ck").tmp_gc == []
    old = time.time() - 7200
    os.utime(torn / "state-00000.safetensors", (old, old))
    os.utime(torn, (old, old))
    mgr2 = CheckpointManager(tmp_path / "ck", engine=engine)
    assert mgr2.tmp_gc == [str(torn)] and not torn.exists()
    assert torch.equal(mgr2.restore({"w": torch.zeros(3)})["w"],
                       torch.ones(3))


def test_max_to_keep(tmp_path, engine):
    mgr = CheckpointManager(tmp_path / "ck", max_to_keep=2, engine=engine)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"w": torch.full((5,), float(s))})
    assert mgr.all_steps() == [3, 4]
    assert torch.equal(mgr.restore({"w": torch.zeros(5)}, step=3)["w"],
                       torch.full((5,), 3.0))


def test_engine_writer_stamps_checksums(tmp_path, engine):
    """Several chunks plus a tail, bf16 and a 0-d tensor: the file reads
    back through both packages' readers with the JAX CRC32C stamps."""
    g = torch.Generator().manual_seed(3)
    tensors = {"a": torch.randn(700, 1000, generator=g),
               "b": torch.randn(33, 7, generator=g).bfloat16(),
               "s": torch.tensor(2.5)}
    path = tmp_path / "x.safetensors"
    write_safetensors_engine(path, tensors, engine, metadata={"step": 9})
    sf = SafetensorsFile(path)
    assert sf.metadata == {"step": "9"}
    stamps = tensor_checksums(sf)
    jsf = jst.SafetensorsFile(path)
    assert jst.tensor_checksums(jsf) == stamps
    raw = path.read_bytes()
    for name, t in tensors.items():
        info = sf.tensors[name]
        got = raw[info["offset"]:info["offset"] + info["nbytes"]]
        want = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        assert got == want, name
        assert stamps[name] == jax_crc32c(np.frombuffer(want, np.uint8))


def test_write_from_device_cpu(tmp_path, engine):
    t = torch.arange(300_001, dtype=torch.int32)
    path = tmp_path / "w.bin"
    open(path, "wb").close()
    n = write_from_device(engine, t, path)
    assert n == t.numel() * 4
    assert path.read_bytes() == t.numpy().tobytes()


def test_params_checkpoint_jax_to_torch(tmp_path, engine):
    rng = np.random.default_rng(0)
    params = {"tok_embed": rng.standard_normal((40, 16), dtype=np.float32),
              "layers.0.wq": rng.standard_normal((16, 16),
                                                 dtype=np.float32),
              "final_norm": np.ones(16, np.float32)}
    JaxManager(tmp_path / "ck").save(3, {k: jnp.asarray(v)
                                         for k, v in params.items()})
    mgr = CheckpointManager(tmp_path / "ck", engine=engine)
    assert mgr.latest_step() == 3
    got = mgr.restore({k: torch.zeros(v.shape) for k, v in params.items()})
    for k, v in params.items():
        assert got[k].numpy().tobytes() == v.tobytes(), k


def test_params_checkpoint_torch_to_jax(tmp_path, engine):
    g = torch.Generator().manual_seed(5)
    params = {"tok_embed": torch.randn(40, 16, generator=g),
              "layers.0.wq": torch.randn(16, 16, generator=g),
              "final_norm": torch.ones(16)}
    CheckpointManager(tmp_path / "ck", engine=engine).save(4, params)
    mgr = JaxManager(tmp_path / "ck")
    assert mgr.latest_step() == 4
    got = mgr.restore({k: np.zeros(tuple(v.shape), np.float32)
                       for k, v in params.items()})
    for k, v in params.items():
        assert np.asarray(got[k]).tobytes() == v.numpy().tobytes(), k
