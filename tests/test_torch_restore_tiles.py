"""The port's restore (checkpoint/manager.py) of checkpoints whose tensors
are stored as several tiles, the JAX package's saves from a mesh, with
the read-once scatter restore off and on; the fallback past a damaged
step; and ``LazyCheckpoint.load`` under scatter.  Everything compared is
bytes: no tolerance.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from nvme_strom_tpu.checkpoint import CheckpointManager as JaxManager
from nvme_strom_tpu.parallel.mesh import exchange_mesh
from nvme_strom_tpu_torch.checkpoint.manager import (CheckpointManager,
                                                     TargetMismatchError)
from nvme_strom_tpu_torch.checkpoint.scatter import build_restore_manifest
from nvme_strom_tpu_torch.io.engine import StromEngine
from nvme_strom_tpu_torch.parallel.mesh import exchange_group
from nvme_strom_tpu_torch.parallel.weights import (LazyCheckpoint,
                                                   save_checkpoint)
from nvme_strom_tpu_torch.utils.config import EngineConfig

UNIT = 1 << 16
N = 8


@pytest.fixture()
def engine():
    with StromEngine(EngineConfig(chunk_bytes=1 << 20, queue_depth=8,
                                  buffer_pool_bytes=8 << 20)) as eng:
        yield eng


def _arrays():
    rng = np.random.default_rng(11)
    return {"w": rng.standard_normal((64, 64)).astype(np.float32),
            "emb": rng.standard_normal((40, 24)).astype(np.float32),
            "b": rng.standard_normal((4096,)).astype(np.float32),
            "r": rng.integers(-9, 9, (7, 5)).astype(np.int32)}


def _save_from_mesh(tmp_path, mesh8):
    """A JAX save over the 2x4 mesh: every tensor but ``r`` is several
    tiles (row, column and row-and-column splits); ``emb`` is bf16."""
    a = _arrays()
    specs = {"w": P("dp", "tp"), "emb": P(None, "tp"), "b": P("dp"),
             "r": P()}
    state = {k: jax.device_put(
        jnp.asarray(v, jnp.bfloat16 if k == "emb" else None),
        NamedSharding(mesh8, specs[k])) for k, v in a.items()}
    state["step"] = 3
    JaxManager(tmp_path / "ck").save(3, state)
    want = {k: np.asarray(v).tobytes() for k, v in state.items()
            if k != "step"}
    return want


def _target():
    return {"w": torch.zeros(64, 64), "b": torch.zeros(4096),
            "emb": torch.zeros(40, 24, dtype=torch.bfloat16),
            "r": torch.zeros(7, 5, dtype=torch.int32), "step": 0}


def _bytes(t: torch.Tensor) -> bytes:
    t = t.contiguous()
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


@pytest.mark.parametrize("scatter", [False, True])
def test_restore_multi_tile_jax_save(tmp_path, mesh8, engine, monkeypatch,
                                     scatter):
    want = _save_from_mesh(tmp_path, mesh8)
    mgr = CheckpointManager(tmp_path / "ck", engine=engine)
    with open(os.path.join(mgr.step_dir(3), "meta.json")) as f:
        tiles = {k: len(v["tiles"]) for k, v in
                 json.load(f)["tensors"].items()}
    assert tiles == {"w": 8, "emb": 4, "b": 2, "r": 1, "step": 1}
    group = None
    if scatter:
        monkeypatch.setenv("STROM_ICI_SCATTER", "1")
        monkeypatch.setenv("STROM_ICI_UNIT_BYTES", str(UNIT))
        group = exchange_group(devices=["cpu"] * N)
    got = mgr.restore(_target(), ici_group=group)
    for k, w in want.items():
        assert got[k].dtype == _target()[k].dtype
        assert _bytes(got[k]) == w, k
    assert got["step"] == 3 and type(got["step"]) is int
    assert mgr.last_restore_step == 3
    st = engine.stats
    if scatter:
        man = build_restore_manifest(mgr.step_dir(3), N, UNIT)
        assert (st.ici_bytes_read, st.ici_fallbacks) == (man.total_bytes, 0)
        for hb in man.host_bytes:
            assert hb <= man.total_bytes / N + len(man.paths) * UNIT
    else:
        assert (st.ici_bytes_read, st.ici_fallbacks) == (0, 0)


def test_scatter_restore_equals_jax_scatter_restore(tmp_path, mesh8, engine,
                                                    monkeypatch):
    _save_from_mesh(tmp_path, mesh8)
    monkeypatch.setenv("STROM_ICI_SCATTER", "1")
    monkeypatch.setenv("STROM_ICI_UNIT_BYTES", str(UNIT))
    got = CheckpointManager(tmp_path / "ck", engine=engine).restore(
        _target(), ici_group=exchange_group(devices=["cpu"] * N))
    import ml_dtypes
    ref = JaxManager(tmp_path / "ck").restore(
        {"w": np.zeros((64, 64), np.float32), "b": np.zeros(4096, np.float32),
         "emb": np.zeros((40, 24), ml_dtypes.bfloat16),
         "r": np.zeros((7, 5), np.int32), "step": 0},
        ici_mesh=exchange_mesh(N))
    for k in ("w", "b", "emb", "r"):
        assert _bytes(got[k]) == np.asarray(ref[k]).tobytes(), k
    assert got["step"] == ref["step"] == 3


def test_region_reader_reads_only_the_rows_it_needs(tmp_path, mesh8, engine):
    want = _save_from_mesh(tmp_path, mesh8)

    class Recording:
        def __init__(self, inner):
            self._inner, self.spans = inner, []

        def submit_readv(self, reads):
            reads = list(reads)
            self.spans += reads
            return self._inner.submit_readv(reads)

        def __getattr__(self, name):
            return getattr(self._inner, name)

    rec = Recording(engine)
    mgr = CheckpointManager(tmp_path / "ck", engine=rec)
    with open(os.path.join(mgr.step_dir(3), "meta.json")) as f:
        info = json.load(f)["tensors"]["w"]
    read_region = mgr._region_reader(rec, mgr.step_dir(3), {}, "w", info)
    got = read_region(((3, 10), (8, 40)))
    w = np.frombuffer(want["w"], np.float32).reshape(64, 64)
    assert np.array_equal(got.numpy(), w[3:10, 8:40])
    # rows 3..9 of the three 16-column tiles that cols 8..39 touch
    assert sum(ln for _, _, ln in rec.spans) == 3 * 7 * 16 * 4


@pytest.mark.parametrize("scatter,keep", [(False, 0.5), (True, 0.5),
                                          (False, 0.0)])
def test_truncated_newest_step_falls_back(tmp_path, engine, monkeypatch,
                                          scatter, keep):
    mgr = CheckpointManager(tmp_path / "ck", engine=engine)
    old = {"w": torch.arange(50_000, dtype=torch.float32), "n": 1}
    mgr.save(1, old)
    mgr.save(2, {"w": torch.zeros(50_000), "n": 2})
    data = os.path.join(mgr.step_dir(2), "state-00000.safetensors")
    with open(data, "r+b") as f:
        f.truncate(int(os.path.getsize(data) * keep))
    group = None
    if scatter:
        monkeypatch.setenv("STROM_ICI_SCATTER", "1")
        monkeypatch.setenv("STROM_ICI_UNIT_BYTES", str(UNIT))
        group = exchange_group(devices=["cpu"] * N)
    got = mgr.restore({"w": torch.zeros(50_000), "n": 0}, ici_group=group)
    assert torch.equal(got["w"], old["w"]) and got["n"] == 1
    assert mgr.last_restore_step == 1
    assert engine.stats.restore_fallbacks == 1
    assert engine.stats.ici_fallbacks == 0
    assert (engine.stats.ici_bytes_read > 0) == scatter
    with pytest.raises(CheckpointManager._DAMAGE):
        mgr.restore({"w": torch.zeros(50_000), "n": 0}, step=2,
                    fallback=False, ici_group=group)


def test_restore_refuses_a_missing_step_and_a_wrong_target(tmp_path, engine):
    mgr = CheckpointManager(tmp_path / "ck", engine=engine)
    mgr.save(1, {"w": torch.ones(8)})
    mgr.save(2, {"w": torch.ones(8) * 2})
    with pytest.raises(FileNotFoundError):
        mgr.restore({"w": torch.zeros(8)}, step=5)
    # a target that does not fit is no damage: no older step is tried
    with pytest.raises(TargetMismatchError):
        mgr.restore({"w": torch.zeros(9)})
    with pytest.raises(KeyError):
        mgr.restore({"v": torch.zeros(8)})
    assert engine.stats.restore_fallbacks == 0
    assert torch.equal(mgr.restore({"w": torch.zeros(8)}, step=1)["w"],
                       torch.ones(8))


def test_lazy_checkpoint_load_scatter_on_equals_off(tmp_path, engine,
                                                    monkeypatch):
    g = torch.Generator().manual_seed(3)
    tensors = {"wte": torch.randn(300, 70, generator=g),
               "bias": torch.randn(70, generator=g).bfloat16(),
               "scale": torch.tensor(2.5)}
    save_checkpoint(tmp_path / "model.safetensors", tensors)
    off = LazyCheckpoint(tmp_path).load(engine, device="cpu")
    monkeypatch.setenv("STROM_ICI_SCATTER", "1")
    monkeypatch.setenv("STROM_ICI_UNIT_BYTES", str(4096))
    on = LazyCheckpoint(tmp_path).load(
        engine, device="cpu", ici_group=exchange_group(devices=["cpu"] * 4))
    for k, t in tensors.items():
        assert _bytes(on[k]) == _bytes(off[k]) == _bytes(t), k
    assert engine.stats.ici_bytes_read == os.path.getsize(
        tmp_path / "model.safetensors")
    assert engine.stats.ici_fallbacks == 0
