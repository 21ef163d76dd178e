"""The port's sharded I/O across 2 and 4 gloo processes on the CPU:
``LazyCheckpoint.load_sharded`` with and without the read-once exchange
(ops/ici.py ``ProcessExchange``), the loader's process groups, the
multi-process checkpoint (tiles, the collective-free save and its
``ckpt.marker`` crash window, restore under another mesh) and the
per-process moment files, held against whole loads and one-process runs
and against the JAX package's checkpoint manager, loader and moment
manifests.

Cases follow the JAX package's ``tests/test_weights.py:48-139``,
``test_loader.py:141``, ``test_checkpoint.py:56``, ``:99`` and ``:225``
and ``tests/test_multiprocess.py``.  Each world size is one spawn of
workers (``tests/_torch_dist.py``, join limit 150 s).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding

import _torch_dist
from nvme_strom_tpu.checkpoint.manager import CheckpointManager as JaxManager
from nvme_strom_tpu.data.loader import ShardedLoader as JaxLoader
from nvme_strom_tpu.models import transformer as jtr
from nvme_strom_tpu.parallel import opt_offload as joo
from nvme_strom_tpu.parallel import shardings as jsh
from nvme_strom_tpu_torch.checkpoint.manager import CheckpointManager
from nvme_strom_tpu_torch.models import transformer as ttr
from nvme_strom_tpu_torch.parallel.opt_offload import OffloadedAdam
from nvme_strom_tpu_torch.parallel.shardings import param_shardings
from nvme_strom_tpu_torch.parallel.mesh import Mesh as TMesh
from nvme_strom_tpu_torch.parallel.weights import save_checkpoint
from nvme_strom_tpu_torch.train_lm import synthesize_shards

WORLDS = (2, 4)


@functools.lru_cache(maxsize=None)
def _model():
    import dataclasses
    jcfg = dataclasses.replace(jtr.tiny_config(), dtype=jnp.float32,
                               max_seq=16)
    names = {f.name for f in dataclasses.fields(ttr.TransformerConfig)}
    fields = {k: v for k, v in jcfg.__dict__.items()
              if k in names and k != "dtype"}
    fields["remat_policy"] = "none"
    pj = jtr.init_params(jax.random.key(2), jcfg)
    full = {k: np.asarray(v, np.float32) for k, v in pj.items()}
    return jcfg, fields, pj, full


def _bounds_of(world: int, rank: int, cfg):
    """Rank ``rank``'s slices in the workers' dp × tp mesh."""
    mesh = TMesh([world // 2, 2], ["dp", "tp"], rank)
    return param_shardings(cfg, mesh)


def _jax_moment_files(path, world, cfg, full, monkeypatch):
    """The JAX ``OffloadedAdam``'s per-process files for ``world``
    processes, each holding the workers' rank slices: the JAX package
    runs here as each process in turn, its process index, process count,
    local pieces and all-gather standing in for a real mesh."""
    from jax.experimental import multihost_utils
    monkeypatch.setattr(jax, "process_count", lambda: world)
    monkeypatch.setattr(multihost_utils, "process_allgather",
                        lambda x: np.stack([np.asarray(x)] * world))
    params = {k: jnp.asarray(v) for k, v in full.items()}
    steps = []
    for r in range(world):
        sh = _bounds_of(world, r, cfg)
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)

        def pieces(arr, sh=sh, r=r):
            name = next(n for n, v in params.items() if v is arr)
            b = sh[name].local_bounds(arr.shape)
            shape = tuple(hi - lo for lo, hi in b)
            return [{"key": tuple(b), "shape": shape}], [(None, 0)]
        monkeypatch.setattr(joo, "_local_pieces", pieces)
        with joo.OffloadedAdam(path, params, lr=1e-3,
                               weight_decay=1e-4) as opt:
            steps.append(opt.step)
    monkeypatch.undo()
    return steps


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    base = tmp_path_factory.mktemp("mgio")
    jcfg, fields, pj, full = _model()
    cfg = ttr.TransformerConfig(**fields, dtype=torch.float32)
    weights = str(base / "model.safetensors")
    save_checkpoint(weights, full)
    wds_dir = base / "wds"
    wds_dir.mkdir()
    wds = synthesize_shards(str(wds_dir), 128, 16, n_shards=4, per_shard=8)
    from nvme_strom_tpu_torch.formats.fixedrec import write_fixedrec
    rng = np.random.default_rng(3)
    fixed = []
    for s in range(4):
        path = str(base / f"rec-{s}.sfr")
        write_fixedrec(path, rng.integers(0, 256, (8, 48), dtype=np.uint8))
        fixed.append(path)
    from nvme_strom_tpu_torch.formats.tfrecord import write_tfrecords
    tfrec = []
    for s in range(4):
        path = str(base / f"rec-{s}.tfrecord")
        write_tfrecords(path, [bytes(r) for r in rng.integers(
            0, 256, (8, 40), dtype=np.uint8)])
        tfrec.append(path)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("dp", "tp"))
    p_sh = jsh.param_shardings(jcfg, mesh)
    JaxManager(str(base / "jax_ckpt")).save(
        1, {k: jax.device_put(v, p_sh[k]) for k, v in pj.items()})
    rng = np.random.default_rng(4)
    grads = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.1
             for k, v in full.items()}
    tokens = np.random.default_rng(9).integers(0, 128, (4, 16)) \
        .astype(np.int32)
    mp = pytest.MonkeyPatch()
    handles, jax_steps = {}, {}
    for w in WORLDS:
        d = base / f"w{w}"
        d.mkdir()
        jax_steps[w] = _jax_moment_files(str(d / "jax_moments"), w, cfg,
                                         full, mp)
        payload = {"cfg": fields, "weights": weights, "wds": wds,
                   "fixedrec": fixed, "tfrecord": tfrec,
                   "ckpt": str(d / "ckpt"),
                   "jax_ckpt": str(base / "jax_ckpt"), "params": full,
                   "grads": grads, "tokens": tokens,
                   "moments": str(d / "moments"),
                   "jax_moments": str(d / "jax_moments")}
        handles[w] = (d, _torch_dist.start("io_cases", w, d, payload,
                                           timeout=150))
    crash = base / "crash"
    crash.mkdir()
    crash_h = _torch_dist.start("marker_crash", 2, crash,
                                {"ckpt": str(crash / "ckpt")}, timeout=60)
    res = {w: (d, _torch_dist.collect(h)) for w, (d, h) in handles.items()}
    entry = base / "entry"
    entry.mkdir()
    entry_h = _torch_dist.start("entry_points", 2, entry,
                                {"ckpt": str(entry / "ckpt")}, timeout=150)
    crash_res = _torch_dist.collect(crash_h, exit_codes={0: 137})
    entry_res = _torch_dist.collect(entry_h)
    return {"cfg": cfg, "jcfg": jcfg, "full": full, "weights": weights,
            "wds": wds, "fixed": fixed, "grads": grads, "res": res,
            "jax_steps": jax_steps, "crash": (crash, crash_res),
            "entry": (entry, entry_res),
            "base": base}


@pytest.fixture(params=WORLDS, ids=[f"{w}ranks" for w in WORLDS])
def world(request):
    return request.param


def _exact(per_rank_slices: list, full: dict) -> None:
    for slices in per_rank_slices:
        for name, (bounds, local) in slices.items():
            want = full[name][tuple(slice(a, b) for a, b in bounds)]
            np.testing.assert_array_equal(local, want, err_msg=name)


@pytest.mark.parametrize("mode", ["direct", "scatter"])
def test_load_sharded_is_a_whole_load_sliced(setup, world, mode):
    """Every rank's tensors are bitwise the slices of a whole load; the
    scatter reads each byte once across the ranks (each rank's share ≤
    payload / N + one unit) and brings the rest from its peers."""
    _, res = setup["res"][world]
    _exact([r["load_" + mode]["slices"] for r in res], setup["full"])
    total = os.path.getsize(setup["weights"])
    if mode == "scatter":
        unit = 4096                 # the workers' STROM_ICI_UNIT_BYTES
        for r in res:
            got = r["load_scatter"]
            assert got["ici_fallbacks"] == 0
            assert 0 < got["ici_bytes_read"] <= total / world + unit
            assert got["ici_bytes_read"] + got["ici_bytes_received"] == \
                sum(setup["res"][world][1][0]["load_scatter"][k]
                    for k in ("ici_bytes_read", "ici_bytes_received"))
        assert sum(r["load_scatter"]["ici_bytes_read"] for r in res) <= \
            total + world * 4096
    else:
        # a rank reads its row spans: the column-split tensors whole, its
        # rows of the row-split ones, never the whole file's tensors twice
        for r in res:
            assert 0 < r["load_direct"]["nvme_bytes"] <= total + (1 << 20)


def test_faulting_checkpoint_faults_each_ranks_slices(setup, world):
    """``FaultingCheckpoint(shardings=)`` demand-faults this rank's slice
    of every tensor, bitwise the whole tensors' slices."""
    _, res = setup["res"][world]
    _exact([r["faulting"] for r in res], setup["full"])


def test_warm_start_and_verify_through_load_sharded(setup, world):
    """``Trainer(mesh=, init_weights=)`` holds each rank's slices of the
    file bitwise; ``STROM_VERIFY=full`` checks the whole row spans."""
    _, res = setup["res"][world]
    _exact([r["warm"] for r in res], setup["full"])
    for r in res:
        assert r["verify"]["bytes_verified"] > 0
        assert r["verify"]["checksum_failures"] == 0


def test_entry_points_under_a_process_group(setup):
    """``train_lm --tp 2`` and ``train_vit --tp 2`` inside a 2-rank group
    (as torchrun starts them): both exit 0, rank 0 logs finite losses
    and the other rank logs nothing; train_lm's checkpoint is the two
    ranks' tiles."""
    import math
    import re
    entry, res = setup["entry"]
    for name in ("lm", "vit"):
        rc0, log0 = res[0][name]
        rc1, log1 = res[1][name]
        assert rc0 == rc1 == 0
        losses = [float(m) for m in re.findall(r"loss[= ]([\d.]+)", log0)]
        assert losses and all(math.isfinite(x) for x in losses), log0
        assert "loss=" not in log1
    with open(entry / "ckpt" / "step_00000003" / "meta.json") as f:
        meta = json.load(f)
    assert meta["process_count"] == 2


def test_loader_covers_the_data_once(setup, world):
    """dp ranks read disjoint rows that cover every sample once; tp peers
    read the same rows."""
    _, res = setup["res"][world]
    all_rows = []
    for r in res:
        rows, local = r["loader"]["wds_dp"]
        assert local == 8 // world
        all_rows += rows
    assert len(all_rows) == len(set(all_rows)) == 32
    for key in ("fixedrec_dp", "wds_raw_dp", "tfrecord_dp"):
        got = [row for r in res for row in r["loader"][key][0]]
        assert len(got) == len(set(got)) == 32, key
    tp = [set(r["loader"]["wds_tp"][0]) for r in res]
    for a in range(0, world, 2):
        assert tp[a] == tp[a + 1]
    assert set().union(*tp) == set(all_rows)


@pytest.mark.parametrize("blocks,n_blk,pi", [
    ({0: {0}, 1: {1}}, 2, 1),                    # dp across processes
    ({0: {0}, 1: {0}, 2: {1}, 3: {1}}, 2, 2),    # tp peers share rows
    ({0: {0, 1}, 1: {2, 3}}, 4, 0),              # two blocks a process
    ({0: {0}, 1: {0, 1}}, 2, 0),                 # overlapping: refused
    ({0: {0}, 1: {1, 2}}, 3, 1)])                # unequal: refused
def test_group_blocks_matches_the_jax_loader(blocks, n_blk, pi):
    from nvme_strom_tpu.data.loader import _group_blocks as jax_groups
    from nvme_strom_tpu_torch.data.loader import _group_blocks
    try:
        want = jax_groups(blocks, n_blk, pi, "dp")
    except ValueError:
        with pytest.raises(ValueError, match="tile"):
            _group_blocks(blocks, n_blk, pi, "dp")
        return
    assert _group_blocks(blocks, n_blk, pi, "dp") == want


def test_loader_processes_match_the_jax_loader(setup):
    """Two processes: each port rank's rows are the JAX loader's rows for
    that process index (``test_loader.py:141``'s simulation)."""
    _, res = setup["res"][2]
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("dp", "tp"))
    for pi in range(2):
        with JaxLoader(setup["wds"], mesh, global_batch=8, fmt="wds",
                       process_index=pi, process_count=2) as dl:
            want = [bytes(r.tobytes()) for hb in dl._host_batches()
                    for r in hb]
        assert res[pi]["loader"]["wds_dp"][0] == want


def _assembled(res, key="trainer"):
    out = {}
    for name in res[0][key]["shapes"]:
        out[name] = _torch_dist.assemble([r[key] for r in res], name)
    return out


def test_checkpoint_restores_under_another_mesh(setup, world):
    """The trainer's dp × tp checkpoint resumes under dp over every rank:
    each rank gets every tensor whole, bitwise, moments included."""
    _, res = setup["res"][world]
    whole = _assembled(res)
    for r in res:
        assert r["resumed_dp"]["step"] == 3
        for name, w in whole.items():
            np.testing.assert_array_equal(r["resumed_dp"]["params"][name],
                                          w, err_msg=name)
    for name in whole:
        parts = [dict(slices={name: (r["trainer"]["slices"][name][0],
                                     r["trainer"]["moments"][name])},
                      shapes=r["trainer"]["shapes"]) for r in res]
        np.testing.assert_array_equal(res[0]["resumed_dp"]["exp_avg"][name],
                                      _torch_dist.assemble(parts, name))


def test_multi_rank_save_restores_in_one_process(setup, world):
    """Both packages' managers restore the ranks' tiles in one process,
    bitwise (steps 2: the synchronous save; 3: the collective-free one)."""
    d, res = setup["res"][world]
    whole = _assembled(res)
    ck = str(d / "ckpt")
    with open(os.path.join(ck, "step_00000003", "meta.json")) as f:
        meta = json.load(f)
    assert meta["process_count"] == world
    assert {t["file"] for t in meta["tensors"]["0|layers.0.wq"]["tiles"]} \
        == {f"state-{r:05d}.safetensors" for r in range(0, 2)}
    for step in (2, 3):
        flat = CheckpointManager(ck).restore(step=step)
        for name, w in whole.items():
            np.testing.assert_array_equal(flat[f"0|{name}"].numpy(), w)
    target = ({n: np.zeros_like(w) for n, w in whole.items()},
              {"exp_avg": {n: np.zeros_like(w) for n, w in whole.items()},
               "exp_avg_sq": {n: np.zeros_like(w)
                              for n, w in whole.items()},
               "step": {n: np.zeros((), np.float32) for n in whole}})
    got = JaxManager(ck).restore(target, step=3)
    for name, w in whole.items():
        np.testing.assert_array_equal(got[0][name], w, err_msg=name)
        assert float(got[1]["step"][name]) == 2.0


def test_scatter_restore_across_processes(setup, world):
    """The trainer's checkpoint read once across the ranks (each its own
    share, ≤ payload / N + one unit a file, the rest received) and
    restored to every rank's slices bitwise."""
    d, res = setup["res"][world]
    whole = _assembled(res)
    step = d / "ckpt" / "step_00000003"
    files = [f for f in os.listdir(step) if f.endswith(".safetensors")]
    payload = sum(os.path.getsize(step / f) for f in files)
    for r in res:
        got = r["scatter_restore"]
        assert got["fallbacks"] == 0
        assert 0 < got["share"] <= payload / world + len(files) * 4096
        assert got["share"] + got["received"] == payload
        for name, (bounds, local) in got["slices"].items():
            np.testing.assert_array_equal(
                local, whole[name][tuple(slice(a, b) for a, b in bounds)])


@pytest.mark.parametrize("fault", ["share_read", "exchange"])
def test_scatter_faults_across_processes(setup, world, fault):
    """A share read failing on one rank browns every rank out to the
    read-all path, whose tensors are bitwise the file's; a fault of the
    exchange itself fails the load on every rank with ``ExchangeError``
    and counts no brown-out."""
    for r in setup["res"][world][1]:
        r = r["faults"]
        if fault == "share_read":
            got = r["read"]
            assert got["fallbacks"] == 1 and got["ici_bytes_read"] == 0
            for name, t in got["tensors"].items():
                np.testing.assert_array_equal(t, setup["full"][name],
                                              err_msg=name)
        else:
            assert "injected exchange fault" in r["exchange"], r
            assert r["exchange_fallbacks"] == 0


def test_jax_mesh_checkpoint_restores_per_rank(setup, world):
    """A JAX save from a dp × tp mesh of 8 devices: each port rank reads
    its own slices of it, bitwise."""
    _, res = setup["res"][world]
    _exact([r["jax_restore"] for r in res], setup["full"])


def test_moment_files_are_per_process(setup, world, monkeypatch):
    """Each rank keeps its slices' moments in ``moments-{rank:05d}``;
    they resume (and the JAX package resumes them, and the port resumes
    the JAX package's), they hold a one-process run's moments sliced,
    and one dirty manifest makes every process refuse."""
    d, res = setup["res"][world]
    cfg, full = setup["cfg"], setup["full"]
    path = str(d / "moments")
    assert sorted(f for f in os.listdir(path) if f.endswith(".bin")) == \
        [f"moments-{r:05d}.bin" for r in range(world)]
    for r in res:
        assert r["moments"]["resumed"] == 2
        assert r["moments"]["jax_step"] == 0
        assert r["moments"]["refused"] is not None
    assert setup["jax_steps"][world] == [0] * world
    # the one-process run on the whole tensors, then each file's slices
    one = str(d / "one")
    params = ttr.trainable_params(full, "cpu")
    grads = {n: torch.from_numpy(g) for n, g in setup["grads"].items()}
    with OffloadedAdam(one, params, lr=1e-3, weight_decay=1e-4) as opt:
        for _ in range(2):
            opt.update(params, grads)
    with open(os.path.join(one, "moments.json")) as f:
        lay = json.load(f)["leaves"]
    whole = np.fromfile(os.path.join(one, "moments.bin"), np.uint8)
    for rank, r in enumerate(res):
        for name, (bounds, local) in r["moments"]["params"].items():
            want = params[name].detach().numpy()[
                tuple(slice(a, b) for a, b in bounds)]
            np.testing.assert_allclose(local, want, rtol=1e-6, atol=1e-7)
        with open(os.path.join(path, f"moments-{rank:05d}.json")) as f:
            mine = json.load(f)["leaves"]
        data = np.fromfile(os.path.join(path, f"moments-{rank:05d}.bin"),
                           np.uint8)
        key = "['layers.0.wq']"
        pc = mine[key]["pieces"][0]
        m = data[pc["off_m"]:pc["off_m"] + pc["nbytes"]].view(np.float32)
        d0 = lay[key]
        mw = whole[d0["off_m"]:d0["off_m"] + d0["nbytes"]].view(
            np.float32).reshape(d0["shape"])
        np.testing.assert_allclose(
            m.reshape(pc["shape"]),
            mw[tuple(slice(a, b) for a, b in pc["key"])],
            rtol=1e-6, atol=1e-9)
    # the JAX package resumes the port's files (as each process in turn)
    with open(os.path.join(path, "moments-00001.json")) as f:
        m1 = json.load(f)
    m1["dirty"] = False
    with open(os.path.join(path, "moments-00001.json"), "w") as f:
        json.dump(m1, f)
    assert _jax_moment_files(path, world, cfg, full, monkeypatch) == \
        [2] * world


def test_marker_crash_leaves_the_previous_step(setup):
    """``ckpt.marker``: rank 0 dies once its done marker is durable, so
    nothing commits; rank 1 times out waiting for the commit and the
    previous step restores."""
    crash, res = setup["crash"]
    assert res[0] is None
    assert "never published" in res[1]["error"]
    ck = str(crash / "ckpt")
    mgr = CheckpointManager(ck)
    assert mgr.all_steps() == [1]
    tmp = os.path.join(ck, ".tmp_step_00000002")
    assert sorted(f for f in os.listdir(tmp) if f.startswith("done-")) == \
        ["done-00000.json", "done-00001.json"]
    np.testing.assert_array_equal(mgr.restore()["w"].numpy(),
                                  np.arange(8, dtype=np.float32))
