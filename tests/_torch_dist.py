"""Multi-process helpers of the port's CPU tests (no JAX here: the
workers import torch and the port only).

:func:`run` starts ``world`` worker processes, each joining a gloo group
through a ``file://`` store under the test's temporary directory (no TCP
port, so parallel test workers never collide), runs one job function of
this module with the pickled payload, and returns every rank's pickled
result.  The parent waits at most ``timeout`` seconds: on expiry it
kills every worker and fails, so a dead rank never hangs the suite; any
rank's non-zero exit fails it with that rank's log.  The ranks compute
on the CPU over gloo unless ``STROM_TEST_DEVICE`` (``RANK`` in it is
the rank: ``cuda:RANK``) and ``STROM_TEST_BACKEND`` say otherwise (the
card tests of tests/test_torch_cuda.py).
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

_CHILD = """
import pickle, sys
import torch
torch.set_num_threads(1)
import _torch_dist as jobs
from nvme_strom_tpu_torch.parallel.mesh import (init_distributed,
                                                shutdown_distributed)
job, rank, world, store, inp, out = sys.argv[1:]
rank, world = int(rank), int(world)
import os
device = os.environ.get("STROM_TEST_DEVICE", "cpu").replace(
    "RANK", str(rank))
init_distributed("file://" + store, world, rank,
                 backend=os.environ.get("STROM_TEST_BACKEND", "gloo"),
                 device=device, timeout_s=60)
with open(inp, "rb") as f:
    payload = pickle.load(f)
res = getattr(jobs, job)(rank, world, payload)
with open(out, "wb") as f:
    pickle.dump(res, f)
shutdown_distributed()
"""


def run(job: str, world: int, tmp, payload=None, timeout: float = 120.0,
        env=None) -> list:
    """Every rank's result of ``job(rank, world, payload)``."""
    return collect(start(job, world, tmp, payload, timeout, env))


def start(job: str, world: int, tmp, payload=None, timeout: float = 120.0,
          env=None) -> tuple:
    """Launch the ranks of ``job`` without waiting (:func:`collect`
    waits), so several spawns can run at once."""
    tmp = str(tmp)
    inp = os.path.join(tmp, f"{job}.{world}.in.pkl")
    with open(inp, "wb") as f:
        pickle.dump(payload, f)
    store = os.path.join(tmp, f"{job}.{world}.store")
    penv = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                PYTHONPATH=os.pathsep.join([REPO, HERE]))
    penv.update(env or {})
    procs, outs, logs = [], [], []
    for r in range(world):
        out = os.path.join(tmp, f"{job}.{world}.{r}.out.pkl")
        log = os.path.join(tmp, f"{job}.{world}.{r}.log")
        outs.append(out)
        logs.append(log)
        with open(log, "w") as lf:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _CHILD, job, str(r), str(world),
                 store, inp, out], env=penv, stdout=lf,
                stderr=subprocess.STDOUT, cwd=tmp))
    return job, procs, outs, logs, time.monotonic() + timeout, timeout


def collect(handle, exit_codes=None) -> list:
    """Every rank's result of a :func:`start`; kills them all and fails
    past the join limit or when a rank fails.  ``exit_codes`` ({rank:
    code}) expects a rank to die with that code (its result is None)."""
    job, procs, outs, logs, deadline, timeout = handle
    exit_codes = exit_codes or {}
    try:
        for p in procs:
            left = deadline - time.monotonic()
            try:
                p.wait(timeout=max(left, 0.01))
            except subprocess.TimeoutExpired:
                raise AssertionError(
                    f"{job}: a rank outlived the {timeout:.0f} s join "
                    "limit\n" + _tails(logs)) from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [r for r, p in enumerate(procs)
           if p.returncode != exit_codes.get(r, 0)]
    if bad:
        raise AssertionError(f"{job}: ranks {bad} failed\n" + _tails(logs))
    res = []
    for r, out in enumerate(outs):
        if r in exit_codes:
            res.append(None)
            continue
        with open(out, "rb") as f:
            res.append(pickle.load(f))
    return res


def _tails(logs) -> str:
    parts = []
    for r, log in enumerate(logs):
        try:
            with open(log) as f:
                text = f.read()[-3000:]
        except OSError:
            text = "(no log)"
        parts.append(f"--- rank {r} ---\n{text}")
    return "\n".join(parts)


def assemble(per_rank: list, name: str) -> np.ndarray:
    """The whole tensor ``name`` from every rank's ``(bounds, local)``
    (a rank's ``{"slices": {name: (bounds, array)}, "shape": {...}}``)."""
    shape = per_rank[0]["shapes"][name]
    out = np.full(shape, np.nan, np.float32)
    for res in per_rank:
        bounds, local = res["slices"][name]
        out[tuple(slice(a, b) for a, b in bounds)] = local
    assert not np.isnan(out).any(), f"{name}: ranks leave a hole"
    return out


# -- jobs: the model (tests/test_torch_multigpu.py) ---------------------------

def _cfg(kind, fields):
    import torch
    if kind == "vit":
        from nvme_strom_tpu_torch.models.vit import ViTConfig
        return ViTConfig(**fields, dtype=torch.float32)
    from nvme_strom_tpu_torch.models.transformer import TransformerConfig
    return TransformerConfig(**fields, dtype=torch.float32)


def _slices(params, shardings, shapes):
    return {n: (shardings[n].local_bounds(shapes[n]),
                p.detach().numpy().copy()) for n, p in params.items()}


def model_cases(rank: int, world: int, cases: list) -> dict:
    """Each case's result under its mesh, keyed by the case's name."""
    import torch
    from nvme_strom_tpu_torch.models import decode as tdec
    from nvme_strom_tpu_torch.models import transformer as ttr
    from nvme_strom_tpu_torch.models import vit as tvit
    from nvme_strom_tpu_torch.parallel import collectives as coll
    from nvme_strom_tpu_torch.parallel.mesh import make_mesh
    from nvme_strom_tpu_torch.parallel.shardings import (local_slice,
                                                         param_shardings,
                                                         shard_params)
    out = {}
    meshes = {}
    for case in cases:
        key = tuple(case["axes"].items())
        if key not in meshes:
            meshes[key] = make_mesh(case["axes"])
        mesh = meshes[key]
        cfg = _cfg(case.get("model", "lm"), case["cfg"])
        full = case["params"]
        kind = case["kind"]
        if kind == "vit_train":
            sh = tvit.vit_param_shardings(cfg, mesh)
            shapes = {n: a.shape for n, a in full.items()}
            params = ttr.trainable_params(
                shard_params(full, cfg, mesh, shardings=sh), "cpu")
            step = tvit.make_vit_train_step(cfg, ttr.adamw(params, 1e-3),
                                            mesh=mesh)
            images = local_slice(torch.from_numpy(case["images"]), mesh)
            labels = local_slice(torch.from_numpy(case["labels"]), mesh)
            with coll.use_mesh(mesh):
                logits = tvit.vit_forward(params, images, cfg)
            losses = [float(step(params, images, labels))
                      for _ in range(case["steps"])]
            out[case["name"]] = {"losses": losses, "shapes": shapes,
                                 "logits": logits.detach().numpy(),
                                 "slices": _slices(params, sh, shapes)}
            continue
        sh = param_shardings(cfg, mesh)
        shapes = ttr.param_shapes(cfg)
        params = ttr.trainable_params(
            shard_params(full, cfg, mesh, shardings=sh), "cpu")
        tokens = torch.from_numpy(case["tokens"])
        if kind == "train":
            step = ttr.make_train_step(
                cfg, ttr.adamw(params, case["lr"]), mesh=mesh,
                shardings=sh, grad_clip=case.get("grad_clip", 0.0))
            mine = local_slice(tokens, mesh)
            losses = [float(step(params, mine))
                      for _ in range(case["steps"])]
            out[case["name"]] = {"losses": losses, "shapes": shapes,
                                 "slices": _slices(params, sh, shapes)}
        elif kind == "loss":
            mine = local_slice(tokens, mesh)
            with coll.use_mesh(mesh):
                loss = ttr.loss_fn(params, mine, cfg)
                names = list(params)
                grads = torch.autograd.grad(loss, [params[n]
                                                   for n in names])
            loss = loss.detach().reshape(1).clone()
            grads = list(grads)
            coll.dp_mean_(grads + [loss], mesh.group("dp"))
            out[case["name"]] = {
                "loss": float(loss[0]), "shapes": shapes,
                "slices": {n: (sh[n].local_bounds(shapes[n]),
                               g.numpy().copy())
                           for n, g in zip(names, grads)}}
        elif kind == "generate":
            from nvme_strom_tpu_torch.ops.decode_attention import (
                decode_attention)
            mine = local_slice(tokens, mesh)
            with coll.use_mesh(mesh), torch.no_grad():
                got = tdec.generate(
                    {n: p.detach() for n, p in params.items()}, mine, cfg,
                    case["new"],
                    cache_attn=decode_attention if case.get("kernel")
                    else None)
                logits = ttr.forward(params, mine, cfg)
            out[case["name"]] = {"tokens": got.numpy(),
                                 "logits": logits.numpy(),
                                 "rows": _rows(mesh, tokens.shape[0])}
        else:
            raise ValueError(kind)
    return out


def quant_cases(rank: int, world: int, cases: list) -> dict:
    """Each case's quantized forward (tests/test_torch_quant_shards.py):
    the whole quantized params cut by ``shard_params`` for this rank of
    the case's mesh, logits of the whole batch under ``use_mesh``."""
    import torch
    from nvme_strom_tpu_torch.models import transformer as ttr
    from nvme_strom_tpu_torch.parallel import collectives as coll
    from nvme_strom_tpu_torch.parallel.mesh import make_mesh
    from nvme_strom_tpu_torch.parallel.shardings import shard_params
    out = {}
    for case in cases:
        mesh = make_mesh(case["axes"])
        cfg = _cfg("lm", case["cfg"])
        params = shard_params(case["params"], cfg, mesh, device="cpu")
        with coll.use_mesh(mesh), torch.no_grad():
            logits = ttr.forward(params, torch.from_numpy(case["tokens"]),
                                 cfg)
        out[case["name"]] = logits.numpy()
    return out


def _rows(mesh, batch: int) -> tuple:
    dp = mesh.shape.get("dp", 1)
    i = mesh.coords.get("dp", 0)
    return (i * batch // dp, (i + 1) * batch // dp)


# -- jobs: the sharded I/O (tests/test_torch_multigpu_io.py) ------------------

def _engine():
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.utils.config import EngineConfig
    from nvme_strom_tpu_torch.utils.stats import StromStats
    return StromEngine(EngineConfig(chunk_bytes=64 << 10, queue_depth=8,
                                    buffer_pool_bytes=2 << 20),
                       stats=StromStats())


def _nvme_bytes(eng) -> int:
    eng.sync_stats()
    return int(eng.stats.bytes_direct + eng.stats.bytes_fallback)


def io_cases(rank: int, world: int, p: dict) -> dict:
    """load_sharded, the loader, the checkpoint, the moment files and
    the exchange under ``world`` ranks (payload: the parent's paths)."""
    import os
    import torch
    from nvme_strom_tpu_torch.checkpoint.manager import CheckpointManager
    from nvme_strom_tpu_torch.data.loader import ShardedLoader
    from nvme_strom_tpu_torch.models import transformer as ttr
    from nvme_strom_tpu_torch.parallel.mesh import barrier, make_mesh
    from nvme_strom_tpu_torch.parallel.opt_offload import OffloadedAdam
    from nvme_strom_tpu_torch.parallel.shardings import (
        Shard, Sharding, P, param_shardings, shard_params)
    from nvme_strom_tpu_torch.parallel.weights import LazyCheckpoint
    from nvme_strom_tpu_torch.train import Trainer

    out: dict = {}
    cfg = _cfg("lm", p["cfg"])
    shapes = ttr.param_shapes(cfg)
    tp_mesh = make_mesh({"dp": world // 2, "tp": 2})
    dp_mesh = make_mesh({"dp": world})
    sh = param_shardings(cfg, tp_mesh)

    # -- load_sharded, read-all and read-once scatter
    for mode in ("direct", "scatter"):
        eng = _engine()
        os.environ["STROM_ICI_SCATTER"] = "1" if mode == "scatter" else "0"
        os.environ["STROM_ICI_UNIT_BYTES"] = "4096"
        try:
            got = LazyCheckpoint(p["weights"]).load_sharded(
                sh, engine=eng, device="cpu")
        finally:
            os.environ["STROM_ICI_SCATTER"] = "0"
        eng.sync_stats()
        out["load_" + mode] = {
            "slices": {n: (sh[n].local_bounds(shapes[n]), t.numpy())
                       for n, t in got.items()},
            "nvme_bytes": _nvme_bytes(eng),
            "ici_bytes_read": int(eng.stats.ici_bytes_read),
            "ici_bytes_received": int(eng.stats.ici_bytes_received),
            "ici_fallbacks": int(eng.stats.ici_fallbacks)}
        eng.close_all()

    # the cold-start front end with this rank's slices, demand-faulted
    from nvme_strom_tpu_torch.parallel.weights import FaultingCheckpoint
    fc = FaultingCheckpoint(p["weights"], device="cpu", engine=_engine(),
                            shardings=sh)
    try:
        out["faulting"] = {n: (sh[n].local_bounds(shapes[n]), t.numpy())
                           for n, t in fc.materialize().items()}
    finally:
        fc.close()

    # STROM_VERIFY on the sharded load: whole row spans are checked
    eng = _engine()
    os.environ["STROM_VERIFY"] = "full"
    try:
        LazyCheckpoint(p["weights"]).load_sharded(sh, engine=eng,
                                                  device="cpu")
    finally:
        os.environ.pop("STROM_VERIFY")
    out["verify"] = {"bytes_verified": int(eng.stats.bytes_verified),
                     "checksum_failures": int(eng.stats.checksum_failures)}
    eng.close_all()
    # a warm start through load_sharded
    with Trainer(cfg, init_weights=p["weights"], mesh=tp_mesh,
                 device="cpu", engine=_engine()) as tw:
        out["warm"] = {n: (sh[n].local_bounds(shapes[n]),
                           t.detach().numpy())
                       for n, t in tw.params.items()}

    # -- the loader: each dp group its own rows; tp peers the same rows
    def rows(mesh, fmt, paths):
        kw = {} if fmt not in ("wds", "tfrecord") else {
            "decode": lambda parts: np.frombuffer(
                next(iter(parts.values())), np.uint8)}
        with ShardedLoader(paths, 8, fmt=fmt, device="cpu", mesh=mesh,
                           **kw) as dl:
            return [bytes(r.numpy().tobytes()) for b in dl for r in b], \
                dl.local_batch
    out["loader"] = {
        "tfrecord_dp": rows(dp_mesh, "tfrecord", p["tfrecord"]),
        "wds_dp": rows(dp_mesh, "wds", p["wds"]),
        "wds_tp": rows(tp_mesh, "wds", p["wds"]),
        "fixedrec_dp": rows(dp_mesh, "fixedrec", p["fixedrec"]),
        "wds_raw_dp": rows(dp_mesh, "wds_raw", p["wds"])}

    # -- checkpoint: the trainer's tiles, sync and collective-free saves
    ck = p["ckpt"]
    with Trainer(cfg, ckpt_dir=ck, mesh=tp_mesh, device="cpu",
                 engine=_engine(), seed=1) as tr:
        tokens = torch.from_numpy(p["tokens"])
        from nvme_strom_tpu_torch.parallel.shardings import local_slice
        tr.fit(iter([local_slice(tokens, tp_mesh)] * 2), steps=2)
        tr.manager.save_async(3, tr.state()).result()
        saved = {n: (sh[n].local_bounds(shapes[n]),
                     t.detach().numpy().copy())
                 for n, t in tr.params.items()}
        moments = {n: tr.optimizer.state[t]["exp_avg"].numpy().copy()
                   for n, t in tr.params.items()}
    out["trainer"] = {"slices": saved, "shapes": shapes,
                      "moments": moments}
    # under another mesh (dp over every rank): each rank reads it whole
    with Trainer(cfg, ckpt_dir=ck, mesh=dp_mesh, device="cpu",
                 engine=_engine()) as tr2:
        out["resumed_dp"] = {
            "step": tr2.resumed_from,
            "params": {n: t.detach().numpy() for n, t in
                       tr2.params.items()},
            "exp_avg": {n: tr2.optimizer.state[t]["exp_avg"].numpy()
                        for n, t in tr2.params.items()}}
    # the read-once restore of that checkpoint, one rank a process
    eng = _engine()
    os.environ["STROM_ICI_SCATTER"] = "1"
    try:
        back = CheckpointManager(ck, engine=eng).restore(
            {f"0|{n}": Shard(torch.empty(sh[n].local_shape(shapes[n])),
                             sh[n], shapes[n]) for n in shapes}, step=3)
    finally:
        os.environ["STROM_ICI_SCATTER"] = "0"
    out["scatter_restore"] = {
        "slices": {n: (sh[n].local_bounds(shapes[n]),
                       back[f"0|{n}"].numpy()) for n in shapes},
        "share": int(eng.stats.ici_bytes_read),
        "received": int(eng.stats.ici_bytes_received),
        "fallbacks": int(eng.stats.ici_fallbacks)}
    eng.close_all()
    # a JAX-written mesh checkpoint, each rank reading its slices
    mgr = CheckpointManager(p["jax_ckpt"])
    target = {n: Shard(torch.empty(sh[n].local_shape(shapes[n])), sh[n],
                       shapes[n]) for n in shapes}
    got = mgr.restore(target, device="cpu")
    out["jax_restore"] = {n: (sh[n].local_bounds(shapes[n]), t.numpy())
                          for n, t in got.items()}

    # -- per-process moment files
    params = ttr.trainable_params(shard_params(p["params"], cfg, tp_mesh,
                                               shardings=sh), "cpu")
    grads = shard_params(p["grads"], cfg, tp_mesh, shardings=sh)
    with OffloadedAdam(p["moments"], params, lr=1e-3, weight_decay=1e-4,
                       engine=_engine(), shardings=sh) as opt:
        for _ in range(2):
            opt.update(params, {n: torch.from_numpy(g.numpy())
                                for n, g in grads.items()})
    with OffloadedAdam(p["moments"], params, lr=1e-3, weight_decay=1e-4,
                       engine=_engine(), shardings=sh) as opt:
        resumed = opt.step
    with OffloadedAdam(p["jax_moments"], params, lr=1e-3,
                       weight_decay=1e-4, engine=_engine(),
                       shardings=sh) as opt:
        jax_step = opt.step
    barrier()
    if rank == 1:           # one process's manifest dirty: all refuse
        import json
        path = os.path.join(p["moments"], "moments-00001.json")
        with open(path) as f:
            m = json.load(f)
        m["dirty"] = True
        with open(path, "w") as f:
            json.dump(m, f)
    barrier()
    try:
        OffloadedAdam(p["moments"], params, lr=1e-3, engine=_engine(),
                      shardings=sh).close()
        refused = None
    except ValueError as e:
        refused = str(e)
    out["moments"] = {"params": {n: (sh[n].local_bounds(shapes[n]),
                                     t.detach().numpy())
                                 for n, t in params.items()},
                      "resumed": resumed, "jax_step": jax_step,
                      "refused": refused}
    out["faults"] = scatter_faults(rank, world, p)
    return out


def marker_crash(rank: int, world: int, p: dict) -> dict:
    """A collective-free save whose rank 0 dies once its done marker is
    durable (``ckpt.marker``): the step is never committed."""
    import os
    import torch
    from nvme_strom_tpu_torch.checkpoint.manager import CheckpointManager
    mgr = CheckpointManager(p["ckpt"])
    state = {"w": torch.arange(8, dtype=torch.float32) + rank}
    mgr.save(1, {"w": torch.arange(8, dtype=torch.float32)})
    if rank == 0:
        os.environ["STROM_CRASH_POINT"] = "ckpt.marker"
    os.environ["STROM_CKPT_WAIT_S"] = "3"
    try:
        mgr.save_async(2, state).result()
        return {"error": None}
    except TimeoutError as e:
        return {"error": str(e)}


# -- jobs: sequence and pipeline parallelism (tests/test_torch_seqpar.py,
# tests/test_torch_pipeline.py) -----------------------------------------------

def _bhsd_sharding(mesh):
    """(b, h, s, d) attention blocks: batch over dp, heads over tp, the
    sequence over sp."""
    from nvme_strom_tpu_torch.parallel.shardings import P, Sharding
    return Sharding(mesh, P("dp", "tp", "sp", None))


def _attn_fn(kind, mesh, device=None):
    from nvme_strom_tpu_torch.ops.flash_attention import make_flash_attn
    from nvme_strom_tpu_torch.parallel.ring_attention import make_ring_attn
    from nvme_strom_tpu_torch.parallel.ulysses import make_ulysses_attn
    if kind is None:
        return None
    if kind.startswith("ring"):
        return make_ring_attn(mesh, inner=kind.split("_")[1])
    return make_ulysses_attn(
        mesh, attn=make_flash_attn() if kind == "ulysses_flash" else None)


def seqpar_cases(rank: int, world: int, cases: list) -> dict:
    """Each case's result under its mesh (ring and Ulysses attention,
    the model under sp), keyed by the case's name."""
    import torch
    from nvme_strom_tpu_torch.models import transformer as ttr
    from nvme_strom_tpu_torch.parallel import collectives as coll
    from nvme_strom_tpu_torch.parallel.mesh import make_mesh
    from nvme_strom_tpu_torch.parallel.ring_attention import ring_attention
    from nvme_strom_tpu_torch.parallel.shardings import (local_slice,
                                                         param_shardings,
                                                         shard_params)
    from nvme_strom_tpu_torch.parallel.ulysses import ulysses_attention
    from nvme_strom_tpu_torch.ops.flash_attention import make_flash_attn
    out = {}
    meshes = {}
    for case in cases:
        key = tuple(case["axes"].items())
        if key not in meshes:
            meshes[key] = make_mesh(case["axes"])
        mesh = meshes[key]
        kind = case["kind"]
        if kind == "attn":
            sh = _bhsd_sharding(mesh)
            shape = case["q"].shape
            cut = tuple(slice(a, b) for a, b in sh.local_bounds(shape))
            qkv = [torch.from_numpy(case[n][cut]).requires_grad_()
                   for n in "qkv"]
            if case["impl"] == "ring":
                o = ring_attention(*qkv, mesh, causal=case["causal"],
                                   inner=case["inner"])
            else:
                o = ulysses_attention(
                    *qkv, mesh, attn=make_flash_attn()
                    if case["inner"] == "flash" else None)
            res = {"shapes": {n: shape for n in "oqkv"},
                   "slices": {"o": (sh.local_bounds(shape),
                                    o.detach().numpy())}}
            if case.get("grad"):
                gs = torch.autograd.grad((o.float() ** 2).sum(), qkv)
                for n, g in zip("qkv", gs):
                    res["slices"][n] = (sh.local_bounds(shape), g.numpy())
            out[case["name"]] = res
            continue
        cfg = _cfg("lm", case["cfg"])
        sh = param_shardings(cfg, mesh)
        shapes = ttr.param_shapes(cfg)
        params = ttr.trainable_params(
            shard_params(case["params"], cfg, mesh, shardings=sh), "cpu")
        tokens = torch.from_numpy(case["tokens"])
        mine = local_slice(tokens, mesh, seq_axis="sp")
        attn = _attn_fn(case.get("attn"), mesh)
        if kind == "forward":
            with coll.use_mesh(mesh), torch.no_grad():
                logits = ttr.forward(params, mine, cfg, attn)
            bounds = _sharding_2d(mesh).local_bounds(tokens.shape)
            out[case["name"]] = {"logits": logits.numpy(),
                                 "bounds": bounds}
        elif kind == "loss":
            with coll.use_mesh(mesh):
                loss, grads = ttr.value_and_grad(params, mine, cfg, attn)
            loss = loss.reshape(1).clone()
            names = list(grads)
            gl = [grads[n] for n in names]
            coll.mesh_mean_(gl + [loss], mesh)
            out[case["name"]] = {
                "loss": float(loss[0]), "shapes": shapes,
                "slices": {n: (sh[n].local_bounds(shapes[n]),
                               g.numpy().copy())
                           for n, g in zip(names, gl)}}
        elif kind == "train":
            step = ttr.make_train_step(
                cfg, ttr.adamw(params, case["lr"]), attn_fn=attn,
                mesh=mesh, shardings=sh,
                grad_clip=case.get("grad_clip", 0.0))
            losses = [float(step(params, mine))
                      for _ in range(case["steps"])]
            out[case["name"]] = {"losses": losses, "shapes": shapes,
                                 "slices": _slices(params, sh, shapes)}
        else:
            raise ValueError(kind)
    return out


def _sharding_2d(mesh):
    """(batch, seq): rows over dp, the sequence over sp where the mesh
    has it."""
    from nvme_strom_tpu_torch.parallel.mesh import batch_sharding
    return batch_sharding(mesh, "dp", "sp" if "sp" in mesh.shape else None)


def pipeline_cases(rank: int, world: int, cases: list) -> dict:
    """Each case's pipelined loss, gradients or train-step losses under
    its mesh, keyed by the case's name."""
    import torch
    from nvme_strom_tpu_torch.models import transformer as ttr
    from nvme_strom_tpu_torch.parallel import pipeline as pp
    from nvme_strom_tpu_torch.parallel.mesh import make_mesh
    from nvme_strom_tpu_torch.parallel.shardings import local_slice
    out = {}
    meshes = {}
    for case in cases:
        key = tuple(case["axes"].items())
        if key not in meshes:
            meshes[key] = make_mesh(case["axes"])
        mesh = meshes[key]
        cfg = _cfg("lm", case["cfg"])
        stack, rest = pp.split_layer_stack(case["params"], cfg)
        shapes = {n: t.shape for n, t in pp.named_leaves(stack)}
        shs = dict(pp.named_leaves(pp.stacked_shardings(mesh, cfg)))
        stack = pp.shard_stack(stack, mesh, cfg)
        stack = pp.from_leaves(stack, {
            n: t.requires_grad_() for n, t in pp.named_leaves(stack)})
        rest = ttr.trainable_params(rest, "cpu")
        seq = "sp" if "sp" in mesh.shape else None
        mine = local_slice(torch.from_numpy(case["tokens"]), mesh,
                           seq_axis=seq)
        n_mb = case["n_mb"]
        res = {}
        if case["kind"] == "loss":
            res["loss"] = float(pp.make_pp_loss(cfg, mesh, n_mb)(
                stack, rest, mine))
            logits, aux = pp.make_pp_forward_with_aux(cfg, mesh, n_mb)(
                stack, rest, mine)
            res["aux"] = float(aux)
            res["logits"] = logits.numpy()
            res["bounds"] = _sharding_2d(mesh).local_bounds(
                case["tokens"].shape)
        elif case["kind"] == "grad":
            loss, g_stack, g_rest = pp.make_pp_value_and_grad(
                cfg, mesh, n_mb)(stack, rest, mine)
            res["loss"] = float(loss)
            res["shapes"] = shapes
            res["slices"] = {n: (shs[n].local_bounds(shapes[n]),
                                 g.numpy().copy())
                             for n, g in pp.named_leaves(g_stack)}
            res["rest"] = {n: g.numpy() for n, g in g_rest.items()}
        else:
            opt = ttr.adamw(pp.pp_parameters(stack, rest), case["lr"])
            step = pp.make_pp_train_step(cfg, opt, mesh, n_mb)
            res["losses"] = [float(step(stack, rest, mine))
                             for _ in range(case["steps"])]
        out[case["name"]] = res
    return out


# -- jobs: on the card (tests/test_torch_cuda.py) -----------------------------

def cuda_refuse(rank: int, world: int, p: dict) -> dict:
    """Two ranks on one card: the error ProcessExchange raises, and what
    a read-once ``load_sharded`` and checkpoint restore do (they must
    raise it too, with no brown-out counted)."""
    import os
    import torch
    from nvme_strom_tpu_torch.checkpoint.manager import CheckpointManager
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.models import transformer as ttr
    from nvme_strom_tpu_torch.ops.ici import ExchangeError, ProcessExchange
    from nvme_strom_tpu_torch.parallel.mesh import make_mesh
    from nvme_strom_tpu_torch.parallel.shardings import Shard, param_shardings
    from nvme_strom_tpu_torch.parallel.weights import LazyCheckpoint
    out = {}
    try:
        ProcessExchange()
        out["exchange"] = ""
    except ExchangeError as e:
        out["exchange"] = str(e)
    cfg = ttr.tiny_config()
    sh = param_shardings(cfg, make_mesh({"tp": world}))
    shapes = ttr.param_shapes(cfg)
    with StromEngine() as eng:
        got = LazyCheckpoint(p["weights"]).load_sharded(sh, engine=eng)
        mgr = CheckpointManager(p["ckpt"], engine=eng)
        mgr.save(1, {n: Shard(t, sh[n], shapes[n]) for n, t in got.items()})
        os.environ["STROM_ICI_SCATTER"] = "1"
        for name, fn in (
                ("load_sharded", lambda: LazyCheckpoint(
                    p["weights"]).load_sharded(sh, engine=eng)),
                ("restore", lambda: mgr.restore(
                    {n: Shard(torch.empty_like(t), sh[n], shapes[n])
                     for n, t in got.items()}))):
            try:
                fn()
                out[name] = ""
            except ExchangeError as e:
                out[name] = str(e)
        os.environ["STROM_ICI_SCATTER"] = "0"
        out["fallbacks"] = int(eng.stats.snapshot()["ici_fallbacks"])
    return out


def scatter_faults(rank: int, world: int, p: dict) -> dict:
    """The read-once restore across processes under two faults: a share
    read failing on the last rank browns every rank out to the read-all
    path (bitwise all the same); the exchange itself failing raises
    ``ExchangeError`` on every rank with no brown-out counted."""
    import os
    from nvme_strom_tpu_torch.ops import ici
    from nvme_strom_tpu_torch.parallel.weights import LazyCheckpoint
    out = {}
    os.environ["STROM_ICI_SCATTER"] = "1"
    os.environ["STROM_ICI_UNIT_BYTES"] = "4096"
    read_share = ici._read_share

    def failing_read(*args):
        if rank == world - 1:
            raise OSError("injected share read fault")
        return read_share(*args)
    ici._read_share = failing_read
    eng = _engine()
    got = LazyCheckpoint(p["weights"]).load(eng, device="cpu")
    out["read"] = {"tensors": {n: t.numpy() for n, t in got.items()},
                   "fallbacks": int(eng.stats.ici_fallbacks),
                   "ici_bytes_read": int(eng.stats.ici_bytes_read)}
    eng.close_all()
    ici._read_share = read_share

    import torch.distributed as dist
    gather = dist.all_gather

    def failing_gather(*args, **kw):
        raise RuntimeError("injected exchange fault")
    dist.all_gather = failing_gather    # the rows' gather on the CPU
    eng = _engine()
    try:
        LazyCheckpoint(p["weights"]).load(eng, device="cpu")
        out["exchange"] = ""
    except ici.ExchangeError as e:
        out["exchange"] = str(e)
    finally:
        dist.all_gather = gather
    out["exchange_fallbacks"] = int(eng.stats.ici_fallbacks)
    eng.close_all()
    return out


def cuda_exchange(rank: int, world: int, widths) -> dict:
    """Kernel 7 across processes, one rank a card: rows of each width
    (ragged included) three times, every row back bitwise."""
    import torch
    from nvme_strom_tpu_torch.ops.ici import ProcessExchange, ici_ring_gather
    ex = ProcessExchange()
    ok = True
    for w in widths:
        rows = ex.host_rows(w)
        rng = np.random.default_rng(w)
        want = torch.from_numpy(rng.integers(0, 256, (world, w),
                                             dtype=np.uint8))
        rows[rank] = want[rank]
        for _ in range(3):
            got = ex.all_gather(rows)
            ok = ok and bool(torch.equal(got, want))
    ex.close()
    return {"ok": ok, "launches": ici_ring_gather.launches,
            "kernel_ms": ex.last_kernel_ms}


def cuda_load_sharded(rank: int, world: int, p: dict) -> dict:
    """load_sharded onto each rank's card (tp over the ranks): bitwise a
    whole load sliced, nothing bounced; with ``STROM_ICI_SCATTER`` the
    read-once restore across processes of a two-rank checkpoint."""
    import os
    import torch
    from nvme_strom_tpu_torch.checkpoint.manager import CheckpointManager
    from nvme_strom_tpu_torch.io.engine import StromEngine
    from nvme_strom_tpu_torch.models import transformer as ttr
    from nvme_strom_tpu_torch.parallel.mesh import local_device, make_mesh
    from nvme_strom_tpu_torch.parallel.shardings import Shard, param_shardings
    from nvme_strom_tpu_torch.parallel.weights import LazyCheckpoint
    cfg = ttr.tiny_config()
    mesh = make_mesh({"tp": world})
    sh = param_shardings(cfg, mesh)
    dev = local_device()
    with StromEngine() as eng:
        got = LazyCheckpoint(p["weights"]).load_sharded(sh, engine=eng)
        whole = LazyCheckpoint(p["weights"]).load(eng, device=dev)
        eng.sync_stats()
        bounce = eng.stats.bounce_bytes
        equal = all(torch.equal(t, whole[n][tuple(
            slice(a, b) for a, b in sh[n].local_bounds(whole[n].shape))])
            for n, t in got.items())
        out = {"equal": equal, "bounce": int(bounce), "device": str(dev)}
        if p.get("scatter"):
            shapes = ttr.param_shapes(cfg)
            mgr = CheckpointManager(p["ckpt"], engine=eng)
            mgr.save(1, {n: Shard(t, sh[n], shapes[n])
                         for n, t in got.items()})
            os.environ["STROM_ICI_SCATTER"] = "1"
            os.environ["STROM_ICI_UNIT_BYTES"] = "4096"
            before = eng.stats.snapshot()
            back = mgr.restore({n: Shard(torch.empty_like(t), sh[n],
                                         shapes[n])
                                for n, t in got.items()})
            after = eng.stats.snapshot()
            out.update(
                restored=all(torch.equal(back[n], t)
                             for n, t in got.items()),
                share=after["ici_bytes_read"] - before["ici_bytes_read"],
                fallbacks=after["ici_fallbacks"] - before["ici_fallbacks"])
    return out


def cuda_seqpar(rank: int, world: int, p: dict) -> dict:
    """The ring and Ulysses on the flash kernels over ``world`` ranks on
    the card(s): this rank's launches of one call, and its span's
    distance from one rank's bf16 flash over the whole sequence and
    from a float32 run, beside that bf16 output's own distance from
    float32; then a float32 pipelined loss and its one-rank value."""
    import torch
    from nvme_strom_tpu_torch.models import transformer as ttr
    from nvme_strom_tpu_torch.ops import flash_attention as fa
    from nvme_strom_tpu_torch.parallel import pipeline as tpp
    from nvme_strom_tpu_torch.parallel.mesh import local_device, make_mesh
    from nvme_strom_tpu_torch.parallel.ring_attention import make_ring_attn
    from nvme_strom_tpu_torch.parallel.shardings import local_slice
    from nvme_strom_tpu_torch.parallel.ulysses import make_ulysses_attn
    dev = local_device()
    mesh = make_mesh({"sp": world})
    b, h, s, d = p["shape"]
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v, do = (torch.randn((b, h, s, d), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")

    def whole(dt):
        qq, kk, vv = (t.detach().to(dt).clone().requires_grad_()
                      for t in (q, k, v))
        o = fa.flash_attention(qq, kk, vv)
        o.backward(do.to(dt))
        return [o.detach(), qq.grad, kk.grad, vv.grad]
    r16, r32 = whole(torch.bfloat16), whole(torch.float32)
    w = s // world
    cut = slice(rank * w, (rank + 1) * w)
    out = {}
    for name, fn in (("ring", make_ring_attn(mesh, inner="flash")),
                     ("ulysses", make_ulysses_attn(
                         mesh, attn=fa.make_flash_attn()))):
        qs, ks, vs = (t[:, :, cut].detach().clone().requires_grad_()
                      for t in (q, k, v))
        before = [getattr(fa, n).launches for n in names]
        o = fn(qs, ks, vs)
        o.backward(do[:, :, cut])
        torch.cuda.synchronize()
        got = [o.detach(), qs.grad, ks.grad, vs.grad]
        out[name] = {
            "launches": [getattr(fa, n).launches - c
                         for n, c in zip(names, before)],
            "dist": [float((g.float() - a[:, :, cut].float()).abs().max())
                     for g, a in zip(got, r16)],
            "dist32": [float((g.float() - z[:, :, cut]).abs().max())
                       for g, z in zip(got, r32)],
            "floor": [float((a[:, :, cut].float() - z[:, :, cut])
                            .abs().max()) for a, z in zip(r16, r32)]}
    cfg = ttr.TransformerConfig(**{**ttr.tiny_config().__dict__,
                                   "max_seq": 16, "dtype": torch.float32})
    full = ttr.init_params(0, cfg)
    tokens = torch.from_numpy(p["tokens"]).to(dev)
    pmesh = make_mesh({"dp": world // 2, "pp": 2})
    stack, rest = tpp.split_layer_stack(full, cfg)
    stack = tpp.shard_stack(stack, pmesh, cfg, device=dev)
    rest = {n: torch.from_numpy(t).to(dev) for n, t in rest.items()}
    out["pp_loss"] = float(tpp.make_pp_loss(cfg, pmesh, 2)(
        stack, rest, local_slice(tokens, pmesh)))
    with torch.no_grad():
        out["one_rank_loss"] = float(ttr.loss_fn(
            {n: torch.from_numpy(t).to(dev) for n, t in full.items()},
            tokens, cfg))
    return out


def entry_points(rank: int, world: int, p: dict) -> dict:
    """``train_lm.main`` and ``train_vit.main`` with ``--tp 2`` inside the
    ranks' group (as under torchrun): exit codes and rank 0's log."""
    import contextlib
    import io
    from nvme_strom_tpu_torch import train_lm, train_vit
    out = {}
    for name, main, args in (
            ("lm", train_lm.main,
             ["--tiny", "--tp", "2", "--device", "cpu", "--seq-len", "16",
              "--global-batch", "4", "--steps", "3", "--save-every", "2",
              "--ckpt-dir", p["ckpt"]]),
            ("vit", train_vit.main,
             ["--tp", "2", "--device", "cpu", "--image-size", "16",
              "--global-batch", "4", "--steps", "2", "--classes", "10"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(args)
        out[name] = (rc, buf.getvalue())
    return out
