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
