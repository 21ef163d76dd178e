"""The port's offline scrubber (nvme_strom_tpu_torch/tools/strom_scrub.py)
held against the JAX package's (nvme_strom_tpu/tools/strom_scrub.py):
checkpoints, shard sets and KV prefix stores written by either package
are scrubbed by both, clean and with one flipped byte, and the two
``--json`` reports and exit codes must be equal (exact); sidecars stamped
by either verify under the other and are the same files; the
crashed-save and orphaned-manifest sweeps act alike.  The counterparts
are tests/test_scrub.py's cases."""

import json
import os
import time

import numpy as np
import pytest
import torch

from nvme_strom_tpu.tools import strom_scrub as jax_scrub
from nvme_strom_tpu_torch.tools import strom_scrub


def _run(tool, capsys, argv):
    rc = tool.main(argv + ["--json"])
    return rc, json.loads(capsys.readouterr().out)


def _both(capsys, argv):
    """(rc, report) of the port and of the JAX scrub on ``argv``, which
    must agree."""
    from nvme_strom_tpu.utils.stats import global_stats
    rc, rep = _run(strom_scrub, capsys, argv)
    # the JAX scrub's engine counts into the process-wide block
    global_stats.reset()
    rc_j, rep_j = _run(jax_scrub, capsys, argv)
    assert rc == rc_j
    assert rep == rep_j
    return rc, rep


def _flip(path, at):
    with open(path, "r+b") as f:
        f.seek(at)
        b = f.read(1)
        f.seek(at)
        f.write(bytes([b[0] ^ 0x08]))


def _ckpt(tmp_path, writer, steps=(1, 2)):
    """A checkpoint dir of ``steps`` written by ``writer``'s manager."""
    d = tmp_path / "ckpt"
    if writer == "port":
        from nvme_strom_tpu_torch.checkpoint.manager import CheckpointManager
        from nvme_strom_tpu_torch.io.engine import StromEngine
        from nvme_strom_tpu_torch.utils.config import EngineConfig
        with StromEngine(EngineConfig(chunk_bytes=1 << 20,
                                      buffer_pool_bytes=8 << 20)) as eng:
            mgr = CheckpointManager(d, engine=eng)
            for s in steps:
                mgr.save(s, {"w": torch.full((8, 8), float(s)),
                             "b": torch.arange(300, dtype=torch.float32)})
            mgr.close()
    else:
        from nvme_strom_tpu.checkpoint import CheckpointManager
        from nvme_strom_tpu.io import StromEngine
        from nvme_strom_tpu.utils.config import EngineConfig
        eng = StromEngine(EngineConfig(chunk_bytes=1 << 20,
                                       buffer_pool_bytes=16 << 20))
        mgr = CheckpointManager(d, engine=eng)
        for s in steps:
            mgr.save(s, {"w": np.full((8, 8), float(s), np.float32),
                         "b": np.arange(300, dtype=np.float32)})
        eng.close_all()
    tiles = sorted(str(p) for p in d.rglob("*.safetensors"))
    return str(d), tiles


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_clean_and_flipped(tmp_path, capsys, writer):
    ckpt, tiles = _ckpt(tmp_path, writer)
    rc, rep = _both(capsys, [ckpt])
    assert rc == 0 and rep["damage"] == [] and rep["files_scanned"] == 2
    assert rep["bytes_verified"] > 0
    _flip(tiles[-1], os.path.getsize(tiles[-1]) - 9)
    rc, rep = _both(capsys, [ckpt])
    assert rc == 1 and len(rep["damage"]) == 1
    assert rep["damage"][0]["file"] == tiles[-1]
    assert "crc32c" in rep["damage"][0]["error"]
    assert rep["checksum_failures"] == 1
    # one file alone, and the text report names the file
    assert strom_scrub.main([tiles[-1]]) == 1
    assert f"DAMAGED {tiles[-1]}" in capsys.readouterr().out


def test_gc_crashed_save_debris(tmp_path, capsys):
    ckpt, _ = _ckpt(tmp_path, "port", steps=(1,))
    debris = os.path.join(ckpt, ".tmp_step_00000002")
    os.makedirs(debris)
    torn = os.path.join(debris, "state-00000.safetensors")
    with open(torn, "wb") as f:
        f.write(b"torn")
    rc, rep = _both(capsys, [ckpt])
    assert rc == 0 and rep["tmp_dirs"] == [debris]
    rc, rep = _both(capsys, [ckpt, "--gc"])     # fresh: a live save?
    assert rep["tmp_dirs_live"] == [debris] and os.path.isdir(debris)
    old = time.time() - 7200
    os.utime(debris, (old, old))
    os.utime(torn, (old, old))
    rc, rep = _run(strom_scrub, capsys, [ckpt, "--gc"])
    assert rc == 0 and rep["tmp_dirs_removed"] == [debris]
    assert not os.path.exists(debris)
    os.makedirs(debris)
    rc, rep = _run(strom_scrub, capsys, [ckpt, "--gc", "--force"])
    assert rep["tmp_dirs_removed"] == [debris]
    assert not os.path.exists(debris)


def _shards(d, writer):
    """A fixedrec file, a WebDataset tar and a TFRecord file, unstamped,
    written by ``writer``'s format writers."""
    if writer == "port":
        from nvme_strom_tpu_torch.formats.fixedrec import write_fixedrec
        from nvme_strom_tpu_torch.formats.tfrecord import write_tfrecords
        from nvme_strom_tpu_torch.formats.wds import write_wds_shard
    else:
        from nvme_strom_tpu.formats.fixedrec import write_fixedrec
        from nvme_strom_tpu.formats.tfrecord import write_tfrecords
        from nvme_strom_tpu.formats.wds import write_wds_shard
    os.makedirs(d)
    rows = np.arange(64 * 32, dtype=np.uint8).reshape(64, 32) % 199
    write_fixedrec(os.path.join(d, "data.fixedrec"), rows)
    write_wds_shard(os.path.join(d, "shard-0.tar"),
                    [{"bin": bytes([i]) * 128} for i in range(8)])
    write_tfrecords(os.path.join(d, "recs.tfrecord"),
                    [bytes([i]) * (50 + i) for i in range(6)])
    return d


@pytest.mark.parametrize("writer,stamper", [("port", "port"),
                                            ("port", "jax"),
                                            ("jax", "port")])
def test_shards_stamped_by_one_verified_by_both(tmp_path, capsys, writer,
                                                stamper):
    d = _shards(str(tmp_path / "shards"), writer)
    rc, rep = _both(capsys, [d])
    assert rc == 0 and len(rep["unstamped"]) == 3
    tool = strom_scrub if stamper == "port" else jax_scrub
    rc, rep = _run(tool, capsys, [d, "--stamp"])
    assert rc == 0 and sorted(os.path.basename(p) for p in rep["stamped"]) \
        == ["data.fixedrec", "recs.tfrecord", "shard-0.tar"]
    rc, rep = _both(capsys, [d])
    assert rc == 0 and rep["files_scanned"] == 3 and rep["damage"] == []
    _flip(os.path.join(d, "data.fixedrec"), 3 * 32 + 5)     # record 3
    rc, rep = _both(capsys, [d])
    assert rc == 1 and len(rep["damage"]) == 1
    assert rep["damage"][0]["offset"] == 3 * 32


def test_sidecars_equal_across_packages(tmp_path):
    """Each package's stamp of the same shard is the same sidecar."""
    from nvme_strom_tpu.utils import checksum as jck
    from nvme_strom_tpu_torch.utils import checksum as tck
    d = _shards(str(tmp_path / "shards"), "port")
    for name, stamp in (("data.fixedrec", "stamp_fixedrec"),
                        ("shard-0.tar", "stamp_wds"),
                        ("recs.tfrecord", "stamp_tfrecord")):
        p = os.path.join(d, name)
        with open(getattr(tck, stamp)(p)) as f:
            ours = json.load(f)
        with open(getattr(jck, stamp)(p)) as f:
            theirs = json.load(f)
        assert ours == theirs, name
        assert len(ours["spans"]) > 1


def test_fixedrec_writer_stamps_scrub_in_both(tmp_path, capsys):
    from nvme_strom_tpu_torch.formats.fixedrec import write_fixedrec
    d = tmp_path / "fx"
    d.mkdir()
    write_fixedrec(d / "a.fixedrec",
                   np.arange(40 * 16, dtype=np.float32).reshape(40, 16),
                   checksums=True)
    rc, rep = _both(capsys, [str(d)])
    assert rc == 0 and rep["files_scanned"] == 1 and rep["unstamped"] == []
    assert rep["bytes_verified"] == 40 * 16 * 4


def _kv_store(tmp_path, writer):
    """A KV prefix store of 3 float32 tiny-config pages written by
    ``writer``'s PrefixStore; (path, page_bytes)."""
    path = str(tmp_path / "serve.kvstore")
    if writer == "port":
        import dataclasses
        from nvme_strom_tpu_torch.io.engine import StromEngine
        from nvme_strom_tpu_torch.models.kv_offload import PrefixStore
        from nvme_strom_tpu_torch.models.transformer import tiny_config
        from nvme_strom_tpu_torch.utils.config import EngineConfig
        cfg = dataclasses.replace(tiny_config(), dtype=torch.float32)
        eng = StromEngine(EngineConfig(chunk_bytes=1 << 20,
                                       buffer_pool_bytes=8 << 20))
        store = PrefixStore(cfg, eng, path, page_tokens=4,
                            capacity_bytes=1 << 20)
    else:
        import jax.numpy as jnp
        from nvme_strom_tpu.io import StromEngine
        from nvme_strom_tpu.models.kv_offload import PrefixStore
        from nvme_strom_tpu.models.transformer import (TransformerConfig,
                                                       tiny_config)
        from nvme_strom_tpu.utils.config import EngineConfig
        cfg = TransformerConfig(**{**tiny_config().__dict__,
                                   "dtype": jnp.float32})
        eng = StromEngine(EngineConfig(chunk_bytes=1 << 20,
                                       buffer_pool_bytes=16 << 20))
        store = PrefixStore(cfg, eng, path, page_tokens=4,
                            capacity_bytes=1 << 20)
    shape = (cfg.n_layers, cfg.n_kv_heads, 4, cfg.head_dim)
    for i, key in enumerate(store.chain_keys(list(range(13)))):
        page = np.full(shape, float(i + 1), np.float32)
        store.put([(key, page, page)])
    store.flush()
    store.close()
    eng.close_all()
    return path, store.page_bytes


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_kv_store_clean_and_flipped(tmp_path, capsys, writer):
    path, pb = _kv_store(tmp_path, writer)
    rc, rep = _both(capsys, [str(tmp_path)])
    assert rc == 0 and rep["damage"] == []
    assert rep["bytes_verified"] == 3 * pb
    _flip(path, pb + 7)
    rc, rep = _both(capsys, [path])
    assert rc == 1 and len(rep["damage"]) == 1
    assert rep["damage"][0]["page"] == 1


def test_orphaned_manifests_swept(tmp_path, capsys):
    doc = json.dumps({"version": 1, "page_bytes": 4096, "pages": {}})
    (tmp_path / "live.kvpages").write_bytes(b"\0" * 4096)
    (tmp_path / "live.kvpages.kvman.json").write_text(doc)
    orphans = [tmp_path / "gone.kvpages.kvman.json",
               tmp_path / "gone.bin.warmhints.json",
               tmp_path / "gone.anchor.handoff.json"]
    for o in orphans:
        o.write_text(doc)
    rc, rep = _both(capsys, [str(tmp_path)])
    assert rc == 0 and rep["orphan_manifests"] == sorted(map(str, orphans))
    rc, rep = _both(capsys, [str(tmp_path), "--gc"])     # fresh: kept
    assert rep["orphan_manifests_removed"] == []
    old = time.time() - 7200
    for o in orphans:
        os.utime(o, (old, old))
    rc, rep = _run(strom_scrub, capsys, [str(tmp_path), "--gc"])
    assert rc == 0
    assert rep["orphan_manifests_removed"] == sorted(map(str, orphans))
    assert not any(o.exists() for o in orphans)
    assert (tmp_path / "live.kvpages.kvman.json").exists()


def test_one_file_and_usage(tmp_path, capsys):
    from nvme_strom_tpu_torch.formats.safetensors import write_safetensors
    p = tmp_path / "m.safetensors"
    write_safetensors(p, {"a": torch.arange(100, dtype=torch.float32)})
    rc, rep = _both(capsys, [str(p)])
    assert rc == 0 and rep["files_scanned"] == 1 and rep["damage"] == []
    assert strom_scrub.main([str(tmp_path / "nope")]) == 2
    assert jax_scrub.main([str(tmp_path / "nope")]) == 2
