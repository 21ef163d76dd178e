"""``python -m nvme_strom_tpu_torch.train_lm --device cpu --tiny`` end to
end, after tests/test_example.py: LoRA with its resume, then the full
larger-than-device-memory triad (``--offload-opt``, ``--remat nvme
--offload-acts``) over a ``--mix`` of two corpora with the warmup /
cosine schedule and the clip, resumed, then refused once its moment
manifest is ahead of the checkpoint; and the argument conflicts.  The
plain run and its resume are tests/test_torch_train.py's.  The JAX runs
are folded into fewer invocations, and the first LoRA run and the
refused one run in this process: each new process pays for importing
torch."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from nvme_strom_tpu_torch import train_lm

REPO = Path(__file__).resolve().parents[1]
BASE = ["--tiny", "--device", "cpu", "--seq-len", "32", "--global-batch",
        "4", "--save-every", "2"]


def _run(args):
    r = subprocess.run([sys.executable, "-m", "nvme_strom_tpu_torch.train_lm",
                        *BASE, *args], capture_output=True, text=True,
                       timeout=300, cwd=str(REPO),
                       env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert r.returncode == 0, r.stderr[-3000:]
    return r


def _losses(out):
    return [float(m) for m in re.findall(r"loss=([\d.]+)", out)]


def _corpus(path, seed):
    path.mkdir()
    train_lm.synthesize_shards(str(path), 128, 32, n_shards=2, per_shard=8,
                               seed=seed)


def test_lora_checkpoint_resume(tmp_path, capsys):
    ck = ["--lora", "4", "--ckpt-dir", str(tmp_path / "ck")]
    assert train_lm.main([*BASE, "--steps", "2", *ck]) == 0
    out1 = capsys.readouterr().out
    assert "lora: rank 4" in out1
    m = re.search(r"(\d+) trainable of (\d+) base", out1)
    assert m and int(m.group(1)) < int(m.group(2)) // 5
    out2 = _run(["--steps", "3", *ck]).stdout
    assert "resumed from step 2" in out2 and "step 3" in out2
    losses = _losses(out1 + out2)
    assert losses and all(x == x and x < 100 for x in losses)


def test_offload_triad_mix_schedule_resume_and_refusal(tmp_path, capsys):
    """Moments on NVMe, layer inputs on NVMe, two corpora mixed 3:1,
    warmup + cosine and a clip; the rerun resumes both the checkpoint
    and the moment manifest; a manifest ahead of the checkpoint is
    refused."""
    _corpus(tmp_path / "a", 1)
    _corpus(tmp_path / "b", 2)
    args = ["--mix", f"{tmp_path / 'a'}:3,{tmp_path / 'b'}:1",
            "--offload-opt", str(tmp_path / "opt"),
            "--remat", "nvme", "--offload-acts", str(tmp_path / "acts"),
            "--lr-schedule", "cosine", "--warmup-steps", "2",
            "--grad-clip", "1.0", "--ckpt-dir", str(tmp_path / "ck")]
    out1 = _run(["--steps", "2", *args]).stdout
    assert "offload-opt:" in out1 and "resumed at step 0" in out1
    assert "offload-acts: 2 layer slots" in out1
    assert (tmp_path / "opt" / "moments.bin").exists()
    assert (tmp_path / "acts" / "acts.bin").exists()
    out2 = _run(["--steps", "3", *args]).stdout
    assert "resumed from step 2" in out2 and "resumed at step 2" in out2
    assert "1 steps in" in out2
    assert "bounce=" in out2
    mpath = tmp_path / "opt" / "moments.json"
    m = json.loads(mpath.read_text())
    assert m["step"] == 3 and m["dirty"] is False
    m["step"] = 99
    mpath.write_text(json.dumps(m))
    with pytest.raises(SystemExit, match="divergent trajectory"):
        train_lm.main([*BASE, "--steps", "4", *args])


@pytest.mark.parametrize("args,msg", [
    (["--offload-opt", "o", "--lora", "4"], "--offload-opt is for full"),
    (["--remat", "nvme"], "go together"),
    (["--offload-acts", "a"], "go together"),
    (["--remat", "nvme", "--offload-acts", "a", "--lora", "2"],
     "--remat nvme is for full"),
    (["--mix", "a:1", "--data-dir", "d"], "--mix and --data-dir"),
    (["--mix", "a:0"], "positive weight"),
])
def test_argument_conflicts(tmp_path, capsys, args, msg):
    for i, a in enumerate(args):
        if a in ("o", "a", "d"):
            args[i] = str(tmp_path / a)
    if args[0] == "--mix":
        (tmp_path / "a").mkdir()
        args[1] = args[1].replace("a:", f"{tmp_path / 'a'}:")
    with pytest.raises(SystemExit) as e:
        train_lm.main([*BASE, *args])
    assert e.value.code == 2
    assert msg in capsys.readouterr().err
