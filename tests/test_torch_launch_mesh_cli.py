"""The port's LM entry points across a world of processes: a SIGTERM to
one of 8 spawned gloo ranks in ``train_loop`` (every rank stops at the
same step, one checkpoint is written, nothing hangs), both command lines
under ``torchrun`` on the CPU (gloo; their last line is the reference's
JSON), and ``launch.mesh.join_world``, which forms the world for them and
never falls back."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_dist
import _torch_mesh
from repro_torch.launch import mesh as tmesh

SIGNALLED = 3


def test_sigterm_on_one_rank_stops_every_rank_at_one_step(tmp_path):
    """Rank 3 gets a SIGTERM while making step 2's batch: the flag,
    reduced over the world at each step boundary, stops all 8 ranks after
    step 2; the synchronous save of step 3 is the one checkpoint, and
    every rank ends with 3 steps run.  The world has 240 s to end."""
    ckpt = tmp_path / "ckpt"
    ranks = tmp_path / "ranks"
    os.makedirs(ranks)
    runs = _torch_dist.run_ranks(_torch_mesh.sigterm_world, ranks,
                                 str(ckpt), SIGNALLED, timeout=240)
    assert len(runs) == 8
    assert [r["steps"] for r in runs] == [3] * 8
    assert all(r["losses"] == runs[0]["losses"] for r in runs)
    assert os.listdir(ckpt) == ["step_00000003"]
    with open(ckpt / "step_00000003" / "manifest.json") as f:
        assert json.load(f)["step"] == 3


def _torchrun(module: str, *args: str, nproc: int = 2):
    env = dict(os.environ, PYTHONPATH=_torch_mesh.SRC, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={nproc}", "-m", module, *args],
        capture_output=True, text=True, env=env, timeout=300)


def test_train_cli_under_torchrun():
    """``torchrun --nproc_per_node 2 -m repro_torch.launch.train --arch
    stablelm-1.6b --smoke --steps 3 --device cpu``: two gloo ranks on the
    (2, 1) host mesh; the last line is the reference's JSON, printed
    once."""
    p = _torchrun("repro_torch.launch.train", "--arch", "stablelm-1.6b",
                  "--smoke", "--steps", "3", "--device", "cpu")
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.strip().splitlines()
    out = json.loads(lines[-1])
    assert out.keys() == {"steps", "final_loss", "wall_s"}
    assert out["steps"] == 3 and np.isfinite(out["final_loss"])
    assert sum(ln.startswith("{") for ln in lines) == 1


def test_serve_cli_under_torchrun():
    """``torchrun --nproc_per_node 2 -m repro_torch.launch.serve --arch
    deepseek-v2-lite-16b --smoke --device cpu``: the prompts' batch over
    the two ranks; the last line holds the reference's keys (and the
    device), the tokens' shape whole."""
    p = _torchrun("repro_torch.launch.serve", "--arch",
                  "deepseek-v2-lite-16b", "--smoke", "--new-tokens", "4",
                  "--device", "cpu")
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["shape"] == [2, 20] and out["decode_tps"] > 0
    assert out["device"] == "cpu"


def test_join_world_outside_a_launcher_is_none(monkeypatch):
    """No ``WORLD_SIZE``: the process runs alone (no group formed)."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert tmesh.join_world() is None
    assert tmesh.join_world("cpu") is None


def test_join_world_on_the_card_never_falls_back(monkeypatch):
    """Launched (``WORLD_SIZE`` set) with no device asked for: without a
    card it raises before forming any group, rather than carry on alone
    or on the CPU."""
    import torch.distributed as dist
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.join_world()
    assert not dist.is_initialized()
