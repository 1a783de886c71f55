"""The port's ``train_loop`` on a mesh (``repro_torch.launch.train``)
against the JAX package's on 8 host devices: the reference trains
stablelm-1.6b's smoke config (B = 8, S = 32) to step 4 on its host mesh,
checkpointing every 2 steps; the port, on 8 spawned gloo ranks, resumes
from the reference's step 2 on the host mesh of its process group
(``mesh=None``, (8, 1)) and on a (4, 2) ("data", "model") mesh passed as
``mesh=``, and runs to step 4.  The same world holds
``init_sharded_params`` against ``init_params`` and the stacked tree of
DTensors (``lm_params_to_tree``/``load_lm_tree``).  Each tolerance is
stated where it is used."""
import json
import os
import shutil

import numpy as np
import pytest
import torch

import _torch_dist
import _torch_mesh
from repro_torch import configs
from repro_torch.launch import train
from test_torch_lm_train_loop import LOSS_TOL, _manifest

MESHES = ("host", "4x2")
INIT_ARCHS = ("stablelm-1.6b", "deepseek-v2-lite-16b", "zamba2-7b")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_train")
    ref = _torch_mesh.reference_train(str(root / "ref"), 4,
                                      str(root / "ref.json"))
    dirs = {}
    for name in MESHES:
        dirs[name] = str(root / name)
        os.makedirs(dirs[name])
        shutil.copytree(root / "ref" / "step_00000002",
                        os.path.join(dirs[name], "step_00000002"))
    os.makedirs(root / "ranks")
    got = _torch_dist.run_ranks(_torch_mesh.train_world, root / "ranks",
                                dirs, INIT_ARCHS, timeout=400)
    return ref, got, dirs, str(root / "ref")


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_train_loop_resumes_the_references_checkpoint(world, mesh):
    """Every rank restores step 2 and runs steps 2 and 3; their losses are
    the reference's uninterrupted run's within ``LOSS_TOL`` (float32 sums
    in other orders over a few AdamW steps), the same on every rank; the
    port's step-4 checkpoint has the reference's manifest."""
    ref, got, dirs, ref_dir = world
    assert ref["steps"] == 4 and len(ref["losses"]) == 4
    runs = got["train", mesh]
    assert len(runs) == 8
    for run in runs:
        assert run["restored_from"] == 2 and run["steps"] == 2
        assert run["losses"] == runs[0]["losses"]
    np.testing.assert_allclose(runs[0]["losses"], ref["losses"][2:],
                               **LOSS_TOL)
    assert _manifest(dirs[mesh], 4) == _manifest(ref_dir, 4)


@pytest.mark.parametrize("arch", INIT_ARCHS)
def test_sharded_init_draws_init_params_numbers(world, arch):
    """``init_sharded_params`` on the (2, 4) mesh: every parameter
    bit-equal to ``init_params``'s from the same CPU generator and laid
    out by ``param_pspecs``."""
    res = world[1]["init", arch]
    assert res["equal"] and all(res["equal"].values()), [
        n for n, ok in res["equal"].items() if not ok]
    assert all(res["laid_out"].values()), [
        n for n, ok in res["laid_out"].items() if not ok]


@pytest.mark.parametrize("arch", INIT_ARCHS)
def test_stacked_tree_passes_dtensors_through(world, arch):
    """``lm_params_to_tree`` of a sharded model gives DTensors laid out by
    ``param_tree_pspecs`` (the stacked leaves' layer dim unsplit), each
    rank holding its shard (some leaf is split), and ``load_lm_tree`` of
    that tree into a sharded model of other weights restores the weights,
    each parameter keeping its layout."""
    res = world[1]["init", arch]
    tree = res["tree"]
    assert all(v["dtensor"] and v["laid_out"] for v in tree.values()), {
        k: v for k, v in tree.items() if not v["laid_out"]}
    assert any(v["local"] != v["global"] for v in tree.values())
    assert all(res["loaded"].values()), [
        n for n, ok in res["loaded"].items() if not ok]


def test_train_loop_without_a_group_is_the_plain_path():
    """``mesh=None`` with no process group: one device, plain tensors
    (and, with no card, ``device`` must be asked for)."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    steps = []
    step_fn = train.make_train_step

    def spy(*a, **k):
        fn = step_fn(*a, **k)

        def inner(params, state, batch):
            steps.append(type(next(params.parameters())).__name__)
            return fn(params, state, batch)
        return inner

    train.make_train_step = spy
    try:
        run = train.train_loop(configs.smoke_config("stablelm-1.6b"),
                               configs.InputShape("t", 16, 2, "train"),
                               steps=1, device="cpu")
    finally:
        train.make_train_step = step_fn
    assert run.steps == 1 and steps == ["Parameter"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train.train_loop(configs.smoke_config("stablelm-1.6b"),
                             configs.InputShape("t", 16, 2, "train"),
                             steps=1)


def test_reference_run_is_recorded(world):
    """The reference's run that the resumes are held against: 4 steps,
    its checkpoints of steps 2 and 4 committed."""
    ref, _, _, ref_dir = world
    assert ref["restored_from"] is None
    assert sorted(os.listdir(ref_dir)) == ["step_00000002", "step_00000004"]
    with open(os.path.join(ref_dir, "step_00000004", "manifest.json")) as f:
        assert json.load(f)["step"] == 4
