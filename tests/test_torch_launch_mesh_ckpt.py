"""Checkpoints of the port's ``train_loop`` across world sizes
(``repro_torch.checkpoint`` with DTensor leaves) against the JAX
package's elastic restore (``tests/test_checkpoint.py::
test_elastic_restore_across_mesh_sizes``): the port saves on 8 spawned
gloo ranks and the reference on 8 host devices (stablelm-1.6b's smoke
config, step 2 of ``train_loop``, ``{"params", "opt"}``); a world of 4
ranks restores both with ``shardings=`` of its host mesh, and the
reference restores the port's with its own ``restore_pytree(shardings=)``
on 4 host devices.  Leaves are compared bit for bit."""
import json
import os

import numpy as np
import pytest

import _torch_dist
import _torch_mesh

WRITERS = ("torch", "jax")


def _arrays(directory: str, step: int) -> dict:
    """Dotted path -> the array a checkpoint holds (bfloat16 as float32;
    there is none in a float32 run)."""
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, "shard_000.npz")) as data:
        return {leaf["path"].replace("/", "."): data[leaf["key"]]
                for leaf in manifest["leaves"]}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_ckpt")
    dirs = {"torch": str(root / "torch"), "jax": str(root / "jax")}
    for sub in ("w8", "w4"):
        os.makedirs(root / sub)
    _torch_mesh.reference_train(dirs["jax"], 2, str(root / "jax.json"))
    saved = _torch_dist.run_ranks(_torch_mesh.save_world, root / "w8",
                                  dirs["torch"], str(root / "manager"),
                                  timeout=300)
    restored = _torch_dist.run_ranks(_torch_mesh.restore_world, root / "w4",
                                     dirs, world=4, timeout=300)
    jax_restored = _torch_mesh.reference_restore(dirs["torch"],
                                                 str(root / "ref4.npz"))
    return {"dirs": dirs, "saved": saved, "restored": restored,
            "jax_restored": jax_restored, "manager": str(root / "manager")}


@pytest.mark.parametrize("writer", WRITERS)
def test_elastic_restore_onto_four_ranks(worlds, writer):
    """A checkpoint of step 2 written on 8 (the port's ranks or the
    reference's devices) restores onto the 4-rank host mesh: every leaf
    of ``{"params", "opt"}`` bit-equal to the file's, of the template's
    dtype, a DTensor laid out by the 4-rank spec (FSDP over "data"
    splits the matrices: some leaf is split)."""
    got = worlds["restored"][writer]
    assert worlds["restored"][writer, "step"] == 2
    want = _arrays(worlds["dirs"][writer], 2)
    assert set(got) == set(want)
    for path, arr in want.items():
        np.testing.assert_array_equal(got[path]["array"], arr, err_msg=path)
        assert got[path]["laid_out"], path
    assert got["opt.step"]["dtype"] == "torch.int32"
    assert sum(v["sharded"] for v in got.values()) >= 10


def test_reference_restores_the_ports_checkpoint_onto_four_devices(worlds):
    """The port's 8-rank checkpoint, restored by the reference's
    ``restore_pytree(shardings=)`` on 4 host devices: every leaf
    bit-equal, each on its spec of the 4-device host mesh (some split)."""
    ref = worlds["jax_restored"]
    want = _arrays(worlds["dirs"]["torch"], 2)
    assert ref["step"] == 2 and set(ref["arrays"]) == set(want)
    for path, arr in want.items():
        np.testing.assert_array_equal(ref["arrays"][path], arr, err_msg=path)
    assert ref["specs"]["params.stack.attn.wq"] == repr(
        (None, "data", "model"))
    assert sum(ref["split"].values()) >= 10


def test_ranks_save_alike_and_wait_for_the_commit(worlds):
    """On 8 ranks, ``save`` and ``save_async`` of a DTensor tree (mixed
    layouts, a bfloat16 leaf): after ``wait()`` every rank's
    ``latest_step`` is the async step; each step holds the whole arrays;
    the manager keeps both steps; the 8-rank ``train_loop`` wrote one
    checkpoint."""
    saved = worlds["saved"]
    assert saved["latest"] == [2] * 8
    assert sorted(os.listdir(worlds["manager"])) == ["step_00000001",
                                                     "step_00000002"]
    for step in (1, 2):
        got = _arrays(worlds["manager"], step)
        np.testing.assert_array_equal(got["a"], saved["tree"]["a"])
        np.testing.assert_array_equal(got["n"], saved["tree"]["n"])
        b = got["b.0"]
        assert b.dtype == np.uint16                   # bfloat16's bytes
        np.testing.assert_array_equal(
            (b.astype(np.uint32) << 16).view(np.float32), saved["tree"]["b"])
    assert saved["run"]["steps"] == 2
    assert os.listdir(worlds["dirs"]["torch"]) == ["step_00000002"]


def test_both_writers_share_the_layout(worlds):
    """The port's 8-rank checkpoint and the reference's 8-device one list
    the same leaves, shapes and dtypes in ``manifest.json``."""
    from test_torch_lm_train_loop import _manifest
    assert _manifest(worlds["dirs"]["torch"], 2) == \
        _manifest(worlds["dirs"]["jax"], 2)


def test_shardings_for_an_unknown_leaf_raise(tmp_path):
    """A sharding whose path the template lacks is refused, not ignored
    (the leaf it meant would otherwise land unsharded)."""
    import torch
    from repro_torch.checkpoint import restore_pytree, save_pytree
    from repro_torch.distributed.sharding import P, NamedSharding
    tree = {"w": torch.ones(2, 3)}
    save_pytree(tree, str(tmp_path), 1)
    with pytest.raises(ValueError, match="lacks"):
        restore_pytree(tree, str(tmp_path), shardings={
            "v": NamedSharding(None, P(None, None))})
