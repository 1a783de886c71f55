"""The port's checkpoint directories (``repro_torch.checkpoint``) against
the JAX package's (``repro.checkpoint``, tests/test_checkpoint.py): atomic
save, restore by path, retention, async save and its failures, byte-viewed
dtypes without ml_dtypes, the agent's ``.npz`` checks, and checkpoints
that cross packages both ways bit for bit with identical manifests."""
import json
import os
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.checkpoint as jck
from _torch_parity import ATTENTION, agent_pair, jax_tree_numpy
from repro_torch.checkpoint import (CheckpointManager, check_leaves_compat,
                                    latest_step, restore_pytree, save_pytree)
from repro_torch.convert import leaves, params_from_jax
from repro_torch.core import AgentConfig, MRSchAgent
from repro_torch.sim import ResourceSpec

RES = [ResourceSpec("node", 16), ResourceSpec("bb", 8)]
MODULES = {"mlp": {}, "attention": ATTENTION}


def tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.bfloat16),
                  "d": torch.tensor(7, dtype=torch.int32)}}


def flat(t):
    return [t["a"], t["b"]["c"], t["b"]["d"]]


def test_roundtrip(tmp_path):
    t = tree()
    save_pytree(t, str(tmp_path), step=3, extra={"note": "x"})
    out, manifest = restore_pytree(t, str(tmp_path))
    assert manifest["step"] == 3
    assert manifest["extra"]["note"] == "x"
    for a, b in zip(flat(t), flat(out)):
        assert torch.equal(a, b) and a.dtype == b.dtype
        assert b.device == a.device and b.data_ptr() != a.data_ptr()


def test_latest_and_gc(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        m.save(tree(), s)
    assert latest_step(str(tmp_path)) == 4
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path))
    assert steps == [3, 4]                       # GC keeps newest 2


def test_async_save(tmp_path):
    m = CheckpointManager(str(tmp_path))
    m.save_async(tree(), 10)
    m.wait()
    out, manifest = m.restore_latest(tree())
    assert manifest["step"] == 10
    assert all(torch.equal(a, b) for a, b in zip(flat(tree()), flat(out)))


def test_async_save_failure_surfaces(tmp_path, monkeypatch):
    """A failed background save must not vanish: wait() (and the next
    save_async, which flushes first) re-raises the worker exception."""
    from repro_torch.checkpoint import store

    m = CheckpointManager(str(tmp_path))

    def boom(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(store, "save_pytree", boom)
    m.save_async(tree(), 1)
    with pytest.raises(OSError, match="disk full"):
        m.wait()
    monkeypatch.undo()
    m.wait()                      # reported once, then usable again
    m.save_async(tree(), 2)
    m.wait()
    assert latest_step(str(tmp_path)) == 2


def test_async_save_failure_surfaces_on_next_save(tmp_path, monkeypatch):
    from repro_torch.checkpoint import store

    m = CheckpointManager(str(tmp_path))
    monkeypatch.setattr(
        store, "save_pytree",
        lambda *a, **kw: (_ for _ in ()).throw(ValueError("bad dtype")))
    m.save_async(tree(), 1)
    m._thread.join()
    monkeypatch.undo()
    with pytest.raises(ValueError, match="bad dtype"):
        m.save_async(tree(), 2)


def test_async_snapshot_is_taken_on_the_callers_thread(tmp_path,
                                                      monkeypatch):
    """On the CPU a tensor's numpy view shares its memory: an in-place
    update right after ``save_async`` (here, before the background write
    starts) must not reach the saved values."""
    from repro_torch.checkpoint import store
    agent = MRSchAgent(RES, AgentConfig(state_hidden=(32, 16), state_out=8,
                                        module_hidden=4), device="cpu")
    before = [p.detach().clone() for _, p in leaves(agent.net)]
    updated, save = threading.Event(), store.save_pytree
    monkeypatch.setattr(store, "save_pytree",
                        lambda *a, **kw: (updated.wait(10.0), save(*a, **kw)))
    m = CheckpointManager(str(tmp_path))
    m.save_async(agent.net, 1)
    with torch.no_grad():
        for _, p in leaves(agent.net):
            p.add_(1.0)
    updated.set()
    m.wait()
    out, _ = restore_pytree(agent.net, str(tmp_path), 1)
    for b, (_, p) in zip(before, leaves(out)):
        assert torch.equal(p, b)


def viewed_leaf(dtype_name):
    """The reference test's leaf as (numpy with ml_dtypes, torch)."""
    if dtype_name == "complex64":
        arr = (np.arange(6, dtype=np.float32).reshape(2, 3)
               + 1j * np.ones((2, 3), np.float32)).astype(np.complex64)
        return arr, torch.from_numpy(arr.copy())
    arr = np.linspace(-2, 2, 12, dtype=np.float32).reshape(3, 4).astype(
        getattr(ml_dtypes, dtype_name))
    t = torch.from_numpy(arr.view(np.uint8).copy()).view(
        getattr(torch, dtype_name))
    return arr, t


def leaf_bytes(x):
    if isinstance(x, torch.Tensor):
        x = x.contiguous().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


@pytest.mark.parametrize("dtype_name", ["bfloat16", "float8_e4m3fn",
                                        "complex64"])
def test_roundtrip_viewed_dtypes(tmp_path, dtype_name):
    """The byte view inverts for 2-byte (bf16), 1-byte (fp8) and wide
    (complex64) dtypes with torch's own dtypes; the manifest records the
    logical shape and the numpy/ml_dtypes name."""
    _, t = viewed_leaf(dtype_name)
    save_pytree({"x": t}, str(tmp_path), step=1)
    with open(tmp_path / "step_00000001" / "manifest.json") as f:
        manifest = json.load(f)
    (leaf,) = manifest["leaves"]
    assert leaf["shape"] == list(t.shape)          # logical, not viewed
    assert leaf["dtype"] == dtype_name
    out, _ = restore_pytree({"x": t}, str(tmp_path))
    assert out["x"].dtype == t.dtype
    np.testing.assert_array_equal(leaf_bytes(out["x"]), leaf_bytes(t))


@pytest.mark.parametrize("dtype_name", ["bfloat16", "float8_e4m3fn",
                                        "complex64"])
def test_viewed_dtypes_cross_packages(tmp_path, dtype_name):
    arr, t = viewed_leaf(dtype_name)
    jck.save_pytree({"x": arr}, str(tmp_path / "ref"), step=1)
    out, _ = restore_pytree({"x": t}, str(tmp_path / "ref"))
    np.testing.assert_array_equal(leaf_bytes(out["x"]), leaf_bytes(arr))
    save_pytree({"x": t}, str(tmp_path / "port"), step=1)
    back, _ = jck.restore_pytree({"x": arr}, str(tmp_path / "port"))
    assert np.asarray(back["x"]).dtype == arr.dtype
    np.testing.assert_array_equal(leaf_bytes(np.asarray(back["x"])),
                                  leaf_bytes(arr))
    for d in ("ref", "port"):
        assert (tmp_path / d / "step_00000001" / "manifest.json") \
            .read_text() == (tmp_path / "ref" / "step_00000001"
                             / "manifest.json").read_text()


WITHOUT_ML_DTYPES = textwrap.dedent("""
    import sys
    sys.modules["ml_dtypes"] = None            # as on a machine without it
    import torch
    from repro_torch.checkpoint import restore_pytree, save_pytree
    path = sys.argv[1]
    t = {"bf": torch.linspace(-2, 2, 12).reshape(3, 4).bfloat16(),
         "f8": torch.linspace(-2, 2, 12).reshape(3, 4).to(
             torch.float8_e4m3fn),
         "cx": torch.complex(torch.ones(2, 3), torch.arange(6.).reshape(2, 3))}
    out, _ = restore_pytree(t, path + "/ref")  # written by the JAX package
    for k in t:
        assert out[k].dtype == t[k].dtype, k
        assert torch.equal(out[k].view(torch.uint8), t[k].view(torch.uint8))
    save_pytree(out, path + "/port", 2)
    print("ok")
""")


def test_viewed_dtypes_without_ml_dtypes(tmp_path):
    """In a process where ``ml_dtypes`` cannot be imported, the port reads
    the JAX package's bfloat16, float8 and complex64 leaves and writes
    them back; the JAX package reads that save bit for bit."""
    t = {"bf": np.linspace(-2, 2, 12, dtype=np.float32).reshape(3, 4)
         .astype(ml_dtypes.bfloat16),
         "f8": np.linspace(-2, 2, 12, dtype=np.float32).reshape(3, 4)
         .astype(ml_dtypes.float8_e4m3fn),
         "cx": (np.ones((2, 3), np.float32) + 1j * np.arange(6, dtype=np.float32)
                .reshape(2, 3)).astype(np.complex64)}
    jck.save_pytree(t, str(tmp_path / "ref"), 1)
    src = Path(__file__).resolve().parents[1] / "src"
    proc = subprocess.run(
        [sys.executable, "-c", WITHOUT_ML_DTYPES, str(tmp_path)],
        env=dict(os.environ, PYTHONPATH=str(src)), capture_output=True,
        text=True, timeout=120)
    assert proc.stdout.strip() == "ok", proc.stderr[-2000:]
    back, _ = jck.restore_pytree(t, str(tmp_path / "port"))
    for k in t:
        np.testing.assert_array_equal(leaf_bytes(np.asarray(back[k])),
                                      leaf_bytes(t[k]))


def test_shape_mismatch_rejected(tmp_path):
    save_pytree(tree(), str(tmp_path), 1)
    bad = tree()
    bad["a"] = torch.zeros(2, 2)
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_pytree(bad, str(tmp_path))
    missing = tree()
    missing["e"] = torch.zeros(1)
    with pytest.raises(KeyError):
        restore_pytree(missing, str(tmp_path))


def test_interrupted_save_never_corrupts(tmp_path):
    """A .tmp directory (simulated crash mid-save) is ignored."""
    save_pytree(tree(), str(tmp_path), 1)
    os.makedirs(tmp_path / "step_00000002.tmp")
    os.makedirs(tmp_path / "step_backup")
    assert latest_step(str(tmp_path)) == 1
    out, manifest = restore_pytree(tree(), str(tmp_path))
    assert manifest["step"] == 1
    with pytest.raises(FileNotFoundError):
        restore_pytree(tree(), str(tmp_path / "empty"))


# ------------------------------------------------------ across packages
@pytest.mark.parametrize("module", sorted(MODULES))
def test_reference_checkpoint_restores_into_the_port(tmp_path, module):
    """The JAX package's ``save_pytree`` of an agent's params, restored by
    path into the port's network: bit-equal to ``params_from_jax``, a new
    module on the template's device, the template untouched."""
    ja, ta = agent_pair(RES, seed=1, **MODULES[module])
    _, template = agent_pair(RES, seed=2, **MODULES[module])
    untouched = [p.detach().clone() for _, p in leaves(template.net)]
    jck.save_pytree(ja.params, str(tmp_path), step=7)
    net, manifest = restore_pytree(template.net, str(tmp_path))
    assert manifest["step"] == 7 and net is not template.net
    want = params_from_jax(jax_tree_numpy(ja.params))
    got = dict(net.named_parameters())
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].dtype == w.dtype and got[name].device.type == "cpu"
        assert torch.equal(got[name], w), name
        assert got[name].requires_grad
    for u, (_, p) in zip(untouched, leaves(template.net)):
        assert torch.equal(u, p)


@pytest.mark.parametrize("module", sorted(MODULES))
def test_port_checkpoint_restores_into_the_reference(tmp_path, module):
    """The port's save, restored by the JAX package into its own tree bit
    for bit; both packages write identical manifests and arrays."""
    ja, ta = agent_pair(RES, seed=1, **MODULES[module])
    with torch.no_grad():
        for _, p in leaves(ta.net):
            p.add_(0.25)                         # differ from ja's
    save_pytree(ta.net, str(tmp_path / "port"), step=3, extra={"k": 1})
    template, _ = agent_pair(RES, seed=5, **MODULES[module])
    out, manifest = jck.restore_pytree(template.params,
                                       str(tmp_path / "port"))
    assert manifest["extra"] == {"k": 1}
    got = jax.tree_util.tree_leaves(out)
    assert len(got) == len(leaves(ta.net))
    for (name, p), r in zip(leaves(ta.net), got):
        assert np.array_equal(p.detach().numpy(), np.asarray(r)), name

    # Identical files for identical weights: the reference saves ta's.
    jtree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(template.params),
        [jnp.asarray(p.detach().numpy()) for _, p in leaves(ta.net)])
    jck.save_pytree(jtree, str(tmp_path / "ref"), step=3, extra={"k": 1})
    port_dir = tmp_path / "port" / "step_00000003"
    ref_dir = tmp_path / "ref" / "step_00000003"
    assert (port_dir / "manifest.json").read_text() == \
        (ref_dir / "manifest.json").read_text()
    paths = [leaf["path"] for leaf in json.loads(
        (port_dir / "manifest.json").read_text())["leaves"]]
    assert paths == [n.replace(".", "/") for n, _ in leaves(ta.net)]
    assert all(p.split("/")[0] in ("action", "expectation", "goal",
                                   "measurement", "state") for p in paths)
    with np.load(port_dir / "shard_000.npz") as a, \
            np.load(ref_dir / "shard_000.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_module_checkpoints_of_other_widths_are_rejected(tmp_path):
    ja, _ = agent_pair(RES, state_hidden=(16, 8))
    _, ta = agent_pair(RES)
    jck.save_pytree(ja.params, str(tmp_path / "narrow"), step=1)
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_pytree(ta.net, str(tmp_path / "narrow"))
    _, attn = agent_pair(RES, **ATTENTION)
    save_pytree(attn.net, str(tmp_path / "attn"), step=1)
    with pytest.raises(KeyError):
        restore_pytree(ta.net, str(tmp_path / "attn"))


# ------------------------------------------------------------ agent.load
def _tiny_agent(state_hidden=(32, 16)):
    return MRSchAgent(RES, AgentConfig(state_hidden=state_hidden,
                                       state_out=8, module_hidden=4),
                      device="cpu")


def test_agent_load_roundtrip(tmp_path):
    a = _tiny_agent()
    a.epsilon = 0.37
    path = str(tmp_path / "agent.npz")
    a.save(path)
    b = MRSchAgent(RES, AgentConfig(state_hidden=(32, 16), state_out=8,
                                    module_hidden=4, seed=4), device="cpu")
    b.load(path)
    assert b.epsilon == 0.37
    for (_, x), (_, y) in zip(leaves(a.net), leaves(b.net)):
        assert torch.equal(x, y)


def test_agent_load_rejects_wrong_width(tmp_path):
    """A checkpoint of another architecture fails loudly and leaves the
    live weights untouched."""
    narrow = _tiny_agent(state_hidden=(16, 8))
    path = str(tmp_path / "narrow.npz")
    narrow.save(path)
    wide = _tiny_agent(state_hidden=(32, 16))
    before = [p.detach().clone() for _, p in leaves(wide.net)]
    with pytest.raises(ValueError, match="shape mismatch"):
        wide.load(path)
    for b, (_, p) in zip(before, leaves(wide.net)):
        assert torch.equal(b, p)


def test_agent_load_rejects_wrong_leaf_count(tmp_path):
    a = _tiny_agent()
    arrs = [p.detach().numpy() for _, p in leaves(a.net)]
    path = str(tmp_path / "truncated.npz")
    np.savez(path, n=len(arrs) - 2, epsilon=0.5,
             **{f"p{i}": x for i, x in enumerate(arrs[:-2])})
    with pytest.raises(ValueError, match="leaves"):
        a.load(path)


def test_agent_load_rejects_truncated_archive(tmp_path):
    """n claiming more leaves than the archive holds is a ValueError, not
    a KeyError from deep inside np.load."""
    a = _tiny_agent()
    arrs = [p.detach().numpy() for _, p in leaves(a.net)]
    path = str(tmp_path / "claims_more.npz")
    np.savez(path, n=len(arrs) + 2, epsilon=0.5,
             **{f"p{i}": x for i, x in enumerate(arrs)})
    with pytest.raises(ValueError, match="absent"):
        a.load(path)


def test_check_leaves_compat_dtype():
    good = [np.zeros((2, 3), np.float32)]
    with pytest.raises(ValueError, match="dtype mismatch"):
        check_leaves_compat(good, [np.zeros((2, 3), np.float64)])
    check_leaves_compat(good, [np.zeros((2, 3), np.float32)])  # no raise
    t = [torch.zeros(2, 3)]
    check_leaves_compat(t, good)              # tensors against arrays
    with pytest.raises(ValueError, match="dtype mismatch — checkpoint "
                                         "bfloat16, expected float32"):
        check_leaves_compat(t, [torch.zeros(2, 3, dtype=torch.bfloat16)])
    for exp, got in ((t, [torch.zeros(3, 2)]), (t, t + t)):
        msgs = []
        for fn, g, e in ((check_leaves_compat, got, exp),
                         (jck.check_leaves_compat,
                          [x.numpy() for x in got], [x.numpy() for x in exp])):
            with pytest.raises(ValueError) as info:
                fn(e, g, context="load(x)")
            msgs.append(str(info.value))
        assert msgs[0] == msgs[1]             # the reference's texts
