"""The CNN state module (the paper's Fig. 3 ablation) in the port against
the JAX package: ``conv1d_apply`` against ``lax.conv_general_dilated``
where SAME padding at a stride is asymmetric, the DFP network's values,
loss and 26 gradient leaves on both backends, ``.npz`` files and
checkpoint directories across packages, sequential and device rollouts
(the device engine on classic rows), and a 3-episode ``train_agent``."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as jck
import repro.core.encoding as jenc
import repro.sim as jsim
import repro_torch.core.encoding as tenc
import repro_torch.sim as tsim
from _torch_parity import (PKGS, agent_pair, assert_results_close,
                           assert_results_equal, env_actions, jax_tree_numpy,
                           synth_jobs, values_and_margin)
from repro.core import dfp as jdfp
from repro.core import train_agent as jtrain_agent
from repro.nn import modules as jmodules
from repro_torch.checkpoint import restore_pytree, save_pytree
from repro_torch.convert import leaves, params_from_jax
from repro_torch.core import dfp as tdfp
from repro_torch.core import train_agent
from repro_torch.nn import backend as tbackend
from repro_torch.nn.modules import Conv1d, conv1d_apply

RES = [jsim.ResourceSpec("node", 16), jsim.ResourceSpec("bb", 8)]
T_RES = [tsim.ResourceSpec(r.name, r.capacity, r.unit) for r in RES]
CNN = dict(state_module="cnn")
PAIRS = [("torch", "xla"), ("kernel", "pallas")]
VAL_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)


def _conv_pair(width, cin, cout, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((width, cin, cout)).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    conv = Conv1d(cin, cout, width)
    assert tuple(conv.w.shape) == w.shape
    with torch.no_grad():
        conv.w.copy_(torch.from_numpy(w))
        conv.b.copy_(torch.from_numpy(b))
    return {"w": jnp.asarray(w), "b": jnp.asarray(b)}, conv


# (length, width, stride, in, out): SAME pads (ceil(L/s)-1)*s + w - L in
# all, split floor/ceil — (11, 9, 4) pads 3 and 4, (8, 9, 4) 2 and 3,
# (13, 5, 3) 1 and 2, (37, 9, 4) 2 and 2, (88, 9, 4) 3 and 4 (the state
# vector of these tests), (22, 9, 4) 3 and 4, (3, 9, 4) 4 and 4.
CONV_CASES = [(11, 9, 4, 1, 3), (8, 9, 4, 1, 2), (13, 5, 3, 3, 4),
              (37, 9, 4, 2, 5), (88, 9, 4, 1, 8), (22, 9, 4, 8, 16),
              (3, 9, 4, 2, 2), (50, 3, 1, 2, 2)]


@pytest.mark.parametrize("length,width,stride,cin,cout", CONV_CASES)
def test_conv1d_matches_lax(length, width, stride, cin, cout):
    params, conv = _conv_pair(width, cin, cout, seed=length)
    x = np.random.default_rng(1).standard_normal(
        (3, length, cin)).astype(np.float32)
    g = np.random.default_rng(2).standard_normal(
        (3, -(-length // stride), cout)).astype(np.float32)
    want, vjp = jax.vjp(
        lambda p, xx: jmodules.conv1d_apply(p, xx, stride=stride),
        params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = conv1d_apply(conv, xt, stride=stride)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **VAL_TOL)
    dp, dx = vjp(jnp.asarray(g))
    gx, gw, gb = torch.autograd.grad(got, (xt, conv.w, conv.b),
                                     torch.from_numpy(g))
    for name, a, b in (("x", gx, dx), ("w", gw, dp["w"]), ("b", gb, dp["b"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **GRAD_TOL)


def test_cnn_tree_matches_reference():
    ja, ta = agent_pair(RES, **CNN)
    assert ta.enc.state_module == "cnn" and ta.enc.state_dim == 88
    names = [n for n, _ in leaves(ta.net) if n.startswith("state.")]
    assert names == ["state.convs.0.b", "state.convs.0.w", "state.convs.1.b",
                     "state.convs.1.w", "state.proj.b", "state.proj.w"]
    assert tuple(ta.net.state.proj.w.shape) == (6 * 16, 8)   # 88 -> 22 -> 6
    flat = jax.tree_util.tree_leaves(ja.params)
    for (name, p), r in zip(leaves(ta.net), flat, strict=True):
        assert np.array_equal(p.detach().numpy(), np.asarray(r)), name
    assert set(params_from_jax(jax_tree_numpy(ja.params))) == \
        set(ta.net.state_dict())


def _batch(cfg, b, seed):
    rng = np.random.default_rng(seed)
    m, t = cfg.n_measurements, cfg.n_offsets
    return {
        "state": rng.uniform(0, 1, (b, cfg.state_dim)).astype(np.float32),
        "meas": rng.uniform(0, 1, (b, m)).astype(np.float32),
        "goal": rng.dirichlet(np.ones(m), b).astype(np.float32),
        "action": rng.integers(0, cfg.n_actions, b).astype(np.int32),
        "target": rng.standard_normal((b, t, m)).astype(np.float32),
        "target_mask": (rng.uniform(size=(b, t)) < 0.7).astype(np.float32),
    }


@pytest.mark.parametrize("backend,jax_backend", PAIRS)
def test_dfp_values_loss_and_26_gradients_match_reference(backend,
                                                           jax_backend):
    ja, ta = agent_pair(RES, seed=3, **CNN)
    ja.set_backend(jax_backend)
    ta.set_backend(backend)
    cfg = ja.dfp
    batch = _batch(cfg, 6, seed=4)
    jx = {k: jnp.asarray(v) for k, v in batch.items()}
    tx = {k: torch.from_numpy(v) for k, v in batch.items()}
    jp = jdfp.predict(ja.params, cfg, jx["state"], jx["meas"], jx["goal"])
    tp = tdfp.predict(ta.net, ta.dfp, tx["state"], tx["meas"], tx["goal"])
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **VAL_TOL)
    ju = jdfp.action_values(ja.params, cfg, jx["state"], jx["meas"],
                            jx["goal"])
    tu = tdfp.action_values(ta.net, ta.dfp, tx["state"], tx["meas"],
                            tx["goal"])
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **VAL_TOL)
    jloss, jgrads = jax.value_and_grad(jdfp.loss_fn)(ja.params, cfg, jx)
    names, ps = zip(*leaves(ta.net))
    loss = tdfp.loss_fn(ta.net, ta.dfp, tx)
    grads = torch.autograd.grad(loss, ps)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(grads) == 26
    for name, g, r in zip(names, grads, jleaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name,
                                   **GRAD_TOL)


def test_kernel_backend_runs_only_the_ten_heads_through_the_wrapper(
        monkeypatch):
    """The convs and the projection stay plain on the kernel backend: a
    forward calls the fused-MLP wrapper for the ten head layers alone."""
    _, ta = agent_pair(RES, **CNN)
    calls = []
    fused = tbackend.fused_mlp

    def counting(x, w, b, **kw):
        calls.append((tuple(x.shape), tuple(w.shape)))
        return fused(x, w, b, **kw)

    monkeypatch.setattr(tbackend, "fused_mlp", counting)
    cfg = ta.dfp
    x = {k: torch.from_numpy(v) for k, v in _batch(cfg, 4, 0).items()}
    tdfp.predict(ta.net, cfg, x["state"], x["meas"], x["goal"])
    assert len(calls) == 10
    assert all(w[0] != ta.net.state.proj.w.shape[0] for _, w in calls)


def test_npz_and_checkpoints_cross_packages(tmp_path):
    ja, ta = agent_pair(RES, seed=1, **CNN)
    ja.epsilon = 0.25
    ja.save(str(tmp_path / "ref.npz"))
    _, tb = agent_pair(RES, seed=2, **CNN)
    tb.load(str(tmp_path / "ref.npz"))
    for (name, p), r in zip(leaves(tb.net),
                            jax.tree_util.tree_leaves(ja.params)):
        assert np.array_equal(p.detach().numpy(), np.asarray(r)), name
    assert tb.epsilon == 0.25
    with torch.no_grad():
        for _, p in leaves(tb.net):
            p.add_(0.5)
    tb.save(str(tmp_path / "port.npz"))
    ja.load(str(tmp_path / "port.npz"))
    for (name, p), r in zip(leaves(tb.net),
                            jax.tree_util.tree_leaves(ja.params)):
        assert np.array_equal(p.detach().numpy(), np.asarray(r)), name
    _, mlp = agent_pair(RES, seed=1)    # the MLP module: 26 leaves, other shapes
    with pytest.raises(ValueError, match="shape mismatch"):
        mlp.load(str(tmp_path / "port.npz"))
    # Checkpoint directories, both ways, by path.
    jck.CheckpointManager(str(tmp_path / "jck")).save(ja.params, 5)
    net, manifest = restore_pytree(ta.net, str(tmp_path / "jck"))
    assert manifest["step"] == 5
    for (name, p), r in zip(leaves(net), jax.tree_util.tree_leaves(ja.params)):
        assert np.array_equal(p.detach().numpy(), np.asarray(r)), name
    save_pytree(tb.net, str(tmp_path / "tck"), step=6)
    out, _ = jck.restore_pytree(ja.params, str(tmp_path / "tck"))
    for (name, p), r in zip(leaves(tb.net), jax.tree_util.tree_leaves(out)):
        assert np.array_equal(p.detach().numpy(), np.asarray(r)), name


def test_greedy_rollouts_match_reference_sequential_and_device():
    """The same weights replay traces greedily: the port's sequential
    engine gives the reference's decisions and result (no greedy decision
    within a top-2 margin of 1e-5); the port's device engine, on classic
    rows, gives the reference device engine's actions (N = 2) and the
    port's sequential run (N = 1)."""
    ja, ta = agent_pair(RES, seed=4, **CNN)
    jobs = {pkg: [synth_jobs(PKGS[pkg], s, n=30) for s in (7, 8)]
            for pkg in PKGS}
    seq = {}
    for pkg, agent, res in (("jax", ja, RES), ("torch", ta, T_RES)):
        seq[pkg] = PKGS[pkg].run_trace(res, jobs[pkg][0], agent)
    assert_results_equal(seq["jax"], seq["torch"])
    rows, actions = [], []
    sim = tsim.Simulator(T_RES, jobs["torch"][0], None)
    while (ctx := sim.next_decision()) is not None:
        row = np.zeros(tenc.decision_row_dim(ta.enc, 10), np.float32)
        tenc.encode_decision_row(ta.enc, ctx, 10, out=row)
        rows.append(row)
        actions.append(ta.select(ctx))
        sim.post_action(actions[-1])
    assert min(values_and_margin(ta, np.stack(rows))[1]) > 1e-5
    rj = jsim.DeviceSimulator(RES, jobs["jax"], ja).rollout()
    rt = tsim.DeviceSimulator(T_RES, jobs["torch"], ta,
                              device="cpu").rollout(collect=True)
    np.testing.assert_array_equal(rt.actions, rj.actions)
    np.testing.assert_array_equal(rt.decided, rj.decided)
    for a, b in zip(rj.results, rt.results):
        assert_results_close(a, b)
    row_dim = tenc.decision_row_dim(ta.enc, 10)
    assert rt.obs.shape[-1] == row_dim == jenc.decision_row_dim(ja.enc, 10)
    one = tsim.DeviceSimulator(T_RES, jobs["torch"][:1], ta,
                               device="cpu").rollout()
    assert env_actions(one, 0) == actions
    assert_results_close(seq["torch"], one.results[0])


TRAIN = dict(stream_hidden=16, batch_size=16, grad_steps_per_episode=4,
             eps_decay=0.9, **CNN)


def test_train_agent_matches_reference():
    """Three episodes of a tiny CNN agent from identical weights (port
    kernel backend, reference XLA): the same decisions, episode metrics
    and epsilon, losses within rtol 1e-4; no greedy decision within a
    top-2 margin of 1e-5."""
    ja, ta = agent_pair(RES, **TRAIN)
    margins = []
    select = ta.select

    def guarded(ctx):
        if copy.deepcopy(ta.rng).uniform() >= ta.epsilon:
            row = np.zeros((1, tenc.decision_row_dim(ta.enc, 10)), np.float32)
            tenc.encode_decision_row(ta.enc, ctx, 10, out=row[0])
            margins.append(float(values_and_margin(ta, row)[1][0]))
        return select(ctx)

    ta.select = guarded
    jlog = jtrain_agent(ja, RES, [synth_jobs(jsim, s) for s in range(3)])
    log = train_agent(ta, T_RES, [synth_jobs(tsim, s) for s in range(3)])
    assert log.episode_metrics == jlog.episode_metrics
    assert log.decisions == jlog.decisions > 0
    assert ta.epsilon == ja.epsilon < 1.0
    np.testing.assert_allclose(log.episode_losses, jlog.episode_losses,
                               rtol=1e-4)
    for te, je in zip(ta.replay.episodes, ja.replay.episodes, strict=True):
        for f in ("states", "meas", "goals", "actions"):
            assert np.array_equal(getattr(te, f), getattr(je, f)), f
    assert not margins or min(margins) > 1e-5
