"""The port's attention state module against the JAX package's, from the
same weights (carried across with ``repro_torch.convert``) and the same
numpy inputs: the encoder's outputs and gradients on each pair of
backends, the attention state layout on a real trace, the DFP forward,
loss and 60 gradient leaves, checkpoints across packages, greedy
sequential and device rollouts, a 3-episode ``train_agent`` and the
decision service."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.encoding as jenc
import repro.nn.queue_encoder as jqe
import repro.sim as jsim
import repro_torch.core.encoding as tenc
import repro_torch.nn.queue_encoder as tqe
import repro_torch.sim as tsim
from repro.core import dfp as jdfp
from repro.core import train_agent as jtrain_agent
from repro_torch.convert import leaves, params_from_jax
from repro_torch.core import dfp as tdfp
from repro_torch.core import train_agent
from repro_torch.serve import DecisionService, ServeConfig
from _torch_parity import (ATTENTION, PKGS, agent_pair,
                           assert_results_close, assert_results_equal,
                           env_actions, jax_tree_numpy, synth_jobs,
                           theta_mini, values_and_margin)

RES = [jsim.ResourceSpec("node", 16), jsim.ResourceSpec("bb", 8)]
T_RES = [tsim.ResourceSpec(r.name, r.capacity, r.unit) for r in RES]
VAL_TOL = dict(rtol=2e-4, atol=2e-4)       # tests/test_queue_encoder.py
GRAD_TOL = dict(rtol=5e-3, atol=1e-4)
PAIRS = [("torch", "xla"), ("kernel", "pallas")]


def _enc_cfgs():
    """tests/test_queue_encoder.py's enc_cfg(queue_cap=8) in both packages."""
    kw = dict(queue_cap=8, job_dim=4, ctx_dim=4, window=4, d_model=8,
              n_heads=2, n_layers=2, mlp_mult=2, out_dim=16)
    return jqe.QueueEncoderConfig(**kw), tqe.QueueEncoderConfig(**kw)


def _attention_states(b, q, jd, extra, seed):
    """(b, Q*jd + 1 + extra) rows of the attention layout: random tokens
    zeroed past each row's queue length, lengths 0 and Q among them when
    b > 1."""
    rng = np.random.default_rng(seed)
    state = rng.normal(size=(b, q * jd + 1 + extra)).astype(np.float32)
    qlen = rng.integers(1, q, b)
    if b > 1:
        qlen[:2] = (q, 0)            # a full and an empty queue among them
    toks = state[:, :q * jd].reshape(b, q, jd)
    for i, n in enumerate(qlen):
        toks[i, n:] = 0.0
    state[:, q * jd] = qlen
    return state


@pytest.mark.parametrize("backend,jax_backend", PAIRS)
@pytest.mark.parametrize("b", [1, 5])
def test_encoder_matches_reference(backend, jax_backend, b):
    """``encode_queue_tokens`` and ``queue_state_features``: outputs, and
    the gradient of a fixed projection of each with respect to all 40
    encoder leaves."""
    jcfg, tcfg = _enc_cfgs()
    params = jqe.queue_encoder_init(jax.random.PRNGKey(b), jcfg)
    enc = tqe.QueueEncoder(tcfg)
    enc.load_state_dict(params_from_jax(jax_tree_numpy(params)))
    state = _attention_states(b, 8, 4, 4, seed=b)
    rng = np.random.default_rng(10 + b)
    ct_h = rng.normal(size=(b, 9, 8)).astype(np.float32)
    ct_y = rng.normal(size=(b, 16)).astype(np.float32)
    pieces = (state[:, :32].reshape(b, 8, 4), state[:, 32], state[:, 33:])

    def jax_fns(p):
        h = jqe.encode_queue_tokens(p, jcfg, *map(jnp.asarray, pieces),
                                    backend=jax_backend)
        y = jqe.queue_state_features(p, jcfg, jnp.asarray(state),
                                     backend=jax_backend)
        return h, y

    @jax.jit
    def reference(p):                 # one compile: eager JAX is slow here
        (h, y), vjp = jax.vjp(jax_fns, p)
        return (h, y, vjp((ct_h, jnp.zeros_like(y)))[0],
                vjp((jnp.zeros_like(h), ct_y))[0])

    jh, jy, jg_h, jg_y = reference(params)
    names, ps = zip(*leaves(enc))
    h = tqe.encode_queue_tokens(enc, tcfg, *(torch.from_numpy(a.copy())
                                             for a in pieces),
                                backend=backend)
    y = tqe.queue_state_features(enc, tcfg, torch.from_numpy(state),
                                 backend=backend)
    # ``out`` is not on h's path: its gradient is zero, as jax.vjp gives.
    g_h = [torch.zeros_like(p) if g is None else g for p, g in zip(
        ps, torch.autograd.grad((h * torch.from_numpy(ct_h)).sum(), ps,
                                allow_unused=True))]
    g_y = torch.autograd.grad((y * torch.from_numpy(ct_y)).sum(), ps)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), **VAL_TOL)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **VAL_TOL)
    for got, want in ((g_h, jg_h), (g_y, jg_y)):
        jleaves = jax.tree_util.tree_leaves(want)
        assert len(jleaves) == len(got) == 40
        for name, g, r in zip(names, got, jleaves):
            np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                       err_msg=name, **GRAD_TOL)


def test_encode_state_is_bit_identical_on_a_trace():
    """The attention layout of every decision of a mini Theta S1 replay
    (first-slot policy), in both packages, bit for bit; some decisions see
    more than Q = 12 waiting jobs."""
    cfgs, sims = {}, {}
    for pkg, enc_mod in (("jax", jenc), ("torch", tenc)):
        res, jobs = theta_mini(pkg, "S1")
        cfgs[pkg] = enc_mod.EncodingConfig(
            window=4, resource_names=tuple(r.name for r in res),
            capacities=tuple(r.capacity for r in res),
            state_module="attention", queue_cap=12)
        sims[pkg] = PKGS[pkg].Simulator(res, jobs, None,
                                        PKGS[pkg].SimConfig(window=4))
    assert cfgs["torch"].state_dim == cfgs["jax"].state_dim == 12 * 4 + 5
    n, over = 0, 0
    while True:
        ctxs = {pkg: sim.next_decision() for pkg, sim in sims.items()}
        if ctxs["jax"] is None:
            assert ctxs["torch"] is None
            break
        a = jenc.encode_state(cfgs["jax"], ctxs["jax"])
        b = tenc.encode_state(cfgs["torch"], ctxs["torch"])
        assert a.dtype == b.dtype and np.array_equal(a, b), n
        over += ctxs["torch"].queue_len > 12
        for sim in sims.values():
            sim.post_action(0)
        n += 1
    assert n > 300 and over > 0


@pytest.mark.parametrize("backend,jax_backend", PAIRS)
def test_dfp_values_loss_and_60_gradients_match_reference(backend,
                                                           jax_backend):
    ja, ta = agent_pair(RES, seed=3, **ATTENTION)
    ja.set_backend(jax_backend)
    ta.set_backend(backend)
    cfg = ja.dfp
    b, m = 5, cfg.n_measurements
    rng = np.random.default_rng(4)
    batch = {
        "state": _attention_states(b, 12, 4, 4, seed=5),
        "meas": rng.uniform(0, 1, (b, m)).astype(np.float32),
        "goal": rng.dirichlet(np.ones(m), b).astype(np.float32),
        "action": rng.integers(0, cfg.n_actions, b).astype(np.int32),
        "target": rng.standard_normal((b, cfg.n_offsets, m)).astype(np.float32),
        "target_mask": (rng.uniform(size=(b, cfg.n_offsets)) < 0.7).astype(
            np.float32),
    }
    jx = {k: jnp.asarray(v) for k, v in batch.items()}
    tx = {k: torch.from_numpy(v) for k, v in batch.items()}
    ju = jax.jit(jdfp.action_values, static_argnums=1)(
        ja.params, cfg, jx["state"], jx["meas"], jx["goal"])
    tu = tdfp.action_values(ta.net, ta.dfp, tx["state"], tx["meas"],
                            tx["goal"])
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **VAL_TOL)
    jloss, jgrads = jax.jit(jax.value_and_grad(jdfp.loss_fn),
                            static_argnums=1)(ja.params, cfg, jx)
    names, ps = zip(*leaves(ta.net))
    loss = tdfp.loss_fn(ta.net, ta.dfp, tx)
    grads = torch.autograd.grad(loss, ps)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(grads) == 60
    for name, g, r in zip(names, grads, jleaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name,
                                   **GRAD_TOL)


def test_npz_crosses_packages_and_the_other_module_raises(tmp_path):
    ja, ta = agent_pair(RES, seed=1, **ATTENTION)
    ja.epsilon = 0.25
    ja.save(str(tmp_path / "ref.npz"))
    _, tb = agent_pair(RES, seed=2, **ATTENTION)
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
    jm, tm = agent_pair(RES, seed=1)                  # the MLP module
    jm.save(str(tmp_path / "mlp.npz"))
    with pytest.raises(ValueError, match="incompatible parameter tree"):
        tb.load(str(tmp_path / "mlp.npz"))
    with pytest.raises(ValueError, match="incompatible parameter tree"):
        tm.load(str(tmp_path / "port.npz"))


def test_greedy_rollouts_match_reference_sequential_and_device():
    """The same weights replay a trace greedily: the port's sequential
    engine gives the reference's decisions and result (no greedy decision
    within a top-2 margin of 1e-5), and the port's device engine (N = 2)
    gives the reference device engine's actions and results; with N = 1
    it follows the port's sequential engine."""
    ja, ta = agent_pair(RES, seed=4, **ATTENTION)
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
    assert len(actions) == seq["torch"].decisions
    assert min(values_and_margin(ta, np.stack(rows))[1]) > 1e-5
    rj = jsim.DeviceSimulator(RES, jobs["jax"], ja).rollout()
    rt = tsim.DeviceSimulator(T_RES, jobs["torch"], ta,
                              device="cpu").rollout()
    np.testing.assert_array_equal(rt.actions, rj.actions)
    np.testing.assert_array_equal(rt.decided, rj.decided)
    for a, b in zip(rj.results, rt.results):
        assert_results_close(a, b)
    assert rt.results[0].truncated_jobs == rj.results[0].truncated_jobs
    one = tsim.DeviceSimulator(T_RES, jobs["torch"][:1], ta,
                               device="cpu").rollout()
    assert env_actions(one, 0) == actions
    assert_results_close(seq["torch"], one.results[0])


TRAIN = dict(stream_hidden=16, batch_size=16, grad_steps_per_episode=4,
             eps_decay=0.9, **ATTENTION)


def test_train_agent_matches_reference():
    """Three episodes of a tiny attention agent from identical weights:
    the same decisions, episode metrics and epsilon, losses within rtol
    1e-4 (port kernel backend, reference XLA backend)."""
    ja, ta = agent_pair(RES, **TRAIN)
    jlog = jtrain_agent(ja, RES, [synth_jobs(jsim, s) for s in range(3)])
    log = train_agent(ta, T_RES, [synth_jobs(tsim, s) for s in range(3)])
    assert log.episode_metrics == jlog.episode_metrics
    assert log.decisions == jlog.decisions > 0
    assert [e["epsilon"] for e in log.episodes] == \
        [e["epsilon"] for e in jlog.episodes]
    assert ta.epsilon == ja.epsilon < 1.0
    assert len(log.episode_losses) == len(jlog.episode_losses) == 3
    np.testing.assert_allclose(log.episode_losses, jlog.episode_losses,
                               rtol=1e-4)
    for te, je in zip(ta.replay.episodes, ja.replay.episodes, strict=True):
        for f in ("states", "meas", "goals", "actions"):
            assert np.array_equal(getattr(te, f), getattr(je, f)), f


def test_service_answers_like_select():
    """tests/test_queue_encoder.py's serving smoke test on the port: the
    service takes the attention rows and answers as ``agent.select``."""
    _, ta = agent_pair(RES, seed=6, **ATTENTION)
    sim = tsim.Simulator(T_RES, synth_jobs(tsim, 11, n=18), None,
                         tsim.SimConfig(window=10))
    ctxs = []
    while len(ctxs) < 6 and (ctx := sim.next_decision()) is not None:
        ctxs.append(ctx)
        sim.post_action(ta.select(ctx))
    assert len(ctxs) == 6
    with DecisionService(ta, ServeConfig(max_batch=4, warmup=False)) as svc:
        for c in ctxs:
            assert svc.decide(c) == ta.select(c)
