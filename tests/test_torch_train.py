"""Sequential DFP training in the port against the JAX package: the loss
and every gradient leaf, one Adam step, replay sampling, a 3-episode
``train_agent`` run from identical weights, and the epsilon a fresh agent
saves.  Inputs come from numpy with a seed; weights are carried across
with ``repro_torch.convert``."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dfp as jdfp
from repro.core import evaluate as jevaluate
from repro.core import train_agent as jtrain_agent
from repro.core.replay import EpisodeRecorder as JRecorder
from repro.core.replay import ReplayBuffer as JReplay
from repro.nn import optim as joptim
from repro_torch.convert import leaves
from repro_torch.core import EpisodeRecorder, FCFSPolicy, ReplayBuffer
from repro_torch.core import dfp as tdfp
from repro_torch.core import evaluate, train_agent
from repro_torch.core.encoding import decision_row_dim, encode_decision_row
from repro_torch.nn import optim as toptim
from repro_torch.sim import run_trace
from _torch_parity import (PKGS, agent_pair, synth_jobs, values_and_margin)

RES = [PKGS["jax"].ResourceSpec("node", 16), PKGS["jax"].ResourceSpec("bb", 8)]
T_RES = [PKGS["torch"].ResourceSpec(r.name, r.capacity, r.unit) for r in RES]
# tests/test_train.py's small_agent (with _torch_parity's SMALL widths).
TRAIN = dict(stream_hidden=16, batch_size=16, grad_steps_per_episode=4,
             eps_decay=0.9)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)      # tests/test_kernels.py's grads


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


@pytest.mark.parametrize("jax_backend", ["xla", "pallas"])
@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_loss_and_gradients_match_reference(backend, jax_backend):
    ja, ta = agent_pair(RES, seed=4, **TRAIN)
    ja.set_backend(jax_backend)
    ta.set_backend(backend)
    batch = _batch(ja.dfp, 16, seed=1)
    jloss, jgrads = jax.value_and_grad(jdfp.loss_fn)(
        ja.params, ja.dfp, {k: jnp.asarray(v) for k, v in batch.items()})
    params = [p for _, p in leaves(ta.net)]
    loss = tdfp.loss_fn(ta.net, ta.dfp,
                        {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, params)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(grads) == 26
    for (name, _), got, want in zip(leaves(ta.net), grads, jleaves):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=name, **GRAD_TOL)


def test_loss_ignores_masked_offsets_and_is_zero_without_targets():
    _, ta = agent_pair(RES, **TRAIN)
    batch = {k: torch.from_numpy(v) for k, v in _batch(ta.dfp, 4, 2).items()}
    batch["target_mask"] = torch.zeros_like(batch["target_mask"])
    assert tdfp.loss_fn(ta.net, ta.dfp, batch).item() == 0.0   # 0 / max(0, 1)


@pytest.mark.parametrize("clip", [1e-2, 1e3], ids=["clip_active",
                                                   "clip_inactive"])
def test_adam_update_matches_reference(clip):
    """Three updates from the same params and grads: params, moments,
    step and the pre-clip norm after each, within atol 1e-6."""
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = [torch.from_numpy(params[k].copy()) for k in sorted(shapes)]
    jstate, tstate = joptim.adam_init(jp), toptim.adam_init(tp)
    for _ in range(3):
        grads = {k: rng.standard_normal(s).astype(np.float32)
                 for k, s in shapes.items()}
        jp, jstate = joptim.adam_update(
            {k: jnp.asarray(v) for k, v in grads.items()}, jstate, jp,
            lr=1e-2, grad_clip=clip)
        tstate, gnorm = toptim.adam_update(
            [torch.from_numpy(grads[k]) for k in sorted(shapes)], tstate, tp,
            lr=1e-2, grad_clip=clip)
        want = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                           for g in grads.values()))
        assert (want > clip) == (clip < 1.0)        # the clip does act
        np.testing.assert_allclose(float(gnorm), want, rtol=1e-6)
        assert int(tstate.step) == int(jstate.step)
        for i, k in enumerate(sorted(shapes)):
            for got, ref in ((tp[i], jp[k]), (tstate.mu[i], jstate.mu[k]),
                             (tstate.nu[i], jstate.nu[k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                           rtol=0, atol=1e-6)


def _episodes(n_eps, state_dim, m, seed):
    rng = np.random.default_rng(seed)
    eps = []
    for _ in range(n_eps):
        n = int(rng.integers(1, 40))
        eps.append([(rng.standard_normal(state_dim).astype(np.float32),
                     rng.uniform(0, 1, m).astype(np.float32),
                     rng.dirichlet(np.ones(m)).astype(np.float32),
                     int(rng.integers(0, 10))) for _ in range(n)])
    return eps


def test_replay_sample_is_bit_identical():
    """Recorder, buffer with eviction, and sampling from one rng seed."""
    offsets = (1, 2, 4, 8, 16, 32)
    jbuf, tbuf = JReplay(offsets, 120), ReplayBuffer(offsets, 120)
    for ep in _episodes(9, 11, 2, seed=0):
        jrec, trec = JRecorder(), EpisodeRecorder()
        for row in ep:
            jrec.record(*row)
            trec.record(*row)
        jbuf.add(jrec.finish())
        tbuf.add(trec.finish())
        assert trec.finish() is None
    assert tbuf.rows == jbuf.rows and len(tbuf.episodes) == len(jbuf.episodes)
    jrng, trng = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(4):
        js, ts = jbuf.sample(jrng, 32), tbuf.sample(trng, 32)
        assert js.keys() == ts.keys()
        for k in js:
            assert js[k].dtype == ts[k].dtype and np.array_equal(js[k], ts[k])
    assert jrng.integers(1 << 30) == trng.integers(1 << 30)


def test_fresh_agent_saves_the_reference_epsilon(tmp_path):
    """A fresh agent starts at eps_start in both packages, saves it, and
    each file loads in the other package with it; loading resets Adam."""
    ja, ta = agent_pair(RES)
    assert ta.epsilon == ja.epsilon == 1.0
    ja.save(str(tmp_path / "ref.npz"))
    ta.save(str(tmp_path / "port.npz"))
    assert float(np.load(tmp_path / "ref.npz")["epsilon"]) == \
        float(np.load(tmp_path / "port.npz")["epsilon"]) == 1.0
    jb, tb = agent_pair(RES, seed=1)
    jb.epsilon = tb.epsilon = 0.5
    tb.opt_state = tb.opt_state._replace(step=tb.opt_state.step + 3)
    tb.load(str(tmp_path / "ref.npz"))
    jb.load(str(tmp_path / "port.npz"))
    assert tb.epsilon == jb.epsilon == 1.0
    assert int(tb.opt_state.step) == 0


def _reference_run(jobsets):
    ja, _ = agent_pair(RES, **TRAIN)
    log = jtrain_agent(ja, RES, jobsets)
    return ja, log


@pytest.fixture(scope="module")
def reference_training():
    jobsets = [synth_jobs(PKGS["jax"], s) for s in range(3)]
    ja, log = _reference_run(jobsets)
    result = jevaluate(ja, RES, synth_jobs(PKGS["jax"], 9))
    return ja, log, result


def _guard_margins(agent, margins):
    """Wrap ``agent.select`` so each greedy decision's top-2 margin (float64,
    plain backend, current weights) is kept; the ε draw is peeked on a
    copy of the agent's rng, which is left untouched."""
    select = agent.select

    def guarded(ctx):
        if not (agent.training
                and copy.deepcopy(agent.rng).uniform() < agent.epsilon):
            w = agent.config.window
            row = np.zeros((1, decision_row_dim(agent.enc, w)), np.float32)
            encode_decision_row(agent.enc, ctx, w, out=row[0])
            margins.append(float(values_and_margin(agent, row)[1][0]))
        return select(ctx)

    agent.select = guarded


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_train_agent_matches_reference(reference_training, backend):
    """Three episodes from identical weights: the same decisions (the
    replay rows), episode metrics and epsilon, losses within rtol 1e-4; then
    the same greedy evaluation.  No greedy decision may have a top-2 margin
    within 1e-5, so a near-tie fails here instead of flaking."""
    ja, jlog, jresult = reference_training
    _, ta = agent_pair(RES, **TRAIN)
    ta.set_backend(backend)
    margins = []
    _guard_margins(ta, margins)
    jobsets = [synth_jobs(PKGS["torch"], s) for s in range(3)]
    log = train_agent(ta, T_RES, jobsets)
    assert not ta.training
    assert log.episode_metrics == jlog.episode_metrics
    assert log.decisions == jlog.decisions > 0
    assert [e["epsilon"] for e in log.episodes] == \
        [e["epsilon"] for e in jlog.episodes]
    assert ta.epsilon == ja.epsilon < 1.0
    assert len(log.episode_losses) == len(jlog.episode_losses) == 3
    np.testing.assert_allclose(log.episode_losses, jlog.episode_losses,
                               rtol=1e-4)
    assert ta.losses == log.episode_losses
    np.testing.assert_allclose(ta.last_grad_norm, ja.last_grad_norm,
                               rtol=1e-3)
    assert int(ta.opt_state.step) == int(ja.opt_state.step) == 12
    assert ta.replay.rows == ja.replay.rows
    for te, je in zip(ta.replay.episodes, ja.replay.episodes, strict=True):
        for f in ("states", "meas", "goals", "actions"):
            assert np.array_equal(getattr(te, f), getattr(je, f)), f
    result = evaluate(ta, T_RES, synth_jobs(PKGS["torch"], 9))
    assert result.metrics.as_row() == jresult.metrics.as_row()
    assert result.decisions == jresult.decisions
    assert len(margins) > result.decisions
    assert min(margins) > 1e-5, min(margins)


def test_evaluate_leaves_a_policy_as_it_was():
    """``evaluate`` of a policy without a training mode is a plain replay;
    an agent in training mode is evaluated greedily and left training."""
    jobs = synth_jobs(PKGS["torch"], 3)
    a, b = evaluate(FCFSPolicy(), T_RES, jobs), run_trace(T_RES, jobs,
                                                          FCFSPolicy())
    assert a.metrics.as_row() == b.metrics.as_row()
    _, ta = agent_pair(RES)
    ta.training = True
    evaluate(ta, T_RES, jobs)
    assert ta.training and len(ta.recorder) == 0


def test_train_agent_runs_every_epoch_and_reports(capsys):
    """``epochs`` passes over the jobsets, one logged row per episode, and
    one ``verbose`` line per episode."""
    _, ta = agent_pair(RES, **{**TRAIN, "batch_size": 4,
                               "grad_steps_per_episode": 2})
    jobsets = [synth_jobs(PKGS["torch"], s, n=8) for s in range(2)]
    log = train_agent(ta, T_RES, jobsets, epochs=2, verbose=True)
    assert [(e["epoch"], e["jobset"]) for e in log.episodes] == \
        [(0, "set0"), (0, "set1"), (1, "set0"), (1, "set1")]
    assert log.decisions == sum(e["decisions"] for e in log.episodes)
    assert len(log.episode_losses) == len(ta.losses) == 4
    assert int(ta.opt_state.step) == 8
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 4 and out[0].startswith("[train] epoch 0 set 0:")
