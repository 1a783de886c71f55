"""The port's comparison policies (``repro_torch.core.policies``: GA and
ScalarRL) and the agent's ``goal_log`` against the JAX package's, on the
same traces: GA bit for bit; ScalarRL's greedy and batched decisions, one
REINFORCE step (loss and parameters) and a sampled training episode with
converted parameters; ScalarRL on the port's device engine against its
sequential run (tests/test_policies.py, tests/test_device.py)."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (PKGS, agent_pair, assert_results_close,
                           assert_results_equal, env_actions, jax_tree_numpy,
                           result_rows, synth_jobs)
from repro.core import policies as jpolicies
from repro_torch.convert import leaves, load_policy_params
from repro_torch.core import policies as tpolicies
from repro_torch.core.policy_api import supports_batch, supports_device
from repro_torch.sim import DeviceSimulator, SimConfig, Simulator, run_trace

JSIM, TSIM = PKGS["jax"], PKGS["torch"]
SIM = {"jax": JSIM, "torch": TSIM}
POL = {"jax": jpolicies, "torch": tpolicies}
CAPS = (("node", 16), ("bb", 8))
HIDDEN = (32, 16)
# One REINFORCE step and the parameters after it (the chip script's
# tolerances for the same step on the card).
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-3, 1e-4


def res(pkg):
    return [SIM[pkg].ResourceSpec(n, c) for n, c in CAPS]


def scalar_pair(hidden=HIDDEN, seed=0):
    """A JAX ScalarRL and the port's (CPU) with the JAX one's weights."""
    cfg = dict(hidden=hidden, seed=seed)
    jp = jpolicies.ScalarRLPolicy(res("jax"), jpolicies.ScalarRLConfig(**cfg))
    tp = tpolicies.ScalarRLPolicy(res("torch"),
                                  tpolicies.ScalarRLConfig(**cfg),
                                  device="cpu")
    load_policy_params(tp, jax_tree_numpy(jp.params))
    return jp, tp


def scores_and_margin(policy, obs: np.ndarray, mask: np.ndarray):
    """Slot scores of ``obs`` rows in float64 (invalid slots -inf) and
    each row's top-2 margin: the yardstick a divergence between the two
    packages' float32 forwards is measured against."""
    state = copy.deepcopy(policy.init_state()).double()
    with torch.no_grad():
        s = policy.score_window(state, torch.from_numpy(
            obs.astype(np.float64))).numpy()
    s = np.where(mask, s, -np.inf)
    top2 = np.sort(s, axis=1)[:, -2:]
    return s, top2[:, 1] - top2[:, 0]


class Recorder:
    """Wrap a policy's ``select`` so its actions (and, for the port's
    ScalarRL, each decision's top-2 margin) are kept."""

    def __init__(self, policy, guard=False):
        self.policy, self.guard = policy, guard
        self.actions, self.margins = [], []

    def select(self, ctx) -> int:
        if self.guard:
            p = self.policy
            obs = p._encode_rows([ctx], p.config.window)
            mask = np.zeros((1, p.config.window), bool)
            mask[0, :min(len(ctx.window), p.config.window)] = True
            self.margins.append(float(scores_and_margin(p, obs, mask)[1][0]))
        a = int(self.policy.select(ctx))
        self.actions.append(a)
        return a


def guarded_prefix(margins, tol=1e-4):
    """Decisions compared: all of them up to the first near-tie."""
    ties = np.flatnonzero(np.asarray(margins) <= tol)
    return int(ties[0]) if len(ties) else len(margins)


# ------------------------------------------------------------------- GA
def test_ga_is_host_only():
    ga = tpolicies.GAOptimizer()
    assert not supports_device(ga) and not supports_batch(ga)


def test_ga_evolve_matches_reference():
    """tests/test_policies.py's Fig. 1 window: the same evolved order from
    the same seed."""
    orders = {}
    for pkg in ("jax", "torch"):
        sim = SIM[pkg]
        w = [sim.Job(0, 0, 10, 10, {"node": 7, "bb": 1}),
             sim.Job(1, 0, 10, 10, {"node": 5, "bb": 6}),
             sim.Job(2, 0, 10, 10, {"node": 3, "bb": 3}),
             sim.Job(3, 0, 10, 10, {"node": 4, "bb": 1})]
        ga = POL[pkg].GAOptimizer(POL[pkg].GAConfig(population=16,
                                                    generations=12, seed=0))
        orders[pkg] = [int(i) for i in ga._evolve(
            w, {"node": 10, "bb": 10}, {"node": 10, "bb": 10})]
    assert orders["jax"] == orders["torch"]


@pytest.mark.parametrize("seed", [0, 3])
def test_ga_schedules_bit_identically(seed):
    out = {}
    for pkg in ("jax", "torch"):
        jobs = synth_jobs(SIM[pkg], seed, n=40)
        ga = POL[pkg].GAOptimizer(POL[pkg].GAConfig(population=8,
                                                    generations=4, seed=1))
        out[pkg] = SIM[pkg].run_trace(res(pkg), jobs, ga)
    assert_results_equal(out["jax"], out["torch"])
    assert result_rows(out["jax"]) == result_rows(out["torch"])


# ------------------------------------------------------------- ScalarRL
def test_scalar_rl_greedy_select_matches_reference():
    jp, tp = scalar_pair()
    jrec, trec = Recorder(jp), Recorder(tp, guard=True)
    jres = JSIM.run_trace(res("jax"), synth_jobs(JSIM, 5, n=40), jrec)
    tres = run_trace(res("torch"), synth_jobs(TSIM, 5, n=40), trec)
    n = guarded_prefix(trec.margins)
    assert n > 10 and jrec.actions[:n] == trec.actions[:n]
    if n == len(trec.margins):
        assert_results_equal(jres, tres)


def test_scalar_rl_select_batch_matches_reference_and_select():
    jp, tp = scalar_pair()
    ctxs = {}
    for pkg, pol in (("jax", jp), ("torch", tp)):
        sims = [SIM[pkg].Simulator(res(pkg), synth_jobs(SIM[pkg], s, n=30),
                                   pol, SIM[pkg].SimConfig(window=10))
                for s in range(6)]
        for s in sims:                  # a few decisions in, varied queues
            for _ in range(4):
                assert s.next_decision() is not None
                s.post_action(0)
        ctxs[pkg] = [s.next_decision() for s in sims]
    assert all(c is not None for c in ctxs["torch"])
    obs = tp._encode_rows(ctxs["torch"], 10)
    mask = np.zeros((len(obs), 10), bool)
    for i, c in enumerate(ctxs["torch"]):
        mask[i, :min(len(c.window), 10)] = True
    _, margins = scores_and_margin(tp, obs, mask)
    assert (margins > 1e-4).all(), margins
    got = [int(a) for a in tp.select_batch(ctxs["torch"])]
    assert got == [int(a) for a in jp.select_batch(ctxs["jax"])]
    assert got == [tp.select(c) for c in ctxs["torch"]]


def test_scalar_rl_pg_step_matches_reference():
    jp, tp = scalar_pair()
    rng = np.random.default_rng(0)
    n, w, sd = 24, 10, tp.enc.state_dim
    mask = np.zeros((n, w), bool)
    for i, k in enumerate(rng.integers(1, w + 1, size=n)):
        mask[i, :k] = True
    action = np.array([rng.integers(0, mask[i].sum()) for i in range(n)])
    batch = {"state": rng.random((n, sd)).astype(np.float32),
             "action": action.astype(np.int32), "mask": mask,
             "ret": rng.standard_normal(n).astype(np.float32)}
    jparams, _, jloss = jpolicies._pg_step(
        jp.params, jp.opt_state, {k: jnp.asarray(v) for k, v in batch.items()},
        w, 3e-4, 1e-3)
    opt, tloss = tpolicies._pg_step(
        tp.params, tp.opt_state,
        {k: torch.from_numpy(v) for k, v in batch.items()}, 3e-4, 1e-3)
    assert int(opt.step) == 1
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    for (name, p), want in zip(leaves(tp.params),
                               jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=name)


class ChoiceGuard:
    """Stand in for a policy's numpy ``rng``: ``choice(n, p=...)`` keeps
    the probabilities and the uniform draw numpy's choice reads (from a
    copy of the stream), then draws from the real generator."""

    def __init__(self, rng):
        self.rng, self.probs, self.draws = rng, [], []

    def choice(self, n, p):
        self.probs.append(np.asarray(p, np.float64))
        self.draws.append(copy.deepcopy(self.rng).random())
        return self.rng.choice(n, p=p)


def test_scalar_rl_training_episode_matches_reference():
    """One sampled episode from the same numpy seed: equal actions while
    every draw lies farther from its cumulative-probability boundaries
    than the two packages' cumulative probabilities differ; then, when
    the whole episode agrees, ``end_episode``'s loss and parameters."""
    jp, tp = scalar_pair()
    jp.training = tp.training = True
    jp.rng, tp.rng = ChoiceGuard(jp.rng), ChoiceGuard(tp.rng)
    jrec, trec = Recorder(jp), Recorder(tp)
    JSIM.run_trace(res("jax"), synth_jobs(JSIM, 2, n=40), jrec)
    run_trace(res("torch"), synth_jobs(TSIM, 2, n=40), trec)
    n_cmp = 0
    for pj, pt, u, aj, at in zip(jp.rng.probs, tp.rng.probs, tp.rng.draws,
                                 jrec.actions, trec.actions):
        cj, ct = np.cumsum(pj) / pj.sum(), np.cumsum(pt) / pt.sum()
        if np.abs(cj - ct).max() >= np.abs(ct - u).min():
            break
        assert aj == at, n_cmp
        n_cmp += 1
    assert n_cmp > 10
    if n_cmp < len(trec.actions):
        return
    assert jrec.actions == trec.actions
    jloss, tloss = jp.end_episode(), tp.end_episode()
    assert np.isfinite(tloss) and tp.losses == [tloss]
    np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL)
    for (name, p), want in zip(leaves(tp.params),
                               jax.tree_util.tree_leaves(jp.params)):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=name)
    assert tp.end_episode() is None        # buffers were cleared


def test_scalar_rl_refuses_batched_training():
    _, tp = scalar_pair()
    tp.training = True
    sim = Simulator(res("torch"), synth_jobs(TSIM, 1, n=10), tp,
                    SimConfig(window=10))
    with pytest.raises(RuntimeError, match="evaluation-only"):
        tp.select_batch([sim.next_decision()])


def test_scalar_rl_device_engine_equals_sequential():
    """tests/test_device.py's ScalarRL pin on the port's device engine."""
    rl = tpolicies.ScalarRLPolicy(res("torch"),
                                  tpolicies.ScalarRLConfig(hidden=(16, 8)),
                                  device="cpu")
    assert supports_device(rl)
    jobs = synth_jobs(TSIM, 7, n=40)
    rec = Recorder(rl)
    seq = Simulator(res("torch"), jobs, rec, SimConfig()).run()
    ro = DeviceSimulator(res("torch"), [jobs], rl, device="cpu").rollout()
    assert env_actions(ro, 0) == rec.actions
    assert_results_close(seq, ro.results[0])


def test_load_policy_params_rejects_another_shape():
    jp, _ = scalar_pair(hidden=(8, 4))
    _, tp = scalar_pair()
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_policy_params(tp, jax_tree_numpy(jp.params))


# ------------------------------------------------------------- goal_log
def test_goal_log_matches_reference_on_both_paths():
    """One goal per decision, equal to the reference's, on ``select``
    (sequential) and ``select_batch`` (lockstep), in evaluation."""
    ja, ta = agent_pair(res("torch"))
    jsets = [synth_jobs(JSIM, s, n=30) for s in range(3)]
    tsets = [synth_jobs(TSIM, s, n=30) for s in range(3)]
    jr = JSIM.run_trace(res("jax"), jsets[0], ja)
    tr = run_trace(res("torch"), tsets[0], ta)
    assert len(ta.goal_log) == tr.decisions == jr.decisions
    np.testing.assert_array_equal(np.stack(ta.goal_log),
                                  np.stack(ja.goal_log))
    ja.goal_log.clear()
    ta.goal_log.clear()
    jv = JSIM.run_traces(res("jax"), jsets, ja)
    tv = TSIM.run_traces(res("torch"), tsets, ta)
    assert len(ta.goal_log) == sum(r.decisions for r in tv) \
        == sum(r.decisions for r in jv)
    np.testing.assert_array_equal(np.stack(ta.goal_log),
                                  np.stack(ja.goal_log))
    assert all(g.shape == (2,) for g in ta.goal_log)


def test_goal_log_records_training_decisions():
    _, ta = agent_pair(res("torch"))
    ta.training = True
    r = run_trace(res("torch"), synth_jobs(TSIM, 4, n=30), ta)
    assert len(ta.goal_log) == r.decisions
    ta.goal_log.clear()
    sims = [Simulator(res("torch"), synth_jobs(TSIM, s, n=20), ta,
                      SimConfig(window=10)) for s in range(2)]
    ta.begin_vector_episodes(2)
    ta.select_batch([s.next_decision() for s in sims], slots=[0, 1])
    assert len(ta.goal_log) == 2
