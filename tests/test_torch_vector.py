"""The port's lockstep vector engine against its sequential engine and the
JAX package's vector engine: re-entrant stepping, FCFS and greedy-agent
lockstep replay, batched against single selection, training-mode slots,
engine statistics, the factory refill, unstarted jobs, service-routed
lockstep replay and the engine's ``SimConfig``."""
import inspect

import numpy as np
import pytest

from _torch_parity import (PKGS, agent_pair, assert_results_equal,
                           result_rows, synth_jobs, values_and_margin)
from repro.core import FCFSPolicy as JFCFS
from repro.serve import DecisionService as JService
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServiceSim as JServiceSim
from repro_torch.core import FCFSPolicy, WindowPolicy
from repro_torch.core.encoding import decision_row_dim, encode_decision_row
from repro_torch.serve import (DecisionService, ServeConfig, ServicePolicy,
                               ServiceSim)
from repro_torch.sim import (ENGINES, Job, ResourceSpec, SimConfig,
                             Simulator, VectorSimulator, run_trace,
                             run_traces, sim_config)

JSIM, TSIM = PKGS["jax"], PKGS["torch"]
RES = [ResourceSpec("node", 16), ResourceSpec("bb", 8)]
J_RES = [JSIM.ResourceSpec("node", 16), JSIM.ResourceSpec("bb", 8)]


def jobsets(sim, n, sparse_bb=False):
    """tests/test_vector.py's traces; ``sparse_bb`` zeroes lane 0's burst
    buffer demands, so its contention and goal differ from the others'."""
    sets = [synth_jobs(sim, seed) for seed in range(n)]
    if sparse_bb:
        for j in sets[0]:
            j.demands["bb"] = 0
    return sets


def _row(agent, ctx):
    """One packed decision row of ``ctx``."""
    row = np.zeros(decision_row_dim(agent.enc, agent.config.window),
                   np.float32)
    encode_decision_row(agent.enc, ctx, agent.config.window, out=row)
    return row


def guard_batches(agent, margins):
    """Wrap ``agent.select_batch`` so every batched row's top-2 margin
    (float64, plain backend) is kept."""
    select_batch = agent.select_batch

    def guarded(ctxs, slots=None):
        rows = np.stack([_row(agent, c) for c in ctxs])
        margins.extend(values_and_margin(agent, rows)[1].tolist())
        return select_batch(ctxs, slots=slots)

    agent.select_batch = guarded


def test_reentrant_stepping_matches_run():
    """Driving next_decision/post_action by hand == the run() adapter."""
    jobs = synth_jobs(TSIM, 3)
    ref = run_trace(RES, jobs, FCFSPolicy())
    sim = Simulator(RES, jobs, FCFSPolicy(), SimConfig(window=10))
    policy = FCFSPolicy()
    while (ctx := sim.next_decision()) is not None:
        sim.post_action(policy.select(ctx))
    assert_results_equal(sim.result(), ref)


@pytest.mark.parametrize("n_envs", [1, 3, 8])
def test_vector_fcfs_equals_sequential_and_reference(n_envs):
    """Port vector == port sequential == JAX package vector, result for
    result (every job's schedule, requeues and failures included)."""
    sets = jobsets(TSIM, n_envs)
    seq = [run_trace(RES, js, FCFSPolicy()) for js in sets]
    vec = run_traces(RES, sets, FCFSPolicy())
    ref = JSIM.run_traces(J_RES, jobsets(JSIM, n_envs), JFCFS())
    assert len(vec) == len(seq) == len(ref) == n_envs
    for a, b, c in zip(seq, vec, ref):
        assert result_rows(b) == result_rows(a) == result_rows(c)


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_agent_run_traces_matches_reference(backend):
    """Greedy lockstep replay of four lanes (lane 0 without burst buffer)
    from the same weights: port vector == port sequential == JAX package
    vector.  No batched greedy row may have a top-2 margin within 1e-5."""
    ja, ta = agent_pair(J_RES)
    ta.set_backend(backend)
    margins = []
    guard_batches(ta, margins)
    vec = run_traces(RES, jobsets(TSIM, 4, sparse_bb=True), ta)
    seq = [run_trace(RES, js, ta) for js in jobsets(TSIM, 4, sparse_bb=True)]
    ref = JSIM.run_traces(J_RES, jobsets(JSIM, 4, sparse_bb=True), ja)
    for a, b, c in zip(vec, seq, ref):
        assert_results_equal(a, b)
        assert_results_equal(a, c)
    contested = np.asarray(margins)[np.isfinite(margins)]
    assert len(margins) == sum(r.decisions for r in vec)
    assert contested.size > 100 and contested.min() > 1e-5, contested.min()


def test_select_batch_matches_select():
    """One batched forward == N single forwards, row for row."""
    _, ta = agent_pair(J_RES)
    sims = [Simulator(RES, synth_jobs(TSIM, seed), ta) for seed in range(3)]
    ctxs = [s.next_decision() for s in sims]
    assert all(c is not None for c in ctxs)
    margins = values_and_margin(ta, np.stack([_row(ta, c) for c in ctxs]))[1]
    assert margins.min() > 1e-5
    assert list(ta.select_batch(ctxs)) == [ta.select(c) for c in ctxs]


def test_select_batch_training_requires_slots():
    """Training-mode batched selection needs slot ids, routes each
    transition to its slot's accumulator, and says so when they are
    missing; the slot parameter is how the engine finds out."""
    _, ta = agent_pair(J_RES)
    ctx = Simulator(RES, synth_jobs(TSIM, 0), ta).next_decision()
    ta.training = True
    with pytest.raises(RuntimeError, match="evaluation-only"):
        ta.select_batch([ctx])
    ta.begin_vector_episodes(2)
    ta.select_batch([ctx, ctx], slots=[0, 1])
    ta.select_batch([ctx], slots=[1])
    assert len(ta.vec_recorder.slot(0)) == 1
    assert len(ta.vec_recorder.slot(1)) == 2
    assert ta.vec_recorder.pending_rows() == 3 and len(ta.vec_recorder) == 2
    assert ta.vec_recorder.finish(0) is not None
    assert ta.vec_recorder.finish(0) is None
    assert "slots" in inspect.signature(ta.select_batch).parameters
    assert VectorSimulator([], policy=ta)._slot_aware
    for policy in (FCFSPolicy(), WindowPolicy()):
        assert not VectorSimulator([], policy=policy)._slot_aware
    assert "slots" not in inspect.signature(
        ServicePolicy.select_batch).parameters


def test_vector_stats_match_reference():
    """One batched call a round, batching happened, and every counter
    equals the JAX package's on the same lanes."""
    ja, ta = agent_pair(J_RES)
    vec = VectorSimulator.from_jobsets(RES, jobsets(TSIM, 4), ta)
    results = vec.run()
    jvec = JSIM.VectorSimulator.from_jobsets(J_RES, jobsets(JSIM, 4), ja)
    jvec.run()
    st = vec.stats
    assert st.as_dict() == jvec.stats.as_dict()
    assert st.decisions == sum(r.decisions for r in results)
    assert st.policy_calls == st.rounds < st.decisions
    assert 1 < st.max_batch <= 4 and st.episodes == 0


class _CountingPolicy:
    """Stateful sequential policy: counts its decisions."""

    def __init__(self):
        self.count = 0

    def select(self, ctx):
        self.count += 1
        return 0


def test_from_factory_policy_survives_refill():
    """A refill that hands back a policy-less ``Simulator`` inherits the
    slot's policy instance instead of resetting its state."""
    made = []

    def factory():
        made.append(_CountingPolicy())
        return made[-1]

    vec = VectorSimulator.from_factory(RES, [synth_jobs(TSIM, 0, n=10)],
                                       factory)
    extra = [synth_jobs(TSIM, 1, n=10)]

    def refill(i, result):
        return Simulator(RES, extra.pop(), None) if extra else None

    results = vec.run(refill=refill)
    assert len(results) == 2 and vec.stats.episodes == 2
    assert len(made) == 1
    assert vec.sims[0].policy is made[0]
    assert made[0].count == sum(r.decisions for r in results)


def test_unstarted_jobs_reported_not_dropped():
    """A job that never fits stays in the result and is counted, in both
    packages' vector engines alike."""
    def trace(sim):
        return [sim.Job(0, 0.0, 50.0, 60.0, {"node": 4}),
                sim.Job(1, 1.0, 10.0, 20.0, {"node": 99})]

    (r,) = run_traces([ResourceSpec("node", 8)], [trace(TSIM)], FCFSPolicy())
    (jr,) = JSIM.run_traces([JSIM.ResourceSpec("node", 8)], [trace(JSIM)],
                            JFCFS())
    assert r.n_unstarted == 1 and len(r.jobs) == 2
    assert [j.jid for j in r.started_jobs] == [0]
    assert r.metrics.n_jobs == 1 and r.metrics.avg_wait >= 0.0
    assert result_rows(r) == result_rows(jr)
    assert isinstance(r.jobs[0], Job)


def test_service_run_traces_equals_run_traces():
    """Lockstep replay through the service == direct lockstep replay ==
    the JAX package's service lockstep replay, on the same weights."""
    ja, ta = agent_pair(J_RES, seed=2)
    direct = run_traces(RES, jobsets(TSIM, 3), ta)
    with DecisionService(ta, ServeConfig(max_batch=4)) as svc:
        ssim = ServiceSim(svc, RES)
        assert ssim.sim_cfg.engine == "vector"
        served = ssim.run_traces(jobsets(TSIM, 3))
        hist = svc.stats()["batch_hist"]
    with JService(ja, JServeConfig(max_batch=4)) as svc:
        ref = JServiceSim(svc, J_RES).run_traces(jobsets(JSIM, 3))
    assert max(hist) > 1                      # rounds coalesced
    for a, b, c in zip(served, direct, ref):
        assert_results_equal(a, b)
        assert_results_equal(a, c)


def test_engine_config_matches_reference():
    """``"vector"`` is an engine; ``sim_config`` is ``for_engine``'s
    functional alias, with the reference's validation."""
    assert ENGINES == JSIM.ENGINES
    for kw in ({}, {"engine": "vector", "window": 4, "backfill": False},
               {"engine": "device", "max_events": 9, "max_rounds": 5}):
        got = sim_config(**kw)
        assert vars(got) == vars(JSIM.sim_config(**kw))
        eng = kw.get("engine", "sequential")
        rest = {k: v for k, v in kw.items() if k != "engine"}
        assert vars(SimConfig.for_engine(eng, **rest)) == vars(got)
    with pytest.raises(ValueError, match="unknown engine"):
        sim_config(engine="warp")
    with pytest.raises(ValueError, match="window"):
        SimConfig.for_engine("vector", window=0)
