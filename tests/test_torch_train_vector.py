"""Vectorised DFP training in the port: N=1 against the port's sequential
trainer, N=3 heterogeneous lanes and interleaved per-round steps against
the JAX package's vectorised trainer from identical weights, lane
dealing, the lane and state-module checks, and the sequential trainer's
episode rows.  Every greedy decision of a parity run is guarded by its
top-2 margin, so a near-tie fails clearly instead of flaking."""
import copy

import numpy as np
import pytest

from _torch_parity import PKGS, agent_pair, synth_jobs, values_and_margin
from repro.core import EnvSlot as JEnvSlot
from repro.core import TrainConfig as JTrainConfig
from repro.core import slots_from_jobsets as jslots_from_jobsets
from repro.core import train_agent as jtrain_agent
from repro.core import train_agent_vectorized as jtrain_vectorized
from repro.workloads import scale_resources as jscale
from repro_torch.core import (EnvSlot, TrainConfig, TrainLog,
                              slots_from_jobsets, train_agent,
                              train_agent_vectorized)
from repro_torch.core.encoding import decision_row_dim, encode_decision_row
from repro_torch.sim import ResourceSpec
from repro_torch.workloads import scale_resources

JSIM, TSIM = PKGS["jax"], PKGS["torch"]
RES = [ResourceSpec("node", 16), ResourceSpec("bb", 8)]
J_RES = [JSIM.ResourceSpec("node", 16), JSIM.ResourceSpec("bb", 8)]
# tests/test_train.py's small_agent (with _torch_parity's SMALL widths).
TRAIN = dict(stream_hidden=16, batch_size=16, grad_steps_per_episode=4,
             eps_decay=0.9)


def guard_training(agent, margins):
    """Wrap ``agent.select_batch`` so the top-2 margin (float64, plain
    backend, current weights) of every row it will answer greedily is
    kept; the ε draws are replayed on a copy of the agent's rng, which is
    left untouched."""
    select_batch = agent.select_batch

    def guarded(ctxs, slots=None):
        rng, w = copy.deepcopy(agent.rng), agent.config.window
        rows = []
        for c in ctxs:
            if agent.training and rng.uniform() < agent.epsilon:
                rng.integers(0, min(len(c.window), w))
                continue
            row = np.zeros(decision_row_dim(agent.enc, w), np.float32)
            encode_decision_row(agent.enc, c, w, out=row)
            rows.append(row)
        if rows:
            margins.extend(values_and_margin(agent, np.stack(rows))[1])
        return select_batch(ctxs, slots=slots)

    agent.select_batch = guarded


def assert_guarded(margins):
    m = np.asarray(margins)
    m = m[np.isfinite(m)]             # a single valid slot cannot tie
    assert m.size > 0 and m.min() > 1e-5, m.min()


def assert_replay_equal(a, b):
    assert a.replay.rows == b.replay.rows > 0
    for ea, eb in zip(a.replay.episodes, b.replay.episodes, strict=True):
        for f in ("states", "meas", "goals", "actions"):
            assert np.array_equal(getattr(ea, f), getattr(eb, f)), f


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_n1_vectorised_matches_sequential(backend):
    """An N=1 lockstep rollout consumes the rng in the sequential order:
    the same decisions, metrics, epsilon schedule and replay rows, and
    losses within rtol 1e-6."""
    _, seq_agent = agent_pair(J_RES, **TRAIN)
    _, vec_agent = agent_pair(J_RES, **TRAIN)
    margins = []
    guard_training(vec_agent, margins)
    jobsets = [synth_jobs(TSIM, s) for s in range(3)]
    seq = train_agent(seq_agent, RES, jobsets, config=None)
    vec = train_agent(vec_agent, RES, jobsets,
                      config=TrainConfig(n_envs=1, backend=backend))
    assert vec_agent.dfp.backend == backend and not vec_agent.training
    seq_agent.set_backend(backend)
    assert vec.episode_metrics == seq.episode_metrics
    assert vec.decisions == seq.decisions > 0
    assert [e["epsilon"] for e in vec.episodes] == \
        [e["epsilon"] for e in seq.episodes]
    assert vec_agent.epsilon == seq_agent.epsilon < 1.0
    assert len(vec.episode_losses) == len(seq.episode_losses) == 3
    np.testing.assert_allclose(vec.episode_losses, seq.episode_losses,
                               rtol=1e-6, atol=0.0)
    assert_replay_equal(vec_agent, seq_agent)
    assert vec.rounds == vec.decisions and vec.round_losses == []
    assert isinstance(vec, TrainLog) and vec.decisions_per_sec > 0
    assert_guarded(margins)


def lanes(pkg):
    """tests/test_train.py's three heterogeneous lanes: four traces over
    a full, a 0.75x and a 0.5x cluster."""
    sim, slot = (JSIM, JEnvSlot) if pkg == "jax" else (TSIM, EnvSlot)
    res = J_RES if pkg == "jax" else RES
    scale = jscale if pkg == "jax" else scale_resources
    return [
        slot(jobsets=[("a", synth_jobs(sim, 1)), ("b", synth_jobs(sim, 2))],
             resources=res, tag="full"),
        slot(jobsets=[("c", synth_jobs(sim, 3))],
             resources=scale(res, 0.75), tag="mid"),
        slot(jobsets=[("d", synth_jobs(sim, 4, n=25))],
             resources=scale(res, 0.5), tag="half"),
    ]


@pytest.fixture(scope="module")
def reference_lanes():
    ja, _ = agent_pair(J_RES, **TRAIN)
    log = jtrain_vectorized(ja, lanes("jax"), JTrainConfig(n_envs=3))
    return ja, log


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_three_lanes_match_reference(reference_lanes, backend):
    """N=3 lanes, two of them scaled down, from identical weights: replay
    episodes bit-equal, episode rows, epsilon and Adam's step count
    equal, losses within rtol 1e-4 and the gradient norm within 1e-3."""
    ja, jlog = reference_lanes
    _, ta = agent_pair(J_RES, **TRAIN)
    margins = []
    guard_training(ta, margins)
    log = train_agent_vectorized(ta, lanes("torch"),
                                 TrainConfig(n_envs=3, backend=backend))
    assert len(log.episodes) == 4
    assert {e["tag"] for e in log.episodes} == {"full", "mid", "half"}
    strip = [{k: v for k, v in e.items() if k != "loss"} for e in log.episodes]
    jstrip = [{k: v for k, v in e.items() if k != "loss"}
              for e in jlog.episodes]
    assert strip == jstrip
    assert log.decisions == jlog.decisions == \
        sum(e["decisions"] for e in log.episodes)
    assert log.rounds == jlog.rounds > 0
    assert ta.epsilon == ja.epsilon < 1.0
    assert int(ta.opt_state.step) == int(ja.opt_state.step) > 0
    assert len(log.episode_losses) == len(jlog.episode_losses) > 0
    np.testing.assert_allclose(log.episode_losses, jlog.episode_losses,
                               rtol=1e-4)
    np.testing.assert_allclose(ta.last_grad_norm, ja.last_grad_norm,
                               rtol=1e-3)
    assert_replay_equal(ta, ja)
    assert_guarded(margins)


def test_round_grad_steps_match_reference():
    """``grad_steps_per_round=1``: lane 1 finishes early and fills the
    buffer, then every later round takes a step; the rounds are equal
    and the per-round losses within rtol 1e-4 of the JAX package's."""
    ja, ta = agent_pair(J_RES, **{**TRAIN, "batch_size": 8})
    cfg = dict(n_envs=2, grad_steps_per_round=1)
    jlog = jtrain_vectorized(ja, jslots_from_jobsets(J_RES, two_traces(JSIM),
                                                     2), JTrainConfig(**cfg))
    margins = []
    guard_training(ta, margins)
    log = train_agent_vectorized(
        ta, slots_from_jobsets(RES, two_traces(TSIM), 2), TrainConfig(**cfg))
    assert log.rounds == jlog.rounds > 0
    assert len(log.round_losses) == len(jlog.round_losses) > 0
    np.testing.assert_allclose(log.round_losses, jlog.round_losses,
                               rtol=1e-4)
    assert int(ta.opt_state.step) == int(ja.opt_state.step)
    assert_replay_equal(ta, ja)
    assert_guarded(margins)


def two_traces(sim):
    """tests/test_train.py's long and short trace."""
    return [synth_jobs(sim, 1, n=40), synth_jobs(sim, 2, n=12)]


def test_slots_from_jobsets_round_robin():
    jobsets = [synth_jobs(TSIM, s, n=5) for s in range(5)]
    slots = slots_from_jobsets(RES, jobsets, 2)
    assert [len(s.jobsets) for s in slots] == [3, 2]
    assert [label for s in slots for label, _ in s.jobsets] == \
        ["set0", "set2", "set4", "set1", "set3"]
    assert [s.tag for s in slots] == ["env0", "env1"]
    assert len(slots_from_jobsets(RES, jobsets, 16)) == 5
    named = slots_from_jobsets(RES, jobsets[:2], 1, labels=["x", "y"])
    assert [label for label, _ in named[0].jobsets] == ["x", "y"]


def test_lane_and_state_module_checks():
    """The reference's messages: a lane of other resources, a lane larger
    than the agent's cluster, a lane without resources, and a state
    module that differs from the agent's."""
    _, ta = agent_pair(J_RES, **TRAIN)
    jobs = [("x", synth_jobs(TSIM, 0, n=3))]
    with pytest.raises(ValueError, match="do not match"):
        train_agent_vectorized(ta, [EnvSlot(jobsets=jobs, resources=[
            ResourceSpec("gpu", 4)], tag="bad")], TrainConfig(n_envs=1))
    with pytest.raises(ValueError, match="exceeds"):
        train_agent_vectorized(ta, [EnvSlot(jobsets=jobs, resources=[
            ResourceSpec("node", 32), ResourceSpec("bb", 8)], tag="big")],
            TrainConfig(n_envs=1))
    with pytest.raises(ValueError, match="has no resources"):
        train_agent_vectorized(ta, [EnvSlot(jobsets=jobs, tag="none")])
    with pytest.raises(ValueError, match="cannot be swapped"):
        train_agent_vectorized(ta, lanes("torch"),
                               TrainConfig(state_module="attention"))
    assert train_agent_vectorized(ta, [EnvSlot(jobsets=[])]).decisions == 0
    assert not ta.training and ta.replay.rows == 0


def test_sequential_rows_carry_the_reference_keys():
    """The sequential trainer's episode rows have the reference's keys,
    ``"env": 0`` among them, and its log the reference's fields."""
    ja, ta = agent_pair(J_RES, **{**TRAIN, "batch_size": 4,
                                  "grad_steps_per_episode": 1})
    jlog = jtrain_agent(ja, J_RES, [synth_jobs(JSIM, 0, n=8)])
    log = train_agent(ta, RES, [synth_jobs(TSIM, 0, n=8)])
    assert list(log.episodes[0]) == list(jlog.episodes[0])
    assert log.episodes[0]["env"] == 0
    assert set(vars(log)) == set(vars(jlog))
    assert log.rounds == jlog.rounds == 0 and log.round_losses == []
