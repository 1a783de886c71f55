"""The port's baseline zoo (``repro_torch.baselines``) under
tests/test_baselines.py's contracts — batchable and device-capable, the
sequential engine equal to the lockstep engine on two registry scenarios,
deterministic, batched equal to single selection, the entrants differ —
and against the JAX package's zoo with converted parameters: CP-Dispatch
and PRB-EWT bit for bit, DRAS and CoSchedRL under a top-2-margin guard;
then PRB, DRAS and CoSched on the port's device engine against their
sequential runs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_results_close, assert_results_equal,
                           env_actions, guard_window_policy, jax_tree_numpy,
                           result_rows)
from repro import baselines as jzoo
from repro.sim import run_traces as jrun_traces
from repro.workloads import ThetaConfig as JThetaConfig
from repro.workloads.registry import build_jobs as jbuild_jobs
from repro_torch import baselines as tzoo
from repro_torch.convert import load_policy_params
from repro_torch.core.policy_api import supports_batch, supports_device
from repro_torch.sim import (DeviceSimulator, SimConfig, Simulator,
                             run_trace, run_traces)
from repro_torch.workloads import ThetaConfig
from repro_torch.workloads.registry import build_jobs

CFG = ThetaConfig.mini(seed=0, duration_days=0.35, jobs_per_day=140)
JCFG = JThetaConfig.mini(seed=0, duration_days=0.35, jobs_per_day=140)
RES, JRES = CFG.resources(), JCFG.resources()
SCENARIOS = ("S2", "bursty-campaigns")      # two registry scenarios
ZOO = ("PRB-EWT", "CP-Dispatch", "DRAS", "CoSchedRL")
NEURAL = ("DRAS", "CoSchedRL")
MARGIN_TOL = 1e-4


def make(name, pkg="torch"):
    """Fresh zoo instance (same construction the tournament uses); the
    port's networks on the CPU."""
    z, res = (tzoo, RES) if pkg == "torch" else (jzoo, JRES)
    kw = {"device": "cpu"} if pkg == "torch" else {}
    return {
        "PRB-EWT": lambda: z.PRBPolicy(res, z.PRBConfig()),
        "CP-Dispatch": lambda: z.CPDispatcher(z.CPConfig()),
        "DRAS": lambda: z.DRASPolicy(res, z.DRASConfig(seed=0), **kw),
        "CoSchedRL": lambda: z.CoSchedPolicy(res, z.CoSchedConfig(seed=0),
                                             **kw),
    }[name]()


def pair(name):
    """The JAX entrant and the port's, the port's holding the JAX one's
    parameters where it has any."""
    jp, tp = make(name, "jax"), make(name)
    if name in NEURAL:
        load_policy_params(tp, jax_tree_numpy(jp.params))
    return jp, tp


@pytest.fixture(scope="module")
def traces():
    return [build_jobs(s, CFG, seed=1) for s in SCENARIOS]


@pytest.fixture(scope="module")
def jtraces():
    return [jbuild_jobs(s, JCFG, seed=1) for s in SCENARIOS]


# ------------------------------------------- tests/test_baselines.py's
@pytest.mark.parametrize("name", ZOO)
def test_zoo_is_batchable(name):
    policy = make(name)
    assert supports_batch(policy)
    assert supports_device(policy) == (name != "CP-Dispatch")


@pytest.mark.parametrize("name", ZOO)
def test_sequential_equals_vector_on_registry_scenarios(name, traces):
    policy = make(name)
    seq = [run_trace(RES, js, policy) for js in traces]
    vec = run_traces(RES, traces, policy)
    for a, b in zip(seq, vec):
        assert_results_equal(a, b)
        assert b.decisions > 0


@pytest.mark.parametrize("name", ZOO)
def test_zoo_policy_is_deterministic(name, traces):
    a = run_traces(RES, traces, make(name))
    b = run_traces(RES, traces, make(name))
    for ra, rb in zip(a, b):
        assert_results_equal(ra, rb)


@pytest.mark.parametrize("name", ZOO)
def test_select_batch_matches_select(name, traces):
    policy = make(name)
    sims = [Simulator(RES, js, policy, SimConfig(window=10)) for js in traces]
    ctxs = [s.next_decision() for s in sims]
    assert all(c is not None for c in ctxs)
    batch = [int(a) for a in policy.select_batch(ctxs)]
    assert batch == [int(policy.select(c)) for c in ctxs]


def test_zoo_entrants_differ_from_each_other(traces):
    starts = {name: tuple(j.start for r in run_traces(RES, traces, make(name))
                          for j in r.jobs)
              for name in ZOO}
    assert len(set(starts.values())) > 1


# ------------------------------------------------ against the reference
@pytest.mark.parametrize("name", ZOO)
def test_entrant_matches_reference(name, traces, jtraces):
    """Lockstep runs of both packages' entrant over both scenarios: equal
    results, every job's start, end and state (the neural entrants only
    when no decision was a near-tie)."""
    jp, tp = pair(name)
    margins = []
    if name in NEURAL:
        guard_window_policy(tp, margins)
    got = run_traces(RES, traces, tp)
    want = jrun_traces(JRES, jtraces, jp)
    if name in NEURAL:
        assert len(margins) == sum(r.decisions for r in got)
        assert min(margins) > MARGIN_TOL, min(margins)
    for a, b in zip(got, want):
        assert result_rows(a) == result_rows(b)
        assert a.decisions > 0


@pytest.mark.parametrize("name", NEURAL)
def test_networks_and_scores_match_reference(name, traces, jtraces):
    """The converted network scores a batch of contexts as the reference
    does, within float32 rounding."""
    jp, tp = pair(name)
    sims = [Simulator(RES, js, tp, SimConfig(window=10)) for js in traces]
    ctxs = [s.next_decision() for s in sims]
    obs = tp._encode_rows(ctxs, 10)
    want = np.asarray(jp.score_window(jp.params, jnp.asarray(obs)))
    with torch.no_grad():
        got = tp.score_window(tp.params, torch.from_numpy(obs)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", ("PRB-EWT", "DRAS", "CoSchedRL"))
def test_device_engine_equals_sequential(name, traces):
    """Both scenarios as two environments of the port's device engine:
    each environment's actions and results equal its sequential run."""
    policy = make(name)
    ro = DeviceSimulator(RES, traces, policy, device="cpu").rollout()
    for i, jobs in enumerate(traces):
        actions = []

        class Rec:
            def select(self, ctx):
                actions.append(int(policy.select(ctx)))
                return actions[-1]

        seq = Simulator(RES, jobs, Rec(), SimConfig()).run()
        assert env_actions(ro, i) == actions, (name, i)
        assert_results_close(seq, ro.results[i])
    assert ro.stats.max_batch == len(traces)
