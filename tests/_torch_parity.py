"""Shared helpers of the tests that hold the PyTorch port (``repro_torch``)
against the JAX package (``repro``): the same inputs, made with numpy from
a seed, go through both."""
import copy
from dataclasses import replace

import numpy as np
import torch

import repro.obs.trace as jtrace
import repro.sim as jsim
import repro.workloads as jwl
import repro_torch.obs.trace as ttrace
import repro_torch.sim as tsim
import repro_torch.workloads as twl
from repro.core import AgentConfig as JAgentConfig
from repro.core import MRSchAgent as JAgent
from repro_torch.convert import params_from_jax
from repro_torch.core import AgentConfig as TAgentConfig
from repro_torch.core import MRSchAgent as TAgent

PKGS = {"jax": jsim, "torch": tsim}
TRACERS = {"jax": jtrace, "torch": ttrace}
WORKLOADS = {"jax": jwl, "torch": twl}


def theta_mini(pkg, scenario, days=1.0):
    cfg = WORKLOADS[pkg].ThetaConfig.mini(seed=0, duration_days=days,
                                          jobs_per_day=220)
    return cfg.resources(), WORKLOADS[pkg].build_scenarios(
        cfg, (scenario,))[scenario]


def faulty_mini(pkg):
    """Mini S1 with failure points on every 5th job, a 25 % node drain with
    a restore, a permanent burst-buffer drain and a tight requeue bound."""
    sim = PKGS[pkg]
    res, jobs = theta_mini(pkg, "S1")
    for j in jobs[::5]:
        j.fail_times = (0.3 * j.runtime, 0.6 * j.runtime)
    faults = sim.FaultSchedule(
        drains=(sim.DrainEvent(0.3, "node", unit_frac=0.25, duration=0.05),
                sim.DrainEvent(0.5, "bb", units=20)),
        max_requeues=1, relative=True)
    return res, jobs, faults


# Small widths, as tests/test_serve.py sizes its agent.
SMALL = dict(state_hidden=(32, 16), state_out=8, module_hidden=4)


def synth_jobs(sim, seed: int, n: int = 40):
    """tests/test_serve.py's synthetic trace, built with ``sim``'s Job."""
    rng = np.random.default_rng(seed)
    jobs, t = [], 0.0
    for i in range(n):
        t += float(rng.exponential(40.0))
        runtime = float(rng.uniform(20, 300))
        jobs.append(sim.Job(jid=i, submit=t, runtime=runtime,
                            walltime=runtime * float(rng.uniform(1.0, 2.0)),
                            demands={"node": int(rng.integers(1, 12)),
                                     "bb": int(rng.integers(0, 6))}))
    return jobs


def job_rows(jobs):
    return [(j.jid, j.submit, j.runtime, j.walltime, dict(j.demands), j.deps,
             j.think_time, j.fail_times) for j in jobs]


def result_rows(r):
    """Everything a SimResult reports, as plain comparable values."""
    return {
        "metrics": r.metrics.as_row(), "makespan": r.makespan,
        "decisions": r.decisions, "n_unstarted": r.n_unstarted,
        "truncated_jobs": r.truncated_jobs, "requeues": r.requeues,
        "n_failed": r.n_failed,
        "jobs": [(j.jid, j.start, j.end, j.first_start, j.state, j.requeues,
                  j.failed_work) for j in r.jobs],
    }


def assert_results_equal(a, b):
    """tests/test_serve.py's check, across the two packages."""
    assert a.metrics.as_row() == b.metrics.as_row()
    assert a.decisions == b.decisions
    assert a.n_unstarted == b.n_unstarted
    assert [(j.jid, j.start, j.end) for j in a.jobs] \
        == [(j.jid, j.start, j.end) for j in b.jobs]


class SlotPolicy:
    """Deterministic policy: slot 0, or a rotating slot (``rotate``)."""

    def __init__(self, rotate: bool = False):
        self.rotate, self.n = rotate, 0

    def select(self, ctx) -> int:
        self.n += 1
        return (self.n * 7) % len(ctx.window) if self.rotate else 0


def agent_pair(resources, seed: int = 0, **overrides):
    """A JAX agent and a port agent (CPU) holding the same weights,
    copied from the JAX one."""
    j_res = [jsim.ResourceSpec(r.name, r.capacity, r.unit) for r in resources]
    t_res = [tsim.ResourceSpec(r.name, r.capacity, r.unit) for r in resources]
    kw = {**SMALL, **overrides}
    ja = JAgent(j_res, JAgentConfig(seed=seed, **kw))
    ta = TAgent(t_res, TAgentConfig(seed=seed, **kw), device="cpu")
    ta.net.load_state_dict(params_from_jax(jax_tree_numpy(ja.params)))
    return ja, ta


def jax_tree_numpy(tree):
    if isinstance(tree, dict):
        return {k: jax_tree_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [jax_tree_numpy(v) for v in tree]
    return np.asarray(tree)


def values_and_margin(agent, rows: np.ndarray):
    """(action values with invalid slots at -inf, top-2 margin) of packed
    decision rows, on the port's plain backend in float64 — the yardstick
    a divergence between the two packages' float32 forwards is measured
    against."""
    from repro_torch.core.dfp import action_values
    sd, m = agent.enc.state_dim, agent.enc.n_resources
    net = copy.deepcopy(agent.net).double()
    x = torch.from_numpy(rows.astype(np.float64))
    u = action_values(net, replace(agent.dfp, backend="torch"), x[:, :sd],
                      x[:, sd:sd + m], x[:, sd + m:sd + 2 * m])
    u = torch.where(x[:, sd + 2 * m:] > 0.5, u, -torch.inf).numpy()
    top2 = np.sort(u, axis=1)[:, -2:]
    return u, top2[:, 1] - top2[:, 0]
