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
# The attention state module at tests/test_queue_encoder.py's tiny_agent
# widths (Q = 12, attn_dim 8, head dim 4), with both of the reference
# default's two layers: 60 parameter leaves, as at full width.
ATTENTION = dict(state_module="attention", queue_cap=12, attn_dim=8,
                 attn_heads=2, attn_layers=2)


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
    copied from the JAX one; ``overrides`` are ``AgentConfig`` fields of
    both packages (``**ATTENTION`` for the attention state module)."""
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


def env_actions(ro, i):
    """The actions one environment of a device rollout took, in order."""
    return [int(a) for a, d in zip(ro.actions[:, i], ro.decided[:, i]) if d]


def assert_results_close(a, b, rtol=1e-5, atol=1e-2):
    """tests/test_device.py's rule: host (f64) vs device (f32 clock)
    results — same schedule, metrics equal to float32 precision."""
    assert a.decisions == b.decisions
    assert a.n_unstarted == b.n_unstarted
    ra, rb = a.metrics.as_row(), b.metrics.as_row()
    assert set(ra) == set(rb)
    for k in ra:
        assert np.isclose(ra[k], rb[k], rtol=rtol, atol=atol), \
            (k, ra[k], rb[k])
    for ja, jb in zip(a.jobs, b.jobs):
        assert ja.jid == jb.jid and ja.started == jb.started
        if ja.started:
            assert np.isclose(ja.start, jb.start, rtol=1e-6, atol=1e-2)


def guard_window_policy(policy, margins):
    """Wrap a network policy's ``select_batch`` so every row's top-2
    margin of its scores (float64, a copy of the network; invalid slots
    out) is appended to ``margins``."""
    select_batch = policy.select_batch
    net = copy.deepcopy(policy.init_state()).double()

    def guarded(ctxs):
        w = policy.enc.window
        obs = torch.from_numpy(policy._encode_rows(ctxs, w).astype(np.float64))
        with torch.no_grad():
            s = policy.score_window(net, obs).numpy()
        for row, c in zip(s, ctxs):
            valid = np.sort(row[:min(len(c.window), w)])
            margins.append(valid[-1] - valid[-2] if len(valid) > 1 else np.inf)
        return select_batch(ctxs)

    policy.select_batch = guarded
