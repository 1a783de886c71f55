"""The plain reference against tiny scheduling runs of the program on the
CPU: both configurations come out correct, and a run whose timed path is
broken underneath, or the TF32 control in the program's place, does not.
The sizes are cut (4 traces of a few hours) so the CPU holds them; the
widths are the configurations' own."""
import copy
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness, traffic_gen
from portbench.reference import dfp as ref_dfp

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 11
CPU = torch.device("cpu")
CELLS = {"mlp-sweep-s1": (0.15, 160.0), "attn-sweep-s1": (0.1, 400.0)}


def _run_module():
    spec = importlib.util.spec_from_file_location(
        "portbench_run", ROOT / "portbench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


RUN = _run_module()


def tiny(workload: str, n: int = 4):
    days, rate = CELLS[workload]
    cell = harness.load_cell(ROOT, workload)
    cell.mix = {**cell.mix, "n_traces": n,
                "theta": {**cell.mix["theta"], "duration_days": days,
                          "jobs_per_day": rate}}
    cell.config = copy.deepcopy(cell.config)
    return cell


def run_tiny(workload: str, rate: float = None):
    cell = tiny(workload)
    if rate:
        cell.mix["theta"] = {**cell.mix["theta"], "jobs_per_day": rate}
    return RUN.run(cell, SEED, 0.05, 0, CPU)


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_program_agrees_with_reference(workload):
    line, checks = run_tiny(workload)
    assert line["correct"], checks
    assert checks["schedule_mismatches"][0] == 0
    assert 0.0 <= checks["score_err"][0] < checks["score_err"][1]
    assert list(line)[-1] == "check"
    assert set(line["metrics"]) == {"decisions_per_s", "setup_s"}


def test_reference_replays_fcfs_by_hand():
    """Two jobs on a 4-node cluster: the second waits for the first."""
    from portbench.reference import sched
    tr = traffic_gen.Trace(
        submit=np.array([0.0, 10.0]), runtime=np.array([100.0, 50.0]),
        walltime=np.array([600.0, 600.0]),
        demands=np.array([[3, 0], [2, 1]]))
    lay = sched.Layout(caps=(4, 2), window=10, state_module="mlp")
    rep = sched.replay(lay, tr, [0, 0, 0])
    assert list(rep.start) == [0.0, 100.0] and list(rep.end) == [100.0,
                                                                 150.0]
    assert rep.unused_actions == 0 and rep.invalid_actions == 0
    # t=0 start; t=10 reserve (no fit); t=100 start
    assert list(rep.n_valid) == [1, 1, 1]
    assert rep.rows.shape == (3, lay.row_dim)


def _broken_alloc(layout, release, owner, env_mask, job_idx, demand, est):
    return release, owner              # the step returns its state unchanged


def _half_batch(orig):
    def score(self, net, obs):
        h = obs.shape[0] // 2
        u = orig(self, net, obs[:max(h, 1)])
        rest = u.mean(dim=0, keepdim=True).expand(obs.shape[0] - len(u), -1)
        return torch.cat([u, rest])
    return score


class _AlteredArgmax(types.ModuleType):
    """``torch`` with ``argmax`` moving each row's choice to the first
    other slot that is not -inf: the action altered where it is
    produced."""

    def __init__(self):
        super().__init__("torch")

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def argmax(x, dim=None, **kw):
        a = torch.argmax(x, dim=dim, **kw)
        if x.dim() != 2 or dim != 1:
            return a
        other = torch.isfinite(x)
        other[torch.arange(len(a)), a] = False
        return torch.where(other.any(dim=1), other.int().argmax(dim=1), a)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_broken_timed_path_is_not_correct(fault, monkeypatch):
    from repro_torch.core.agent import MRSchAgent
    from repro_torch.sim import device as device_mod
    if fault == "state_unchanged":
        monkeypatch.setattr(device_mod, "_alloc_first_free", _broken_alloc)
    elif fault == "half_batch":
        monkeypatch.setattr(MRSchAgent, "score_window",
                            _half_batch(MRSchAgent.score_window))
    else:
        monkeypatch.setattr(device_mod, "torch", _AlteredArgmax())
    line, checks = run_tiny("mlp-sweep-s1", rate=400.0)
    assert not line["correct"], (fault, checks)


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_tf32_control_is_not_correct(workload):
    """The plain network in TF32 in the program's place fails score_err."""
    cell = tiny(workload, n=8)
    traces = traffic_gen.make_traces(cell.mix, SEED)
    weights = ref_dfp.make_weights(cell.config, SEED, CPU)
    agent, res = harness.build_agent(cell.config, weights, CPU)
    sim = harness.build_sim(cell.config, traces, agent, res, CPU)
    ro = sim.rollout()
    envs = harness.sample_envs(SEED, ro.decided.sum(axis=0), 8)
    chk = harness.reference_check(cell.config, traces, ro, envs, None,
                                  weights, CPU, precision="tf32")
    assert chk.schedule_mismatches == 0
    assert chk.score_err > cell.config["check"]["score_err_limit"]
