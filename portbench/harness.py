"""One run of one cell: find its files by name, build the program's device
engine and agent from the seed, warm up, time whole greedy rollouts, read
the trace, and check the answers against the plain reference.

The program (``repro_torch``) is imported here and by ``run.py``, never
by ``traffic_gen``, ``yardstick``, ``reference`` or the metric readers.
"""
from __future__ import annotations

import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from . import traffic_gen
from .reference import dfp as ref_dfp
from .reference import sched as ref_sched

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


# ------------------------------------------------------------- manifest
@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its
    configuration and traffic files, found by name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; have "
                         f"{sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    mix = traffic_gen.load_mix(traffic_file(root, w["traffic"]))

    def applies(m):
        return workload in m.get("workloads", [workload])

    return Cell(workload, int(w["chips"]), config, mix,
                [m for m in bench["end_to_end"] if applies(m)],
                [m for m in bench["per_layer"] if applies(m)])


def traffic_file(root: Path, name: str) -> Path:
    found = sorted((root / "portbench" / "traffic").glob(f"{name}.*"))
    if len(found) != 1:
        raise SystemExit(f"traffic {name!r}: expected one file, found "
                         f"{[str(p) for p in found]}")
    return found[0]


def metric_reader(root: Path, name: str):
    """``portbench/layer_metrics/<name>.py``'s ``read``."""
    path = root / "portbench" / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is a JAX package's."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


# ------------------------------------------------------------- build
def ref_layout(config: dict) -> ref_sched.Layout:
    a = config["agent"]
    return ref_sched.Layout(
        caps=tuple(config["cluster"]["capacities"]), window=a["window"],
        state_module=a["state_module"], queue_cap=a.get("queue_cap", 0),
        time_scale=config["sim"]["time_scale_s"])


def check_cell(config: dict, mix: dict) -> None:
    """The mix's cluster is the configuration's."""
    caps = tuple(config["cluster"]["capacities"])
    if traffic_gen.capacities(mix) != caps:
        raise ValueError(f"traffic sized for {traffic_gen.capacities(mix)}, "
                         f"configuration has {caps}")
    if tuple(config["cluster"]["resources"]) != traffic_gen.RESOURCES:
        raise ValueError("resources differ from the generator's")


def build_agent(config: dict, weights: Dict[str, torch.Tensor], device):
    """The program's agent with the benchmark's weights copied in."""
    from repro_torch.core.agent import AgentConfig, MRSchAgent
    from repro_torch.sim.cluster import ResourceSpec
    a = config["agent"]
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in a.items()}
    res = [ResourceSpec(n, c) for n, c in
           zip(config["cluster"]["resources"],
               config["cluster"]["capacities"])]
    agent = MRSchAgent(res, AgentConfig(**kw), device=device)
    params = dict(agent.net.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"weight layouts differ: program only "
                         f"{sorted(set(params) - set(weights))}, benchmark "
                         f"only {sorted(set(weights) - set(params))}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name])
    return agent, res


def build_sim(config: dict, traces, agent, res, device):
    from repro_torch.sim import DeviceSimulator, SimConfig
    from repro_torch.sim.job import Job
    names = config["cluster"]["resources"]
    jobsets = [[Job(jid=j, submit=float(t.submit[j]),
                    runtime=float(t.runtime[j]),
                    walltime=float(t.walltime[j]),
                    demands={n: int(t.demands[j, r])
                             for r, n in enumerate(names)})
                for j in range(len(t.submit))] for t in traces]
    cfg = SimConfig.for_engine("device", window=config["sim"]["window"],
                               backfill=config["sim"]["backfill"] == "easy")
    return DeviceSimulator(res, jobsets, agent, cfg, device=device)


# ------------------------------------------------------------- probe
class Probe:
    """Records, over one rollout, what the per-layer metrics need to cost
    the kernels on this data: per front call the counts of
    ``yardstick.FrontCall``, and per forward each row's queue length
    (attention).  It wraps the program's calls from outside and adds
    device work of its own, so it watches the warm-up rollout, not the
    traced ones; every rollout of a run does the same work."""

    def __init__(self, agent, config: dict):
        from repro_torch.sim import device as device_mod
        self.mod, self.agent = device_mod, agent
        self.orig_pack = device_mod.pack_decision_rows
        self.front: List[torch.Tensor] = []
        self.qlens: List[torch.Tensor] = []
        a = config["agent"]
        R = len(config["cluster"]["capacities"])
        self.qcol = (a["queue_cap"] * (R + 2)
                     if a["state_module"] == "attention" else None)

    def __enter__(self):
        orig_pack, orig_score = self.orig_pack, self.agent.score_window

        def pack(spec, **args):
            out = orig_pack(spec, **args)
            waiting = out.waiting > 0.5
            running = args["started"] & ~args["finished"]
            self.front.append(torch.stack([
                waiting.sum(), running.sum(), (waiting | running).sum(),
                out.valid.sum()]))
            return out

        def score(state, obs):
            if self.qcol is not None:
                self.qlens.append(obs[:, self.qcol].clone())
            return orig_score(state, obs)

        self.mod.pack_decision_rows = pack
        self.agent.score_window = score
        return self

    def __exit__(self, *exc):
        self.mod.pack_decision_rows = self.orig_pack
        del self.agent.score_window


# ------------------------------------------------------------- run
class ScoreRecorder:
    """Keeps, for every deciding round of every rollout in the window, the
    program's action scores of the sampled environments: one row gather
    on the card a round, wrapped around the agent's ``score_window``."""

    def __init__(self, agent, envs: List[int], device):
        self.agent, self.idx = agent, torch.tensor(envs, device=device)
        self.rollouts: List[List[torch.Tensor]] = []

    def next_rollout(self) -> None:
        self.rollouts.append([])

    def __enter__(self):
        orig = self.agent.score_window

        def score(state, obs):
            u = orig(state, obs)
            self.rollouts[-1].append(u.index_select(0, self.idx))
            return u

        self.agent.score_window = score
        return self

    def __exit__(self, *exc):
        del self.agent.score_window


@dataclass
class Window:
    walls: List[float] = field(default_factory=list)
    decisions: int = 0
    rounds_run: int = 0
    deciding_rounds: int = 0
    host_syncs: int = 0
    rollouts: list = field(default_factory=list)

    def add(self, wall: float, ro) -> None:
        self.walls.append(wall)
        self.decisions += ro.stats.decisions
        self.rounds_run += ro.stats.rounds_run
        self.deciding_rounds += ro.stats.rounds
        self.host_syncs += ro.stats.host_syncs
        self.rollouts.append(ro)

    @property
    def seconds(self) -> float:
        return float(sum(self.walls))


def timed_rollouts(sim, seconds: float, sync, recorder: ScoreRecorder,
                   count: Optional[int] = None) -> Window:
    """Whole greedy rollouts back to back: ``count`` of them or, without
    it, as many as end within ``seconds``.  A rollout starts only where
    the last one's wall says it ends in time, so the window never runs
    past ``seconds`` by more than the spread of one rollout's wall; the
    first always runs."""
    win = Window()
    t_start = time.perf_counter()
    while True:
        sync()
        recorder.next_rollout()
        t0 = time.perf_counter()
        ro = sim.rollout()
        t1 = time.perf_counter()
        win.add(t1 - t0, ro)
        if count is not None:
            if len(win.walls) >= count:
                return win
        elif t1 - t_start + (t1 - t0) > seconds:
            return win


# ------------------------------------------------------------- check
def sample_envs(seed: int, decisions_per_env: np.ndarray, k: int) -> List[int]:
    """The environment with the most decisions and ``k - 1`` others,
    drawn from the seed."""
    rng = np.random.default_rng(np.random.SeedSequence(
        [int(seed) % 2**64, 0x636865636B]))
    longest = int(np.argmax(decisions_per_env))
    rest = [i for i in range(len(decisions_per_env)) if i != longest]
    k = min(k, len(decisions_per_env))
    others = rng.choice(rest, size=k - 1, replace=False) if k > 1 else []
    return [longest, *sorted(int(i) for i in others)]


def pick_rollout(seed: int, n: int) -> int:
    """The window's rollout whose answers are checked, drawn from the seed."""
    rng = np.random.default_rng(np.random.SeedSequence(
        [int(seed) % 2**64, 0x726F6C6C]))
    return int(rng.integers(0, n))


def program_scores(ro, recorded: List[torch.Tensor], envs: List[int]):
    """Per sampled environment, the program's scores (D_i, W) at each of
    its decisions, in order."""
    calls = np.flatnonzero(ro.decided.any(axis=1))      # round of each call
    if len(calls) != len(recorded):
        raise RuntimeError(f"{len(recorded)} recorded forwards for "
                           f"{len(calls)} deciding rounds")
    rec = torch.stack(recorded).cpu().numpy() if recorded else None
    out = []
    for s, i in enumerate(envs):
        at = np.flatnonzero(ro.decided[calls, i])
        out.append(rec[at, s] if rec is not None else np.zeros((0, 0)))
    return out


@dataclass
class CheckResult:
    schedule_mismatches: int
    score_err: float
    score_dev: float                # the scores' part of score_err
    action_gap: float               # the chosen actions' part
    decisions: int
    queue_len_mean: float
    queue_len_max: int


def _deviation(u_ref: np.ndarray, u: np.ndarray, act: np.ndarray,
               nv: np.ndarray):
    """(largest |u - u_ref| over valid slots, largest gap of the chosen
    action below the reference's best), each over the decision's scale:
    the larger of its largest valid |u_ref| and the median of that over
    the decisions."""
    valid = np.arange(u_ref.shape[1])[None, :] < nv[:, None]
    mag = np.where(valid, np.abs(u_ref), 0.0).max(axis=1)
    scale = np.maximum(mag, np.median(mag) if len(mag) else 0.0)
    scale = np.maximum(scale, 1e-30)
    dev = np.where(valid, np.abs(u - u_ref), 0.0).max(axis=1) / scale
    best = np.where(valid, u_ref, -np.inf).max(axis=1)
    gap = (best - u_ref[np.arange(len(act)), act]) / scale
    return (float(dev.max(initial=0.0)), float(gap.max(initial=0.0)))


@dataclass
class Sample:
    """The sampled environments replayed by the plain scheduler under the
    program's actions: the rows it observed at each decision, their
    valid slots, the program's actions, and the schedule's mismatches."""
    mismatches: int
    rows: np.ndarray
    n_valid: np.ndarray
    acts: np.ndarray
    queue_len: np.ndarray
    decisions: List[int]            # rows compared per environment


def replay_sample(config: dict, traces, ro, envs: List[int]) -> Sample:
    """Replay each sampled environment under the program's actions.
    Mismatches: jobs whose start or end differs, actions outside the
    valid window, and decisions one side made and the other did not."""
    lay = ref_layout(config)
    mism, rows, n_valid, acts, qlens, counts = 0, [], [], [], [], []
    for i in envs:
        a_i = ro.actions[:, i][ro.decided[:, i]].astype(np.int64)
        rep = ref_sched.replay(lay, traces[i], a_i)
        mism += (rep.unused_actions + rep.missing_actions
                 + rep.invalid_actions)
        jobs = ro.results[i].jobs
        p_start = np.asarray([jb.start if jb.started else -1.0
                              for jb in jobs])
        p_end = np.asarray([jb.end if jb.started else -1.0 for jb in jobs])
        mism += int(((p_start != rep.start) | (p_end != rep.end)).sum())
        d = min(len(a_i), len(rep.rows))
        rows.append(rep.rows[:d])
        n_valid.append(rep.n_valid[:d])
        acts.append(np.clip(a_i[:d], 0, lay.window - 1))
        qlens.append(rep.queue_len)
        counts.append(d)
    return Sample(int(mism), np.concatenate(rows), np.concatenate(n_valid),
                  np.concatenate(acts), np.concatenate(qlens), counts)


def judge(config: dict, sample: Sample, scores: Optional[List[np.ndarray]],
          weights: Dict[str, torch.Tensor], device,
          precision: str = "float32", block: int = 2048):
    """(score_err, its scores' part, its actions' part): the larger of how
    far the valid scores (``scores``, the program's per environment)
    stray from the plain network's in float32 and how far the chosen
    action's plain score lies below the plain best, over the decision's
    scale (``_deviation``).  With ``scores=None`` the plain network in
    ``precision`` takes the program's place for the scores and picks the
    actions it ranks first: the control."""
    net = ref_dfp.Net(config, weights, "float32")
    ctl = ref_dfp.Net(config, weights, precision) if scores is None else None
    u_ref, u_ctl = [], []
    for b in range(0, len(sample.rows), block):
        x = torch.from_numpy(sample.rows[b:b + block]).to(device)
        u_ref.append(net.scores(x).double().cpu().numpy())
        if ctl is not None:
            u_ctl.append(ctl.scores(x).double().cpu().numpy())
    u_ref = np.concatenate(u_ref)
    nv = sample.n_valid
    if ctl is not None:
        u = np.concatenate(u_ctl)
        valid = np.arange(u.shape[1])[None, :] < nv[:, None]
        act = np.where(valid, u, -np.inf).argmax(axis=1)
    else:
        u = np.concatenate([s[:d] for s, d in zip(scores, sample.decisions)]
                           ).astype(np.float64)
        act = sample.acts
    dev, gap = _deviation(u_ref, u, act, nv)
    return max(dev, gap), dev, gap


def reference_check(config: dict, traces, ro, envs: List[int],
                    scores: Optional[List[np.ndarray]],
                    weights: Dict[str, torch.Tensor], device,
                    precision: str = "float32") -> CheckResult:
    """Replay each sampled environment under the program's actions with
    the plain scheduler (``replay_sample``) and score its rows with the
    plain network (``judge``; ``scores=None``: the control)."""
    sample = replay_sample(config, traces, ro, envs)
    err, dev, gap = judge(config, sample, scores, weights, device, precision)
    ql = sample.queue_len
    return CheckResult(
        schedule_mismatches=sample.mismatches, score_err=err,
        score_dev=dev, action_gap=gap, decisions=int(len(sample.rows)),
        queue_len_mean=float(ql.mean()) if len(ql) else 0.0,
        queue_len_max=int(ql.max()) if len(ql) else 0)
