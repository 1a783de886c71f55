"""Curriculum training loops for the MRSch agent (paper §III-D, §V-B),
and deterministic evaluation.

Two ways to run the same training loop:

* ``train_agent`` with no ``config`` — the sequential loop: one trace at
  a time through ``run_trace``, gradient steps at each episode's end.
* ``train_agent`` with a ``TrainConfig`` (or ``train_agent_vectorized``
  with explicit ``EnvSlot`` lanes) — batched collection: N environments
  advance in lockstep through ``repro_torch.sim.vector.VectorSimulator``,
  every decision round is answered by ONE ε-greedy DFP forward over the
  exploiting rows, transitions land in per-environment episode
  accumulators, and whenever a lane finishes a trace its episode is
  flushed to replay and trained on while the other lanes keep collecting
  (optionally with extra gradient steps every round).  Lanes can carry
  different traces, seeds and scaled-down clusters (see
  ``repro_torch.workloads.sweep.build_train_mix``), so one batch mixes
  Eq. (1) goal vectors.

With ``n_envs=1`` the vectorised trainer consumes the agent's ``rng`` in
exactly the sequential order, so both loops give the same trajectories,
losses and metrics from one seed.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

from ..obs.metrics import MetricsRegistry
from ..obs.profiling import annotate
from ..sim.cluster import ResourceSpec
from ..sim.job import Job
from ..sim.simulator import SimConfig, SimResult, Simulator, run_trace
from ..sim.vector import VectorSimulator
from .agent import MRSchAgent


@dataclass(frozen=True)
class TrainConfig:
    """Knobs of the vectorised curriculum trainer."""
    n_envs: int = 8                  # lockstep environment lanes
    epochs: int = 1                  # passes over every lane's jobset queue
    window: Optional[int] = None     # None -> agent.config.window
    backfill: bool = True            # EASY backfilling in every lane
    grad_steps_per_round: int = 0    # extra train steps interleaved per
    #                                  lockstep round (0 = train only when
    #                                  an episode completes)
    backend: Optional[str] = None    # None -> keep the agent's backend;
    #                                  "torch" | "kernel" re-routes the agent
    #                                  via set_backend (persists after the
    #                                  run)
    state_module: Optional[str] = None  # None -> keep the agent's module;
    #                                  anything else must MATCH it (the
    #                                  parameter sets differ across
    #                                  modules, so it cannot be switched
    #                                  on a live agent)
    verbose: bool = False


@dataclass
class EnvSlot:
    """One environment lane of the vectorised trainer.

    ``jobsets`` is a queue of ``(label, trace)`` pairs consumed in order;
    when a trace drains, the lane is refilled with the next one.
    ``resources`` is the lane's cluster: the shared spec, or a scaled-down
    variant (same resource names, capacities no larger than the agent's
    reference cluster) to diversify contention.
    """
    jobsets: List[Tuple[str, List[Job]]]
    resources: Optional[Sequence[ResourceSpec]] = None
    tag: str = ""


@dataclass
class TrainLog:
    episode_losses: List[float] = field(default_factory=list)
    episode_metrics: List[Dict[str, float]] = field(default_factory=list)
    episodes: List[Dict] = field(default_factory=list)   # per-episode rows
    round_losses: List[float] = field(default_factory=list)
    wall_seconds: float = 0.0
    decisions: int = 0
    rounds: int = 0

    @property
    def decisions_per_sec(self) -> float:
        return self.decisions / max(self.wall_seconds, 1e-9)


def train_agent(agent: MRSchAgent, resources: Sequence[ResourceSpec],
                jobsets: Sequence[Sequence], epochs: int = 1,
                verbose: bool = False,
                config: Optional[TrainConfig] = None,
                registry: Optional[MetricsRegistry] = None) -> TrainLog:
    """Run the agent through the ordered jobsets with exploration and
    learning.

    Without ``config`` this is the sequential loop: each trace is one
    episode, ended by ``agent.end_episode``.  With a ``TrainConfig`` the
    jobsets are dealt round-robin across ``config.n_envs`` lockstep lanes
    and collected through the batched engine (``train_agent_vectorized``),
    which fills ``registry``; the sequential loop, as the JAX package's,
    does not.
    """
    if config is not None:
        slots = slots_from_jobsets(resources, jobsets, config.n_envs)
        cfg = config
        # The positional knobs apply unless the config sets its own.
        if epochs != 1 and cfg.epochs == 1:
            cfg = replace(cfg, epochs=epochs)
        if verbose and not cfg.verbose:
            cfg = replace(cfg, verbose=True)
        return train_agent_vectorized(agent, slots, cfg, registry=registry)
    log = TrainLog()
    t0 = time.perf_counter()
    agent.training = True
    for epoch in range(epochs):
        for i, jobs in enumerate(jobsets):
            result = run_trace(resources, jobs, agent,
                               window=agent.config.window)
            loss = agent.end_episode()
            if loss is not None:
                log.episode_losses.append(loss)
            row = result.metrics.as_row()
            log.episode_metrics.append(row)
            log.episodes.append({"env": 0, "jobset": f"set{i}",
                                 "epoch": epoch, "loss": loss,
                                 "epsilon": agent.epsilon,
                                 "decisions": result.decisions, **row})
            log.decisions += result.decisions
            if verbose:
                print(f"[train] epoch {epoch} set {i}: loss={loss} "
                      f"eps={agent.epsilon:.3f} "
                      f"util={result.metrics.utilization}")
    agent.training = False
    log.wall_seconds = time.perf_counter() - t0
    return log


def slots_from_jobsets(resources: Sequence[ResourceSpec],
                       jobsets: Sequence[Sequence], n_envs: int,
                       labels: Optional[Sequence[str]] = None
                       ) -> List[EnvSlot]:
    """Deal an ordered jobset list round-robin across ``n_envs`` lanes."""
    n_envs = max(1, min(int(n_envs), len(jobsets) or 1))
    slots = [EnvSlot(jobsets=[], resources=resources, tag=f"env{i}")
             for i in range(n_envs)]
    for k, jobs in enumerate(jobsets):
        label = labels[k] if labels is not None else f"set{k}"
        slots[k % n_envs].jobsets.append((label, list(jobs)))
    return slots


def _check_lane_resources(agent: MRSchAgent,
                          resources: Sequence[ResourceSpec]) -> None:
    names = tuple(r.name for r in resources)
    if names != tuple(agent.enc.resource_names):
        raise ValueError(
            f"lane resources {names} do not match the agent's encoding "
            f"{tuple(agent.enc.resource_names)}")
    for r, cap in zip(resources, agent.enc.capacities):
        if r.capacity > cap:
            raise ValueError(
                f"lane resource {r.name!r} capacity {r.capacity} exceeds "
                f"the agent's reference capacity {cap}; the state encoding "
                "only pads smaller clusters")


def train_agent_vectorized(agent: MRSchAgent, slots: Sequence[EnvSlot],
                           config: TrainConfig = TrainConfig(),
                           registry: Optional[MetricsRegistry] = None
                           ) -> TrainLog:
    """Batched curriculum training over heterogeneous environment lanes.

    Every lockstep round collects one decision from each live lane with a
    single ε-greedy forward; a lane that drains its trace flushes its
    episode to replay, runs the train steps (``agent.end_episode``) and is
    refilled with its next jobset, so the batch stays wide.  Reports
    per-episode metrics, rounds and decisions/s.

    ``registry`` (a ``repro_torch.obs.MetricsRegistry``) receives the
    training telemetry at each finished episode: loss, grad-norm, epsilon
    and decisions/s gauges, the episode-loss histogram and per-lane
    episode and decision counters.  Every value is a host float by then,
    so filling it costs no device sync.
    """
    log = TrainLog()
    if config.backend is not None:
        agent.set_backend(config.backend)
    if (config.state_module is not None
            and config.state_module != agent.config.state_module):
        raise ValueError(
            f"TrainConfig.state_module={config.state_module!r} does not "
            f"match the agent's {agent.config.state_module!r}: state-module "
            "parameter trees are structurally different, so the module "
            "cannot be swapped on a live agent — construct the agent with "
            "AgentConfig(state_module=...) instead")
    lanes = [s for s in slots if s.jobsets]
    if not lanes:
        return log
    window = config.window or agent.config.window
    queues: List[List[Tuple[str, List[Job]]]] = [
        list(lane.jobsets) * max(1, config.epochs) for lane in lanes]
    lane_res: List[Sequence[ResourceSpec]] = []
    for lane in lanes:
        res = lane.resources
        if res is None:
            raise ValueError(f"lane {lane.tag!r} has no resources")
        _check_lane_resources(agent, res)
        lane_res.append(list(res))
    active: List[str] = [""] * len(lanes)

    def make_sim(i: int) -> Optional[Simulator]:
        if not queues[i]:
            return None
        label, jobs = queues[i].pop(0)
        active[i] = label
        return Simulator(lane_res[i], jobs, agent,
                         SimConfig(window=window, backfill=config.backfill))

    t0 = time.perf_counter()
    agent.training = True
    agent.begin_vector_episodes(len(lanes))
    # Lanes are non-empty by construction, so every initial sim exists.
    vec = VectorSimulator([make_sim(i) for i in range(len(lanes))],
                          policy=agent)

    def refill(i: int, result: SimResult) -> Optional[Simulator]:
        with annotate("mrsch.train.episode_flush"):
            loss = agent.end_episode(slot=i)
        if loss is not None:
            log.episode_losses.append(loss)
        row = result.metrics.as_row()
        log.episode_metrics.append(row)
        log.episodes.append({"env": i, "jobset": active[i],
                             "tag": lanes[i].tag, "loss": loss,
                             "epsilon": agent.epsilon,
                             "decisions": result.decisions, **row})
        log.decisions += result.decisions
        if registry is not None:
            lane = {"lane": lanes[i].tag or f"env{i}"}
            registry.counter("train_episodes_total", lane).inc()
            registry.counter("train_decisions_total",
                             lane).inc(result.decisions)
            if loss is not None:
                registry.gauge("train_loss").set(loss)
                registry.histogram("train_episode_loss").observe(loss)
                if agent.last_grad_norm is not None:
                    registry.gauge("train_grad_norm").set(
                        agent.last_grad_norm)
            registry.gauge("train_epsilon").set(agent.epsilon)
            elapsed = time.perf_counter() - t0
            registry.gauge("train_decisions_per_sec").set(
                log.decisions / max(elapsed, 1e-9))
        if config.verbose:
            print(f"[train-vec] env {i} ({lanes[i].tag}) {active[i]}: "
                  f"loss={loss} eps={agent.epsilon:.3f} "
                  f"decisions={result.decisions}")
        return make_sim(i)

    on_round = None
    if config.grad_steps_per_round > 0:
        def on_round(round_idx: int, n_live: int) -> None:
            with annotate("mrsch.train.grad_steps"):
                loss = agent.train_steps(config.grad_steps_per_round)
            if loss is not None:
                log.round_losses.append(loss)

    vec.run(refill=refill, on_round=on_round)
    agent.training = False
    log.rounds = vec.stats.rounds
    log.wall_seconds = time.perf_counter() - t0
    return log


def evaluate(policy, resources: Sequence[ResourceSpec], jobs: Sequence,
             window: int = 10) -> SimResult:
    """Deterministic evaluation run (no exploration, no learning)."""
    was_training = getattr(policy, "training", False)
    if hasattr(policy, "training"):
        policy.training = False
    result = run_trace(resources, jobs, policy, window=window)
    if hasattr(policy, "training"):
        policy.training = was_training
    return result
