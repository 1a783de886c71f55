"""Sequential curriculum training of the MRSch agent (paper §III-D, §V-B),
and deterministic evaluation: the JAX package's ``train_agent`` without a
``TrainConfig`` (one trace at a time through ``run_trace``, gradient steps
at each episode's end) and ``evaluate``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

from ..sim.cluster import ResourceSpec
from ..sim.simulator import SimResult, run_trace
from .agent import MRSchAgent


@dataclass
class TrainLog:
    episode_losses: List[float] = field(default_factory=list)
    episode_metrics: List[Dict[str, float]] = field(default_factory=list)
    episodes: List[Dict] = field(default_factory=list)   # per-episode rows
    wall_seconds: float = 0.0
    decisions: int = 0


def train_agent(agent: MRSchAgent, resources: Sequence[ResourceSpec],
                jobsets: Sequence[Sequence], epochs: int = 1,
                verbose: bool = False) -> TrainLog:
    """Run the agent through the ordered jobsets with exploration and
    learning: each trace is one episode, ended by ``agent.end_episode``."""
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
            log.episodes.append({"jobset": f"set{i}", "epoch": epoch,
                                 "loss": loss, "epsilon": agent.epsilon,
                                 "decisions": result.decisions, **row})
            log.decisions += result.decisions
            if verbose:
                print(f"[train] epoch {epoch} set {i}: loss={loss} "
                      f"eps={agent.epsilon:.3f} "
                      f"util={result.metrics.utilization}")
    agent.training = False
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
