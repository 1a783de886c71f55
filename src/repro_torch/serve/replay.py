"""Replay through the service: the bridge between the simulator and the
decision service.

``ServicePolicy`` is a ``SchedulingPolicy`` facade whose ``select`` /
``select_batch`` route every decision through a ``DecisionService``, so
the ``Simulator`` and ``VectorSimulator`` — and every harness built on
them — can be driven end to end through the serving stack.  The
service's decision function is the same packed greedy forward the agent
uses, so a service-routed replay gives the same ``SimResult`` as a direct
``agent.select`` replay: the serving layer adds concurrency and batching,
never different decisions.

``ServiceSim`` bundles the cluster spec and the shared
``SimConfig.for_engine`` plumbing (the constructor the sweep and drift
harnesses use) into one replay entry point for traces and registry
scenarios.
"""
from __future__ import annotations

import time
from typing import List, Sequence

import numpy as np

from ..sim.cluster import ResourceSpec
from ..sim.job import Job
from ..sim.simulator import SchedContext, SimConfig, SimResult, Simulator
from ..sim.vector import VectorSimulator
from ..workloads.registry import build_jobs
from .service import DecisionService


class ServicePolicy:
    """Route a scheduling policy's decisions through a DecisionService.

    With ``track_latency=True`` every ``select`` records its end-to-end
    request latency (seconds) into ``latencies_s``.  ``select_batch``
    submits the whole group before waiting, so the group's requests
    coalesce in the batcher.
    """

    def __init__(self, service: DecisionService, track_latency: bool = False):
        self.service = service
        self.track_latency = track_latency
        self.latencies_s: List[float] = []

    def select(self, ctx: SchedContext) -> int:
        if not self.track_latency:
            return self.service.decide(ctx)
        t0 = time.perf_counter()
        action = self.service.decide(ctx)
        self.latencies_s.append(time.perf_counter() - t0)
        return action

    def select_batch(self, ctxs: Sequence[SchedContext]) -> np.ndarray:
        t0 = time.perf_counter()
        actions = self.service.decide_many(ctxs)
        if self.track_latency:
            dt = time.perf_counter() - t0
            self.latencies_s.extend([dt] * len(ctxs))
        return actions


class ServiceSim:
    """Drive the simulator(s) through a running decision service."""

    def __init__(self, service: DecisionService,
                 resources: Sequence[ResourceSpec], window: int = 10,
                 backfill: bool = True, track_latency: bool = False):
        self.service = service
        self.resources = list(resources)
        self.sim_cfg = SimConfig.for_engine("vector", window=window,
                                            backfill=backfill)
        self.policy = ServicePolicy(service, track_latency=track_latency)

    def run_trace(self, jobs: Sequence[Job]) -> SimResult:
        """Sequential replay of one trace, every decision served."""
        return Simulator(self.resources, jobs, self.policy,
                         self.sim_cfg).run()

    def run_traces(self, jobsets: Sequence[Sequence[Job]]) -> List[SimResult]:
        """Lockstep replay of N traces; each round's decisions coalesce
        into (at most) one service batch."""
        vec = VectorSimulator.from_jobsets(self.resources, jobsets,
                                           self.policy, self.sim_cfg)
        return vec.run()

    def run_scenario(self, name: str, theta, seed: int = 1,
                     **overrides) -> SimResult:
        """Replay one registry scenario through the service."""
        return self.run_trace(build_jobs(name, theta, seed=seed, **overrides))

    @property
    def latencies_s(self) -> List[float]:
        return self.policy.latencies_s
