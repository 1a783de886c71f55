"""Replay through the service: the bridge between the simulator and the
decision service.

``ServicePolicy`` is a ``SchedulingPolicy`` facade whose ``select`` /
``select_batch`` route every decision through a ``DecisionService``, so
the ``Simulator`` can be driven end to end through the serving stack.
The service's decision function is the same packed greedy forward the
agent uses, so a service-routed replay gives the same ``SimResult`` as a
direct ``agent.select`` replay: the serving layer adds concurrency and
batching, never different decisions.  (Lockstep replay of many traces and
registry scenarios wait for the vector engine and the registry.)
"""
from __future__ import annotations

import time
from typing import List, Sequence

import numpy as np

from ..sim.cluster import ResourceSpec
from ..sim.job import Job
from ..sim.simulator import SchedContext, SimConfig, SimResult, Simulator
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
    """Drive the simulator through a running decision service."""

    def __init__(self, service: DecisionService,
                 resources: Sequence[ResourceSpec], window: int = 10,
                 backfill: bool = True, track_latency: bool = False):
        self.service = service
        self.resources = list(resources)
        self.sim_cfg = SimConfig.for_engine(window=window, backfill=backfill)
        self.policy = ServicePolicy(service, track_latency=track_latency)

    def run_trace(self, jobs: Sequence[Job]) -> SimResult:
        """Sequential replay of one trace, every decision served."""
        return Simulator(self.resources, jobs, self.policy,
                         self.sim_cfg).run()

    @property
    def latencies_s(self) -> List[float]:
        return self.policy.latencies_s
