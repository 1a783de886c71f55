"""Scheduling quality metrics (paper §IV-B, plus lifecycle extensions).

1) node utilization      = used node-hours / elapsed node-hours
2) burst-buffer util     = used BB-hours / elapsed BB-hours
   (generalized: one utilization figure per schedulable resource)
3) average job wait time = mean(first start - submit)
4) average job slowdown  = mean((wait + runtime) / runtime)

Workflow/fault extensions (repro_torch.sim.lifecycle, beyond the paper's
rigid-independent-job assumption):

5) requeues              = killed attempts that re-entered the queue
6) n_failed              = jobs terminally FAILED (requeue bound / cascade)
7) failed_node_hours     = node-hours of work lost to killed attempts
8) completed_work_frac   = completed / (completed + failed) node-hours
9) pipeline_makespan     = mean (last end - first submit) over fully
   finished workflow components
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from . import lifecycle


@dataclass
class ScheduleMetrics:
    utilization: Dict[str, float]
    avg_wait: float
    avg_slowdown: float
    avg_bounded_slowdown: float
    p95_wait: float
    max_wait: float
    n_jobs: int
    makespan: float
    truncated_jobs: int = 0   # waiting jobs beyond the observable window,
    #                           summed over decisions (set by the engines,
    #                           not by MetricsAccumulator.summarize)
    # Lifecycle metrics — appended last so committed baseline rows keep
    # prefix-comparing (tools/check_bench.py contract).
    requeues: int = 0
    n_failed: int = 0
    failed_node_hours: float = 0.0
    completed_work_frac: float = 1.0
    pipeline_makespan: float = 0.0

    def as_row(self) -> Dict[str, float]:
        """Flat CSV/JSON row: every scalar field plus one util_<name>
        column per resource (tests pin that no field is dropped)."""
        row = {f"util_{k}": v for k, v in self.utilization.items()}
        row.update(
            avg_wait=self.avg_wait,
            avg_slowdown=self.avg_slowdown,
            avg_bounded_slowdown=self.avg_bounded_slowdown,
            p95_wait=self.p95_wait,
            max_wait=self.max_wait,
            n_jobs=self.n_jobs,
            makespan=self.makespan,
            truncated_jobs=self.truncated_jobs,
            requeues=self.requeues,
            n_failed=self.n_failed,
            failed_node_hours=self.failed_node_hours,
            completed_work_frac=self.completed_work_frac,
            pipeline_makespan=self.pipeline_makespan,
        )
        return row


class MetricsAccumulator:
    """Integrates per-resource busy-units over simulated time."""

    def __init__(self, cluster):
        self.cluster = cluster
        self.last_time = 0.0
        self.busy_area: Dict[str, float] = {n: 0.0 for n in cluster.names}
        self.start_time: float | None = None

    def advance(self, new_time: float) -> None:
        dt = new_time - self.last_time
        if dt > 0:
            for n in self.cluster.names:
                # Drained units are neither busy nor free: the outage is
                # charged to the fault metrics, not to utilization.
                self.busy_area[n] += self.cluster.busy_units(n) * dt
        self.last_time = new_time

    def job_started(self, job) -> None:
        if self.start_time is None:
            self.start_time = job.start

    def summarize(self, jobs: List,
                  all_jobs: Optional[List] = None) -> ScheduleMetrics:
        """``jobs``: started jobs (finite wait).  ``all_jobs``: the full
        trace with final lifecycle states, for the fault/workflow metrics;
        omitted by callers predating the lifecycle core."""
        elapsed = max(self.last_time - (self.start_time or 0.0), 1e-9)
        util = {
            n: self.busy_area[n] / (self.cluster.capacities[n] * elapsed)
            for n in self.cluster.names
        }
        waits = np.array([j.wait for j in jobs]) if jobs else np.zeros(1)
        slow = np.array([j.slowdown for j in jobs]) if jobs else np.ones(1)
        bslow = np.array([j.bounded_slowdown() for j in jobs]) if jobs else np.ones(1)
        m = ScheduleMetrics(
            utilization=util,
            avg_wait=float(waits.mean()),
            avg_slowdown=float(slow.mean()),
            avg_bounded_slowdown=float(bslow.mean()),
            p95_wait=float(np.percentile(waits, 95)),
            max_wait=float(waits.max()),
            n_jobs=len(jobs),
            makespan=self.last_time,
        )
        if all_jobs is not None:
            primary = ("node" if "node" in self.cluster.names
                       else self.cluster.names[0])
            lifecycle.cascade_failures(all_jobs)
            # A job's final kill may take it to FAILED instead of back to
            # the queue; only actual re-entries count as requeues.
            m.requeues = int(sum(
                j.requeues - (1 if j.state == lifecycle.FAILED
                              and j.requeues > 0 else 0)
                for j in all_jobs))
            m.n_failed = sum(1 for j in all_jobs
                             if j.state == lifecycle.FAILED)
            done, lost = lifecycle.work_summary(all_jobs, primary)
            m.failed_node_hours = lost / 3600.0
            m.completed_work_frac = (done / (done + lost)
                                     if done + lost > 0 else 1.0)
            m.pipeline_makespan = lifecycle.pipeline_makespan(all_jobs)
        return m
