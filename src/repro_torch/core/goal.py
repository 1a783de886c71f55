"""Dynamic resource prioritizing (paper §III-B, Eq. 1).

    r_j = sum_i P_ij * t_i / sum_j sum_i P_ij * t_i

summed over ALL jobs in the system — queued jobs (t_i = user walltime
estimate) and running jobs (t_i = remaining walltime estimate).  r_j is the
normalized ideal completion time of resource j's outstanding demand: the
fiercer the contention for a resource, the larger its goal weight.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..sim.simulator import SchedContext


def ctx_goal(ctx: SchedContext, resource_names: Sequence[str]) -> np.ndarray:
    """Eq. (1) goal vector against the context's OWN cluster capacities.

    Identical to using the reference capacities on the homogeneous
    cluster; on scaled-down environments it keeps the contention
    normalization honest for that environment.  The capacity array is
    cached on the cluster instance — this runs on every decision, for
    the agent's sequential/batched paths and the serving layer alike.
    """
    names = tuple(resource_names)
    cache = ctx.cluster.__dict__.setdefault("_goal_caps", {})
    cached = cache.get(names)
    if cached is None:
        caps = ctx.cluster.capacities
        cached = cache[names] = np.maximum(
            np.asarray([caps[n] for n in names], np.float64), 1.0)
    return goal_vector(ctx, names, cached)


def goal_vector(ctx: SchedContext, resource_names: Sequence[str],
                capacities: Sequence[int]) -> np.ndarray:
    names = tuple(resource_names)
    R = len(names)
    rng_r = range(R)
    acc = [0.0] * R

    # Queued jobs (full queue, not just the window): user walltime estimate.
    # This runs on every scheduling decision, so the per-job demand rows
    # come from Job.demand_row's instance cache and accumulate in plain
    # Python floats — numpy per-job ops would pay ~1us dispatch each.
    queued = ctx.queue if ctx.queue is not None else ctx.window
    if queued:
        for j in queued:
            w = j.walltime
            row = j.demand_row(names)
            for r in rng_r:
                acc[r] += w * row[r]

    # Running jobs: remaining estimated time.
    now = ctx.now
    for rj in ctx.cluster.running.values():
        rem = rj.est_end - now
        if rem > 0.0:
            row = rj.job.demand_row(names)
            for r in rng_r:
                acc[r] += rem * row[r]

    if isinstance(capacities, np.ndarray) and capacities.dtype == np.float64:
        caps = np.maximum(capacities, 1.0)   # hot path: no list conversion
    else:
        caps = np.maximum(np.asarray(capacities, dtype=np.float64), 1.0)
    demand_time = np.asarray(acc, dtype=np.float64) / caps
    total = demand_time.sum()
    if total <= 0:
        return np.full(R, 1.0 / R, dtype=np.float32)
    return (demand_time / total).astype(np.float32)
