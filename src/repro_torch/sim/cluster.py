"""Multi-resource cluster state.

Tracks per-*unit* occupancy for every schedulable resource so the MRSch
vector state encoding (availability bit + estimated time-to-free per unit,
paper §III-A) can be produced exactly.  Unit granularity is configured per
resource (e.g. 1 node, 1 TB of burst buffer, 1 kW of power headroom).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .job import Job

# Time-to-free values are clamped to this horizon (30 days) in the state
# encoding: a permanently drained unit carries an infinite release time,
# which would otherwise leak inf into the NN features.  Ordinary jobs
# (walltime <= 1 day in every trace family) never reach the clamp.
TTF_HORIZON = 30.0 * 86400.0


@dataclass(frozen=True)
class ResourceSpec:
    name: str
    capacity: int               # number of schedulable units
    unit: str = ""              # human label, e.g. "node", "TB", "kW"


@dataclass
class RunningJob:
    job: Job
    units: Dict[str, np.ndarray]          # resource -> allocated unit indices
    est_end: float                        # start + walltime (user estimate)


class Cluster:
    """Allocation state over R resources, each an array of units.

    ``release[r][i]`` is the *estimated* release time of unit ``i`` of
    resource ``r`` (from the running job's user walltime estimate), or 0.0
    when the unit is free — exactly the quantity the paper's state encoding
    consumes.

    Drained units (fault injection) are modeled as *phantom reservations*:
    the unit's release time is set to the restore time (``inf`` for a
    permanent failure) without any owning job, so every fit / reservation /
    backfill / encoding path treats the outage like one more running job.
    ``drained[r]`` marks which units are phantom so restores never free a
    real job's units and utilization can exclude the lost capacity.
    """

    def __init__(self, resources: List[ResourceSpec]):
        self.resources = list(resources)
        self.names = [r.name for r in self.resources]
        self.capacities: Dict[str, int] = {r.name: r.capacity for r in self.resources}
        self.release: Dict[str, np.ndarray] = {
            r.name: np.zeros(r.capacity, dtype=np.float64) for r in self.resources
        }
        self.free: Dict[str, int] = dict(self.capacities)
        self.running: Dict[int, RunningJob] = {}
        self.drained: Dict[str, np.ndarray] = {
            r.name: np.zeros(r.capacity, dtype=bool) for r in self.resources
        }

    # ------------------------------------------------------------ queries
    def fits(self, job: Job) -> bool:
        return all(job.demands.get(n, 0) <= self.free[n] for n in self.names)

    def free_vector(self) -> Dict[str, int]:
        return dict(self.free)

    def drained_count(self, name: str) -> int:
        return int(self.drained[name].sum())

    def busy_units(self, name: str) -> int:
        """Units running real work: capacity minus free minus drained."""
        return self.capacities[name] - self.free[name] - self.drained_count(name)

    def utilization(self) -> np.ndarray:
        """Instantaneous busy fraction per resource (paper's measurement).

        Drained units count as neither busy nor free — lost capacity is
        reported through the fault metrics, not as utilization.
        """
        return np.array(
            [self.busy_units(n) / max(self.capacities[n], 1) for n in self.names],
            dtype=np.float64,
        )

    def earliest_fit_time(self, job: Job, now: float) -> float:
        """Earliest time the job fits, assuming running jobs release at their
        estimated end times.  Used to place the head-of-queue reservation.
        Phantom (drained) reservations participate like any other: a
        permanently drained unit releases at ``inf``."""
        t = now
        for n in self.names:
            need = job.demands.get(n, 0)
            if need <= self.free[n]:
                continue
            rel = self.release[n]
            busy = np.sort(rel[rel > 0.0])
            extra = need - self.free[n]
            if extra > len(busy):          # can never fit (over capacity)
                return float("inf")
            t = max(t, busy[extra - 1])
        return t

    # ------------------------------------------------------------ mutation
    def allocate(self, job: Job, now: float) -> None:
        assert self.fits(job), f"job {job.jid} does not fit"
        units: Dict[str, np.ndarray] = {}
        est_end = now + job.walltime
        for n in self.names:
            need = job.demands.get(n, 0)
            if need == 0:
                units[n] = np.empty(0, dtype=np.int64)
                continue
            idx = np.flatnonzero(self.release[n] == 0.0)[:need]
            self.release[n][idx] = est_end
            self.free[n] -= need
            units[n] = idx
        job.start = now
        job.end = now + job.runtime
        if job.first_start < 0.0:
            job.first_start = now
        self.running[job.jid] = RunningJob(job=job, units=units, est_end=est_end)

    def release_job(self, jid: int) -> Job:
        rj = self.running.pop(jid)
        for n, idx in rj.units.items():
            if idx.size:
                self.release[n][idx] = 0.0
                self.free[n] += int(idx.size)
        return rj.job

    # ------------------------------------------------------------ faults
    def residents(self, name: str, count: int) -> List[int]:
        """jids of running jobs owning any unit of ``name`` in [0, count)."""
        out = []
        for jid, rj in self.running.items():
            idx = rj.units.get(name)
            if idx is not None and idx.size and int(idx.min()) < count:
                out.append(jid)
        return sorted(out)

    def apply_drain(self, name: str, count: int, restore_t: float) -> None:
        """Mark units [0, count) of ``name`` as phantom-reserved until
        ``restore_t``.  Resident jobs must have been killed already."""
        rel = self.release[name]
        assert not rel[:count].any(), "drain applied over occupied units"
        assert not self.drained[name][:count].any(), "overlapping drains"
        rel[:count] = restore_t
        self.drained[name][:count] = True
        self.free[name] -= count

    def apply_restore(self, name: str, count: int) -> None:
        """Return the phantom units of a finished drain to the free pool."""
        mask = self.drained[name].copy()
        mask[count:] = False
        n = int(mask.sum())
        self.release[name][mask] = 0.0
        self.drained[name][mask] = False
        self.free[name] += n

    # ------------------------------------------------------------ encoding
    def unit_encoding(self, now: float) -> Dict[str, np.ndarray]:
        """Per-unit (availability, time-to-free) pairs, paper §III-A."""
        out = {}
        for n in self.names:
            rel = self.release[n]
            avail = (rel == 0.0).astype(np.float64)
            ttf = np.where(rel > 0.0, np.maximum(rel - now, 0.0), 0.0)
            out[n] = np.stack([avail, np.minimum(ttf, TTF_HORIZON)], axis=1)
        return out

    def running_jobs(self) -> List[RunningJob]:
        return list(self.running.values())
