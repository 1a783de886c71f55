"""Shared job-lifecycle core of the scheduling engine.

One explicit state machine::

    HELD -> ELIGIBLE -> QUEUED -> RUNNING -> FINISHED
                           ^          |
                           +-- requeue+---------> FAILED

- HELD:     submitted (or not yet submitted) with unfinished parents.
- ELIGIBLE: all parents finished; waiting out ``think_time`` before the
  job may join the queue.
- QUEUED:   visible to the scheduler (window/backfill candidates).
- RUNNING:  holds cluster units until the attempt ends.
- FINISHED: terminal success; releases children.
- FAILED:   terminal failure — a killed attempt past the requeue bound,
  or (at result time) a cascade from a FAILED ancestor.

The *transition logic* lives here and only here:

- the sequential :class:`~repro_torch.sim.simulator.Simulator` calls the
  host methods on :class:`JobLifecycle` per event;
- the device engine (:mod:`repro_torch.sim.device`) folds the
  ``device_*`` tensor functions below into its round loop over masked
  fixed-capacity arrays.

Queue ordering is part of the contract: the waiting queue is kept sorted
by ``(original submit, jid)`` (:func:`queue_key`).  For dependency-free
traces this equals arrival order, so historic schedules are unchanged;
for requeued or dependency-released jobs it pins one deterministic order
that the packed device engine reproduces by construction (jobs are
packed sorted by the same key).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .cluster import Cluster
from .job import Job

# State constants.  HELD must stay 0: freshly built Jobs default to it.
HELD, ELIGIBLE, QUEUED, RUNNING, FINISHED, FAILED = range(6)
STATE_NAMES = ("HELD", "ELIGIBLE", "QUEUED", "RUNNING", "FINISHED", "FAILED")

#: Attempts a job may lose before it is FAILED permanently: a job is
#: requeued after kill k while ``k <= DEFAULT_MAX_REQUEUES``.
DEFAULT_MAX_REQUEUES = 3

INF = float("inf")

#: Owner id of drained (phantom-reserved) units in the device engine's
#: packed owner array; real jobs are >= 0 and free units are -1.
PHANTOM_OWNER = -2


# --------------------------------------------------------------------------
# Fault schedule
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class DrainEvent:
    """Drain the FIRST ``units`` units of ``resource`` at ``time`` for
    ``duration`` seconds (``inf`` = permanent failure).  Resident jobs are
    killed (whole-job: rigid jobs cannot shrink) and requeued.

    ``unit_frac`` may be given instead of ``units`` so one schedule works
    across cluster sizes; it resolves against capacity at simulation
    setup.  With ``FaultSchedule.relative``, ``time``/``duration`` are
    fractions of the trace's submit span instead of seconds.
    """

    time: float
    resource: str
    units: int = 0
    duration: float = INF
    unit_frac: float = 0.0


@dataclass(frozen=True)
class FaultSchedule:
    """Deterministic per-scenario fault plan (drains + requeue bound)."""

    drains: Tuple[DrainEvent, ...] = ()
    max_requeues: int = DEFAULT_MAX_REQUEUES
    relative: bool = False

    def resolve(self, jobs: Sequence[Job],
                capacities: Dict[str, int]) -> "FaultSchedule":
        """Return an absolute schedule: fractions -> units/seconds, drains
        sorted by time, per-resource overlap rejected (a unit can belong
        to at most one outage at a time)."""
        if self.max_requeues < 0:
            raise ValueError("max_requeues must be >= 0")
        submits = [j.submit for j in jobs]
        t0 = min(submits) if submits else 0.0
        span = max((max(submits) - t0), 1.0) if submits else 1.0
        out = []
        for d in self.drains:
            if d.resource not in capacities:
                raise ValueError(f"drain on unknown resource {d.resource!r}")
            units = d.units or int(round(d.unit_frac * capacities[d.resource]))
            units = max(0, min(units, capacities[d.resource]))
            t, dur = d.time, d.duration
            if self.relative:
                t = t0 + t * span
                dur = dur * span if np.isfinite(dur) else INF
            if dur <= 0:
                raise ValueError("drain duration must be > 0")
            if units > 0:
                out.append(DrainEvent(t, d.resource, units=units, duration=dur))
        out.sort(key=lambda d: (d.time, d.resource))
        last_end: Dict[str, float] = {}
        for d in out:
            if d.time < last_end.get(d.resource, -INF):
                raise ValueError(
                    f"overlapping drains on resource {d.resource!r}")
            last_end[d.resource] = d.time + d.duration
        return FaultSchedule(tuple(out), self.max_requeues, relative=False)


def resolve_faults(faults: Optional[FaultSchedule], jobs: Sequence[Job],
                   capacities: Dict[str, int]) -> FaultSchedule:
    return (faults or FaultSchedule()).resolve(jobs, capacities)


# --------------------------------------------------------------------------
# Queue ordering
# --------------------------------------------------------------------------
def queue_key(job: Job) -> Tuple[float, int]:
    """Deterministic waiting-queue order: original submit time, then jid."""
    return (job.submit, job.jid)


def insert_queued(queue: List[Job], job: Job) -> None:
    """Insert ``job`` into ``queue`` keeping it sorted by :func:`queue_key`.

    Requeued jobs re-enter at their ORIGINAL submit position, so they do
    not lose queue priority to jobs that arrived after them.
    """
    k = queue_key(job)
    lo, hi = 0, len(queue)
    while lo < hi:
        mid = (lo + hi) // 2
        if queue_key(queue[mid]) <= k:
            lo = mid + 1
        else:
            hi = mid
    queue.insert(lo, job)


# --------------------------------------------------------------------------
# Host transition core
# --------------------------------------------------------------------------
class JobLifecycle:
    """Per-event host transitions over one cluster + one job set.

    The :class:`~repro_torch.sim.simulator.Simulator` owns the event heap
    and the waiting queue; every state change flows through this object.
    """

    def __init__(self, jobs: Sequence[Job], cluster: Cluster,
                 faults: Optional[FaultSchedule] = None):
        self.cluster = cluster
        self.jobs = list(jobs)
        self.by_id: Dict[int, Job] = {}
        for j in self.jobs:
            if j.jid in self.by_id:
                raise ValueError(f"duplicate jid {j.jid}")
            j.state = HELD
            self.by_id[j.jid] = j
        # Dangling deps (parent not in this jobset — e.g. sampled
        # sub-traces) are treated as already satisfied.
        self.children: Dict[int, List[Job]] = {}
        for j in self.jobs:
            for d in j.deps:
                if d in self.by_id and d != j.jid:
                    self.children.setdefault(d, []).append(j)
        self.faults = resolve_faults(faults, self.jobs, cluster.capacities)
        self.max_requeues = self.faults.max_requeues
        self.submitted: set = set()
        # "node" anchors the failed-work metric; first resource otherwise.
        self.primary = "node" if "node" in cluster.names else cluster.names[0]

    # ---------------------------------------------------------- eligibility
    def ready_time(self, job: Job) -> float:
        """Time the job may join the queue: ``max(submit, max_parent(end)
        + think_time)``; ``inf`` while any present parent is unfinished."""
        t = job.submit
        for d in job.deps:
            p = self.by_id.get(d)
            if p is None or p is job:
                continue
            if p.state != FINISHED:
                return INF
            t = max(t, p.end + job.think_time)
        return t

    def on_submit(self, job: Job, now: float) -> Tuple[str, float]:
        """Submit event.  Returns ``(outcome, ready)`` where outcome is
        ``"queued"`` (insert now), ``"eligible"`` (schedule a release
        event at ``ready``) or ``"held"`` (parents pending)."""
        self.submitted.add(job.jid)
        r = self.ready_time(job)
        if r <= now:
            job.state = QUEUED
            return "queued", now
        if np.isfinite(r):
            job.state = ELIGIBLE
            return "eligible", r
        return "held", INF

    def on_release(self, job: Job) -> bool:
        """ELIGIBLE -> QUEUED (think-time expiry).  False if stale."""
        if job.state != ELIGIBLE:
            return False
        job.state = QUEUED
        return True

    # ---------------------------------------------------------- run attempts
    def attempt(self, job: Job) -> Tuple[float, bool]:
        """Duration and failure flag of the job's NEXT attempt."""
        k = job.requeues
        if k < len(job.fail_times) and job.fail_times[k] < job.runtime:
            return float(job.fail_times[k]), True
        return job.runtime, False

    def start(self, job: Job, now: float) -> float:
        """QUEUED -> RUNNING.  Allocates units and returns the attempt's
        end time (the failure point for a doomed attempt)."""
        assert job.state == QUEUED, f"start from {STATE_NAMES[job.state]}"
        self.cluster.allocate(job, now)
        dur, _ = self.attempt(job)
        job.end = now + dur
        job.state = RUNNING
        return job.end

    def is_stale_end(self, job: Job, attempt_id: int) -> bool:
        """An end event is stale when its attempt was killed by a drain
        (the job was requeued or failed since the event was scheduled)."""
        return job.state != RUNNING or job.requeues != attempt_id

    def on_end(self, job: Job, now: float) -> Tuple[str, List[Tuple[Job, float]]]:
        """RUNNING attempt reached its scheduled end.

        Returns ``(outcome, released)``: outcome is ``"finished"``,
        ``"requeued"`` or ``"failed"``; ``released`` lists newly eligible
        children as ``(child, ready_time)`` pairs (ready <= now means the
        child joins the queue in this same coalesced timestamp).
        """
        _, fails = self.attempt(job)
        if fails:
            return self.kill(job, now), []
        self.cluster.release_job(job.jid)
        job.state = FINISHED
        return "finished", self._release_children(job, now)

    def _release_children(self, job: Job, now: float) -> List[Tuple[Job, float]]:
        out = []
        for c in self.children.get(job.jid, ()):  # deterministic jobset order
            if c.state != HELD or c.jid not in self.submitted:
                continue
            r = self.ready_time(c)
            if not np.isfinite(r):
                continue
            c.state = QUEUED if r <= now else ELIGIBLE
            out.append((c, max(r, now)))
        return out

    # ---------------------------------------------------------- faults
    def kill(self, job: Job, now: float) -> str:
        """Kill the RUNNING attempt (failure point or drain).  The lost
        work is charged to ``failed_work``; the job re-enters the queue at
        its original position unless the requeue bound is exhausted."""
        assert job.state == RUNNING
        job.failed_work += job.demands.get(self.primary, 0) * (now - job.start)
        self.cluster.release_job(job.jid)
        job.requeues += 1
        job.start = -1.0
        job.end = -1.0
        if job.requeues > self.max_requeues:
            job.state = FAILED
            return "failed"
        job.state = QUEUED
        return "requeued"

    def on_drain(self, d: DrainEvent, now: float) -> List[Tuple[Job, str]]:
        """Apply a drain: kill resident jobs (ascending jid), then mark
        the unit range as phantom-reserved until the restore time."""
        out = []
        for jid in self.cluster.residents(d.resource, d.units):
            job = self.cluster.running[jid].job
            out.append((job, self.kill(job, now)))
        restore_t = d.time + d.duration
        self.cluster.apply_drain(d.resource, d.units, restore_t)
        return out

    def on_restore(self, d: DrainEvent) -> None:
        self.cluster.apply_restore(d.resource, d.units)


# --------------------------------------------------------------------------
# Result-time helpers (shared by every engine's summarize path)
# --------------------------------------------------------------------------
def cascade_failures(jobs: Sequence[Job]) -> int:
    """Mark never-started descendants of FAILED ancestors as FAILED.

    Run at result time: during simulation a HELD child of a failed parent
    simply never becomes eligible, which is indistinguishable from
    starvation; the cascade makes the verdict explicit in the metrics.
    Returns the number of jobs newly marked.
    """
    by_id = {j.jid: j for j in jobs}
    n, changed = 0, True
    while changed:
        changed = False
        for j in jobs:
            if j.state in (FINISHED, FAILED) or j.started:
                continue
            if any(by_id[d].state == FAILED
                   for d in j.deps if d in by_id and d != j.jid):
                j.state = FAILED
                n += 1
                changed = True
    return n


def workflow_components(jobs: Sequence[Job]) -> List[List[Job]]:
    """Connected components of the dependency graph (size >= 2 only)."""
    idx = {j.jid: i for i, j in enumerate(jobs)}
    parent = list(range(len(jobs)))

    def find(a: int) -> int:
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for j in jobs:
        for d in j.deps:
            if d in idx and d != j.jid:
                ra, rb = find(idx[j.jid]), find(idx[d])
                if ra != rb:
                    parent[ra] = rb
    comps: Dict[int, List[Job]] = {}
    for i, j in enumerate(jobs):
        comps.setdefault(find(i), []).append(j)
    return [c for c in comps.values() if len(c) >= 2]


def pipeline_makespan(jobs: Sequence[Job]) -> float:
    """Mean makespan (last end - first submit) over workflow components
    whose every member FINISHED; 0.0 when no component completed."""
    spans = []
    for comp in workflow_components(jobs):
        if all(j.state == FINISHED for j in comp):
            spans.append(max(j.end for j in comp) - min(j.submit for j in comp))
    return float(np.mean(spans)) if spans else 0.0


def work_summary(jobs: Sequence[Job], primary: str) -> Tuple[float, float]:
    """(completed, failed) node-seconds on the ``primary`` resource."""
    completed = sum(j.demands.get(primary, 0) * j.runtime
                    for j in jobs if j.state == FINISHED)
    failed = sum(j.failed_work for j in jobs)
    return float(completed), float(failed)


# --------------------------------------------------------------------------
# Device-side transitions (folded into the device engine's round loop)
# --------------------------------------------------------------------------
# Shapes: N envs, J jobs, P max parents, A max attempts, D drains, U total
# resource units (concatenated segments).  Counterparts of the JAX
# package's ``device_*`` functions in ``repro/sim/lifecycle.py``, on torch
# tensors of one device; the functions that take the state dict ``st``
# replace its entries and return it.  The zero-size fast paths (P == 0,
# A == 0, D == 0) are Python branches, as in the reference.

def device_ready(submit, deps_idx, think, end_t, finished):
    """Earliest queue-entry time per job: ``max(submit, max_parent(end) +
    think)`` while all present parents are finished, else ``+inf``
    (reference: ``device_ready``)."""
    n, j, p = deps_idx.shape
    if p == 0:
        return submit
    flat = deps_idx.clamp(0, j - 1).reshape(n, j * p).long()
    has = deps_idx >= 0
    pfin = torch.gather(finished, 1, flat).reshape(n, j, p) & has
    pend = torch.gather(end_t, 1, flat).reshape(n, j, p)
    all_done = torch.where(has, pfin, True).all(dim=2)
    pmax = torch.where(pfin, pend, -torch.inf).amax(dim=2)
    ready = torch.maximum(submit, pmax + think)
    return torch.where(all_done, ready, torch.inf)


def device_queued(ready, now, started, finished, failed):
    """QUEUED mask: eligible by ``now`` and not in any other live state
    (reference: ``device_queued``)."""
    return (ready <= now[:, None]) & ~started & ~finished & ~failed


def device_attempt(fail_times, requeues, runtime):
    """(duration, will_fail) of each job's NEXT attempt (reference:
    ``device_attempt``)."""
    if fail_times.shape[2] == 0:
        return runtime, torch.zeros(runtime.shape, dtype=torch.bool,
                                    device=runtime.device)
    a = fail_times.shape[2]
    k = requeues.clamp(0, a - 1)[..., None].long()
    ft = torch.gather(fail_times, 2, k)[..., 0]
    ft = torch.where(requeues < a, ft, torch.inf)
    will_fail = ft < runtime
    return torch.where(will_fail, ft, runtime), will_fail


def device_free_units(mask_j, release, owner):
    """Free every unit owned by a job in ``mask_j`` (N, J) (reference:
    ``device_free_units``).  Free (-1) and phantom (-2) owners gather job
    0 and are masked out afterwards."""
    hit = torch.gather(mask_j, 1, owner.clamp_min(0).long()) & (owner >= 0)
    return torch.where(hit, 0.0, release), torch.where(hit, -1, owner)


def device_kill(killed, now, demands, node_idx, max_requeues, st):
    """Kill RUNNING attempts in ``killed`` (N, J): free their units,
    charge the lost work, and either requeue (original queue position —
    ordering is by packed job index) or mark FAILED past the bound
    (reference: ``device_kill``)."""
    # where() not arithmetic masking: ``now`` is +inf for envs with no
    # event this round, and inf * 0.0 would poison the area with NaN.
    run_t = torch.where(killed, (now[:, None] - st["start"]).clamp_min(0.0),
                        0.0)
    work = demands * run_t[..., None]                      # (N, J, R)
    st["failed_area"] = st["failed_area"] + work.sum(dim=1)
    st["failed_work"] = st["failed_work"] + work[..., node_idx]
    st["release"], st["owner"] = device_free_units(
        killed, st["release"], st["owner"])
    st["requeues"] = st["requeues"] + killed.to(st["requeues"].dtype)
    st["failed"] = st["failed"] | (killed & (st["requeues"] > max_requeues))
    st["started"] = st["started"] & ~killed
    st["start"] = torch.where(killed, -1.0, st["start"])
    st["end"] = torch.where(killed, torch.inf, st["end"])
    st["cur_fail"] = st["cur_fail"] & ~killed
    return st


def device_apply_ends(t, act, demands, node_idx, max_requeues, st,
                      has_kills=True):
    """Apply every attempt-end scheduled at ``t``: clean finishes release
    units and go FINISHED; failure points are killed/requeued.
    ``has_kills=False`` skips the kill path for traces with no failure
    points and no drains (reference: ``device_apply_ends``)."""
    running = st["started"] & ~st["finished"]
    due = running & (st["end"] == t[:, None]) & act[:, None]
    fin = due & ~st["cur_fail"] if has_kills else due
    st["finished"] = st["finished"] | fin
    st["release"], st["owner"] = device_free_units(
        fin, st["release"], st["owner"])
    if has_kills:
        st = device_kill(due & st["cur_fail"], t, demands, node_idx,
                         max_requeues, st)
    return st


def _drain_range(faults, d):
    return ((faults.unit_seg[None, :] == faults.drain_res[:, d:d + 1])
            & (faults.unit_local[None, :] < faults.drain_units[:, d:d + 1]))


def device_apply_drains(t, act, faults, demands, node_idx, st):
    """Fire drains scheduled at ``t``: kill residents of the unit range,
    then phantom-reserve it (owner = PHANTOM_OWNER) until restore
    (reference: ``device_apply_drains``)."""
    n, u = st["release"].shape
    jmax = st["started"].shape[1]
    for d in range(faults.drain_t.shape[1]):
        fire = act & (faults.drain_t[:, d] == t) & ~st["drain_done"][:, d]
        in_range = _drain_range(faults, d)
        kill_u = fire[:, None] & in_range & (st["owner"] >= 0)
        # A job owning several units of the range is hit once per unit:
        # amax makes the duplicates OR, never overwrite True with False.
        killed = torch.zeros((n, jmax), dtype=torch.int32,
                             device=kill_u.device).scatter_reduce(
            1, st["owner"].clamp_min(0).long(), kill_u.to(torch.int32),
            "amax").bool()
        st = device_kill(killed, t, demands, node_idx,
                         faults.max_requeues, st)
        phantom = fire[:, None] & in_range
        st["release"] = torch.where(phantom, faults.restore_t[:, d:d + 1],
                                    st["release"])
        st["owner"] = torch.where(phantom, PHANTOM_OWNER, st["owner"])
        done = st["drain_done"].clone()
        done[:, d] |= fire
        st["drain_done"] = done
    return st


def device_apply_restores(t, act, faults, st):
    """Return phantom units of elapsed drains to the free pool (reference:
    ``device_apply_restores``)."""
    for d in range(faults.drain_t.shape[1]):
        fire = act & (faults.restore_t[:, d] == t) \
            & st["drain_done"][:, d] & ~st["restore_done"][:, d]
        clear = (fire[:, None] & _drain_range(faults, d)
                 & (st["owner"] == PHANTOM_OWNER))
        st["release"] = torch.where(clear, 0.0, st["release"])
        st["owner"] = torch.where(clear, -1, st["owner"])
        done = st["restore_done"].clone()
        done[:, d] |= fire
        st["restore_done"] = done
    return st


def device_next_event(now, ready, end_t, started, finished, failed, faults,
                      st):
    """Next event time per env: min over pending queue-entries, running
    ends, un-fired drains and un-fired restores (inf when drained)
    (reference: ``device_next_event``)."""
    pending = ~started & ~finished & ~failed & (ready > now[:, None])
    nxt = torch.where(pending, ready, torch.inf).amin(dim=1)
    running = started & ~finished
    nxt = torch.minimum(nxt, torch.where(running, end_t,
                                         torch.inf).amin(dim=1))
    if faults is not None and faults.drain_t.shape[1]:
        nxt = torch.minimum(nxt, torch.where(
            ~st["drain_done"], faults.drain_t, torch.inf).amin(dim=1))
        nxt = torch.minimum(nxt, torch.where(
            st["drain_done"] & ~st["restore_done"], faults.restore_t,
            torch.inf).amin(dim=1))
    return nxt
