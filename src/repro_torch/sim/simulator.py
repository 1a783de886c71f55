"""Event-driven multi-resource scheduling simulator (CQSim-equivalent).

Semantics follow the paper (§IV): jobs are imported from a trace; the
simulation clock advances on job arrival / eligibility-release / attempt
end / drain / restore events; each event triggers a scheduling pass in
which the policy (MRSch agent or a baseline) repeatedly selects jobs from
a window at the head of the queue.  A selected job that fits starts
immediately; the first selected job that does not fit receives a
reservation at its earliest fit time and EASY backfilling then fills the
remaining gap (§III-C).

All job state transitions flow through ``repro_torch.sim.lifecycle`` —
this module owns only the event heap, the waiting queue, and the
scheduling pass.  Events coalesced at one timestamp apply in a fixed kind
order (attempt ends, then submissions/releases, then drains, then
restores), the order the JAX package's engines share.  End events carry
their attempt id: an attempt killed by a drain leaves a stale end event
behind, which is dropped WITHOUT advancing the clock or opening a pass.

The decision step is *re-entrant*: ``next_decision()`` advances the event
loop until a policy decision is required and returns the pending
``SchedContext``; ``post_action(a)`` applies the selection and resumes.
``run()`` is the synchronous adapter that drives a ``SchedulingPolicy``
inline; the decision service drives the same API from client threads.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Protocol, Sequence, Tuple

import numpy as np

from ..obs.trace import NULL, Tracer
from .cluster import Cluster, ResourceSpec
from .job import Job
from .lifecycle import (ELIGIBLE, FaultSchedule, JobLifecycle, insert_queued)
from .metrics import MetricsAccumulator, ScheduleMetrics


@dataclass
class SchedContext:
    """Everything a policy may observe at one selection step."""
    now: float
    cluster: Cluster
    window: List[Job]            # first W waiting jobs, queue order
    queue_len: int
    running: List[Job]
    queue: Optional[List[Job]] = None   # full waiting queue (sorted by
    #                                     original submit time, then jid)


class SchedulingPolicy(Protocol):
    """What ``Simulator.run`` needs of a policy: ``select`` (and,
    optionally, the two notifications)."""

    def select(self, ctx: SchedContext) -> int:
        """Return an index into ``ctx.window``."""
        ...

    def notify_started(self, job: Job, ctx: SchedContext) -> None: ...
    def notify_reserved(self, job: Job, ctx: SchedContext) -> None: ...


# The engines this package has so far; the JAX package also has
# "vector" and "device".
ENGINES = ("sequential",)

# Application order for events coalesced at one timestamp.  Ends first
# (a job finishing at t is NOT killed by a drain at t), then queue
# entries, then drains, then restores.
_KIND_ORDER = {"end": 0, "submit": 1, "release": 1, "drain": 2, "restore": 3}


@dataclass
class SimConfig:
    window: int = 10             # W, paper §III-C / §IV-C
    backfill: bool = True        # EASY backfilling
    max_events: int = 50_000_000
    engine: str = "sequential"

    @classmethod
    def for_engine(cls, engine: str = "sequential", *, window: int = 10,
                   backfill: bool = True,
                   max_events: Optional[int] = None) -> "SimConfig":
        """The single validated constructor path.

        Every harness that builds a simulator (``run_trace``,
        service-routed replay) builds its ``SimConfig`` here, so
        validation lands everywhere at once.
        """
        if engine not in ENGINES:
            raise ValueError(
                f"unknown engine {engine!r}; expected one of {ENGINES}")
        window = int(window)
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        cfg = SimConfig(window=window, backfill=bool(backfill), engine=engine)
        if max_events is not None:
            if int(max_events) < 1:
                raise ValueError(f"max_events must be >= 1, got {max_events}")
            cfg.max_events = int(max_events)
        return cfg


@dataclass
class SimResult:
    metrics: ScheduleMetrics
    jobs: List[Job]              # ALL trace jobs, including never-started
    makespan: float
    decisions: int
    n_unstarted: int = 0         # jobs still waiting when events drained
    truncated_jobs: int = 0      # waiting jobs beyond the observable window,
    #                              summed over decisions (queue pressure the
    #                              classic W-window encoding cannot see)
    requeues: int = 0            # killed attempts that re-entered the queue
    n_failed: int = 0            # terminally FAILED jobs (incl. cascades)

    @property
    def started_jobs(self) -> List[Job]:
        return [j for j in self.jobs if j.started]


class Simulator:
    def __init__(self, resources: Sequence[ResourceSpec], jobs: Sequence[Job],
                 policy, config: SimConfig | None = None, *,
                 faults: Optional[FaultSchedule] = None,
                 tracer: Tracer = NULL, env: int = 0):
        self.cluster = Cluster(list(resources))
        self.jobs = sorted((j.copy() for j in jobs), key=lambda j: (j.submit, j.jid))
        self.policy = policy
        self.config = config or SimConfig()
        self.lifecycle = JobLifecycle(self.jobs, self.cluster, faults=faults)
        self.queue: List[Job] = []
        self._events: List = []
        self._eseq = itertools.count()
        self.now = 0.0
        self.decisions = 0
        self.truncated = 0
        self.acc = MetricsAccumulator(self.cluster)
        self._started = False
        self._in_pass = False     # inside a scheduling pass awaiting decisions
        self._pending_ctx: Optional[SchedContext] = None
        # mrsch.trace/v1 emission (docs/observability.md).  The default
        # NULL tracer keeps these paths allocation-free; ``env`` tags
        # events when many simulators share one tracer.
        self.tracer = tracer
        self.env = int(env)

    # ------------------------------------------------------------ event api
    def _push(self, time: float, kind: str, payload) -> None:
        heapq.heappush(self._events, (time, next(self._eseq), kind, payload))

    def _is_stale(self, kind: str, payload) -> bool:
        if kind == "end":
            jid, attempt = payload
            return self.lifecycle.is_stale_end(self.lifecycle.by_id[jid],
                                               attempt)
        if kind == "release":
            return payload.state != ELIGIBLE
        return False

    def _apply(self, kind: str, payload) -> None:
        lc = self.lifecycle
        tr, env = self.tracer, self.env
        if kind == "submit":
            out, ready = lc.on_submit(payload, self.now)
            if out == "queued":
                insert_queued(self.queue, payload)
                tr.job_queued(env, self.now, payload.jid)
            elif out == "eligible":
                self._push(ready, "release", payload)
        elif kind == "release":
            if lc.on_release(payload):
                insert_queued(self.queue, payload)
                tr.job_queued(env, self.now, payload.jid)
        elif kind == "end":
            jid, _attempt = payload
            job = lc.by_id[jid]
            out, released = lc.on_end(job, self.now)
            if out == "requeued":
                insert_queued(self.queue, job)
                tr.job_requeue(env, self.now, job.jid, job.requeues)
                tr.job_queued(env, self.now, job.jid)
            else:
                if out == "failed":
                    tr.job_fail(env, self.now, job.jid)
                else:
                    tr.job_finish(env, self.now, job.jid)
                for child, ready in released:
                    if ready <= self.now:
                        insert_queued(self.queue, child)
                        tr.job_queued(env, self.now, child.jid)
                    else:
                        self._push(ready, "release", child)
        elif kind == "drain":
            tr.drain(env, self.now, payload.resource, payload.units)
            for job, out in lc.on_drain(payload, self.now):
                if out == "requeued":
                    insert_queued(self.queue, job)
                    tr.job_requeue(env, self.now, job.jid, job.requeues)
                    tr.job_queued(env, self.now, job.jid)
                else:
                    tr.job_fail(env, self.now, job.jid)
        else:  # "restore"
            lc.on_restore(payload)
            tr.restore(env, self.now, payload.resource, payload.units)

    # ------------------------------------------------------------ re-entrant
    def start(self) -> None:
        """Seed the event queue.  Idempotent; called lazily by the steppers."""
        if self._started:
            return
        self._started = True
        self._n_events = 0
        for job in self.jobs:
            self._push(job.submit, "submit", job)
        for d in self.lifecycle.faults.drains:
            self._push(d.time, "drain", d)
            if np.isfinite(d.duration):
                self._push(d.time + d.duration, "restore", d)

    def next_decision(self) -> Optional[SchedContext]:
        """Advance the event loop until the policy must pick a window slot.

        Returns the pending ``SchedContext``, or ``None`` once every event
        has been processed (the simulation is over).  Each returned context
        must be answered with exactly one ``post_action`` call before the
        next ``next_decision``.
        """
        self.start()
        while True:
            if self._in_pass:
                if self.queue:
                    self._pending_ctx = self._ctx()
                    return self._pending_ctx
                self._in_pass = False
            if not self._events:
                return None
            # Pop the full coalesced batch at the next timestamp, dropping
            # stale events.  An all-stale batch neither advances the clock
            # nor opens a pass.  Likewise a submission that cannot join the
            # queue yet (parents unfinished, or think-time pending) is
            # applied WITHOUT advancing the clock: its queue entry is a
            # later release/end event.  (Both keep the clock in step with
            # the JAX package's device engine.)
            time = self._events[0][0]
            batch = []
            while self._events and self._events[0][0] == time:
                _, seq, kind, payload = heapq.heappop(self._events)
                if self._is_stale(kind, payload):
                    continue
                if (kind == "submit"
                        and self.lifecycle.ready_time(payload) > time):
                    self._apply(kind, payload)
                    continue
                batch.append((_KIND_ORDER[kind], seq, kind, payload))
            if not batch:
                continue
            self._n_events += 1
            if self._n_events > self.config.max_events:
                raise RuntimeError("simulator exceeded max_events")
            self.acc.advance(time)
            self.now = time
            for _, _, kind, payload in sorted(batch):
                self._apply(kind, payload)
            self._in_pass = True

    def post_action(self, action: int) -> None:
        """Apply the policy's selection for the context from ``next_decision``.

        A fitting job starts and the scheduling pass continues (the next
        ``next_decision`` returns a fresh context at the same timestamp);
        the first non-fitting selection takes a reservation, triggers EASY
        backfilling, and ends the pass.
        """
        assert self._in_pass and self.queue, "no pending decision"
        # Reuse the context handed out by next_decision (nothing mutates
        # between the two calls); rebuild only for direct post_action use.
        ctx = self._pending_ctx if self._pending_ctx is not None else self._ctx()
        self._pending_ctx = None
        self.decisions += 1
        self.truncated += max(ctx.queue_len - len(ctx.window), 0)
        a = max(0, min(int(action), len(ctx.window) - 1))
        job = ctx.window[a]
        if self.cluster.fits(job):
            self.tracer.decision(self.env, self.now, a, job.jid,
                                 ctx.queue_len, 1)
            if hasattr(self.policy, "notify_started"):
                self.policy.notify_started(job, ctx)
            self._start(job)
            return
        # First non-fitting selection: reserve it, then backfill.
        self.tracer.decision(self.env, self.now, a, job.jid,
                             ctx.queue_len, 0)
        self.tracer.reserve(self.env, self.now, job.jid)
        if hasattr(self.policy, "notify_reserved"):
            self.policy.notify_reserved(job, ctx)
        if self.config.backfill:
            n_bf = self._easy_backfill(job)
            self.tracer.backfill(self.env, self.now, n_bf)
        self._in_pass = False

    def result(self) -> SimResult:
        """Summarize after the event loop drains.

        ``jobs`` contains the FULL trace, including jobs that never started
        (e.g. demands exceeding capacity, so no event could free enough
        units).  Wait/slowdown metrics aggregate started jobs only — an
        unstarted job has no finite wait — but ``n_unstarted`` is reported
        so starvation cannot pass silently.  Failure cascades (children of
        FAILED ancestors) are resolved here, inside ``summarize``.
        """
        started = [j for j in self.jobs if j.started]
        metrics = self.acc.summarize(started, all_jobs=self.jobs)
        metrics.truncated_jobs = self.truncated
        return SimResult(
            metrics=metrics,
            jobs=list(self.jobs),
            makespan=self.now,
            decisions=self.decisions,
            n_unstarted=len(self.jobs) - len(started),
            truncated_jobs=self.truncated,
            requeues=metrics.requeues,
            n_failed=metrics.n_failed,
        )

    # ------------------------------------------------------------ main loop
    def run(self) -> SimResult:
        """Synchronous adapter: drive ``self.policy.select`` inline."""
        while (ctx := self.next_decision()) is not None:
            self.post_action(int(self.policy.select(ctx)))
        return self.result()

    # ------------------------------------------------------------ scheduling
    def _ctx(self) -> SchedContext:
        return SchedContext(
            now=self.now,
            cluster=self.cluster,
            window=self.queue[: self.config.window],
            queue_len=len(self.queue),
            running=[rj.job for rj in self.cluster.running.values()],
            queue=self.queue,
        )

    def _start(self, job: Job, bf: int = 0) -> None:
        end = self.lifecycle.start(job, self.now)
        self.queue.remove(job)
        self._push(end, "end", (job.jid, job.requeues))
        self.acc.job_started(job)
        self.tracer.job_start(self.env, self.now, job.jid, bf)

    def _easy_backfill(self, reserved: Job) -> int:
        """EASY backfilling against a reservation for ``reserved``.

        A waiting job may jump ahead iff it fits now AND either (a) it is
        estimated to finish before the reservation start, or (b) at the
        reservation start the reserved job still fits with the backfilled
        job occupying its units ("shadow" resources).  Drained units are
        phantom reservations, so they participate automatically.
        """
        t_res = self.cluster.earliest_fit_time(reserved, self.now)
        if not np.isfinite(t_res):
            return 0
        names = self.cluster.names
        # Free units at t_res assuming estimated releases and no backfill.
        free_at_res = {}
        for n in names:
            rel = self.cluster.release[n]
            free_at_res[n] = int((rel <= t_res).sum())  # free now or released by t_res
        shadow = {n: free_at_res[n] - reserved.demands.get(n, 0) for n in names}

        n_started = 0
        for job in list(self.queue):
            if job is reserved:
                continue
            if not self.cluster.fits(job):
                continue
            ends_before = self.now + job.walltime <= t_res
            fits_shadow = all(job.demands.get(n, 0) <= shadow[n] for n in names)
            if ends_before or fits_shadow:
                if not ends_before:
                    for n in names:
                        shadow[n] -= job.demands.get(n, 0)
                self._start(job, bf=1)
                n_started += 1
        return n_started


def run_trace(resources, jobs, policy, window: int = 10,
              backfill: bool = True,
              faults: Optional[FaultSchedule] = None) -> SimResult:
    """Convenience one-shot simulation."""
    return Simulator(resources, jobs, policy,
                     SimConfig.for_engine(window=window, backfill=backfill),
                     faults=faults).run()
