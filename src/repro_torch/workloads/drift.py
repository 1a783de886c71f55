"""Time-varying workload drift (paper §V-D "dynamic resource prioritizing").

MRSch's headline claim is that the DFP agent *adapts* its policy when the
workload mix changes mid-stream.  The static S1–S10 families in
``scenarios.py`` cannot exercise that: every job in a scenario is drawn
from one distribution.  This module makes traces drift over time:

* :class:`DriftPhase` / :class:`DriftSchedule` — a piecewise (or ramped)
  schedule of distribution parameters over the trace span: the fraction
  of jobs requesting burst buffer, a multiplier on BB request sizes, a
  multiplier on node demands, and an arrival-rate multiplier.
* :func:`apply_drift` — transform a job list according to a schedule,
  seeded and deterministic.  Arrival-rate drift warps inter-arrival gaps;
  the per-job fields are redrawn/scaled from the parameters in force at
  the job's (original) position in the trace.
* :func:`segment_jobs` + :func:`run_phases` — the §V-D adaptation
  experiment: split a drifted trace into consecutive phases and walk a
  policy through them via ``VectorSimulator.run``'s ``refill`` hook, so
  each phase yields its own ``SimResult`` and the per-phase metrics show
  whether the policy re-prioritizes after the shift.

Drift *scenarios* (named, buildable traces) live in ``registry.py``; this
module owns the transformation machinery.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..sim.cluster import ResourceSpec
from ..sim.job import Job
from ..sim.simulator import SimConfig, SimResult, Simulator
from ..sim.vector import VectorSimulator
from .scenarios import bb_pool_units
from .theta import ThetaConfig

_MULT_FIELDS = ("bb_scale", "node_scale", "rate_scale")


@dataclass(frozen=True)
class DriftPhase:
    """Distribution parameters in force from ``start`` (fraction of span).

    ``bb_fraction`` — when set, jobs arriving in this phase have their BB
    request *redrawn*: with this probability they get a request from the
    scenario-style heavy-tailed pool, otherwise none.  ``None`` leaves
    the trace's own BB demands untouched.
    ``bb_scale`` / ``node_scale`` — multipliers on BB / node demands.
    ``rate_scale`` — arrival-rate multiplier (>1 compresses gaps).
    ``fail_fraction`` — when set, jobs arriving in this phase are given a
    mid-run failure point (one requeue-triggering fault drawn uniformly
    inside the runtime) with this probability; ``None`` leaves any
    ``fail_times`` already on the trace untouched, ``0.0`` strips them.
    """
    start: float
    bb_fraction: Optional[float] = None
    bb_scale: float = 1.0
    node_scale: float = 1.0
    rate_scale: float = 1.0
    fail_fraction: Optional[float] = None

    def __post_init__(self):
        if not 0.0 <= self.start <= 1.0:
            raise ValueError(f"phase start must be in [0, 1], got {self.start}")
        for name in _MULT_FIELDS:
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be > 0")
        if (self.fail_fraction is not None
                and not 0.0 <= self.fail_fraction <= 1.0):
            raise ValueError(
                f"fail_fraction must be in [0, 1], got {self.fail_fraction}")


@dataclass(frozen=True)
class DriftSchedule:
    """Ordered phases over the trace span.

    mode="piecewise" applies each phase's parameters verbatim from its
    start; mode="ramp" linearly interpolates the multipliers between
    consecutive phase starts (``bb_fraction`` interpolates only when both
    endpoints are set).  The first phase must start at 0.
    """
    phases: Tuple[DriftPhase, ...]
    mode: str = "piecewise"

    def __post_init__(self):
        if not self.phases:
            raise ValueError("schedule needs at least one phase")
        starts = [p.start for p in self.phases]
        if starts != sorted(starts) or starts[0] != 0.0:
            raise ValueError("phases must be sorted by start, first at 0.0")
        if self.mode not in ("piecewise", "ramp"):
            raise ValueError(f"unknown drift mode {self.mode!r}")

    # ------------------------------------------------------------- lookup
    def params_at(self, frac: float) -> Dict[str, Optional[float]]:
        """Effective parameters at ``frac`` in [0, 1] of the trace span."""
        frac = min(max(frac, 0.0), 1.0)
        phases = self.phases
        k = 0
        for i, p in enumerate(phases):
            if p.start <= frac:
                k = i
        cur = phases[k]
        out = {f.name: getattr(cur, f.name) for f in fields(cur)
               if f.name != "start"}
        if self.mode == "ramp" and k + 1 < len(phases):
            nxt = phases[k + 1]
            span = nxt.start - cur.start
            w = (frac - cur.start) / span if span > 0 else 1.0
            for name in _MULT_FIELDS:
                out[name] = ((1 - w) * getattr(cur, name)
                             + w * getattr(nxt, name))
            if cur.bb_fraction is not None and nxt.bb_fraction is not None:
                out["bb_fraction"] = ((1 - w) * cur.bb_fraction
                                      + w * nxt.bb_fraction)
            if cur.fail_fraction is not None and nxt.fail_fraction is not None:
                out["fail_fraction"] = ((1 - w) * cur.fail_fraction
                                        + w * nxt.fail_fraction)
        return out


def step_schedule(at: float = 0.5, *, bb_fraction: float = 0.85,
                  bb_scale: float = 1.0, node_scale: float = 1.0,
                  rate_scale: float = 1.0) -> DriftSchedule:
    """The canonical §V-D experiment: one mid-trace distribution shift."""
    return DriftSchedule(phases=(
        DriftPhase(start=0.0),
        DriftPhase(start=at, bb_fraction=bb_fraction, bb_scale=bb_scale,
                   node_scale=node_scale, rate_scale=rate_scale),
    ))


def apply_drift(jobs: Sequence[Job], schedule: DriftSchedule,
                cfg: ThetaConfig, seed: int = 0) -> List[Job]:
    """Transform ``jobs`` per the schedule; deterministic for a seed.

    Phase position is evaluated on the *original* timeline (job rank in
    span), so rate warping never shifts which distribution a job draws
    from.  Returns fresh copies sorted by warped submit time.
    """
    if not jobs:
        return []
    ordered = sorted(jobs, key=lambda j: (j.submit, j.jid))
    rng = np.random.default_rng(seed)
    pool = bb_pool_units(cfg, rng)
    t0 = ordered[0].submit
    span = max(ordered[-1].submit - t0, 1e-9)
    out: List[Job] = []
    warped = t0
    prev = t0
    for j in ordered:
        frac = (j.submit - t0) / span
        p = schedule.params_at(frac)
        warped += (j.submit - prev) / p["rate_scale"]
        prev = j.submit
        nj = j.copy()
        nj.submit = warped
        nj.demands["node"] = min(
            max(1, int(round(nj.demands.get("node", 1) * p["node_scale"]))),
            cfg.n_nodes)
        if p["bb_fraction"] is not None:
            bb = int(rng.choice(pool)) if rng.uniform() < p["bb_fraction"] else 0
        else:
            bb = nj.demands.get("bb", 0)
        nj.demands["bb"] = min(int(round(bb * p["bb_scale"])), cfg.bb_units)
        if p["fail_fraction"] is not None:
            # One mid-run fault per afflicted job; both draws are consumed
            # even when the job stays healthy, so raising fail_fraction
            # only adds failures instead of reshuffling which jobs fail.
            u, at = rng.uniform(), rng.uniform(0.15, 0.85)
            if u < p["fail_fraction"]:
                nj.fail_times = (float(at * nj.runtime),)
            else:
                nj.fail_times = ()
        out.append(nj)
    return out


# ---------------------------------------------------------------- phases
def segment_jobs(jobs: Sequence[Job], n_segments: int,
                 rebase: bool = True) -> List[List[Job]]:
    """Split a trace into consecutive equal-time segments of its span.

    With ``rebase`` each segment's submits are shifted to start at 0 so
    every segment is a self-contained episode (wait/slowdown metrics stay
    comparable across phases).  Empty segments are kept (as empty lists)
    so phase indices always align with the schedule.
    """
    if n_segments < 1:
        raise ValueError("n_segments must be >= 1")
    jobs = sorted(jobs, key=lambda j: (j.submit, j.jid))
    if not jobs:
        return [[] for _ in range(n_segments)]
    t0, t1 = jobs[0].submit, jobs[-1].submit
    span = max(t1 - t0, 1e-9)
    segments: List[List[Job]] = [[] for _ in range(n_segments)]
    for j in jobs:
        k = min(int((j.submit - t0) / span * n_segments), n_segments - 1)
        segments[k].append(j)
    if rebase:
        rebased = []
        for seg in segments:
            base = seg[0].submit if seg else 0.0
            out = []
            for j in seg:
                nj = j.copy()
                nj.submit = j.submit - base
                out.append(nj)
            rebased.append(out)
        segments = rebased
    return segments


@dataclass
class PhaseResult:
    env: int
    phase: int
    result: SimResult


def run_phases(policy, resources: Sequence[ResourceSpec],
               phases_per_env: Sequence[Sequence[Sequence[Job]]],
               config: Optional[SimConfig] = None,
               on_round=None, policy_factory=None) -> List[PhaseResult]:
    """Walk each lockstep lane through its phase sequence (§V-D).

    ``phases_per_env[i]`` is the ordered list of jobsets lane ``i`` plays;
    when a lane drains a phase, the ``refill`` hook immediately seeds it
    with the next one, so the decision batch stays wide across the whole
    drift experiment and each phase still yields its own ``SimResult``.
    ``config`` comes from ``SimConfig.for_engine`` (window/backfill live
    there); ``on_round`` is forwarded to ``VectorSimulator.run`` (the
    §V-D goal trace can be logged there).

    Sequential stateful policies (``GAOptimizer``'s plan cache) must not
    be shared across lanes: pass ``policy_factory`` (with ``policy=None``)
    to give every lane its own instance; sharing a ``select_batch``-less
    policy across >1 lanes is rejected.
    """
    sim_cfg = config if config is not None else SimConfig.for_engine("vector")
    if policy_factory is not None:
        env_policies = [policy_factory() for _ in phases_per_env]
        shared = None
    else:
        if not hasattr(policy, "select_batch") and len(phases_per_env) > 1:
            raise ValueError(
                "sharing a sequential policy across lanes cross-"
                "contaminates its per-trace state — pass policy_factory= "
                "for one instance per lane")
        env_policies = [policy] * len(phases_per_env)
        shared = policy if hasattr(policy, "select_batch") else None
    cursors = [0] * len(phases_per_env)
    labels: List[Tuple[int, int]] = []    # completion-order (env, phase)

    def make_sim(env: int) -> Optional[Simulator]:
        seq = phases_per_env[env]
        while cursors[env] < len(seq) and not seq[cursors[env]]:
            cursors[env] += 1             # skip empty phases
        if cursors[env] >= len(seq):
            return None
        jobs = seq[cursors[env]]
        cursors[env] += 1
        return Simulator(resources, jobs, env_policies[env], sim_cfg)

    def refill(env: int, _result: SimResult) -> Optional[Simulator]:
        labels.append((env, cursors[env] - 1))
        return make_sim(env)

    sims, live_envs = [], []
    for env in range(len(phases_per_env)):
        sim = make_sim(env)
        if sim is not None:
            sims.append(sim)
            live_envs.append(env)
    if not sims:
        return []
    vec = VectorSimulator(sims, policy=shared)
    # refill receives slot indices into `sims`; map back to env ids.
    results = vec.run(refill=lambda i, r: refill(live_envs[i], r),
                      on_round=on_round)
    return [PhaseResult(env=e, phase=p, result=r)
            for (e, p), r in zip(labels, results)]
