"""Named, parameterized scenario registry.

One lookup point for every workload the package can replay, so sweeps,
drift experiments, training mixes and the service's ``run_scenario`` all
speak the same scenario names (the JAX package's names, building the
same jobs from the same ``(ThetaConfig, seed)``):

* the paper's S1–S10 contention/power families (Table III, §V-E),
* the raw Theta-like base trace,
* real-trace replay via SWF files (:func:`register_swf`),
* new synthetic families — pronounced diurnal cycles, bursty campaign
  submissions, size-skewed mixes,
* drifting workloads (§V-D) whose distribution shifts mid-trace via
  ``drift.DriftSchedule`` transformers.

Every scenario builds deterministically from ``(ThetaConfig, seed)``; the
registry is import-time populated and extensible at runtime via
:func:`register` (plugins, tests, SWF drop-ins).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..sim.job import Job
from ..sim.lifecycle import DrainEvent, FaultSchedule
from .drift import DriftPhase, DriftSchedule, apply_drift, step_schedule
from .scenarios import SCENARIOS as _PAPER_SCENARIOS
from .scenarios import build_scenarios, with_power
from .theta import ThetaConfig, generate_trace, jobs_from_swf

BuildFn = Callable[..., List[Job]]     # (cfg, seed, **params) -> jobs


@dataclass(frozen=True)
class ScenarioSpec:
    """A named, parameterized workload family.

    ``build(cfg, seed, **params)`` produces the trace; ``drift`` (when
    set) is applied afterwards with a seed derived from ``seed``; then
    ``power`` attaches §V-E power profiles.  ``faults`` is NOT applied to
    the trace — it is the scenario's deterministic node-outage plan, and
    engines consume it directly (``Simulator(..., faults=...)``); runners
    that build jobs from a name must forward ``get_scenario(name).faults``
    alongside.  ``tags`` support filtered selection (e.g. every "drift"
    scenario for the adaptation bench).
    """
    name: str
    description: str
    build: BuildFn
    family: str = "synthetic"  # paper|base|synthetic|drift|workflow|faulty|swf
    params: Dict[str, object] = field(default_factory=dict)
    drift: Optional[DriftSchedule] = None
    power: bool = False
    faults: Optional[FaultSchedule] = None
    tags: Tuple[str, ...] = ()


_REGISTRY: Dict[str, ScenarioSpec] = {}


def register(spec: ScenarioSpec, overwrite: bool = False) -> ScenarioSpec:
    if not overwrite and spec.name in _REGISTRY:
        raise ValueError(f"scenario {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def get_scenario(name: str) -> ScenarioSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        known = ", ".join(sorted(_REGISTRY))
        raise KeyError(f"unknown scenario {name!r}; registered: {known}") \
            from None


def scenario_names(family: Optional[str] = None,
                   tag: Optional[str] = None) -> List[str]:
    """Registered names, optionally filtered by family and/or tag."""
    out = []
    for name, spec in sorted(_REGISTRY.items()):
        if family is not None and spec.family != family:
            continue
        if tag is not None and tag not in spec.tags:
            continue
        out.append(name)
    return out


def build_jobs(name: str, cfg: ThetaConfig, seed: int = 1,
               **overrides) -> List[Job]:
    """Materialize one scenario's trace, deterministically for a seed."""
    spec = get_scenario(name)
    params = {**spec.params, **overrides}
    jobs = spec.build(cfg, seed, **params)
    if spec.drift is not None:
        jobs = apply_drift(jobs, spec.drift, cfg, seed=seed + 101)
    if spec.power:
        jobs = with_power(jobs, cfg, seed=seed + 7)
    return jobs


def build_many(names: Sequence[str], cfg: ThetaConfig,
               seed: int = 1) -> Dict[str, List[Job]]:
    return {n: build_jobs(n, cfg, seed=seed) for n in names}


# ------------------------------------------------------- scenario traces
def _reseeded(cfg: ThetaConfig, seed: int) -> ThetaConfig:
    """Per-(scenario, seed) trace variant of the base config."""
    return replace(cfg, seed=cfg.seed + 7919 * seed)


def _paper(cfg: ThetaConfig, seed: int, scenario: str = "S1") -> List[Job]:
    return build_scenarios(cfg, names=(scenario,), seed=seed)[scenario]


def _theta_base(cfg: ThetaConfig, seed: int) -> List[Job]:
    return generate_trace(_reseeded(cfg, seed))


def _diurnal(cfg: ThetaConfig, seed: int, amplitude: float = 0.95,
             weekend_factor: float = 0.35) -> List[Job]:
    """Pronounced day/night + weekend arrival cycles (queue breathes)."""
    return generate_trace(replace(_reseeded(cfg, seed),
                                  diurnal_amplitude=amplitude,
                                  weekend_factor=weekend_factor))


def _bursty(cfg: ThetaConfig, seed: int, campaign_mean: float = 8.0,
            within_gap_s: float = 120.0) -> List[Job]:
    """Campaign submissions: jobs arrive in tight bursts with long gaps.

    Re-times the base trace's jobs: arrivals are regrouped into campaigns
    of geometric size (mean ``campaign_mean``), ~``within_gap_s`` apart
    inside a campaign, with the inter-campaign gaps stretched so the
    total span is preserved (same load, very different queue dynamics).
    """
    jobs = sorted(generate_trace(_reseeded(cfg, seed)),
                  key=lambda j: (j.submit, j.jid))
    if len(jobs) < 2:
        return jobs
    rng = np.random.default_rng(1000 + seed)
    span = jobs[-1].submit - jobs[0].submit
    sizes: List[int] = []
    while sum(sizes) < len(jobs):
        sizes.append(1 + rng.geometric(1.0 / campaign_mean))
    n_campaigns = len(sizes)
    in_burst = sum(min(s, len(jobs)) for s in sizes) * within_gap_s
    gap_mean = max((span - in_burst) / max(n_campaigns, 1), within_gap_s)
    out, t, k = [], jobs[0].submit, 0
    for s in sizes:
        for _ in range(s):
            if k >= len(jobs):
                break
            nj = jobs[k].copy()
            nj.submit = t
            out.append(nj)
            t += rng.exponential(within_gap_s)
            k += 1
        t += rng.exponential(gap_mean)
    return out


def _flood(cfg: ThetaConfig, seed: int, span_s: float = 1800.0) -> List[Job]:
    """Queue flood: the whole trace submits within ``span_s`` seconds.

    Re-times the base trace's submits uniformly into a short span, so
    the waiting queue holds hundreds of jobs at once from the first
    scheduling pass — the regime where the classic W-window encoding is
    blind to nearly all of the backlog (``truncated_jobs`` explodes) and
    the queue-as-tokens attention encoder has signal to exploit.
    """
    jobs = generate_trace(_reseeded(cfg, seed))
    rng = np.random.default_rng(2000 + seed)
    t0 = min(j.submit for j in jobs) if jobs else 0.0
    out = []
    for j, dt in zip(jobs, rng.uniform(0.0, span_s, len(jobs))):
        nj = j.copy()
        nj.submit = t0 + float(dt)
        out.append(nj)
    return sorted(out, key=lambda j: (j.submit, j.jid))


def _compressed(cfg: ThetaConfig, seed: int, factor: float = 6.0) -> List[Job]:
    """Sustained oversubscription: submit times compressed ``factor``x.

    Unlike the one-shot flood, arrivals keep their relative pattern —
    the queue builds steadily to a deep sustained backlog instead of one
    spike, exercising long-queue dynamics across the whole trace.
    """
    jobs = generate_trace(_reseeded(cfg, seed))
    t0 = min(j.submit for j in jobs) if jobs else 0.0
    out = []
    for j in jobs:
        nj = j.copy()
        nj.submit = t0 + (j.submit - t0) / factor
        out.append(nj)
    return sorted(out, key=lambda j: (j.submit, j.jid))


_SKEW_SMALL = (0.30, 0.24, 0.18, 0.12, 0.07, 0.04, 0.03, 0.01, 0.007, 0.003)
_SKEW_LARGE = (0.02, 0.03, 0.04, 0.05, 0.08, 0.12, 0.18, 0.22, 0.16, 0.10)


def _size_skew(cfg: ThetaConfig, seed: int,
               weights: Sequence[float] = _SKEW_SMALL) -> List[Job]:
    return generate_trace(replace(_reseeded(cfg, seed),
                                  size_weights=tuple(weights)))


def _drifted_paper(cfg: ThetaConfig, seed: int,
                   scenario: str = "S2") -> List[Job]:
    """Base jobs for drift scenarios: a paper family pre-drift."""
    return _paper(cfg, seed, scenario=scenario)


def _workflow_pipelines(cfg: ThetaConfig, seed: int, chain_len: int = 4,
                        workflow_frac: float = 0.5,
                        think_s: float = 300.0) -> List[Job]:
    """Linear pipeline DAGs: stage k depends on stage k-1.

    Walks the base trace in submit order and, with probability
    ``workflow_frac``, folds the next ``chain_len`` jobs into one
    pipeline: all stages are submitted with the root (the user submits
    the whole workflow at once) but each stays HELD until its predecessor
    finishes plus ``think_s`` of post-processing think time.
    """
    jobs = sorted(generate_trace(_reseeded(cfg, seed)),
                  key=lambda j: (j.submit, j.jid))
    rng = np.random.default_rng(5000 + seed)
    out = [j.copy() for j in jobs]
    i = 0
    while i + chain_len <= len(out):
        if rng.uniform() < workflow_frac:
            root = out[i]
            for k in range(1, chain_len):
                stage = out[i + k]
                stage.deps = (out[i + k - 1].jid,)
                stage.think_time = float(think_s)
                stage.submit = root.submit
            i += chain_len
        else:
            i += 1
    return sorted(out, key=lambda j: (j.submit, j.jid))


def _workflow_ensembles(cfg: ThetaConfig, seed: int, width: int = 4,
                        ensemble_frac: float = 0.4,
                        think_s: float = 60.0) -> List[Job]:
    """Fan-out/fan-in DAGs: root -> ``width`` members -> collector.

    The ensemble members run concurrently once the root finishes; the
    collector fans in on ALL members (a multi-parent dependency, which a
    linear SWF "preceding job" field cannot express).
    """
    jobs = sorted(generate_trace(_reseeded(cfg, seed)),
                  key=lambda j: (j.submit, j.jid))
    rng = np.random.default_rng(6000 + seed)
    out = [j.copy() for j in jobs]
    group = width + 2
    i = 0
    while i + group <= len(out):
        if rng.uniform() < ensemble_frac:
            root = out[i]
            members = out[i + 1: i + 1 + width]
            collector = out[i + 1 + width]
            for m in members:
                m.deps = (root.jid,)
                m.think_time = float(think_s)
                m.submit = root.submit
            collector.deps = tuple(m.jid for m in members)
            collector.think_time = float(think_s)
            collector.submit = root.submit
            i += group
        else:
            i += 1
    return sorted(out, key=lambda j: (j.submit, j.jid))


def _faulty_jobs(cfg: ThetaConfig, seed: int, fail_fraction: float = 0.2,
                 max_attempts: int = 2) -> List[Job]:
    """Base trace where a fraction of jobs carry mid-run failure points.

    Afflicted jobs fail 1..``max_attempts`` times at uniform positions
    within the runtime before an attempt finally survives, exercising the
    requeue path (and FAILED exhaustion when attempts exceed the
    schedule's ``max_requeues``).
    """
    rng = np.random.default_rng(4000 + seed)
    out = []
    for j in generate_trace(_reseeded(cfg, seed)):
        nj = j.copy()
        if rng.uniform() < fail_fraction:
            k = int(rng.integers(1, max_attempts + 1))
            nj.fail_times = tuple(
                float(f) * nj.runtime
                for f in sorted(rng.uniform(0.15, 0.85, size=k)))
        out.append(nj)
    return out


def register_swf(name: str, path: str, description: str = "",
                 overwrite: bool = False) -> ScenarioSpec:
    """Register a real-trace replay scenario backed by an SWF file.

    The seed is ignored (a real trace has one realization); ``n_nodes``
    clamps per-job demands to the configured cluster.
    """
    def _build(cfg: ThetaConfig, seed: int, **_params) -> List[Job]:
        return jobs_from_swf(path, n_nodes=cfg.n_nodes)

    return register(ScenarioSpec(
        name=name, family="swf", build=_build,
        description=description or f"SWF replay of {path}",
        tags=("swf", "replay")), overwrite=overwrite)


# ------------------------------------------------------------------ defaults
def _register_defaults() -> None:
    for s, (frac, lo_tb, halve) in _PAPER_SCENARIOS.items():
        register(ScenarioSpec(
            name=s, family="paper", build=_paper, params={"scenario": s},
            description=(f"Table III {s}: {frac:.0%} of jobs request BB in "
                         f"[{lo_tb:g}, 285] TB" + (", node demand halved"
                                                   if halve else "")),
            tags=("paper", "table3")))
        s_pow = f"S{int(s[1:]) + 5}"
        register(ScenarioSpec(
            name=s_pow, family="paper", build=_paper,
            params={"scenario": s_pow},
            description=f"§V-E {s_pow}: {s} plus 100–215 W/node power "
                        "profile under the scaled 500 kW budget",
            tags=("paper", "three-resource", "power")))
    register(ScenarioSpec(
        name="theta-base", family="base", build=_theta_base,
        description="Raw Theta-like synthetic trace (Darshan-style BB mix)",
        tags=("base",)))
    register(ScenarioSpec(
        name="diurnal-heavy", family="synthetic", build=_diurnal,
        description="Pronounced diurnal/weekend arrival cycles "
                    "(amplitude 0.95, weekends at 35%)",
        tags=("synthetic", "arrival")))
    register(ScenarioSpec(
        name="bursty-campaigns", family="synthetic", build=_bursty,
        description="Campaign submissions: geometric bursts (~8 jobs, "
                    "~2 min spacing) separated by long idle gaps",
        tags=("synthetic", "arrival")))
    register(ScenarioSpec(
        name="huge-queue-flood", family="synthetic", build=_flood,
        description="Whole trace submitted within 30 min: hundreds of "
                    "jobs waiting at once (window truncation stress)",
        tags=("synthetic", "huge-queue", "arrival")))
    register(ScenarioSpec(
        name="huge-queue-sustained", family="synthetic", build=_compressed,
        description="Submit times compressed 6x: sustained deep backlog "
                    "for the full trace span",
        tags=("synthetic", "huge-queue", "arrival")))
    register(ScenarioSpec(
        name="size-skew-small", family="synthetic", build=_size_skew,
        params={"weights": _SKEW_SMALL},
        description="Job-size mix skewed toward small jobs "
                    "(capacity fragmentation regime)",
        tags=("synthetic", "size")))
    register(ScenarioSpec(
        name="size-skew-large", family="synthetic", build=_size_skew,
        params={"weights": _SKEW_LARGE},
        description="Job-size mix skewed toward capability-class jobs "
                    "(blocking/backfill regime)",
        tags=("synthetic", "size")))
    register(ScenarioSpec(
        name="drift-bb-surge", family="drift", build=_drifted_paper,
        params={"scenario": "S1"},
        drift=step_schedule(at=0.5, bb_fraction=0.85, bb_scale=1.25),
        description="§V-D shift: S1 trace whose BB demand surges at "
                    "mid-trace (85% of jobs request BB, sizes +25%)",
        tags=("drift", "bb")))
    register(ScenarioSpec(
        name="drift-arrival-ramp", family="drift", build=_drifted_paper,
        params={"scenario": "S2"},
        drift=DriftSchedule(mode="ramp", phases=(
            DriftPhase(start=0.0),
            DriftPhase(start=1.0, rate_scale=2.5))),
        description="§V-D shift: S2 trace whose arrival rate ramps to "
                    "2.5x over the trace span",
        tags=("drift", "arrival")))
    register(ScenarioSpec(
        name="drift-node-shift", family="drift", build=_drifted_paper,
        params={"scenario": "S3"},
        drift=DriftSchedule(phases=(
            DriftPhase(start=0.0),
            DriftPhase(start=0.4, node_scale=1.6, bb_fraction=0.2),
            DriftPhase(start=0.8, node_scale=0.7, bb_fraction=0.8))),
        description="§V-D shift: S3 trace flipping from CPU-heavy "
                    "(nodes x1.6, BB 20%) to BB-heavy (nodes x0.7, BB 80%)",
        tags=("drift", "node", "bb")))
    register(ScenarioSpec(
        name="workflow-pipelines", family="workflow",
        build=_workflow_pipelines,
        description="Half the trace folded into 4-stage pipeline DAGs "
                    "(submit-with-root, 5 min think time between stages)",
        tags=("workflow", "deps")))
    register(ScenarioSpec(
        name="workflow-ensembles", family="workflow",
        build=_workflow_ensembles,
        description="Fan-out/fan-in ensembles: root -> 4 members -> "
                    "collector (multi-parent fan-in joins)",
        tags=("workflow", "deps")))
    register(ScenarioSpec(
        name="faulty-jobs", family="faulty", build=_faulty_jobs,
        description="20% of jobs fail mid-run up to 2 times before an "
                    "attempt survives (requeue stress)",
        tags=("faulty", "requeue")))
    register(ScenarioSpec(
        name="faulty-drain", family="faulty", build=_theta_base,
        faults=FaultSchedule(relative=True, drains=(
            DrainEvent(time=0.30, resource="node", unit_frac=0.25,
                       duration=0.15),
            DrainEvent(time=0.60, resource="bb", unit_frac=0.30,
                       duration=0.10),
        )),
        description="Base trace under scheduled outages: 25% of nodes "
                    "drain at 30% of the span (15% long), 30% of BB at "
                    "60% (10% long); residents are killed and requeued",
        tags=("faulty", "drain")))
    register(ScenarioSpec(
        name="drift-failure-wave", family="drift", build=_drifted_paper,
        params={"scenario": "S1"},
        drift=DriftSchedule(phases=(
            DriftPhase(start=0.0, fail_fraction=0.0),
            DriftPhase(start=0.4, fail_fraction=0.30),
            DriftPhase(start=0.8, fail_fraction=0.0))),
        description="§V-D-style reliability shift: a mid-trace wave where "
                    "30% of arriving jobs fail once mid-run and requeue",
        tags=("drift", "faulty", "requeue")))


_register_defaults()
