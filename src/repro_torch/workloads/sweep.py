"""Scenario-sweep harness: scenarios x seeds, sequential or vectorized.

The paper's results (§V) come from sweeping a policy across workload
scenarios S1-S10 with multiple trace seeds.  ``build_sweep`` materializes
the (scenario, seed) task grid; ``run_sweep`` evaluates one policy over it
either one trace at a time or through the batched
``repro_torch.sim.VectorSimulator`` rollout engine, and reports decision
throughput either way so the two modes can be compared apples-to-apples.
``build_train_mix`` deals the same grid across the lockstep lanes of the
vectorized trainer (``repro_torch.core.train.train_agent_vectorized``) —
optionally with scaled-down resource variants per lane — so one training
batch spans heterogeneous traces, seeds, and contention regimes
(exercising the paper's §III-B dynamic goal vectors heterogeneously).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.train import EnvSlot
from ..sim.cluster import ResourceSpec
from ..sim.job import Job
from ..sim.simulator import SimConfig, SimResult, Simulator
from ..sim.vector import VectorSimulator
from .scenarios import build_scenarios
from .theta import ThetaConfig


@dataclass(frozen=True)
class SweepTask:
    scenario: str
    seed: int


def build_sweep(cfg: ThetaConfig, scenarios: Sequence[str] = ("S1", "S2",
                "S3", "S4", "S5"), seeds: Sequence[int] = (1, 2, 3),
                power: bool = False) -> List[Tuple[SweepTask, List[Job]]]:
    """The (scenario x seed) task grid, each with its derived trace."""
    out: List[Tuple[SweepTask, List[Job]]] = []
    for seed in seeds:
        sets = build_scenarios(cfg, names=scenarios, power=power, seed=seed)
        for name in scenarios:
            out.append((SweepTask(name, seed), sets[name]))
    return out


def scale_resources(resources: Sequence[ResourceSpec],
                    scale: float) -> List[ResourceSpec]:
    """Shrink a cluster spec (same resources, ``scale``x the units)."""
    if not 0.0 < scale <= 1.0:
        raise ValueError(f"scale must be in (0, 1], got {scale}")
    return [ResourceSpec(r.name, max(1, round(r.capacity * scale)), r.unit)
            for r in resources]


def build_train_mix(cfg: ThetaConfig,
                    scenarios: Sequence[str] = ("S1", "S2", "S3", "S4", "S5"),
                    seeds: Sequence[int] = (1, 2, 3), n_envs: int = 8,
                    power: bool = False,
                    resource_scales: Optional[Sequence[float]] = None
                    ) -> List[EnvSlot]:
    """Heterogeneous lane assignments for the vectorized trainer.

    Builds the (scenario x seed) trace grid and deals it round-robin
    across ``n_envs`` lockstep lanes, so one training batch mixes
    different workload scenarios and trace seeds.  ``resource_scales``
    optionally cycles scaled-down cluster variants across the lanes
    (e.g. ``(1.0, 0.75, 0.5)``), diversifying contention — and therefore
    the Eq. (1) goal vectors the agent learns to condition on — within a
    single batch.  The agent must be built on the unscaled ``cfg``
    resources; smaller lanes are padded by the state encoding.
    """
    tasks = build_sweep(cfg, scenarios=scenarios, seeds=seeds, power=power)
    n_envs = max(1, min(int(n_envs), len(tasks)))
    base = cfg.resources(
        power_budget_kw=cfg.default_power_budget_kw() if power else None)
    slots: List[EnvSlot] = []
    for i in range(n_envs):
        res = base
        tag = f"env{i}"
        if resource_scales:
            scale = resource_scales[i % len(resource_scales)]
            res = scale_resources(base, scale)
            tag = f"env{i}@{scale:g}x"
        slots.append(EnvSlot(jobsets=[], resources=res, tag=tag))
    for k, (task, jobs) in enumerate(tasks):
        slots[k % n_envs].jobsets.append(
            (f"{task.scenario}/seed{task.seed}", jobs))
    return slots


def _row(task: SweepTask, result: SimResult) -> Dict:
    return {
        "scenario": task.scenario,
        "seed": task.seed,
        "decisions": result.decisions,
        "n_unstarted": result.n_unstarted,
        **{k: round(float(v), 4) for k, v in result.metrics.as_row().items()},
    }


def run_sweep(resources: Sequence[ResourceSpec],
              tasks: Sequence[Tuple[SweepTask, List[Job]]], policy,
              config: Optional[SimConfig] = None, vector: int = 0) -> Dict:
    """Evaluate ``policy`` over every sweep task.

    vector=0/1 runs traces one at a time (the classic loop); vector=N
    advances N environments in lockstep with batched policy inference.
    Tasks beyond N are processed in successive groups of N.  ``config``
    comes from ``SimConfig.for_engine`` (window/backfill live there, not
    in per-harness kwargs); it defaults to the engine implied by
    ``vector``.
    """
    engine = "vector" if vector and vector > 1 else "sequential"
    sim_cfg = config if config is not None else SimConfig.for_engine(engine)
    t0 = time.perf_counter()
    results: List[SimResult] = []
    vector_stats: List[Dict] = []
    if vector and vector > 1:
        for i in range(0, len(tasks), vector):
            chunk = tasks[i:i + vector]
            vec = VectorSimulator.from_jobsets(
                resources, [jobs for _, jobs in chunk], policy, sim_cfg)
            results.extend(vec.run())
            vector_stats.append(vec.stats.as_dict())
    else:
        for _, jobs in tasks:
            results.append(Simulator(resources, jobs, policy, sim_cfg).run())
    wall = time.perf_counter() - t0
    decisions = sum(r.decisions for r in results)
    out = {
        "mode": f"vector{vector}" if vector and vector > 1 else "sequential",
        "n_tasks": len(tasks),
        "wall_seconds": round(wall, 4),
        "decisions": decisions,
        "decisions_per_sec": round(decisions / max(wall, 1e-9), 2),
        "tasks": [_row(t, r) for (t, _), r in zip(tasks, results)],
    }
    if vector_stats:
        out["vector_stats"] = vector_stats
    return out
