"""Policy x scenario evaluation matrix on the batched rollout engine (the
JAX package's ``repro/eval/matrix.py``; same schema, columns and rounding,
so a grid of either package diffs against the committed baselines).

The paper's §V evidence is a grid: every policy (MRSch, FCFS, GA,
ScalarRL) against every workload scenario, one ``ScheduleMetrics`` row
per cell.  This module is the single harness that produces that grid —
for the Table III families, the new registry scenarios, and the §V-D
drift workloads alike — and emits it in a *stable* JSON/CSV schema so CI
can diff runs against committed baselines (``tools/check_bench.py``).

Policies are probed through the ``repro_torch.core.policy_api`` helpers:
``supports_batch`` instances (MRSch, FCFS, ScalarRL) are fanned over
``VectorSimulator`` so every lockstep round costs one batched forward;
stateful sequential policies (GA) run through
``VectorSimulator.from_factory`` with one fresh instance per environment.

Schema stability contract (``MATRIX_SCHEMA`` bumps on change):
``columns`` lists every row key in order; each row is one (policy,
scenario, seed) cell; metric values are rounded to 4 decimals and are
deterministic for a fixed config/seed (no wall-clock noise in rows —
timing lives under ``summary``).
"""
from __future__ import annotations

import io
import json
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..core.policies import (FCFSPolicy, GAConfig, GAOptimizer,
                             ScalarRLConfig, ScalarRLPolicy)
from ..core.policy_api import supports_batch
from ..obs.profiling import span
from ..obs.trace import NULL, Tracer
from ..sim.cluster import ResourceSpec
from ..sim.simulator import SimConfig, SimResult
from ..sim.vector import VectorSimulator
from ..workloads.registry import build_jobs, get_scenario
from ..workloads.theta import ThetaConfig

MATRIX_SCHEMA = "mrsch.eval.matrix/v1"

CORE_COLUMNS = ("policy", "scenario", "family", "drift", "seed",
                "decisions", "n_unstarted")
METRIC_COLUMNS = ("avg_wait", "avg_slowdown", "avg_bounded_slowdown",
                  "p95_wait", "max_wait", "n_jobs", "makespan",
                  "truncated_jobs",
                  # lifecycle metrics (workflow/fault scenarios) — appended
                  # last: committed baselines prefix-compare their columns
                  "requeues", "n_failed", "failed_node_hours",
                  "completed_work_frac", "pipeline_makespan")

PolicyFactory = Callable[[], object]


@dataclass(frozen=True)
class MatrixConfig:
    scenarios: Tuple[str, ...]
    seeds: Tuple[int, ...] = (1,)
    window: int = 10
    backfill: bool = True
    vector: int = 8                  # lockstep width for batched policies


def matrix_columns(resources: Sequence[ResourceSpec]) -> List[str]:
    """Row keys, in order — the schema CI pins against."""
    return (list(CORE_COLUMNS)
            + [f"util_{r.name}" for r in resources]
            + list(METRIC_COLUMNS))


def default_policies(resources: Sequence[ResourceSpec], agent=None,
                     scalar_rl: Optional[ScalarRLPolicy] = None,
                     ga: GAConfig = GAConfig(population=12, generations=8),
                     *, device=None) -> Dict[str, PolicyFactory]:
    """The paper's four methods as matrix-ready factories.

    Pass a trained ``agent`` / ``scalar_rl`` for paper-faithful numbers;
    untrained instances still exercise the full grid (CI smoke).  GA's
    factory returns a FRESH optimizer per environment (its plan cache is
    per-trace).  The ScalarRL built here lives on ``device`` (the card
    unless ``device="cpu"`` is asked for).
    """
    out: Dict[str, PolicyFactory] = {"FCFS": FCFSPolicy}
    out["GA"] = lambda: GAOptimizer(ga)
    rl = scalar_rl or ScalarRLPolicy(
        resources, ScalarRLConfig(hidden=(256, 64)), device=device)
    out["ScalarRL"] = lambda: rl
    if agent is not None:
        out["MRSch"] = lambda: agent
    return out


def _row(policy: str, scenario: str, seed: int, result: SimResult,
         resources: Sequence[ResourceSpec]) -> Dict[str, object]:
    spec = get_scenario(scenario)
    row: Dict[str, object] = {
        "policy": policy, "scenario": scenario, "family": spec.family,
        "drift": spec.drift is not None, "seed": seed,
        "decisions": result.decisions, "n_unstarted": result.n_unstarted,
    }
    metrics = result.metrics.as_row()
    for col in matrix_columns(resources)[len(CORE_COLUMNS):]:
        row[col] = round(float(metrics[col]), 4)
    return row


def _check_power(scenarios: Sequence[str],
                 resources: Sequence[ResourceSpec]) -> None:
    names = {r.name for r in resources}
    needy = [s for s in scenarios
             if "power" in get_scenario(s).tags and "power" not in names]
    if needy:
        raise ValueError(
            f"scenarios {needy} carry power demands but the cluster has no "
            "'power' resource — build resources with "
            "cfg.resources(power_budget_kw=cfg.default_power_budget_kw())")


def eval_factory(factory: PolicyFactory) -> PolicyFactory:
    """Wrap a factory so every produced instance is in evaluation mode
    (learning baselines must not train inside the matrix)."""
    def make():
        policy = factory()
        if getattr(policy, "training", False):
            policy.training = False
        return policy
    return make


def run_matrix(policies: Mapping[str, PolicyFactory],
               resources: Sequence[ResourceSpec], theta: ThetaConfig,
               cfg: MatrixConfig, tracer: Tracer = NULL) -> Dict:
    """Evaluate every policy over every (scenario, seed) cell.

    Traces are built once per cell and shared across policies, so every
    policy sees the identical workload.  Policies exposing ``training``
    are forced into evaluation mode for the run (restored afterwards).

    ``tracer`` receives the full ``mrsch.trace/v1`` event stream of every
    cell.  Environment ids are globally unique across the grid —
    ``env = policy_index * n_cells + cell_index`` — and the tracer's
    ``meta["envs"]`` (when it records meta, e.g. ``BufferTracer``) maps
    each id back to its (policy, scenario, seed).  Each policy's grid
    sweep is additionally wrapped in a ``prof.span`` named
    ``policy:<name>`` so per-policy decision latency can be read straight
    from the trace (``tools/trace_report.py``).

    Partial-failure contract: one policy crashing must not silently
    shrink the grid.  Its remaining cells are recorded under
    ``summary.failures`` (with the exception text) while every other
    policy's rows are kept; callers that need a hard stop check
    ``summary.failures`` and exit non-zero (the bench entry points do).
    """
    _check_power(cfg.scenarios, resources)
    t0 = time.perf_counter()
    cells: List[Tuple[str, int]] = [(s, seed) for s in cfg.scenarios
                                    for seed in cfg.seeds]
    traces = {cell: build_jobs(cell[0], theta, seed=cell[1])
              for cell in cells}
    sim_cfg = SimConfig.for_engine("vector", window=cfg.window,
                                   backfill=cfg.backfill)
    meta = getattr(tracer, "meta", None)
    if meta is not None:
        envs = meta.setdefault("envs", {})
        for p, name in enumerate(policies):
            for c, (scenario, seed) in enumerate(cells):
                envs[str(p * len(cells) + c)] = {
                    "policy": name, "scenario": scenario, "seed": seed}
    rows: List[Dict] = []
    failures: List[Dict] = []
    batched_policies = 0
    for p_idx, (name, factory) in enumerate(policies.items()):
        try:
            probe = factory()
        except Exception as e:
            failures.append({"policy": name,
                             "cells": [list(c) for c in cells],
                             "error": f"{type(e).__name__}: {e}"})
            continue
        batched = supports_batch(probe)
        batched_policies += bool(batched)
        # Batched policies share the probe instance, so eval mode is
        # toggled here; factory-path instances are wrapped per env by
        # eval_factory instead.
        was_training = getattr(probe, "training", None) if batched else None
        if was_training:
            probe.training = False
        width = max(cfg.vector, 1)
        try:
            for i in range(0, len(cells), width):
                chunk = cells[i:i + width]
                jobsets = [traces[c] for c in chunk]
                # Scenario fault plans ride alongside the trace: the engine
                # consumes them directly (they are not job attributes).
                flist = [get_scenario(s).faults for s, _ in chunk]
                eids = [p_idx * len(cells) + i + j
                        for j in range(len(chunk))]
                try:
                    if batched:
                        vec = VectorSimulator.from_jobsets(resources, jobsets,
                                                           probe, sim_cfg,
                                                           faults=flist,
                                                           tracer=tracer,
                                                           env_ids=eids)
                    else:
                        vec = VectorSimulator.from_factory(resources, jobsets,
                                                           eval_factory(factory),
                                                           sim_cfg,
                                                           faults=flist,
                                                           tracer=tracer,
                                                           env_ids=eids)
                    with span(tracer, f"policy:{name}"):
                        chunk_results = vec.run()
                except Exception as e:
                    # All cells this policy has not completed are failed —
                    # a crash mid-grid must not read as a smaller grid.
                    failures.append({"policy": name,
                                     "cells": [list(c) for c in cells[i:]],
                                     "error": f"{type(e).__name__}: {e}"})
                    break
                for (scenario, seed), result in zip(chunk, chunk_results):
                    rows.append(_row(name, scenario, seed, result, resources))
        finally:
            if was_training:
                probe.training = was_training
    return {
        "schema": MATRIX_SCHEMA,
        "columns": matrix_columns(resources),
        "config": {
            "scenarios": list(cfg.scenarios), "seeds": list(cfg.seeds),
            "policies": list(policies), "window": cfg.window,
            "backfill": cfg.backfill, "vector": cfg.vector,
            "n_nodes": theta.n_nodes, "bb_units": theta.bb_units,
            "duration_days": theta.duration_days,
            "resources": [r.name for r in resources],
        },
        "rows": rows,
        "summary": {
            "n_cells": len(rows),
            "batched_policies": batched_policies,
            "wins": _wins(rows),
            "failures": failures,
            "n_failed_cells": sum(len(f["cells"]) for f in failures),
            "wall_seconds": round(time.perf_counter() - t0, 3),
        },
    }


def kiviat_scores(rows: Sequence[Dict], key: str = "method") -> Dict[str, float]:
    """Normalized overall score (Fig. 7 area proxy): mean over
    [util_<resource>..., 1/wait, 1/slowdown], each scaled so the best
    method = 1.  The single scorer behind both the per-figure benches
    (``benchmarks.common``) and the matrix ``wins`` summary."""
    axes = [k for k in rows[0] if k.startswith("util_")]
    vals = {}
    for r in rows:
        v = [r[a] for a in axes]
        v.append(1.0 / max(r["avg_wait"], 1e-9))
        v.append(1.0 / max(r["avg_slowdown"], 1e-9))
        vals[r[key]] = np.array(v)
    stack = np.stack(list(vals.values()))
    best = stack.max(axis=0) + 1e-12
    return {m: float((v / best).mean()) for m, v in vals.items()}


def _wins(rows: Sequence[Dict]) -> Dict[str, int]:
    """Per-policy count of (scenario, seed) cells won on the kiviat proxy."""
    by_cell: Dict[Tuple[str, int], List[Dict]] = {}
    for r in rows:
        by_cell.setdefault((r["scenario"], r["seed"]), []).append(r)
    wins: Dict[str, int] = {}
    for cell_rows in by_cell.values():
        scores = kiviat_scores(cell_rows, key="policy")
        winner = max(scores, key=scores.get)
        wins[winner] = wins.get(winner, 0) + 1
    return dict(sorted(wins.items()))


# ------------------------------------------------------------------ output
def matrix_csv(matrix: Dict) -> str:
    """Rows as CSV, header = ``matrix['columns']`` (the stable order)."""
    buf = io.StringIO()
    cols = matrix["columns"]
    buf.write(",".join(cols) + "\n")
    for row in matrix["rows"]:
        buf.write(",".join(str(row[c]) for c in cols) + "\n")
    return buf.getvalue()


def save_matrix(matrix: Dict, json_path: str,
                csv_path: Optional[str] = None) -> Tuple[str, str]:
    """Write the JSON grid plus its CSV twin (defaults to .csv sibling)."""
    os.makedirs(os.path.dirname(json_path) or ".", exist_ok=True)
    with open(json_path, "w") as f:
        json.dump(matrix, f, indent=1, default=float)
    csv_path = csv_path or os.path.splitext(json_path)[0] + ".csv"
    with open(csv_path, "w") as f:
        f.write(matrix_csv(matrix))
    return json_path, csv_path
