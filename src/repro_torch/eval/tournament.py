"""Standing policy tournament: zoo x scenario x seed with a leaderboard
(the JAX package's ``repro/eval/tournament.py``; same schema, standings
and rendered markdown).

The paper's §V evidence compares MRSch against FCFS/GA/ScalarRL once;
the related work fields a stronger lineup.  This module runs the full
baseline zoo (``repro_torch.baselines``: PRB-EWT, the CP window-packing
dispatcher, a DRAS-style two-level agent, an RL co-scheduler variant)
plus the paper's four methods as a round-robin on the vector engine —
every entrant over every (scenario, seed) cell, reusing the
``run_matrix`` cell plumbing so traces are shared and rows stay in the
stable matrix schema — and derives the standings:

* per-policy aggregates (mean metrics over cells) — the per-policy
  section CI gates against ``benchmarks/baselines/tournament.json``;
* per-metric ranks (direction-aware: waits rank ascending,
  utilizations descending);
* head-to-head win rates on the per-cell kiviat score;
* MRSch's relative wait improvement over every baseline — the paper's
  "up to 48%" headline, recomputed against the stronger field on
  every run.

Output is a stable ``mrsch.eval.tournament/v1`` JSON plus a rendered
markdown leaderboard (the nightly CI lane appends it to the step
summary).  Everything except ``summary.wall_seconds`` is deterministic
for a fixed seed.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from ..baselines import (CoSchedConfig, CoSchedPolicy, CPConfig, CPDispatcher,
                         DRASConfig, DRASPolicy, PRBConfig, PRBPolicy)
from ..obs.trace import NULL, Tracer
from ..sim.cluster import ResourceSpec
from ..workloads.theta import ThetaConfig
from .matrix import (MatrixConfig, PolicyFactory, default_policies,
                     kiviat_scores, run_matrix)

TOURNAMENT_SCHEMA = "mrsch.eval.tournament/v1"

# Leaderboard row keys, in order (tests pin this; util_<r> columns are
# appended per cluster resource before the trailing improvement column).
LEADERBOARD_CORE = ("rank", "policy", "overall_score", "wins",
                    "h2h_win_rate", "avg_wait", "avg_slowdown", "p95_wait")
LEADERBOARD_TAIL = ("wait_improvement_vs",)

# Metrics ranked per-policy (direction-aware), beyond the util_* columns.
RANK_LOWER = ("avg_wait", "avg_slowdown", "avg_bounded_slowdown", "p95_wait")


@dataclass(frozen=True)
class TournamentConfig:
    scenarios: Tuple[str, ...]
    seeds: Tuple[int, ...] = (1,)
    window: int = 10
    backfill: bool = True
    vector: int = 8
    reference: str = "MRSch"         # policy the improvement figure targets

    def matrix_config(self) -> MatrixConfig:
        return MatrixConfig(scenarios=self.scenarios, seeds=self.seeds,
                            window=self.window, backfill=self.backfill,
                            vector=self.vector)


def zoo_policies(resources: Sequence[ResourceSpec], agent=None,
                 window: int = 10, seed: int = 0, *, device=None,
                 **default_kw) -> Dict[str, PolicyFactory]:
    """The full tournament field: the paper's four methods plus the
    literature zoo.  Stateless/shared entrants reuse one instance;
    ``default_policies`` keeps its own conventions for the originals.
    The networks built here live on ``device`` (the card unless
    ``device="cpu"`` is asked for)."""
    out = default_policies(resources, agent=agent, device=device,
                           **default_kw)
    prb = PRBPolicy(resources, PRBConfig(window=window))
    out["PRB-EWT"] = lambda: prb
    cp = CPDispatcher(CPConfig(window=window))
    out["CP-Dispatch"] = lambda: cp
    dras = DRASPolicy(resources, DRASConfig(window=window, seed=seed),
                      device=device)
    out["DRAS"] = lambda: dras
    cosched = CoSchedPolicy(resources,
                            CoSchedConfig(window=window, seed=seed),
                            device=device)
    out["CoSchedRL"] = lambda: cosched
    return out


def leaderboard_columns(resources: Sequence[ResourceSpec]) -> List[str]:
    return (list(LEADERBOARD_CORE)
            + [f"util_{r.name}" for r in resources]
            + list(LEADERBOARD_TAIL))


# ------------------------------------------------------------- standings
def _cell_scores(rows: Sequence[Dict]) -> Dict[Tuple[str, int], Dict[str, float]]:
    """Per-(scenario, seed) kiviat score of every policy present."""
    by_cell: Dict[Tuple[str, int], List[Dict]] = {}
    for r in rows:
        by_cell.setdefault((r["scenario"], r["seed"]), []).append(r)
    return {cell: kiviat_scores(cell_rows, key="policy")
            for cell, cell_rows in by_cell.items()}


def _aggregates(rows: Sequence[Dict], metrics: Sequence[str]
                ) -> Dict[str, Dict[str, float]]:
    agg: Dict[str, Dict[str, List[float]]] = {}
    for r in rows:
        acc = agg.setdefault(r["policy"], {m: [] for m in metrics})
        for m in metrics:
            acc[m].append(float(r[m]))
    return {p: {m: round(sum(v) / len(v), 4) for m, v in acc.items()}
            for p, acc in agg.items()}


def _ranks(agg: Mapping[str, Mapping[str, float]], metric: str,
           lower_is_better: bool) -> Dict[str, int]:
    """1 = best; deterministic tie-break on policy name."""
    order = sorted(agg, key=lambda p: (
        agg[p][metric] if lower_is_better else -agg[p][metric], p))
    return {p: i + 1 for i, p in enumerate(order)}


def _head_to_head(cell_scores: Mapping, policies: Sequence[str]
                  ) -> Dict[str, Dict[str, float]]:
    """h2h[p][q] = fraction of shared cells where p outscores q."""
    h2h: Dict[str, Dict[str, float]] = {}
    for p in policies:
        h2h[p] = {}
        for q in policies:
            if q == p:
                continue
            shared = [s for s in cell_scores.values() if p in s and q in s]
            if not shared:
                continue
            wins = sum(1 for s in shared if s[p] > s[q])
            h2h[p][q] = round(wins / len(shared), 4)
    return h2h


def run_tournament(policies: Mapping[str, PolicyFactory],
                   resources: Sequence[ResourceSpec], theta: ThetaConfig,
                   cfg: TournamentConfig, tracer: Tracer = NULL) -> Dict:
    """Round-robin every policy over every (scenario, seed) cell and
    derive the standings (see module docstring for the sections).
    ``tracer`` is threaded through to ``run_matrix`` (one
    ``mrsch.trace/v1`` stream covering the whole round-robin)."""
    matrix = run_matrix(policies, resources, theta, cfg.matrix_config(),
                        tracer=tracer)
    rows = matrix["rows"]
    util_cols = [f"util_{r.name}" for r in resources]
    metrics = list(RANK_LOWER) + util_cols
    agg = _aggregates(rows, metrics)
    cell_scores = _cell_scores(rows)
    present = sorted(agg)

    overall = {p: round(sum(s[p] for s in cell_scores.values() if p in s)
                        / max(sum(1 for s in cell_scores.values() if p in s),
                              1), 4)
               for p in present}
    wins = {p: sum(1 for s in cell_scores.values()
                   if p in s and s[p] == max(s.values())) for p in present}
    h2h = _head_to_head(cell_scores, present)
    h2h_rate = {p: round(sum(h2h[p].values()) / max(len(h2h[p]), 1), 4)
                for p in present}

    ranks = {m: _ranks(agg, m, lower_is_better=m in RANK_LOWER)
             for m in metrics}

    ref = cfg.reference
    improvement: Dict[str, float] = {}
    if ref in agg:
        for p in present:
            if p == ref:
                continue
            base = max(agg[p]["avg_wait"], 1e-9)
            improvement[p] = round((base - agg[ref]["avg_wait"]) / base, 4)

    lb_order = sorted(present, key=lambda p: (-overall[p], p))
    leaderboard = []
    for i, p in enumerate(lb_order):
        entry = {"rank": i + 1, "policy": p, "overall_score": overall[p],
                 "wins": wins[p], "h2h_win_rate": h2h_rate[p],
                 "avg_wait": agg[p]["avg_wait"],
                 "avg_slowdown": agg[p]["avg_slowdown"],
                 "p95_wait": agg[p]["p95_wait"]}
        for c in util_cols:
            entry[c] = agg[p][c]
        entry["wait_improvement_vs"] = improvement.get(p)
        leaderboard.append(entry)

    return {
        "schema": TOURNAMENT_SCHEMA,
        "columns": matrix["columns"],
        "leaderboard_columns": leaderboard_columns(resources),
        "config": {**matrix["config"], "reference": ref},
        "rows": rows,
        "leaderboard": leaderboard,
        "per_policy": agg,
        "ranks": ranks,
        "head_to_head": h2h,
        "relative_improvement": {
            "reference": ref,
            "vs": improvement,
            "max": round(max(improvement.values()), 4) if improvement else None,
        },
        "summary": {
            **matrix["summary"],
            "n_policies": len(present),
            "leader": lb_order[0] if lb_order else None,
        },
    }


# --------------------------------------------------------------- rendering
def render_leaderboard(t: Dict) -> str:
    """Markdown standings (the nightly lane appends this to the CI step
    summary, so keep it a plain table — no HTML)."""
    cfgt = t["config"]
    ref = t["relative_improvement"]["reference"]
    cols = t["leaderboard_columns"]
    head = {"rank": "#", "policy": "policy", "overall_score": "overall",
            "wins": "wins", "h2h_win_rate": "h2h win%",
            "avg_wait": "wait (s)", "avg_slowdown": "slowdown",
            "p95_wait": "p95 wait (s)",
            "wait_improvement_vs": f"{ref} wait cut"}
    lines = [
        "# Tournament leaderboard",
        "",
        f"{len(t['leaderboard'])} policies x {len(cfgt['scenarios'])} "
        f"scenarios x {len(cfgt['seeds'])} seeds "
        f"({t['summary']['n_cells']} cells); overall = mean per-cell kiviat "
        "score (1 = best on every axis).",
        "",
        "| " + " | ".join(head.get(c, c) for c in cols) + " |",
        "|" + "---|" * len(cols),
    ]
    for e in t["leaderboard"]:
        cells = []
        for c in cols:
            v = e[c]
            if c == "wait_improvement_vs":
                v = "—" if v is None else f"{v:+.1%}"
            elif c == "h2h_win_rate":
                v = f"{v:.0%}"
            elif isinstance(v, float):
                v = f"{v:.4g}"
            cells.append(str(v))
        lines.append("| " + " | ".join(cells) + " |")
    imp = t["relative_improvement"]
    if imp["vs"]:
        best = max(imp["vs"], key=lambda p: imp["vs"][p])
        lines += [
            "",
            f"**{ref} relative wait improvement** (the paper's §V headline, "
            f"re-litigated against the full field): up to "
            f"**{imp['max']:+.1%}** (vs {best}); "
            + ", ".join(f"{p}: {v:+.1%}"
                        for p, v in sorted(imp["vs"].items())) + ".",
        ]
    lines += ["", "## Head-to-head win rate (row beats column)", ""]
    pols = [e["policy"] for e in t["leaderboard"]]
    lines.append("| | " + " | ".join(pols) + " |")
    lines.append("|" + "---|" * (len(pols) + 1))
    for p in pols:
        row = [f"**{p}**"]
        for q in pols:
            row.append("—" if q == p
                       else f"{t['head_to_head'][p].get(q, 0.0):.0%}")
        lines.append("| " + " | ".join(row) + " |")
    fails = t["summary"].get("failures") or []
    if fails:
        lines += ["", "## FAILED policies", ""]
        for f in fails:
            lines.append(f"- **{f['policy']}**: {f['error']} "
                         f"({len(f['cells'])} cells lost)")
    return "\n".join(lines) + "\n"


def save_tournament(t: Dict, json_path: str,
                    md_path: Optional[str] = None) -> Tuple[str, str]:
    """Write the JSON standings plus the rendered leaderboard.md."""
    import json
    os.makedirs(os.path.dirname(json_path) or ".", exist_ok=True)
    with open(json_path, "w") as f:
        json.dump(t, f, indent=1, default=float)
    md_path = md_path or os.path.join(
        os.path.dirname(json_path), "leaderboard.md")
    with open(md_path, "w") as f:
        f.write(render_leaderboard(t))
    return json_path, md_path
