"""Curriculum jobsets for the three-phase training strategy (paper §III-D).

Phase 1 — *sampled*: jobs sampled from the training trace with controlled
Poisson arrivals at the trace's mean inter-arrival time (easiest regime).
Phase 2 — *real*: contiguous slices of the trace with natural burstiness.
Phase 3 — *synthetic*: freshly generated jobsets mimicking the trace's
hourly/daily patterns and marginals, exposing unseen states.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from ..sim.job import Job
from .theta import ThetaConfig, generate_trace


def _renumber(jobs: List[Job]) -> List[Job]:
    """Reassign contiguous jids in submit order, remapping workflow edges.

    ``deps`` reference jids from the source trace; a slice/sample that
    renumbers without remapping would silently rewire DAGs onto unrelated
    jobs.  Edges whose parent was not selected into this jobset are
    dropped (the child behaves as a root), as are self-edges — a sampled
    set that re-times jobs can otherwise not guarantee acyclicity."""
    ordered = sorted(jobs, key=lambda x: x.submit)
    remap = {j.jid: i for i, j in enumerate(ordered)}
    out = []
    for i, j in enumerate(ordered):
        nj = j.copy()
        nj.jid = i
        nj.deps = tuple(remap[d] for d in j.deps
                        if d in remap and remap[d] != i)
        out.append(nj)
    return out


def sampled_jobsets(trace: Sequence[Job], n_sets: int, jobs_per_set: int,
                    seed: int = 0) -> List[List[Job]]:
    """Random draws with rates smoothed to the trace average (phase 1)."""
    rng = np.random.default_rng(seed)
    submits = np.array([j.submit for j in trace])
    mean_iat = float(np.diff(np.sort(submits)).mean()) if len(trace) > 1 else 60.0
    sets = []
    for _ in range(n_sets):
        picks = rng.choice(len(trace), size=min(jobs_per_set, len(trace)),
                           replace=False)
        arrivals = np.cumsum(rng.exponential(mean_iat, size=len(picks)))
        js = []
        for t, k in zip(arrivals, picks):
            nj = trace[k].copy()
            nj.submit = float(t)
            js.append(nj)
        sets.append(_renumber(js))
    return sets


def real_jobsets(trace: Sequence[Job], n_sets: int,
                 jobs_per_set: int) -> List[List[Job]]:
    """Contiguous slices with original arrival gaps (phase 2)."""
    trace = sorted(trace, key=lambda j: j.submit)
    sets = []
    step = max(1, (len(trace) - jobs_per_set) // max(n_sets, 1))
    for i in range(n_sets):
        lo = min(i * step, max(0, len(trace) - jobs_per_set))
        chunk = [j.copy() for j in trace[lo: lo + jobs_per_set]]
        if not chunk:
            break
        t0 = chunk[0].submit
        for j in chunk:
            j.submit -= t0
        sets.append(_renumber(chunk))
    return sets


def synthetic_jobsets(cfg: ThetaConfig, n_sets: int, jobs_per_set: int,
                      seed: int = 100) -> List[List[Job]]:
    """Fresh generator draws (phase 3) — same marginals, unseen sequences."""
    sets = []
    for i in range(n_sets):
        c = ThetaConfig(**{**cfg.__dict__, "seed": seed + i,
                           "duration_days": max(1.0, jobs_per_set / cfg.jobs_per_day)})
        js = generate_trace(c)[:jobs_per_set]
        sets.append(_renumber(js))
    return sets


@dataclass
class Curriculum:
    """Ordered jobsets for agent training; ``order`` permutes the phases to
    reproduce the Fig. 4 ablation (e.g. 'srs' = sampled, real, synthetic)."""

    sampled: List[List[Job]]
    real: List[List[Job]]
    synthetic: List[List[Job]]

    def ordered(self, order: str = "sampled_real_synthetic") -> List[List[Job]]:
        phases = {
            "sampled": self.sampled, "real": self.real,
            "synthetic": self.synthetic,
        }
        out: List[List[Job]] = []
        for p in order.split("_"):
            out.extend(phases[p])
        return out


def build_curriculum(cfg: ThetaConfig, trace: Sequence[Job],
                     n_sampled: int = 10, n_real: int = 10,
                     n_synth: int = 20, jobs_per_set: int = 5000,
                     seed: int = 0) -> Curriculum:
    """Paper §V-B: 10 sampled + 10 real + 20 synthetic jobsets."""
    return Curriculum(
        sampled=sampled_jobsets(trace, n_sampled, jobs_per_set, seed=seed),
        real=real_jobsets(trace, n_real, jobs_per_set),
        synthetic=synthetic_jobsets(cfg, n_synth, jobs_per_set, seed=seed + 100),
    )
