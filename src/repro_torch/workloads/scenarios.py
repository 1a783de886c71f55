"""Workloads S1–S5 (Table III) and the 3-resource case study S6–S10 (§V-E).

S1–S5 re-draw each job's burst-buffer request from the base trace's request
pool restricted to a range, for a controlled contention sweep:

  S1: 50 % of jobs request BB, sizes in [ 5 TB, 285 TB]
  S2: 75 %                         [ 5 TB, 285 TB]
  S3: 50 %                         [20 TB, 285 TB]
  S4: 75 %                         [20 TB, 285 TB]
  S5: S4 with node requests halved (less CPU contention)

S6–S10 add a power profile to S1–S5 jobs: per-node draw uniform in
100–215 W (KNL 7230 TDP 215 W), system budget 500 kW (scaled
proportionally for reduced clusters).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

from ..sim.job import Job
from .theta import THETA_BB_UNITS, ThetaConfig, generate_trace

SCENARIOS = {
    # name: (frac of jobs with BB request, min TB, halve nodes)
    "S1": (0.50, 5.0, False),
    "S2": (0.75, 5.0, False),
    "S3": (0.50, 20.0, False),
    "S4": (0.75, 20.0, False),
    "S5": (0.75, 20.0, True),
}


def _bb_pool_tb(cfg: ThetaConfig, rng: np.random.Generator, lo: float) -> np.ndarray:
    """Empirical-style pool of BB requests in [lo, 285] TB (log-uniform-ish
    heavy tail like the trace's large movers)."""
    raw = 10 ** rng.uniform(math.log10(lo), math.log10(cfg.bb_max_tb), size=4096)
    return raw


def bb_pool_units(cfg: ThetaConfig, rng: np.random.Generator,
                  lo_tb: float = 5.0) -> np.ndarray:
    """Heavy-tailed BB request pool in cluster *units*, clamped to capacity.

    The single source of the scenario-style request distribution: the TB
    range scales with the cluster so mini systems see the same
    *fractional* contention the paper's full system does.  Shared by the
    Table III derivations here and the §V-D drift transformers
    (``drift.apply_drift``) so drifted traces stay in family.
    """
    scale = cfg.bb_units / THETA_BB_UNITS
    unit_tb = 1.26e3 / THETA_BB_UNITS
    tb = _bb_pool_tb(cfg, rng, lo_tb) * scale
    return np.minimum(np.ceil(tb / unit_tb), cfg.bb_units).astype(int)


def derive_scenario(base: List[Job], cfg: ThetaConfig, name: str,
                    seed: int = 1) -> List[Job]:
    frac, lo_tb, halve = SCENARIOS[name]
    # stable per-scenario offset (NOT hash(): str hashing is salted per
    # process, which made benchmark runs non-reproducible across invocations)
    rng = np.random.default_rng(seed + sum(ord(c) for c in name))
    pool = bb_pool_units(cfg, rng, lo_tb)
    jobs = []
    for j in base:
        nj = j.copy()
        if halve:
            nj.demands["node"] = max(1, nj.demands["node"] // 2)
        nj.demands["bb"] = int(rng.choice(pool)) if rng.uniform() < frac else 0
        jobs.append(nj)
    return jobs


def with_power(jobs: List[Job], cfg: ThetaConfig, seed: int = 2,
               idle_w: float = 60.0, lo_w: float = 100.0,
               hi_w: float = 215.0) -> List[Job]:
    """Attach a power demand (kW units) to every job: nodes x per-node watts."""
    rng = np.random.default_rng(seed)
    out = []
    for j in jobs:
        nj = j.copy()
        per_node = rng.uniform(lo_w, hi_w)
        nj.demands["power"] = max(1, int(math.ceil(
            nj.demands["node"] * per_node / 1000.0)))
        out.append(nj)
    return out


def build_scenarios(cfg: ThetaConfig, names: Sequence[str] = ("S1", "S2", "S3", "S4", "S5"),
                    power: bool = False, seed: int = 1) -> Dict[str, List[Job]]:
    base = generate_trace(cfg)
    out = {}
    for name in names:
        key = name
        src = name
        if name.startswith("S") and int(name[1:]) > 5:
            # S6-S10 mirror S1-S5 with power profiles.
            src = f"S{int(name[1:]) - 5}"
            power = True
        jobs = derive_scenario(base, cfg, src, seed=seed)
        if power:
            jobs = with_power(jobs, cfg, seed=seed + 7)
        out[key] = jobs
    return out
