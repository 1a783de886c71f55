"""Theta-like workload trace generator.

The paper evaluates on a five-month 2018 production trace from Theta at ALCF
(4392 nodes) extended with burst-buffer requests derived from Darshan I/O
logs (1.26 PB shared burst buffer; 40 % of jobs had I/O records; 17.18 %
moved > 1 GB; requests spanned 1 GB – 285 TB).  That trace is not
redistributable, so this module generates a synthetic trace matched to the
published statistics; every knob is explicit so a real SWF trace can be
dropped in via :func:`jobs_from_swf`.

The full-scale dimensions reproduce the paper's state-vector size:
W=10 window, 4392 nodes, 1293 burst-buffer units (~1 TB each) →
4*10 + 2*4392 + 2*1293 = 11410 (paper §IV-C).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from ..sim.cluster import ResourceSpec
from ..sim.job import Job

HOUR = 3600.0
DAY = 24 * HOUR

# Published full-scale constants.
THETA_NODES = 4392
THETA_BB_UNITS = 1293            # 1.26 PB at ~1 TB/unit -> 11410-dim state
THETA_BB_UNIT_TB = 1.26e3 / THETA_BB_UNITS


@dataclass
class ThetaConfig:
    """Knobs for the synthetic trace.  Defaults give the full-scale system;
    ``mini()`` gives a CPU-friendly scale for tests/benchmarks."""

    n_nodes: int = THETA_NODES
    bb_units: int = THETA_BB_UNITS
    duration_days: float = 150.0          # five months
    jobs_per_day: float = 80.0
    seed: int = 0
    # Job size distribution: log2-ish buckets with heavy small-job mass plus
    # capability-class jobs, mimicking ALCF mixes.
    size_buckets: Sequence[float] = (0.002, 0.004, 0.008, 0.016, 0.03, 0.06,
                                     0.125, 0.25, 0.5, 1.0)
    size_weights: Sequence[float] = (0.10, 0.12, 0.14, 0.14, 0.12, 0.12,
                                     0.12, 0.08, 0.04, 0.02)
    # Runtime: lognormal (median ~45 min), clipped.
    runtime_median_s: float = 45 * 60.0
    runtime_sigma: float = 1.1
    runtime_min_s: float = 120.0
    runtime_max_s: float = 12 * HOUR
    walltime_cap_s: float = 24 * HOUR
    # Burst buffer statistics from the paper.
    frac_jobs_with_io: float = 0.40
    frac_jobs_gt_1gb: float = 0.1718
    bb_max_tb: float = 285.0
    # Diurnal/weekly arrival modulation.
    diurnal_amplitude: float = 0.45
    weekend_factor: float = 0.6

    @staticmethod
    def mini(seed: int = 0, duration_days: float = 4.0,
             jobs_per_day: float = 220.0) -> "ThetaConfig":
        """Scaled-down system for CPU-only experimentation."""
        return ThetaConfig(
            n_nodes=256, bb_units=80, duration_days=duration_days,
            jobs_per_day=jobs_per_day, seed=seed,
            runtime_median_s=30 * 60.0, runtime_max_s=6 * HOUR,
        )

    def resources(self, power_budget_kw: Optional[float] = None):
        specs = [
            ResourceSpec("node", self.n_nodes, "node"),
            ResourceSpec("bb", self.bb_units, "TB"),
        ]
        if power_budget_kw is not None:
            specs.append(ResourceSpec("power", int(round(power_budget_kw)), "kW"))
        return specs

    def default_power_budget_kw(self) -> float:
        # Paper case study: 500 kW budget on the 4392-node system.
        return 500.0 * self.n_nodes / THETA_NODES


def _arrival_times(cfg: ThetaConfig, rng: np.random.Generator) -> np.ndarray:
    """Nonhomogeneous Poisson arrivals with diurnal + weekly modulation,
    generated by thinning."""
    lam_base = cfg.jobs_per_day / DAY
    lam_max = lam_base * (1 + cfg.diurnal_amplitude)
    t, end = 0.0, cfg.duration_days * DAY
    out = []
    while t < end:
        t += rng.exponential(1.0 / lam_max)
        hour = (t % DAY) / HOUR
        dow = int(t // DAY) % 7
        lam = lam_base * (1 + cfg.diurnal_amplitude * math.sin(
            (hour - 8.0) / 24.0 * 2 * math.pi))
        if dow >= 5:
            lam *= cfg.weekend_factor
        if rng.uniform() < lam / lam_max:
            out.append(t)
    return np.asarray(out)


def _bb_request_pool(cfg: ThetaConfig, n: int,
                     rng: np.random.Generator) -> np.ndarray:
    """Per-job BB request in TB for the *base* trace (0 when no I/O record).

    Matches the published shape: 40 % of jobs have records, 17.18 % move
    more than 1 GB, and requests reach 285 TB with a heavy tail."""
    req = np.zeros(n)
    has_io = rng.uniform(size=n) < cfg.frac_jobs_with_io
    # Of jobs with records, the >1 GB fraction is 0.1718/0.40.
    big = has_io & (rng.uniform(size=n) < cfg.frac_jobs_gt_1gb / cfg.frac_jobs_with_io)
    small = has_io & ~big
    # <=1 GB movers: negligible request (0.001-1 GB).
    req[small] = 10 ** rng.uniform(-6.0, -3.0, size=int(small.sum()))
    # >1 GB movers: lognormal in TB, clipped to 285 TB.
    raw = 10 ** rng.normal(loc=-0.3, scale=1.3, size=int(big.sum()))
    req[big] = np.clip(raw, 1e-3, cfg.bb_max_tb)
    return req


def generate_trace(cfg: ThetaConfig) -> List[Job]:
    """Base trace: CPU demands from the size distribution, BB demands from
    the Darshan-style pool (may be zero)."""
    rng = np.random.default_rng(cfg.seed)
    arrivals = _arrival_times(cfg, rng)
    n = len(arrivals)
    frac = rng.choice(np.asarray(cfg.size_buckets), size=n,
                      p=np.asarray(cfg.size_weights) / np.sum(cfg.size_weights))
    nodes = np.maximum(1, np.round(frac * cfg.n_nodes)).astype(int)
    mu = math.log(cfg.runtime_median_s)
    runtime = np.clip(rng.lognormal(mu, cfg.runtime_sigma, size=n),
                      cfg.runtime_min_s, cfg.runtime_max_s)
    # Users round walltime estimates up to coarse values.
    overest = rng.uniform(1.0, 2.5, size=n)
    walltime = np.minimum(np.ceil(runtime * overest / 600.0) * 600.0,
                          cfg.walltime_cap_s)
    bb_tb = _bb_request_pool(cfg, n, rng)
    unit_tb = 1.26e3 * (cfg.bb_units / THETA_BB_UNITS) / cfg.bb_units \
        if cfg.bb_units != THETA_BB_UNITS else THETA_BB_UNIT_TB
    jobs = []
    for i in range(n):
        demands = {"node": int(nodes[i])}
        bb_units = int(math.ceil(bb_tb[i] / unit_tb)) if bb_tb[i] > 0 else 0
        demands["bb"] = min(bb_units, cfg.bb_units)
        jobs.append(Job(jid=i, submit=float(arrivals[i]),
                        runtime=float(runtime[i]), walltime=float(walltime[i]),
                        demands=demands))
    return jobs


def jobs_from_swf(path: str, n_nodes: int,
                  max_jobs: Optional[int] = None) -> List[Job]:
    """Load a Standard Workload Format trace (drop-in for the real log).

    Real SWF logs are messy, so the parser is defensive (production logs
    must never crash a replay):

    * ``;`` header/comment lines, blank lines, and lines that are too
      short or non-numeric are skipped;
    * SWF ``-1`` sentinels are mapped: missing runtime falls back to the
      requested time (field 9); missing *used* processors (field 5) fall
      back to *requested* processors (field 8); a job with neither a
      positive runtime nor a positive processor count is dropped;
    * negative submit times are clamped to 0; the walltime estimate is
      raised to the runtime when the log reports run > request (the
      simulator's ``walltime >= runtime`` invariant); processor requests
      are clamped to the configured cluster size;
    * SWF workflow fields 17–18 ("Preceding Job Number" / "Think Time
      from Preceding Job") populate ``Job.deps`` / ``Job.think_time``:
      the ``-1`` sentinel (and ``0``, which SWF reserves for "no
      predecessor") means no dependency; negative think times clamp to 0.
      A predecessor must appear EARLIER in the file — forward references
      would allow cycles, which no real log produces — and references to
      dropped/absent rows are discarded in a post-pass, so a truncated
      ``max_jobs`` replay never carries dangling edges.

    Jobs come back sorted by (submit, jid).  ``max_jobs`` truncates (in
    file order) for CI-sized replays of multi-year logs.
    """
    jobs: List[Job] = []
    seen: set = set()
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(";"):
                continue
            fields = line.split()
            if len(fields) < 9:
                continue                       # malformed/truncated row
            try:
                jid = int(fields[0])
                submit = float(fields[1])
                runtime = float(fields[3])
                used_procs = int(fields[4])
                req_procs = int(fields[7])
                req_time = float(fields[8])
            except ValueError:
                continue                       # non-numeric garbage
            prev_job, think = 0, 0.0
            if len(fields) >= 17:
                try:
                    prev_job = int(fields[16])
                except ValueError:
                    prev_job = 0
            if len(fields) >= 18:
                try:
                    think = max(float(fields[17]), 0.0)
                except ValueError:
                    think = 0.0
            procs = used_procs if used_procs > 0 else req_procs
            if runtime <= 0:
                runtime = req_time             # -1 sentinel: fall back
            if runtime <= 0 or procs <= 0:
                continue                       # nothing schedulable
            walltime = req_time if req_time > 0 else runtime
            deps = ((prev_job,) if prev_job > 0 and prev_job != jid
                    and prev_job in seen else ())
            jobs.append(Job(jid=jid, submit=max(submit, 0.0),
                            runtime=runtime,
                            walltime=max(walltime, runtime),
                            demands={"node": min(procs, n_nodes), "bb": 0},
                            deps=deps, think_time=think if deps else 0.0))
            seen.add(jid)
            if max_jobs is not None and len(jobs) >= max_jobs:
                break
    jobs.sort(key=lambda j: (j.submit, j.jid))
    return jobs
