"""The one traffic generator: Theta-like job traces under a Table III
scenario, read from a mix file under ``portbench/traffic/``.

Frozen copies of the port's generator, so that a later change to the
program cannot move the yardstick:

* ``_arrival_times``, ``_base_trace`` copy
  ``src/repro_torch/workloads/theta.py`` lines 89-160 (``_arrival_times``,
  ``generate_trace``; its base BB requests are replaced by the
  scenario's, so ``_bb_request_pool`` is not copied) at commit fe026a5;
* ``_bb_pool_units``, ``_derive`` copy
  ``src/repro_torch/workloads/scenarios.py`` lines 37-73 (``_bb_pool_tb``,
  ``bb_pool_units``, ``derive_scenario``) and its ``SCENARIOS`` table
  (line 27);
* trace seeds replace ``chip_smoke.py::s1_trace`` (line 1352), which
  seeded trace ``i`` of a sweep with ``i`` and every scenario with 1.

What differs from the copies, all set in the mix file: the draws are
made in bulk (the same distributions, another order of the stream); the
traces are a fixed pool, trace ``i`` drawn from ``SeedSequence([pool_seed,
i])``, and the run's seed only assigns them to environments, so every run
does the same work ("the same set of sizes and arrivals, in another
order"); ``time_resolution_s`` rounds submit times down and runtimes up to
whole seconds, as production logs (SWF) record them, so that float32
clocks hold every time exactly.  A trace is plain arrays; nothing here
imports the program.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import List

import numpy as np

HOUR = 3600.0
DAY = 24 * HOUR
THETA_BB_UNITS = 1293

# The generator's knobs (ThetaConfig's defaults); a mix file's "theta"
# object overrides any of them.
THETA_DEFAULTS = dict(
    n_nodes=4392, bb_units=THETA_BB_UNITS, duration_days=150.0,
    jobs_per_day=80.0,
    size_buckets=(0.002, 0.004, 0.008, 0.016, 0.03, 0.06, 0.125, 0.25, 0.5,
                  1.0),
    size_weights=(0.10, 0.12, 0.14, 0.14, 0.12, 0.12, 0.12, 0.08, 0.04, 0.02),
    runtime_median_s=45 * 60.0, runtime_sigma=1.1, runtime_min_s=120.0,
    runtime_max_s=12 * HOUR, walltime_cap_s=24 * HOUR,
    frac_jobs_with_io=0.40, frac_jobs_gt_1gb=0.1718, bb_max_tb=285.0,
    diurnal_amplitude=0.45, weekend_factor=0.6)

# name: (fraction of jobs with a BB request, min TB, halve nodes)
SCENARIOS = {
    "S1": (0.50, 5.0, False),
    "S2": (0.75, 5.0, False),
    "S3": (0.50, 20.0, False),
    "S4": (0.75, 20.0, False),
    "S5": (0.75, 20.0, True),
}

RESOURCES = ("node", "bb")


@dataclass(frozen=True)
class Trace:
    """One job trace, sorted by (submit, jid); jid is the row index."""
    submit: np.ndarray       # (J,) float64 seconds
    runtime: np.ndarray      # (J,) float64 seconds
    walltime: np.ndarray     # (J,) float64 seconds, >= runtime
    demands: np.ndarray      # (J, R) int64 units, R = len(RESOURCES)


def load_mix(path: Path) -> dict:
    mix = json.loads(Path(path).read_text())
    if mix.get("generator") != "theta":
        raise ValueError(f"{path}: unknown generator {mix.get('generator')!r}")
    if mix["scenario"] not in SCENARIOS:
        raise ValueError(f"{path}: unknown scenario {mix['scenario']!r}")
    if not isinstance(mix.get("pool_seed"), int):
        raise ValueError(f"{path}: pool_seed must be a whole number")
    unknown = set(mix.get("theta", {})) - set(THETA_DEFAULTS)
    if unknown:
        raise ValueError(f"{path}: unknown generator knobs {sorted(unknown)}")
    return mix


def theta_config(mix: dict) -> dict:
    return {**THETA_DEFAULTS, **mix.get("theta", {})}


def _arrival_times(cfg: dict, rng: np.random.Generator) -> np.ndarray:
    """Nonhomogeneous Poisson arrivals with diurnal + weekly modulation,
    generated by thinning: candidates at rate lam_max up to and including
    the first past the end, each kept with probability lam(t) / lam_max."""
    lam_base = cfg["jobs_per_day"] / DAY
    lam_max = lam_base * (1 + cfg["diurnal_amplitude"])
    end = cfg["duration_days"] * DAY
    n = int(lam_max * end + 10 * math.sqrt(lam_max * end + 1) + 10)
    t = np.cumsum(rng.exponential(1.0 / lam_max, size=n))
    while t[-1] < end:
        t = np.concatenate([t, t[-1] + np.cumsum(
            rng.exponential(1.0 / lam_max, size=n))])
    t = t[:int(np.searchsorted(t, end, side="left")) + 1]
    hour = (t % DAY) / HOUR
    lam = lam_base * (1 + cfg["diurnal_amplitude"] * np.sin(
        (hour - 8.0) / 24.0 * 2 * math.pi))
    lam = np.where((t // DAY).astype(np.int64) % 7 >= 5,
                   lam * cfg["weekend_factor"], lam)
    return t[rng.uniform(size=len(t)) < lam / lam_max]


def _base_trace(cfg: dict, rng: np.random.Generator):
    """(submit, runtime, walltime, nodes) of the base trace; its burst
    buffer requests are the scenario's (``_derive``)."""
    arrivals = _arrival_times(cfg, rng)
    n = len(arrivals)
    weights = np.asarray(cfg["size_weights"])
    frac = rng.choice(np.asarray(cfg["size_buckets"]), size=n,
                      p=weights / np.sum(weights))
    nodes = np.maximum(1, np.round(frac * cfg["n_nodes"])).astype(int)
    mu = math.log(cfg["runtime_median_s"])
    runtime = np.clip(rng.lognormal(mu, cfg["runtime_sigma"], size=n),
                      cfg["runtime_min_s"], cfg["runtime_max_s"])
    overest = rng.uniform(1.0, 2.5, size=n)
    walltime = np.minimum(np.ceil(runtime * overest / 600.0) * 600.0,
                          cfg["walltime_cap_s"])
    return arrivals, runtime, walltime, nodes


def _bb_pool_units(cfg: dict, rng: np.random.Generator, lo_tb: float):
    """Heavy-tailed BB request pool in cluster units, clamped to capacity."""
    raw = 10 ** rng.uniform(math.log10(lo_tb), math.log10(cfg["bb_max_tb"]),
                            size=4096)
    tb = raw * (cfg["bb_units"] / THETA_BB_UNITS)
    unit_tb = 1.26e3 / THETA_BB_UNITS
    return np.minimum(np.ceil(tb / unit_tb), cfg["bb_units"]).astype(int)


def _derive(nodes: np.ndarray, cfg: dict, scenario: str,
            rng: np.random.Generator):
    """(nodes, bb units) of the scenario: each job asks, with the
    scenario's probability, for a BB request drawn from its pool."""
    frac, lo_tb, halve = SCENARIOS[scenario]
    pool = _bb_pool_units(cfg, rng, lo_tb)
    n = len(nodes)
    asks = rng.uniform(size=n) < frac
    bb = np.where(asks, pool[rng.integers(0, len(pool), size=n)], 0)
    if halve:
        nodes = np.maximum(1, nodes // 2)
    return nodes, bb.astype(np.int64)


def make_trace(mix: dict, index: int) -> Trace:
    """Trace ``index`` of the mix's pool."""
    cfg = theta_config(mix)
    base_ss, scn_ss = np.random.SeedSequence(
        [int(mix["pool_seed"]), int(index)]).spawn(2)
    submit, runtime, walltime, nodes = _base_trace(
        cfg, np.random.default_rng(base_ss))
    nodes, bb = _derive(nodes, cfg, mix["scenario"],
                        np.random.default_rng(scn_ss))
    res = float(mix.get("time_resolution_s", 0.0))
    if res > 0:
        submit = np.floor(submit / res) * res
        runtime = np.ceil(runtime / res) * res
        walltime = np.maximum(walltime, runtime)
    order = np.lexsort((np.arange(len(submit)), submit))
    return Trace(submit=submit[order], runtime=runtime[order],
                 walltime=walltime[order],
                 demands=np.stack([nodes, bb], axis=1)[order].astype(np.int64))


def make_traces(mix: dict, seed: int) -> List[Trace]:
    """The mix's ``n_traces`` pool traces, in the order run seed ``seed``
    assigns them to environments."""
    n = int(mix["n_traces"])
    order = np.random.default_rng(
        np.random.SeedSequence([int(seed) % 2**64])).permutation(n)
    pool = [make_trace(mix, i) for i in range(n)]
    return [pool[i] for i in order]


def capacities(mix: dict) -> tuple:
    cfg = theta_config(mix)
    return (int(cfg["n_nodes"]), int(cfg["bb_units"]))
