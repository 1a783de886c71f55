"""MRSch as the framework's fleet scheduler (the JAX package's
``launch/scheduler.py``): the paper's technique as a first-class feature.

An accelerator fleet runs many training/serving jobs.  Each job requests:
  * chips       — a gang-scheduled slice of the fleet, rigid, like HPC jobs
  * burst buffer— host-side staging TB for checkpoints / dataset shards
  * power       — kW envelope under the facility budget

which is exactly the paper's multi-resource setting (CPU nodes / BB /
power) with renamed units, so the *same* ``MRSchAgent`` (identical code
path, window + reservation + EASY backfilling) schedules the fleet.
Job demand vectors come from the cost model (``distributed.costs``):
chips from the memory footprint, BB from checkpoint size, power from the
per-chip envelope.  ``FleetSpec``'s defaults are the reference's, field
for field, so both packages schedule the same fleet; pass a chip's own
memory and power to describe another.

The agent runs on the card unless ``device`` says otherwise: each
decision is one forward of the DFP network (the fused-MLP kernel B1), each
training step its backward (B2, B3).
"""
from __future__ import annotations

import argparse
import json
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..configs import SHAPES, all_configs, get_config
from ..core import (AgentConfig, FCFSPolicy, GAOptimizer, MRSchAgent,
                    evaluate, train_agent)
from ..distributed.costs import cell_costs
from ..sim import Job, ResourceSpec, run_trace


@dataclass(frozen=True)
class FleetSpec:
    chips: int = 512
    chip_unit: int = 8               # chips per schedulable host
    bb_tb: int = 400                 # shared staging burst buffer
    power_budget_kw: int = 160       # facility envelope for this fleet
    hbm_gb_per_chip: float = 16.0
    watts_per_chip: float = 250.0

    def resources(self) -> List[ResourceSpec]:
        return [
            ResourceSpec("chips", self.chips // self.chip_unit, "host"),
            ResourceSpec("bb", self.bb_tb, "TB"),
            ResourceSpec("power", self.power_budget_kw, "kW"),
        ]


def job_demands(arch: str, shape_name: str, fleet: FleetSpec) -> Dict[str, int]:
    """Demand vector for one (arch x shape) job from the cost model."""
    cfg = get_config(arch)
    costs = cell_costs(cfg, SHAPES[shape_name])
    state_bytes = costs.param_bytes * (3.0 if SHAPES[shape_name].kind == "train"
                                       else 1.2)
    chips = max(8, 1 << math.ceil(math.log2(max(
        state_bytes / (fleet.hbm_gb_per_chip * 1e9 * 0.7), 1))))
    chips = min(chips, fleet.chips)
    hosts = max(1, chips // fleet.chip_unit)
    bb = max(1, int(math.ceil(3 * costs.param_bytes / 1e12)))   # 3 checkpoints
    power = max(1, int(math.ceil(chips * fleet.watts_per_chip / 1000.0)))
    return {"chips": hosts, "bb": bb, "power": power}


def synth_fleet_trace(fleet: FleetSpec, n_jobs: int = 200, seed: int = 0,
                      mean_iat_s: float = 900.0,
                      mean_runtime_s: float = 3 * 3600.0) -> List[Job]:
    """A fleet workload: random (arch x shape) cells arriving as jobs,
    drawn in the reference's order from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    cells = [(a, s) for a in all_configs() for s in ("train_4k", "prefill_32k",
                                                     "decode_32k")]
    jobs = []
    t = 0.0
    for i in range(n_jobs):
        t += rng.exponential(mean_iat_s)
        arch, sname = cells[rng.integers(len(cells))]
        runtime = float(np.clip(rng.lognormal(math.log(mean_runtime_s), 0.9),
                                300, 48 * 3600))
        walltime = min(runtime * rng.uniform(1.1, 2.0), 72 * 3600)
        jobs.append(Job(jid=i, submit=t, runtime=runtime, walltime=walltime,
                        demands=job_demands(arch, sname, fleet)))
    return jobs


def fleet_agent_config(seed: int = 0) -> AgentConfig:
    """The fleet agent's (small) network and training knobs."""
    return AgentConfig(state_hidden=(512, 256), state_out=128,
                       module_hidden=64, grad_steps_per_episode=24,
                       batch_size=48, seed=seed)


def make_fleet_agent(fleet: FleetSpec, train_jobs: int = 400,
                     episodes: int = 6, seed: int = 0,
                     device=None) -> MRSchAgent:
    """Train an MRSch agent on synthetic fleet traces, on the card unless
    ``device`` says otherwise."""
    res = fleet.resources()
    agent = MRSchAgent(res, fleet_agent_config(seed), device=device)
    sets = [synth_fleet_trace(fleet, train_jobs // 2, seed=seed + i)
            for i in range(episodes)]
    train_agent(agent, res, sets)
    return agent


def schedule_fleet(jobs: Sequence[Job], fleet: FleetSpec,
                   policy: str = "mrsch", agent: Optional[MRSchAgent] = None,
                   device=None):
    """Schedule ``jobs`` on ``fleet`` with ``policy`` (``"mrsch"``,
    ``"fcfs"`` or ``"ga"``) -> the ``SimResult``.  Without ``agent``,
    ``"mrsch"`` trains one first (``make_fleet_agent`` on ``device``)."""
    res = fleet.resources()
    if policy == "mrsch":
        agent = agent or make_fleet_agent(fleet, device=device)
        return evaluate(agent, res, jobs)
    if policy == "fcfs":
        return run_trace(res, jobs, FCFSPolicy())
    if policy == "ga":
        return run_trace(res, jobs, GAOptimizer())
    raise ValueError(policy)


def main(argv=None) -> dict:
    """``python -m repro_torch.launch.scheduler [--jobs N] [--policy P]
    [--seed S] [--device cpu]``: prints the schedule's metrics row as one
    JSON line (and returns it)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=150)
    ap.add_argument("--policy", default="mrsch",
                    choices=["mrsch", "fcfs", "ga"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the agent's device (default: the card)")
    args = ap.parse_args(argv)
    fleet = FleetSpec()
    jobs = synth_fleet_trace(fleet, args.jobs, seed=args.seed + 1000)
    result = schedule_fleet(jobs, fleet, args.policy, device=args.device)
    row = {"policy": args.policy,
           **{k: round(v, 4) for k, v in result.metrics.as_row().items()}}
    print(json.dumps(row))
    return row


if __name__ == "__main__":
    main()
