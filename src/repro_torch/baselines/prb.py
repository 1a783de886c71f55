"""Priority Rules Based (PRB) dispatcher with EWT priorities (the JAX
package's ``repro/baselines/prb.py``).

After accasim's PRB scheduler (SNIPPETS.md snippet 1; Borghesi,
Collina, Lombardi, Milano, Benini, *Power Capping in High Performance
Computing Systems*, CP 2015): each queued job carries an Estimated
Waiting Time derived from its request class, and its dispatch priority
is the elapsed wait normalized by that EWT — jobs that have waited
longer than their class predicts float to the front, while wide/long
requests (whose classes expect long waits) cannot starve narrow ones.

The EWT model is the linear request-class proxy used throughout that
line of work: ``EWT = base + a * walltime + b * sum_r demand_frac_r``
(bigger asks expect to wait longer).  Reservation + EASY backfilling
come from the simulator, as for every policy in the zoo — PRB only
changes the selection order.

Expressed as a ``score_window`` of torch ops over the classic state
layout (``repro_torch.core.encoding``), run on ``obs``'s device: each
window token already carries ``[P_1..P_R, walltime_norm, queued_norm]``,
which is everything the priority needs, so the policy batches on
``VectorSimulator`` and is device-capable with no parameters and no host
state.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..core.encoding import EncodingConfig, encode_state
from ..core.policy_api import WindowPolicy
from ..sim.cluster import ResourceSpec
from ..sim.simulator import SchedContext


@dataclass(frozen=True)
class PRBConfig:
    window: int = 10
    base_ewt_s: float = 3600.0       # class EWT floor (1 h)
    walltime_factor: float = 0.5     # EWT seconds per requested walltime second
    demand_factor: float = 4.0       # EWT hours per unit of summed demand frac
    min_wait_s: float = 60.0         # wait floor so fresh jobs still rank


class PRBPolicy(WindowPolicy):
    """EWT-normalized priority selection over the window."""

    def __init__(self, resources: Sequence[ResourceSpec],
                 config: PRBConfig = PRBConfig()):
        self.config = config
        self.enc = EncodingConfig(
            window=config.window,
            resource_names=tuple(r.name for r in resources),
            capacities=tuple(r.capacity for r in resources))

    def score_window(self, policy_state, obs: torch.Tensor) -> torch.Tensor:
        cfg, enc = self.config, self.enc
        W, jd, R = enc.window, enc.job_dim, enc.n_resources
        tok = obs[..., : W * jd].reshape(*obs.shape[:-1], W, jd)
        demand = tok[..., :R].sum(-1)                  # summed demand fraction
        wall = tok[..., R]                             # walltime / time_scale
        queued = tok[..., R + 1]                       # wait / time_scale
        ts = enc.time_scale
        ewt = (cfg.base_ewt_s / ts
               + cfg.walltime_factor * wall
               + cfg.demand_factor * 3600.0 / ts * demand)
        prio = (queued + cfg.min_wait_s / ts) / ewt
        # FCFS tiebreak: equal priorities resolve in queue order.
        return prio - 1e-6 * torch.arange(W, dtype=torch.float32,
                                          device=obs.device)

    def _encode_rows(self, ctxs: Sequence[SchedContext],
                     n_actions: int) -> np.ndarray:
        # Only the window tokens feed the priority; skip meas/goal work.
        return np.stack([encode_state(self.enc, c) for c in ctxs])
