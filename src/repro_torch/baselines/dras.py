"""DRAS-style hierarchical agent: window select + reserve/backfill head
(the JAX package's ``repro/baselines/dras.py``).

After *Deep Reinforcement Agent for Scheduling in HPC* (Fan & Lan et
al., arXiv:2102.06243): DRAS is a two-level neural network mirroring
the reserve/backfill structure of production schedulers — a first
level picks jobs from the queue window, a second level decides how
aggressively to backfill short jobs behind the current reservation.

Here both levels read the classic MRSch state vector: the select
network produces per-slot logits, and the backfill head produces one
gate in ``[0, 1]`` that scales a shortest-job-first bonus — a high
gate reproduces DRAS's backfill level favoring jobs that slip into
reservation shadows, a low gate degrades to the level-1 ordering.  An
FCFS positional prior anchors the untrained network (the CI tournament
runs untrained instances, exactly like the matrix's CI agent; the
paper-faithful comparison loads trained weights).

A ``score_window`` of torch ops on ``obs``'s device + fixed-seed
parameters (two ``MLP``s drawn by ``he_init`` from a ``torch.Generator``
seeded with ``config.seed``, on ``device``: the card unless
``device="cpu"`` is asked for) make the policy deterministic, batched,
and device-capable.  The networks run as plain PyTorch ops (the
reference's ``mlp_apply``), never the fused-MLP kernel.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..core.agent import resolve_device
from ..core.encoding import EncodingConfig, encode_state
from ..core.policy_api import WindowPolicy
from ..nn.backend import mlp_forward
from ..nn.modules import MLP
from ..sim.cluster import ResourceSpec
from ..sim.simulator import SchedContext


@dataclass(frozen=True)
class DRASConfig:
    window: int = 10
    hidden: Tuple[int, ...] = (64, 32)
    seed: int = 0
    net_scale: float = 0.1           # level-1 logits weight
    fcfs_weight: float = 0.05        # positional prior anchoring the ordering
    backfill_scale: float = 1.0      # SJF bonus reach of the level-2 gate


class DRASPolicy(WindowPolicy):
    """Two-level (select net + backfill-gate head) window scorer."""

    def __init__(self, resources: Sequence[ResourceSpec],
                 config: DRASConfig = DRASConfig(), *, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.enc = EncodingConfig(
            window=config.window,
            resource_names=tuple(r.name for r in resources),
            capacities=tuple(r.capacity for r in resources))
        kw = dict(generator=torch.Generator().manual_seed(config.seed),
                  device=self.device)
        sd = self.enc.state_dim
        self.params = nn.ModuleDict({
            "select": MLP([sd, *config.hidden, config.window], **kw),
            "gate": MLP([sd, config.hidden[-1], 1], **kw),
        })

    def init_state(self) -> nn.ModuleDict:
        return self.params

    def score_window(self, policy_state: nn.ModuleDict,
                     obs: torch.Tensor) -> torch.Tensor:
        cfg, enc = self.config, self.enc
        W, jd, R = enc.window, enc.job_dim, enc.n_resources
        state = obs[..., : enc.state_dim].contiguous()
        logits = mlp_forward(policy_state["select"], state,
                             backend="torch")                    # level 1
        gate = torch.sigmoid(mlp_forward(policy_state["gate"], state,
                                         backend="torch"))       # level 2
        tok = obs[..., : W * jd].reshape(*obs.shape[:-1], W, jd)
        wall = tok[..., R]                         # walltime / time_scale
        sjf = -wall * cfg.backfill_scale           # short jobs backfill first
        fcfs = -cfg.fcfs_weight * torch.arange(W, dtype=torch.float32,
                                               device=obs.device)
        return cfg.net_scale * logits + gate * sjf + fcfs

    def _encode_rows(self, ctxs: Sequence[SchedContext],
                     n_actions: int) -> np.ndarray:
        # Both levels consume the state section only.
        return np.stack([encode_state(self.enc, c) for c in ctxs])
