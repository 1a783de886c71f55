"""RL co-scheduler variant: score node-sharing pairs in the window (the
JAX package's ``repro/baselines/cosched.py``).

After *A HPC Co-Scheduler with Reinforcement Learning* (Souza,
Pelckmans, Tordsson, arXiv:2401.09706): the co-scheduler's core signal
is how well two jobs share the machine — pairs whose combined
multi-resource footprint packs tightly without oversubscription are
scheduled together.  Here every window slot is scored by its best
pairing partner: ``pair(i, j)`` rewards combined per-resource demand
approaching (but not exceeding) the full machine and penalizes
oversubscription, so a job complementary to another waiting job
outranks one that would strand capacity.  A fixed-seed network adds
the learned residual (untrained in CI, like the other RL entrants),
and waiting time plus an FCFS prior keep the ordering anchored.

A ``score_window`` of torch ops on ``obs``'s device over the classic
state layout: demand fractions for all W tokens are in the leading
section, so the W x W pair matrix is one broadcast — batched on
``VectorSimulator`` and device-capable.  The network (an ``MLP`` drawn by
``he_init`` from a ``torch.Generator`` seeded with ``config.seed``, on
``device``: the card unless ``device="cpu"`` is asked for) runs as plain
PyTorch ops (the reference's ``mlp_apply``), never the fused-MLP kernel.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from ..core.agent import resolve_device
from ..core.encoding import EncodingConfig, encode_state
from ..core.policy_api import WindowPolicy
from ..nn.backend import mlp_forward
from ..nn.modules import MLP
from ..sim.cluster import ResourceSpec
from ..sim.simulator import SchedContext


@dataclass(frozen=True)
class CoSchedConfig:
    window: int = 10
    hidden: Tuple[int, ...] = (64, 32)
    seed: int = 0
    pair_weight: float = 1.0         # co-scheduling complementarity weight
    over_penalty: float = 2.0        # oversubscribed pair penalty
    wait_weight: float = 0.5         # aging term (queued time, normalized)
    net_scale: float = 0.1           # learned residual weight
    fcfs_weight: float = 0.02


class CoSchedPolicy(WindowPolicy):
    """Best-pairing-partner window scorer with a learned residual."""

    def __init__(self, resources: Sequence[ResourceSpec],
                 config: CoSchedConfig = CoSchedConfig(), *, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.enc = EncodingConfig(
            window=config.window,
            resource_names=tuple(r.name for r in resources),
            capacities=tuple(r.capacity for r in resources))
        self.params = MLP(
            [self.enc.state_dim, *config.hidden, config.window],
            generator=torch.Generator().manual_seed(config.seed),
            device=self.device)

    def init_state(self) -> MLP:
        return self.params

    def score_window(self, policy_state: MLP,
                     obs: torch.Tensor) -> torch.Tensor:
        cfg, enc = self.config, self.enc
        W, jd, R = enc.window, enc.job_dim, enc.n_resources
        tok = obs[..., : W * jd].reshape(*obs.shape[:-1], W, jd)
        d = tok[..., :R]                               # (..., W, R) fractions
        queued = tok[..., R + 1]
        combined = d[..., :, None, :] + d[..., None, :, :]   # (..., W, W, R)
        packed = torch.clamp(combined, max=1.0).mean(-1)     # fill quality
        over = torch.clamp(combined - 1.0, min=0.0).sum(-1)  # oversubscription
        pair = packed - cfg.over_penalty * over
        # A slot may not pair with itself (its -inf never enters a sum:
        # W >= 2 leaves each row a finite maximum); empty slots (zero
        # demand) offer no pairing gain and are masked out by the engines
        # anyway.
        eye = torch.eye(W, dtype=torch.bool, device=obs.device)
        best_pair = pair.masked_fill(eye, -torch.inf).amax(-1)
        logits = mlp_forward(policy_state,
                             obs[..., : enc.state_dim].contiguous(),
                             backend="torch")
        fcfs = -cfg.fcfs_weight * torch.arange(W, dtype=torch.float32,
                                               device=obs.device)
        return (cfg.pair_weight * best_pair + cfg.wait_weight * queued
                + cfg.net_scale * logits + fcfs)

    def _encode_rows(self, ctxs: Sequence[SchedContext],
                     n_actions: int) -> np.ndarray:
        return np.stack([encode_state(self.enc, c) for c in ctxs])
