"""Comparison scheduling policies (paper §IV-D), the JAX package's
``repro/core/policies.py``.  Ported so far: FCFS.  The GA optimizer and
the scalar-reward RL policy come with the evaluation slice."""
from __future__ import annotations

import torch

from ..sim.simulator import SchedContext
from .policy_api import WindowPolicy


class FCFSPolicy(WindowPolicy):
    """Head-of-queue list scheduling.

    Expressed through the ``Policy`` protocol as a static slot
    preference over the window-valid mask: earlier window slots score
    higher, so the masked argmax always lands on the head.  ``select`` keeps the trivial host fast
    path (identical result, no tensor round trip per decision).
    """

    requires_obs = False      # scores need only the window-valid mask

    def select(self, ctx: SchedContext) -> int:
        return 0

    def score_window(self, policy_state, obs: torch.Tensor) -> torch.Tensor:
        return -torch.arange(obs.shape[-1], dtype=torch.float32,
                             device=obs.device).expand(obs.shape)
