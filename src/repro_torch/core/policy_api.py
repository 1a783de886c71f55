"""The ``Policy`` protocol shared by the rollout engines (the JAX
package's ``repro/core/policy_api.py``).

``init_state()``
    Return the policy's device-side state (the network for NN policies,
    ``None`` for stateless ones).  Pure read — calling it never mutates
    the policy.

``score_window(policy_state, obs)``
    Scoring of a batch of decisions from torch tensors: ``obs`` is either
    a batch of packed decision rows ``[state | meas | goal | valid]``
    (``encoding.encode_decision_row`` layout) when the policy sets
    ``requires_obs = True``, or just the ``(B, W)`` window-valid mask when
    it does not need observations.  Returns ``(B, A)`` scores on ``obs``'s
    device; the engine masks invalid slots and takes the argmax.  The same
    function serves the device rollout (``repro_torch.sim.device``) and
    the host batched stage below.

``select(ctx)``
    The host-side single-decision stage (``SchedulingPolicy`` in
    ``repro_torch.sim.simulator``).

``WindowPolicy`` derives the host batched stage (``select_batch``) from
a mask-only ``score_window``.  Policies with host-only state declare
``score_window = None``; the device engine refuses them.
"""
from __future__ import annotations

from typing import Protocol, Sequence, runtime_checkable

import numpy as np
import torch

from ..sim.simulator import SchedContext


@runtime_checkable
class Policy(Protocol):
    """One policy, three engine-facing stages (see module docstring)."""

    def select(self, ctx: SchedContext) -> int:
        """Host stage: index into ``ctx.window`` for one decision."""
        ...

    def init_state(self):
        """Device stage: the policy state handed to ``score_window``."""
        ...

    def score_window(self, policy_state, obs: torch.Tensor) -> torch.Tensor:
        """Device stage: ``(B, obs)`` -> ``(B, A)`` slot scores."""
        ...


def supports_batch(policy) -> bool:
    """True when the engines may batch this policy's decisions."""
    return callable(getattr(policy, "select_batch", None))


def supports_device(policy) -> bool:
    """True when the policy can run inside the device rollout."""
    return (callable(getattr(policy, "score_window", None))
            and callable(getattr(policy, "init_state", None)))


class WindowPolicy:
    """Base class deriving the host batched stage from ``score_window``
    for policies that score from the window-valid mask alone
    (``requires_obs = False``: FCFS-style static preferences, no encoding
    work).  Policies that score packed decision rows, such as
    ``MRSchAgent``, bring their own host stages.
    """

    requires_obs: bool = False

    # ------------------------------------------------------- device stages
    def init_state(self):
        return None

    def score_window(self, policy_state, obs: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    # --------------------------------------------------------- host stages
    def select(self, ctx: SchedContext) -> int:
        return int(self.select_batch([ctx])[0])

    def select_batch(self, ctxs: Sequence[SchedContext]) -> np.ndarray:
        """One ``score_window`` call for N contexts -> greedy actions."""
        n_actions = max(len(c.window) for c in ctxs)
        mask = np.zeros((len(ctxs), n_actions), bool)
        for i, c in enumerate(ctxs):
            mask[i, :len(c.window)] = True
        with torch.no_grad():
            obs = torch.from_numpy(mask.astype(np.float32))
            scores = self.score_window(self.init_state(), obs)
        scores = np.where(mask, scores.cpu().numpy(), -np.inf)
        return np.argmax(scores, axis=1).astype(np.int32)
