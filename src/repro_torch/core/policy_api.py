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
``score_window``, so a policy written for the device engine drives the
lockstep engine with no adapter.  Policies with host-only state declare
``score_window = None``; the device engine refuses them.
"""
from __future__ import annotations

from typing import Optional, Protocol, Sequence, runtime_checkable

import numpy as np
import torch

from ..sim.simulator import SchedContext
from .encoding import EncodingConfig, decision_row_dim, encode_decision_row


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
    """Base class deriving the host batched stage from ``score_window``.

    Subclasses implement ``score_window`` (torch ops on ``obs``'s device)
    and set:

    ``requires_obs``
        ``True`` (default) — the engines build packed decision rows for
        ``obs``; the subclass must provide ``enc`` (an
        ``EncodingConfig``) fixing the row layout.
        ``False`` — the policy scores from the window-valid mask alone
        (FCFS-style static preferences); no encoding work is done.

    ``training`` — when True the derived ``select_batch`` refuses to
        run: training trajectories are policy-specific (episode buffers,
        exploration RNG order) and must go through the policy's own
        ``select``/``select_batch`` implementation.

    The host stage builds ``obs`` on the host and copies it to the device
    of the policy's network when ``init_state()`` is one (CPU tensors
    otherwise); the device engine hands ``score_window`` its rows on its
    own device.
    """

    requires_obs: bool = True
    enc: Optional[EncodingConfig] = None
    training: bool = False

    # ------------------------------------------------------- device stages
    def init_state(self):
        return None

    def score_window(self, policy_state, obs: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    # --------------------------------------------------------- host stages
    def _encode_rows(self, ctxs: Sequence[SchedContext],
                     n_actions: int) -> np.ndarray:
        """Packed decision rows for the host batched stage.

        Subclasses that only consume the state section may override this
        to skip the measurement/goal encoding work.
        """
        assert self.enc is not None, \
            f"{type(self).__name__}.requires_obs needs an EncodingConfig"
        rows = np.zeros((len(ctxs), decision_row_dim(self.enc, n_actions)),
                        dtype=np.float32)
        for i, c in enumerate(ctxs):
            encode_decision_row(self.enc, c, n_actions, out=rows[i])
        return rows

    def select(self, ctx: SchedContext) -> int:
        return int(self.select_batch([ctx])[0])

    def select_batch(self, ctxs: Sequence[SchedContext]) -> np.ndarray:
        """One ``score_window`` call for N contexts -> greedy actions."""
        if self.training:
            raise RuntimeError(
                f"{type(self).__name__}.select_batch is evaluation-only: "
                "training records a policy-specific trajectory — run "
                "training through the policy's own select path")
        n_actions = self._n_actions(ctxs)
        mask = np.zeros((len(ctxs), n_actions), bool)
        for i, c in enumerate(ctxs):
            mask[i, :min(len(c.window), n_actions)] = True
        if self.requires_obs:
            obs = self._encode_rows(ctxs, n_actions)
        else:
            obs = mask.astype(np.float32)
        state = self.init_state()
        obs = torch.from_numpy(obs)
        if isinstance(state, torch.nn.Module):
            # Score where the network lives (the card unless the policy
            # was built on the CPU).
            obs = obs.to(next(state.parameters()).device)
        with torch.no_grad():
            scores = self.score_window(state, obs)
        scores = np.where(mask, scores.cpu().numpy(), -np.inf)
        return np.argmax(scores, axis=1).astype(np.int32)

    def _n_actions(self, ctxs: Sequence[SchedContext]) -> int:
        if self.enc is not None:
            return self.enc.window
        return max(len(c.window) for c in ctxs)
