"""The MRSch scheduling agent (paper §III), in evaluation mode.

Wraps the DFP network with the vector state encoding and the Eq. (1)
dynamic goal vector, and implements the simulator's ``SchedulingPolicy``
protocol with greedy decisions, and the device stages of the ``Policy``
protocol (``init_state``/``score_window``) that the device rollout
engine scores with.  Exploration, the replay buffer and Adam
training are not ported yet.  ``save``/``load`` read and write the JAX
package's ``.npz`` format, so a file saved by either package loads in the
other.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Sequence, Tuple

import numpy as np
import torch

from ..convert import load_npz, save_npz
from ..nn.backend import resolve_backend
from ..sim.cluster import ResourceSpec
from ..sim.simulator import SchedContext
from .dfp import DFPConfig, DFPNetwork, action_values, greedy_actions_packed
from .encoding import (EncodingConfig, decision_row_dim, encode_decision_row,
                       encode_measurement, encode_state, pad_decision_rows)
from .goal import ctx_goal


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; the CPU only when the caller asks for it."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run on the CPU")
    return device


@dataclass(frozen=True)
class AgentConfig:
    window: int = 10
    offsets: Tuple[int, ...] = (1, 2, 4, 8, 16, 32)
    temporal_weights: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.5, 0.5, 1.0)
    state_module: str = "mlp"
    backend: str = "kernel"           # "torch" | "kernel" (fused-MLP kernel)
    state_hidden: Tuple[int, ...] = (4000, 1000)
    state_out: int = 512
    module_hidden: int = 128
    stream_hidden: int = 512
    seed: int = 0


class MRSchAgent:
    """DFP-based multi-resource scheduling agent (greedy decisions)."""

    def __init__(self, resources: Sequence[ResourceSpec],
                 config: AgentConfig = AgentConfig(), *, device=None):
        self.resources = list(resources)
        self.config = config
        self.device = resolve_device(device)
        names = tuple(r.name for r in self.resources)
        caps = tuple(r.capacity for r in self.resources)
        self.enc = EncodingConfig(window=config.window, resource_names=names,
                                  capacities=caps)
        self.dfp = DFPConfig(
            state_dim=self.enc.state_dim,
            n_measurements=len(names),
            n_actions=config.window,
            offsets=config.offsets,
            temporal_weights=config.temporal_weights,
            state_module=config.state_module,
            backend=config.backend,
            state_hidden=config.state_hidden,
            state_out=config.state_out,
            module_hidden=config.module_hidden,
            stream_hidden=config.stream_hidden,
        )
        gen = torch.Generator().manual_seed(config.seed)
        self.net = DFPNetwork(self.dfp, generator=gen, device=self.device)
        self.epsilon = 0.0

    def set_backend(self, backend: str) -> None:
        """Switch the NN execution backend ("torch" | "kernel") in place;
        the weights are the same on both."""
        self.dfp = replace(self.dfp, backend=resolve_backend(backend))
        self.config = replace(self.config, backend=backend)

    # ------------------------------------------------------ Policy protocol
    # Device-side stages (repro_torch.core.policy_api): the device rollout
    # engine calls ``score_window`` on rows it builds on the card; the
    # host stages below (``select`` / ``select_batch``) are unchanged.
    requires_obs = True

    def init_state(self) -> DFPNetwork:
        """Policy state for the device rollout: the network."""
        return self.net

    def score_window(self, net: DFPNetwork, obs: torch.Tensor) -> torch.Tensor:
        """Action values from packed decision rows (reference:
        ``MRSchAgent.score_window``).

        ``obs`` rows follow ``encoding.encode_decision_row``; the valid
        mask is applied by the engine, not here.
        """
        sd, m = self.enc.state_dim, self.enc.n_resources
        return action_values(net, self.dfp, obs[:, :sd].contiguous(),
                             obs[:, sd:sd + m].contiguous(),
                             obs[:, sd + m:sd + 2 * m].contiguous())

    # ---------------------------------------------------------------- policy
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def select(self, ctx: SchedContext) -> int:
        state = encode_state(self.enc, ctx)
        meas = encode_measurement(self.enc, ctx)
        goal = ctx_goal(ctx, self.enc.resource_names)
        n_valid = min(len(ctx.window), self.config.window)
        u = action_values(self.net, self.dfp, self._tensor(state)[None],
                          self._tensor(meas)[None], self._tensor(goal)[None])
        u = u[0].cpu().numpy()
        u[n_valid:] = -np.inf
        return int(np.argmax(u))

    def select_batch(self, ctxs: Sequence[SchedContext]) -> np.ndarray:
        """Greedy actions for N pending decisions with ONE forward."""
        feats = np.zeros((len(ctxs), decision_row_dim(self.enc,
                                                      self.config.window)),
                         dtype=np.float32)
        for i, c in enumerate(ctxs):
            encode_decision_row(self.enc, c, self.config.window, out=feats[i])
        return self._greedy_rows(feats)

    def _greedy_rows(self, rows: np.ndarray) -> np.ndarray:
        """One forward over packed decision rows -> greedy actions.  Width
        is padded up to a power of two, as the JAX package pads it for its
        jit cache; padded rows are valid everywhere and their actions are
        discarded."""
        n = rows.shape[0]
        width = 1 << max(n - 1, 0).bit_length()
        packed = pad_decision_rows(rows, width, self.enc)
        acts = greedy_actions_packed(self.net, self.dfp, self._tensor(packed))
        return acts.cpu().numpy()[:n].astype(np.int32)

    # ---------------------------------------------------------------- io
    def save(self, path: str) -> None:
        save_npz(path, self.net, epsilon=self.epsilon)

    def load(self, path: str) -> None:
        """Restore ``save``d weights (from either package), raising
        ``ValueError`` on a leaf count, shape or dtype mismatch."""
        self.epsilon = load_npz(path, self.net)
