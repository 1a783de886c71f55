"""Direct Future Prediction network (Dosovitskiy & Koltun '17) as adapted by
MRSch (paper §II-B, §III, §IV-C), for inference.

Three input modules:
  * state module   — MLP  state_dim -> 4000 -> 1000 -> 512 (leaky rectifier);
  * measurement    — 3 fully-connected layers of 128 units;
  * goal           — 3 fully-connected layers of 128 units.

The joint representation (concat, 768) feeds two parallel streams (dueling,
Wang et al.):
  * expectation stream E(j)            -> (T*M,)
  * action stream      A(j)            -> (A, T*M), normalized to zero mean
                                          across actions.
Prediction for action a:  p_a = E + (A_a - mean_a A)   reshaped (T, M).

Action scoring:  u(a) = sum_tau w_tau * sum_m g_m * p_a[tau, m]
with fixed temporal weights w and the dynamic goal vector g from Eq. (1).

The functions take the network (the weights) and a ``DFPConfig`` (the
shape contract and the backend) separately, as the JAX package's take
``params`` and ``cfg``, so one set of weights runs on either backend.
Only the "mlp" state module is ported; the CNN and attention variants,
and the training loss, are not yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from ..nn.backend import mlp_forward, resolve_backend
from ..nn.modules import MLP

STATE_MODULES = ("mlp",)


@dataclass(frozen=True)
class DFPConfig:
    state_dim: int
    n_measurements: int                       # M (one per resource)
    n_actions: int                            # A = window size W
    offsets: Tuple[int, ...] = (1, 2, 4, 8, 16, 32)
    temporal_weights: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.5, 0.5, 1.0)
    state_hidden: Tuple[int, ...] = (4000, 1000)   # paper §IV-C
    state_out: int = 512
    module_hidden: int = 128                  # measurement/goal modules
    stream_hidden: int = 512
    state_module: str = "mlp"
    backend: str = "kernel"                   # "torch" | "kernel"

    def __post_init__(self):
        resolve_backend(self.backend)
        if self.state_module not in STATE_MODULES:
            raise ValueError(f"state_module {self.state_module!r} is not "
                             f"ported; expected one of {STATE_MODULES}")

    @property
    def n_offsets(self) -> int:
        return len(self.offsets)

    @property
    def pred_dim(self) -> int:
        return self.n_offsets * self.n_measurements


class DFPNetwork(nn.Module):
    """The DFP weights: one ``MLP`` per module of the JAX parameter tree.

    The temporal weights of ``cfg`` are kept beside them as a buffer (not
    a parameter, not in the state dict), so scoring finds them on the
    network's device without a host-to-device copy per call.
    """

    def __init__(self, cfg: DFPConfig, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.temporal = tuple(cfg.temporal_weights)
        self.register_buffer(
            "temporal_weights",
            torch.tensor(cfg.temporal_weights, dtype=torch.float32,
                         device=device), persistent=False)
        kw = dict(generator=generator, device=device)
        h = cfg.module_hidden
        joint = cfg.state_out + 2 * h
        self.state = MLP([cfg.state_dim, *cfg.state_hidden, cfg.state_out],
                         **kw)
        self.measurement = MLP([cfg.n_measurements, h, h, h], **kw)
        self.goal = MLP([cfg.n_measurements, h, h, h], **kw)
        self.expectation = MLP([joint, cfg.stream_hidden, cfg.pred_dim], **kw)
        self.action = MLP([joint, cfg.stream_hidden,
                           cfg.n_actions * cfg.pred_dim], **kw)


@torch.no_grad()
def predict(net: DFPNetwork, cfg: DFPConfig, state: torch.Tensor,
            meas: torch.Tensor, goal: torch.Tensor) -> torch.Tensor:
    """state (B, state_dim), meas (B, M), goal (B, M)
    -> predictions (B, A, T, M): per-action future measurement deltas."""
    be = cfg.backend
    s = mlp_forward(net.state, state, final_activation="leaky_relu",
                    backend=be)
    m = mlp_forward(net.measurement, meas, final_activation="leaky_relu",
                    backend=be)
    g = mlp_forward(net.goal, goal, final_activation="leaky_relu", backend=be)
    j = torch.cat([s, m, g], dim=-1)
    e = mlp_forward(net.expectation, j, backend=be)                # (B, T*M)
    a = mlp_forward(net.action, j, backend=be)                     # (B, A*T*M)
    a = a.reshape(*a.shape[:-1], cfg.n_actions, cfg.pred_dim)
    a = a - a.mean(dim=-2, keepdim=True)                           # dueling norm
    p = e[..., None, :] + a                                        # (B, A, T*M)
    return p.reshape(*p.shape[:-1], cfg.n_offsets, cfg.n_measurements)


@torch.no_grad()
def action_values(net: DFPNetwork, cfg: DFPConfig, state: torch.Tensor,
                  meas: torch.Tensor, goal: torch.Tensor) -> torch.Tensor:
    """u(a) = sum_tau w_tau sum_m g_m * p[a, tau, m]   -> (B, A)."""
    if tuple(cfg.temporal_weights) != net.temporal:
        raise ValueError(f"cfg.temporal_weights {cfg.temporal_weights} differ "
                         f"from the network's {net.temporal}")
    p = predict(net, cfg, state, meas, goal)
    return torch.einsum("batm,t,bm->ba", p, net.temporal_weights.to(p.dtype),
                        goal)


@torch.no_grad()
def greedy_action(net: DFPNetwork, cfg: DFPConfig, state: torch.Tensor,
                  meas: torch.Tensor, goal: torch.Tensor,
                  valid_mask: torch.Tensor) -> torch.Tensor:
    """Argmax over valid window slots (invalid slots masked to -inf)."""
    u = action_values(net, cfg, state[None], meas[None], goal[None])[0]
    u = torch.where(valid_mask, u, -torch.inf)
    return torch.argmax(u)


@torch.no_grad()
def greedy_actions_packed(net: DFPNetwork, cfg: DFPConfig,
                          packed: torch.Tensor) -> torch.Tensor:
    """Batched greedy selection: ONE forward pass for N pending decisions.

    ``packed`` is one (N, state_dim + 2M + A) buffer with a row per
    decision, [state | meas | goal | valid].  One batched forward on both
    backends: ``action_values`` weights each row's prediction by that
    row's own goal, which is what the JAX package's per-row ``vmap``
    computes.  ``torch.argmax`` returns the first maximal index, as
    ``jnp.argmax`` does.
    """
    sd, m, a = cfg.state_dim, cfg.n_measurements, cfg.n_actions
    states = packed[:, :sd]
    meas = packed[:, sd:sd + m]
    goals = packed[:, sd + m:sd + 2 * m]
    masks = packed[:, sd + 2 * m:sd + 2 * m + a] > 0.5
    u = action_values(net, cfg, states.contiguous(), meas.contiguous(),
                      goals.contiguous())
    return torch.argmax(torch.where(masks, u, -torch.inf), dim=-1)
