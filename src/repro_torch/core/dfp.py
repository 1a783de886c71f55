"""Direct Future Prediction network (Dosovitskiy & Koltun '17) as adapted by
MRSch (paper §II-B, §III, §IV-C), and its training loss.

Three input modules:
  * state module   — MLP  state_dim -> 4000 -> 1000 -> 512 (leaky rectifier),
                     the queue-as-tokens attention encoder
                     (``repro_torch.nn.queue_encoder``) over the attention
                     state layout, or the Fig. 3 ablation's CNN (1-D convs
                     over the classic state vector, then a projection);
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
The inference functions run under ``torch.no_grad()``; ``loss_fn`` runs
the same forward body with autograd on.  The CNN state module's convs and
projection run as plain PyTorch ops on both backends, as the reference
keeps them on plain XLA ops; its heads follow the backend.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from ..kernels.fused_mlp.ref import apply_activation
from ..nn.backend import mlp_forward, resolve_backend
from ..nn.modules import MLP, Conv1d, Dense, conv1d_apply
from ..nn.queue_encoder import (QueueEncoder, QueueEncoderConfig,
                                queue_state_features)

STATE_MODULES = ("mlp", "cnn", "attention")


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
    state_module: str = "mlp"                 # "mlp" | "cnn" (Fig. 3 ablation)
    #                                           | "attention" (queue encoder)
    cnn_channels: Tuple[int, ...] = (8, 16)
    cnn_width: int = 9
    cnn_stride: int = 4
    # Queue-as-tokens attention state module (repro_torch.nn.queue_encoder),
    # read only when state_module == "attention".
    attn_queue: int = 128                     # Q: job-token buffer size
    attn_dim: int = 64                        # d_model
    attn_heads: int = 4
    attn_layers: int = 2
    attn_mlp_mult: int = 2
    backend: str = "kernel"                   # "torch" | "kernel"

    def __post_init__(self):
        resolve_backend(self.backend)
        if self.state_module not in STATE_MODULES:
            raise ValueError(f"unknown state_module {self.state_module!r}; "
                             f"expected one of {STATE_MODULES}")
        if self.state_module == "attention":
            expect = (self.attn_queue * (self.n_measurements + 2) + 1
                      + 2 * self.n_measurements)
            if self.state_dim != expect:
                raise ValueError(
                    f"attention state_dim mismatch: got {self.state_dim}, "
                    f"layout Q*(M+2)+1+2M = {expect} for "
                    f"attn_queue={self.attn_queue} M={self.n_measurements}")

    @property
    def n_offsets(self) -> int:
        return len(self.offsets)

    @property
    def pred_dim(self) -> int:
        return self.n_offsets * self.n_measurements

    @property
    def queue_encoder(self) -> QueueEncoderConfig:
        """Encoder architecture derived from the DFP shape contract."""
        return QueueEncoderConfig(
            queue_cap=self.attn_queue,
            job_dim=self.n_measurements + 2,
            ctx_dim=2 * self.n_measurements,
            window=self.n_actions,
            d_model=self.attn_dim,
            n_heads=self.attn_heads,
            n_layers=self.attn_layers,
            mlp_mult=self.attn_mlp_mult,
            out_dim=self.state_out,
        )


class CNNState(nn.Module):
    """The CNN ablation's state module: ``convs`` (stride ``cnn_stride``,
    SAME padding) over the state vector as one channel, then ``proj`` from
    the flattened (position-major) features to ``state_out``; the JAX
    tree's ``{"convs": [...], "proj": {...}}``."""

    def __init__(self, cfg: "DFPConfig", **kw):
        super().__init__()
        convs, in_ch, length = [], 1, cfg.state_dim
        for ch in cfg.cnn_channels:
            convs.append(Conv1d(in_ch, ch, cfg.cnn_width, **kw))
            in_ch = ch
            length = -(-length // cfg.cnn_stride)
        self.convs = nn.ModuleList(convs)
        self.proj = Dense(length * in_ch, cfg.state_out, **kw)


def _cnn_features(state_net: CNNState, cfg: "DFPConfig",
                  state: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch on both backends (the reference: "CNN ablation stays
    on plain XLA ops")."""
    x = state[..., :, None]                                        # (B, L, 1)
    for conv in state_net.convs:
        x = apply_activation(conv1d_apply(conv, x, stride=cfg.cnn_stride),
                             "leaky_relu", 0.2)                    # (B, L', C)
    x = x.reshape(*x.shape[:-2], -1)              # position-major, as JAX
    return apply_activation(state_net.proj(x), "leaky_relu", 0.2)


class DFPNetwork(nn.Module):
    """The DFP weights: one module per module of the JAX parameter tree
(``MLP``s; a ``QueueEncoder`` for the attention state module, a
``CNNState`` for the CNN one).

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
        if cfg.state_module == "attention":
            self.state = QueueEncoder(cfg.queue_encoder, **kw)
        elif cfg.state_module == "cnn":
            self.state = CNNState(cfg, **kw)
        else:
            self.state = MLP([cfg.state_dim, *cfg.state_hidden,
                              cfg.state_out], **kw)
        self.measurement = MLP([cfg.n_measurements, h, h, h], **kw)
        self.goal = MLP([cfg.n_measurements, h, h, h], **kw)
        self.expectation = MLP([joint, cfg.stream_hidden, cfg.pred_dim], **kw)
        self.action = MLP([joint, cfg.stream_hidden,
                           cfg.n_actions * cfg.pred_dim], **kw)


def _predict(net: DFPNetwork, cfg: DFPConfig, state: torch.Tensor,
             meas: torch.Tensor, goal: torch.Tensor) -> torch.Tensor:
    """The forward body shared by ``predict`` and ``loss_fn``."""
    be = cfg.backend
    if cfg.state_module == "attention":
        s = queue_state_features(net.state, cfg.queue_encoder, state,
                                 backend=be)
    elif cfg.state_module == "cnn":
        s = _cnn_features(net.state, cfg, state)
    else:
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
def predict(net: DFPNetwork, cfg: DFPConfig, state: torch.Tensor,
            meas: torch.Tensor, goal: torch.Tensor) -> torch.Tensor:
    """state (B, state_dim), meas (B, M), goal (B, M)
    -> predictions (B, A, T, M): per-action future measurement deltas."""
    return _predict(net, cfg, state, meas, goal)


def loss_fn(net: DFPNetwork, cfg: DFPConfig, batch) -> torch.Tensor:
    """MSE between the taken action's predicted and realised future deltas.

    ``batch``: tensors state (B, S), meas (B, M), goal (B, M), action (B,),
    target (B, T, M) and target_mask (B, T); the mask drops offsets past
    the episode's end.  The sum of squared errors over the kept entries,
    over ``max(mask.sum() * M, 1)``.
    """
    p = _predict(net, cfg, batch["state"], batch["meas"], batch["goal"])
    rows = torch.arange(p.shape[0], device=p.device)
    taken = p[rows, batch["action"].long()]                        # (B, T, M)
    err = (taken - batch["target"]) ** 2
    mask = batch["target_mask"][..., None]
    return (err * mask).sum() / torch.clamp_min(
        mask.sum() * cfg.n_measurements, 1.0)


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
