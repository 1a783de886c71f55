"""Mixture-of-Experts on one card (the JAX package's ``models/moe.py``).

``moe_apply`` is the reference's path without a mesh: every token picks
its ``top_k`` experts by a float32 router, each expert takes at most
``capacity`` tokens (``_default_capacity``), and the choices past it are
dropped; the kept rows are scattered into an (E, C, D) buffer, the
experts' FFNs run as batched products over it (plain ``torch.bmm``, as
the reference computes them in plain XLA outside any Pallas kernel), and
each token's rows are gathered back and summed with their gates.  Shared
experts run densely on every token.

Which choices are dropped follows the reference exactly: a choice's
position within its expert is its rank in the stable sort of the flat
(token * k + j) choice list (``_positions_in_expert``).  The scatter and
the gather go through one spare row past the buffer, where dropped
choices land and which reads back as 0, so neither needs the host.

Not here: the reference's multi-card paths, the small-T decode layout
(``_moe_small_t``) and the ``shard_map`` expert parallelism; they come
with the distribution item of the roadmap's module queue.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..configs.base import MoEConfig
from .layers import FFN, _act, _normal, empty_param, ffn_apply


class MoE(nn.Module):
    """The reference's leaves: ``router`` (D, E) in float32 whatever the
    model's dtype; ``w_up``, ``w_down`` and, with GLU, ``w_gate`` stacked
    (E, in, out); ``shared``, an FFN of width ``d_shared_expert`` or
    ``d_expert * n_shared``."""

    def __init__(self, d_model: int, cfg: MoEConfig, glu: bool, dtype,
                 device=None):
        super().__init__()
        E, Fe = cfg.n_routed, cfg.d_expert
        kw = dict(dtype=dtype, device=device)
        self.router = empty_param(d_model, E, dtype=torch.float32,
                                  device=device)
        self.w_up = empty_param(E, d_model, Fe, **kw)
        self.w_down = empty_param(E, Fe, d_model, **kw)
        self.w_gate: Optional[nn.Parameter] = (
            empty_param(E, d_model, Fe, **kw) if glu else None)
        if cfg.n_shared:
            shared_f = cfg.d_shared_expert or cfg.d_expert * cfg.n_shared
            self.shared = FFN(d_model, shared_f, glu, dtype, device)

    def reset_parameters(self, generator=None) -> None:
        """Each matrix normal / sqrt(its in dim): the router's (D, E) and
        every expert's (the FFN resets itself)."""
        for p in (self.router, self.w_up, self.w_down, self.w_gate):
            if p is not None:
                std = 1.0 / math.sqrt(p.shape[-2])
                p.copy_(_normal(p.shape, generator, p.device) * std)


def moe_init(d_model: int, cfg: MoEConfig, glu: bool, dtype, *, generator,
             device=None) -> MoE:
    m = MoE(d_model, cfg, glu, dtype, device)
    for sub in m.modules():
        sub.reset_parameters(generator)
    return m


def _positions_in_expert(idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """idx (T, k) -> each choice's position within its expert (T, k): its
    rank among the choices of that expert in flat (t * k + j) order, by a
    stable sort."""
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    sorted_e = flat[order]
    starts = torch.searchsorted(
        sorted_e, torch.arange(n_experts, device=idx.device,
                               dtype=sorted_e.dtype), side="left")
    pos_sorted = torch.arange(flat.numel(), device=idx.device) \
        - starts[sorted_e]
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    return pos.reshape(idx.shape)


def route(router_w: torch.Tensor, x: torch.Tensor, cfg: MoEConfig
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, D) -> (gates (T, k) float32, experts (T, k) int64): softmax
    of the float32 logits, its top k (largest first), the gates
    renormalised to sum 1 (floored at 1e-9)."""
    probs = torch.softmax(x.float() @ router_w, dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return gates, idx


def _expert_ffn(buf, w_gate, w_up, w_down, act: str, glu: bool):
    """buf (E, C, D) through each expert's FFN -> (E, C, D)."""
    up = torch.bmm(buf, w_up)
    h = _act(act)(torch.bmm(buf, w_gate)) * up if glu else _act(act)(up)
    return torch.bmm(h, w_down)


def _moe_local(x, params: MoE, cfg: MoEConfig, act: str, glu: bool,
               capacity: int) -> torch.Tensor:
    """Routed experts over x (T, D) with every expert on this card."""
    T, D = x.shape
    E, K = cfg.n_routed, cfg.top_k
    gates, idx = route(params.router, x, cfg)
    pos = _positions_in_expert(idx, E)
    keep = pos < capacity
    # Row e * C + pos of the buffer; dropped choices go to the spare row.
    dest = torch.where(keep, idx * capacity + pos, E * capacity).reshape(-1)
    buf = torch.zeros(E * capacity + 1, D, dtype=x.dtype, device=x.device)
    buf.index_copy_(0, dest, x[:, None].expand(T, K, D).reshape(T * K, D))
    out = _expert_ffn(buf[:-1].view(E, capacity, D), params.w_gate,
                      params.w_up, params.w_down, act, glu)
    out = torch.cat([out.reshape(E * capacity, D),
                     out.new_zeros(1, D)])                # the spare row: 0
    y = out[dest].reshape(T, K, D)
    w = (gates * keep)[..., None].to(y.dtype)
    return (y * w).sum(dim=1)


def _default_capacity(T: int, cfg: MoEConfig) -> int:
    return max(int(math.ceil(T * cfg.top_k / cfg.n_routed
                             * cfg.capacity_factor)), cfg.top_k)


def moe_apply(params: MoE, x: torch.Tensor, cfg: MoEConfig, act: str,
              glu: bool) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D): routed experts at the default capacity
    of B * S tokens, plus the shared experts."""
    B, S, D = x.shape
    y = _moe_local(x.reshape(-1, D), params, cfg, act, glu,
                   _default_capacity(B * S, cfg)).reshape(B, S, D)
    if cfg.n_shared:
        y = y + ffn_apply(params.shared, x, act, glu)
    return y


def load_balance_loss(router_w: torch.Tensor, x_flat: torch.Tensor,
                      cfg: MoEConfig) -> torch.Tensor:
    """Switch-style auxiliary loss: n_routed * sum(f * P), f the share of
    top-k choices and P the mean router probability of each expert."""
    probs = torch.softmax(x_flat.float() @ router_w, dim=-1)
    _, idx = torch.topk(probs, cfg.top_k, dim=-1)
    onehot = torch.nn.functional.one_hot(idx, cfg.n_routed).sum(-2).float()
    f = onehot.reshape(-1, cfg.n_routed).mean(dim=0)
    p = probs.reshape(-1, cfg.n_routed).mean(dim=0)
    return cfg.n_routed * torch.sum(f * p)
