"""Dense layers and MLPs as ``nn.Module``s, with He initialisation.

A dense layer keeps the JAX package's weight layout ``w: (in, out)``
(``repro/nn/modules.py``), stored as an ``nn.Parameter`` of that shape and
not as ``nn.Linear.weight`` (out, in), for two reasons: the fused kernel
reads W with the output dimension contiguous, which gives coalesced loads
at a skinny batch, and carrying weights across from the JAX package stays
a plain copy.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn


def he_init(shape: Sequence[int], *, generator: Optional[torch.Generator],
            device=None, dtype=torch.float32) -> torch.Tensor:
    """Normal(0, 2 / fan_in), drawn on the CPU from ``generator`` so one
    seed gives the same weights on every device."""
    fan_in = shape[0] if len(shape) == 2 else math.prod(shape[:-1])
    std = math.sqrt(2.0 / fan_in)
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32)
    return (w * std).to(device=device, dtype=dtype)


class Dense(nn.Module):
    """x @ w + b with w (in, out): see the module docstring for the layout."""

    def __init__(self, in_dim: int, out_dim: int, *,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.w = nn.Parameter(he_init((in_dim, out_dim), generator=generator,
                                      device=device, dtype=dtype))
        self.b = nn.Parameter(torch.zeros(out_dim, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class MLP(nn.Module):
    """sizes = [in, h1, ..., out]: ``layers`` holds one Dense per step,
    as the JAX package's ``{'layers': [{'w', 'b'}, ...]}``."""

    def __init__(self, sizes: Sequence[int], *,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.layers = nn.ModuleList(
            Dense(sizes[i], sizes[i + 1], generator=generator, device=device,
                  dtype=dtype)
            for i in range(len(sizes) - 1))


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
