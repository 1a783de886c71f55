"""Dense layers, MLPs and the CNN ablation's 1-D convolution as
``nn.Module``s, with He initialisation.

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
import torch.nn.functional as F
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


class Conv1d(nn.Module):
    """A 1-D convolution (the JAX package's ``conv1d_init``) with its leaf
    layout, ``w: (width, in, out)`` and ``b: (out,)``, so carrying weights
    across stays a copy; ``conv1d_apply`` runs it."""

    def __init__(self, in_ch: int, out_ch: int, width: int, *,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.w = nn.Parameter(he_init((width, in_ch, out_ch),
                                      generator=generator, device=device,
                                      dtype=dtype))
        self.b = nn.Parameter(torch.zeros(out_ch, device=device, dtype=dtype))


def conv1d_apply(conv: Conv1d, x: torch.Tensor,
                 stride: int = 1) -> torch.Tensor:
    """x: (..., length, channels) -> (..., ceil(length / stride),
    out_channels), as ``lax.conv_general_dilated`` with ``padding="SAME"``
    pads: ``(ceil(L / s) - 1) * s + width - L`` zeros in all (none if that
    is negative), half of them (rounded down) before and the rest after.
    ``F.conv1d`` takes no "same" padding at a stride above 1, so the pad is
    explicit.  Neither flips the kernel.  The bias is added after the
    convolution, as the reference adds it.

    On the card this runs cuDNN, whose float32 convolutions may use TF32
    unless ``torch.backends.cudnn.allow_tf32`` is False (its default is
    True); a comparison with a float32 reference sets it False.
    """
    width = conv.w.shape[0]
    lead, length = x.shape[:-2], x.shape[-2]
    out_len = -(-length // stride)
    total = max((out_len - 1) * stride + width - length, 0)
    xt = x.reshape(-1, length, x.shape[-1]).transpose(1, 2)   # (B, C, L)
    xt = F.pad(xt, (total // 2, total - total // 2))
    y = F.conv1d(xt, conv.w.permute(2, 1, 0), stride=stride)  # (B, O, L')
    return (y.transpose(1, 2) + conv.b).reshape(*lead, out_len, -1)


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
