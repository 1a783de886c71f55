"""Plain PyTorch version of the fused dense layer: the CPU path, and the
oracle the CUDA kernel is held against on the card."""
from __future__ import annotations

import torch

ACTIVATIONS = ("leaky_relu", "relu", "tanh", "linear")


def check_activation(activation: str) -> None:
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}; "
                         f"expected one of {ACTIVATIONS}")


def apply_activation(y: torch.Tensor, activation: str,
                     slope: float) -> torch.Tensor:
    """The kernel's epilogue activations, one dispatch table for both
    backends."""
    if activation == "leaky_relu":
        return torch.where(y >= 0, y, slope * y)
    if activation == "relu":
        return torch.clamp_min(y, 0.0)
    if activation == "tanh":
        return torch.tanh(y)
    check_activation(activation)
    return y                                            # linear


def fused_mlp_layer_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        activation: str = "leaky_relu",
                        slope: float = 0.2) -> torch.Tensor:
    """act(x @ w + b) computed in float32, returned in x's dtype."""
    y = x.float() @ w.float() + b.float()
    return apply_activation(y, activation, slope).to(x.dtype)
