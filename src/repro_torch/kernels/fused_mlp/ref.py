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


def activation_grad(y: torch.Tensor, activation: str,
                    slope: float) -> torch.Tensor:
    """d act / d pre-activation, written in terms of the output ``y``:
    leaky_relu' = 1 at y >= 0 (else slope), relu' = 0 at y = 0,
    tanh' = 1 - y², linear' = 1 (the JAX package's ``_activation_grad``)."""
    if activation == "leaky_relu":
        return torch.where(y >= 0, 1.0, slope).to(y.dtype)
    if activation == "relu":
        return (y > 0).to(y.dtype)
    if activation == "tanh":
        return 1.0 - y * y
    check_activation(activation)
    return torch.ones_like(y)                           # linear


def fused_mlp_layer_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        activation: str = "leaky_relu",
                        slope: float = 0.2) -> torch.Tensor:
    """act(x @ w + b) computed in float32, returned in x's dtype."""
    y = x.float() @ w.float() + b.float()
    return apply_activation(y, activation, slope).to(x.dtype)


def scaled_grad_ref(g: torch.Tensor, y: torch.Tensor, activation: str,
                    slope: float) -> torch.Tensor:
    """g * act'(y) in float32: the operand both gradient kernels stage."""
    return g.float() * activation_grad(y.float(), activation, slope)


def fused_mlp_dgrad_ref(g: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                        activation: str = "leaky_relu",
                        slope: float = 0.2) -> torch.Tensor:
    """dx (M, K) = (g * act'(y)) @ w.T for g, y (M, N), w (K, N); computed
    in float32, returned in g's dtype."""
    return (scaled_grad_ref(g, y, activation, slope) @ w.float().T).to(g.dtype)


def fused_mlp_wgrad_ref(x: torch.Tensor, g: torch.Tensor, y: torch.Tensor,
                        activation: str = "leaky_relu",
                        slope: float = 0.2) -> tuple:
    """(dW (K, N) = x.T @ (g * act'(y)), db (N,) = sum over M of
    g * act'(y)) for x (M, K), g, y (M, N); computed in float32, returned
    in x's dtype."""
    gm = scaled_grad_ref(g, y, activation, slope)
    return (x.float().T @ gm).to(x.dtype), gm.sum(0).to(x.dtype)
