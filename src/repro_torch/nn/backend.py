"""Execution backend for dense/MLP layers.

Two backends run the same modules (switching never touches the weights),
and both are differentiable:

* ``"torch"``  — plain PyTorch ops (``Dense`` + activation), through
                 autograd; the counterpart of the JAX package's ``"xla"``;
* ``"kernel"`` — every layer runs through the fused matmul+bias+act
                 wrapper (``repro_torch.kernels.fused_mlp``), whose
                 gradient runs the dgrad and wgrad kernels: the CUDA
                 kernels for a tensor on the card, their plain versions
                 for a tensor on the CPU.  The counterpart of ``"pallas"``.

Activations are named (strings), not callables, so the kernel epilogue
can fuse them; ``None`` means linear.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels.fused_mlp.ops import fused_mlp
from ..kernels.fused_mlp.ref import apply_activation
from .modules import MLP, Dense

BACKENDS = ("torch", "kernel")


def resolve_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown nn backend {backend!r}; "
                         f"expected one of {BACKENDS}")
    return backend


def dense_forward(layer: Dense, x: torch.Tensor,
                  activation: Optional[str] = None, *, slope: float = 0.2,
                  backend: str = "kernel") -> torch.Tensor:
    """One dense layer + optional named activation on the given backend."""
    if resolve_backend(backend) == "kernel":
        return fused_mlp(x, layer.w, layer.b,
                         activation=activation or "linear", slope=slope)
    y = layer(x)
    return y if activation is None else apply_activation(y, activation, slope)


def mlp_forward(mlp: MLP, x: torch.Tensor,
                hidden_activation: str = "leaky_relu",
                final_activation: Optional[str] = None, *,
                slope: float = 0.2, backend: str = "kernel") -> torch.Tensor:
    """MLP forward with named activations, dispatched per backend."""
    n = len(mlp.layers)
    for i, layer in enumerate(mlp.layers):
        act = hidden_activation if i < n - 1 else final_activation
        x = dense_forward(layer, x, act, slope=slope, backend=backend)
    return x
