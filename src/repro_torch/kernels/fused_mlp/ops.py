"""Public wrappers of the fused dense layer: ``fused_mlp(x, w, b)``, which
is differentiable, and its two gradient kernels ``fused_mlp_dgrad`` and
``fused_mlp_wgrad``.

A tensor on the CPU goes through the plain PyTorch versions (``ref.py``);
a CUDA tensor launches the hand-written kernels (``kernel.py``) or raises,
never falling back.  The gradient is a ``torch.autograd.Function``, the
counterpart of the JAX package's ``jax.custom_vjp``: its forward saves
``(x, w, y)``; its backward computes dx with the dgrad kernel, only where
autograd asks for it, and dW with the wgrad kernel, which also sums the
bias gradient ``db = sum_m g * act'(y)`` (the JAX package leaves db to an
XLA reduction outside its kernels).
"""
from __future__ import annotations

import torch

from ...obs.profiling import named_scope
from . import kernel
from .ref import (check_activation, fused_mlp_dgrad_ref, fused_mlp_layer_ref,
                  fused_mlp_wgrad_ref)


def _check(name: str, layout: str, **operands: torch.Tensor) -> None:
    """Every operand 2-D (a bias 1-D), of one supported dtype, contiguous,
    non-empty and on one device; shapes are checked by the callers."""
    tensors = list(operands.values())
    dtype, device = tensors[0].dtype, tensors[0].device
    if dtype not in kernel.DTYPES:
        raise TypeError(f"{name}: dtype {dtype} not supported; expected "
                        "torch.float32 or torch.bfloat16")
    if any(t.dtype != dtype for t in tensors):
        raise TypeError(f"{name}: operands must share one dtype, got "
                        f"{[t.dtype for t in tensors]}")
    shapes = {k: tuple(t.shape) for k, t in operands.items()}
    if any(t.dim() != (1 if k == "b" else 2) for k, t in operands.items()):
        raise ValueError(f"{name}: expected {layout}, got {shapes}")
    if any(t.numel() == 0 for t in tensors):
        raise ValueError(f"{name}: empty operand {shapes}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous")
    if any(t.device != device for t in tensors):
        raise ValueError(f"{name}: operands on different devices "
                         f"{[str(t.device) for t in tensors]}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {device}")


def _layer(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           activation: str, slope: float) -> torch.Tensor:
    if x.device.type == "cpu":
        return fused_mlp_layer_ref(x, w, b, activation, slope)
    with named_scope("mrsch.kernel.fused_mlp"):
        y = kernel.fused_mlp_forward(x, w, b, activation, slope)
    fused_mlp.launches += 1
    return y


def fused_mlp_dgrad(g: torch.Tensor, y: torch.Tensor, w: torch.Tensor, *,
                    activation: str = "leaky_relu",
                    slope: float = 0.2) -> torch.Tensor:
    """dx (M, K) = (g * act'(y)) @ w.T for g, y (M, N), w (K, N)."""
    check_activation(activation)
    _check("fused_mlp_dgrad", "g, y (M, N), w (K, N)", g=g, y=y, w=w)
    if g.shape != y.shape or w.shape[1] != g.shape[1]:
        raise ValueError(f"fused_mlp_dgrad: shape mismatch g "
                         f"{tuple(g.shape)}, y {tuple(y.shape)}, "
                         f"w {tuple(w.shape)}")
    if g.device.type == "cpu":
        return fused_mlp_dgrad_ref(g, y, w, activation, slope)
    dx = kernel.fused_mlp_dgrad(g, y, w, activation, slope)
    fused_mlp_dgrad.launches += 1
    return dx


def fused_mlp_wgrad(x: torch.Tensor, g: torch.Tensor, y: torch.Tensor, *,
                    activation: str = "leaky_relu",
                    slope: float = 0.2) -> tuple:
    """(dW (K, N) = x.T @ (g * act'(y)), db (N,) = sum over M of
    g * act'(y)) for x (M, K), g, y (M, N)."""
    check_activation(activation)
    _check("fused_mlp_wgrad", "x (M, K), g, y (M, N)", x=x, g=g, y=y)
    if g.shape != y.shape or x.shape[0] != g.shape[0]:
        raise ValueError(f"fused_mlp_wgrad: shape mismatch x "
                         f"{tuple(x.shape)}, g {tuple(g.shape)}, "
                         f"y {tuple(y.shape)}")
    if x.device.type == "cpu":
        return fused_mlp_wgrad_ref(x, g, y, activation, slope)
    dw_db = kernel.fused_mlp_wgrad(x, g, y, activation, slope)
    fused_mlp_wgrad.launches += 1
    return dw_db


class _FusedMLP(torch.autograd.Function):
    """y = act(x @ w + b) on 2-D x; gradients through the two kernels."""

    @staticmethod
    def forward(ctx, x, w, b, activation: str, slope: float):
        y = _layer(x, w, b, activation, slope)
        ctx.save_for_backward(x, w, y)
        ctx.activation, ctx.slope = activation, slope
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        act, slope = ctx.activation, ctx.slope
        g = g.contiguous()
        dx = dw = db = None
        with named_scope("mrsch.kernel.fused_mlp_bwd"):
            if ctx.needs_input_grad[0]:
                dx = fused_mlp_dgrad(g, y, w, activation=act, slope=slope)
            if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
                dw, db = fused_mlp_wgrad(x, g, y, activation=act, slope=slope)
        return dx, dw, db, None, None


def fused_mlp(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
              activation: str = "leaky_relu",
              slope: float = 0.2) -> torch.Tensor:
    """y = act(x @ w + b) for x (M, K) or (K,), w (K, N), b (N,);
    differentiable in x, w and b."""
    check_activation(activation)
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    _check("fused_mlp", "x (M, K), w (K, N), b (N,)", x=x, w=w, b=b)
    if w.shape[0] != x.shape[1] or b.shape[0] != w.shape[1]:
        raise ValueError(f"fused_mlp: shape mismatch x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)}")
    y = _FusedMLP.apply(x, w, b, activation, float(slope))
    return y[0] if squeeze else y


#: Kernel launches since the count was last set to 0 (CPU calls excluded).
fused_mlp.launches = 0
fused_mlp_dgrad.launches = 0
fused_mlp_wgrad.launches = 0
