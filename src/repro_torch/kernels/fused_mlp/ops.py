"""Public wrapper of the fused dense layer: ``fused_mlp(x, w, b)``.

A tensor on the CPU goes through the plain PyTorch version (``ref.py``);
a CUDA tensor launches the hand-written kernel (``kernel.py``) or raises,
never falling back.  Forward only: the gradient kernels come with
training, so the wrapper refuses to run where autograd would need them.
"""
from __future__ import annotations

import torch

from . import kernel
from .ref import check_activation, fused_mlp_layer_ref


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    if x.dtype not in kernel.DTYPES:
        raise TypeError(f"fused_mlp: dtype {x.dtype} not supported; expected "
                        "torch.float32 or torch.bfloat16")
    if w.dtype != x.dtype or b.dtype != x.dtype:
        raise TypeError(f"fused_mlp: x, w and b must share one dtype, got "
                        f"{x.dtype}, {w.dtype}, {b.dtype}")
    if x.dim() != 2 or w.dim() != 2 or b.dim() != 1:
        raise ValueError(f"fused_mlp: expected x (M, K), w (K, N), b (N,), "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(b.shape)}")
    m, k = x.shape
    if w.shape[0] != k or b.shape[0] != w.shape[1]:
        raise ValueError(f"fused_mlp: shape mismatch x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)}")
    if min(m, k, w.shape[1]) < 1:
        raise ValueError(f"fused_mlp: empty operand x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("fused_mlp: x, w and b must be contiguous")
    if not (x.device == w.device == b.device):
        raise ValueError(f"fused_mlp: operands on different devices "
                         f"{x.device}, {w.device}, {b.device}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                    or b.requires_grad):
        raise RuntimeError("fused_mlp has no backward yet: call it under "
                           "torch.no_grad()")


def fused_mlp(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
              activation: str = "leaky_relu",
              slope: float = 0.2) -> torch.Tensor:
    """y = act(x @ w + b) for x (M, K) or (K,), w (K, N), b (N,)."""
    check_activation(activation)
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    _check(x, w, b)
    if x.device.type == "cpu":
        y = fused_mlp_layer_ref(x, w, b, activation, slope)
    elif x.device.type == "cuda":
        with torch.profiler.record_function("mrsch.kernel.fused_mlp"):
            y = kernel.fused_mlp_forward(x, w, b, activation, slope)
        fused_mlp.launches += 1
    else:
        raise ValueError(f"fused_mlp: no kernel for device {x.device}")
    return y[0] if squeeze else y


#: Kernel launches since the count was last set to 0 (CPU calls excluded).
fused_mlp.launches = 0
