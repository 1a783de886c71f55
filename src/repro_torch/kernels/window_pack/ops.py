"""Public wrapper of the window pack: ``pack_window(waiting, feats,
window=W)``, the counterpart of the JAX package's
``kernels/window_pack/ops.py::pack_window``.

A tensor on the CPU goes through the plain PyTorch version (``ref.py``);
a CUDA tensor launches the hand-written kernel (``kernel.py``) or raises,
never falling back.  Nothing is padded: the JAX wrapper's pad to 128
lanes and 8 sublanes exists only for the TPU's tiles.
"""
from __future__ import annotations

import torch

from . import kernel
from .ref import pack_window_reference


def _check(waiting: torch.Tensor, feats: torch.Tensor, window: int) -> None:
    if waiting.dtype != torch.float32 or feats.dtype != torch.float32:
        raise TypeError(f"pack_window: expected float32 waiting and feats, "
                        f"got {waiting.dtype}, {feats.dtype}")
    if waiting.dim() != 2 or feats.dim() != 3 \
            or feats.shape[:2] != waiting.shape:
        raise ValueError(f"pack_window: expected waiting (N, J) and feats "
                         f"(N, J, F), got {tuple(waiting.shape)}, "
                         f"{tuple(feats.shape)}")
    if min(feats.shape) < 1 or window < 1:
        raise ValueError(f"pack_window: empty operand: feats "
                         f"{tuple(feats.shape)}, window {window}")
    if not (waiting.is_contiguous() and feats.is_contiguous()):
        raise ValueError("pack_window: waiting and feats must be contiguous")
    if waiting.device != feats.device:
        raise ValueError(f"pack_window: operands on different devices "
                         f"{waiting.device}, {feats.device}")


def pack_window(waiting: torch.Tensor, feats: torch.Tensor, *, window: int):
    """First ``window`` waiting jobs per environment, densely packed.

    waiting (N, J) 0/1 float32, feats (N, J, F) float32 ->
    (win_feats (N, W, F) f32, win_idx (N, W) int32, win_valid (N, W) bool).
    """
    window = int(window)
    _check(waiting, feats, window)
    if waiting.device.type == "cpu":
        return pack_window_reference(waiting, feats, window=window)
    if waiting.device.type != "cuda":
        raise ValueError(f"pack_window: no kernel for device {waiting.device}")
    with torch.profiler.record_function("mrsch.kernel.window_pack"):
        out = kernel.window_pack_forward(waiting, feats, window)
    pack_window.launches += 1
    return out


#: Kernel launches since the count was last set to 0 (CPU calls excluded).
pack_window.launches = 0
