"""Public wrapper of the Mamba2 chunked SSD: ``ssd(x, dt, dA, B, C,
chunk=...)`` (B8) — the JAX package's ``kernels/ssd/ops.py::ssd``.

The wrapper does the reference wrapper's preparation of the step sizes
(dt and dA padded with zeros to a chunk multiple, l = the within-chunk
cumsum of dA; ``ref.prepare``).  x, B and C are not padded: the kernel
reads tokens past S as zeros, which is what the padding gives, and takes
them in the models' layout, strided, with no per-head copy of B and C.
A tensor on the CPU goes through the plain version (``ref.ssd_plain``); a
CUDA tensor launches the kernels or raises, never falling back.  B8
builds no autograd graph: on the card it raises when grad mode is on and
an operand requires grad, and it takes no DTensor (a sharded model runs
the plain ``"torch"`` backend).  On the card B8 is three launches
(``kernel.PASSES``): ``ssd.launches`` counts the wrapper's calls and
``ssd.kernel_launches`` each pass's launches, counted by the pass.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...obs.profiling import named_scope
from .. import refuse_dtensors
from . import kernel
from .ref import prepare, ssd_plain


def ssd(x: torch.Tensor, dt: torch.Tensor, dA: torch.Tensor,
        B: torch.Tensor, C: torch.Tensor, *, chunk: int = 256,
        out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Chunked SSD: x (b, S, H, P); dt and dA = dt * A (b, S, H); B and C
    (b, S, G, N), G dividing H (head h reads group h // (H // G)) -> y
    (b, S, H, P) in ``out_dtype`` (x's dtype by default, as the Pallas
    kernel writes it; the models ask for float32).  x, B and C share a
    dtype, float32 or bfloat16, with unit feature stride and heads
    (groups) packed; on the card P must be one of ``kernel.HEAD_DIMS``, N
    at most ``kernel.MAX_STATE`` and the chunk at most
    ``kernel.MAX_CHUNK``."""
    out_dtype = out_dtype or x.dtype
    named = {"x": x, "dt": dt, "dA": dA, "B": B, "C": C}
    refuse_dtensors("ssd", "B8", named)
    shapes = {n: tuple(t.shape) for n, t in named.items()}
    if x.dim() != 4 or B.dim() != 4 or C.shape != B.shape \
            or dt.shape != x.shape[:3] or dA.shape != dt.shape:
        raise ValueError(f"ssd: expected x (b, S, H, P), dt and dA "
                         f"(b, S, H), B and C (b, S, G, N), got {shapes}")
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if B.shape[:2] != (b, S) or H % G:
        raise ValueError(f"ssd: shape mismatch {shapes}")
    if min(b, S, H, P, N, chunk) < 1:
        raise ValueError(f"ssd: empty operand or chunk {shapes}, "
                         f"chunk={chunk}")
    if x.dtype not in kernel.DTYPES or B.dtype != x.dtype \
            or C.dtype != x.dtype or out_dtype not in (x.dtype,
                                                       torch.float32):
        raise TypeError(f"ssd: x, B and C must share a dtype of "
                        f"{tuple(kernel.DTYPES)} and y be float32 or that "
                        f"dtype, got { {n: t.dtype for n, t in named.items()} }"
                        f", out {out_dtype}")
    if not (dt.is_floating_point() and dA.is_floating_point()):
        raise TypeError(f"ssd: dt and dA must be floating, got "
                        f"{dt.dtype}, {dA.dtype}")
    if any(t.device != x.device for t in named.values()):
        raise ValueError(f"ssd: operands on different devices "
                         f"{[str(t.device) for t in named.values()]}")
    if x.device.type == "cpu":
        return ssd_plain(x, dt, dA, B, C, chunk=chunk, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"ssd: no kernel for device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in named.values()):
        raise RuntimeError(
            "ssd: B8 is forward-only, as in the reference, so an operand "
            "that requires grad would get no gradient through it; train on "
            "the \"torch\" backend")
    if P not in kernel.HEAD_DIMS or N > kernel.MAX_STATE \
            or chunk > kernel.MAX_CHUNK:
        raise ValueError(f"ssd: P={P}, N={N}, chunk={chunk} has no kernel; "
                         f"P must be one of {kernel.HEAD_DIMS}, N at most "
                         f"{kernel.MAX_STATE} and the chunk at most "
                         f"{kernel.MAX_CHUNK}")
    if (x.stride(3), x.stride(2), B.stride(3), B.stride(2), C.stride(3),
            C.stride(2)) != (1, P, 1, N, 1, N):
        raise ValueError(f"ssd: x, B and C need unit feature stride and "
                         f"packed heads, got strides {x.stride()}, "
                         f"{B.stride()}, {C.stride()}")
    with named_scope("mrsch.kernel.ssd"):
        dtp, l = prepare(dt, dA, S, chunk)
        y = kernel.ssd_forward(x, dtp, l, B, C, chunk, out_dtype)
    ssd.launches += 1
    return y


#: Kernel launches since the count was last set to 0 (CPU calls excluded):
#: ``ssd.launches`` counts calls of B8, ``ssd.kernel_launches`` the
#: launches of each of its three passes, each counted where the pass
#: launches (``kernel.LAUNCHES``, the same dict: set it to 0 in place).
ssd.launches = 0
ssd.kernel_launches = kernel.LAUNCHES
