"""Public wrappers of the attention kernels: ``flash_attention(q, k, v,
causal=...)`` (B7), the LM zoo's causal attention in the models' layout,
forward only — the JAX package's ``kernels/flash_attention/ops.py::
flash_attention`` — and the masked non-causal attention ``mha(q, k, v,
lengths)``, which is differentiable in q, k and v, with the three kernels
under it, ``mha_fwd`` (B5), ``mha_bwd_dq`` and ``mha_bwd_dkv`` (B6) — the
same file's ``mha``.

A tensor on the CPU goes through the plain PyTorch versions (``ref.py``);
a CUDA tensor launches the hand-written kernels (``kernel.py``) or raises,
never falling back.  Nothing is padded: the kernels mask the ragged edges
themselves (the JAX wrapper pads every sequence to a multiple of the TPU
block).  The gradient is a ``torch.autograd.Function``, the counterpart of
the JAX package's ``jax.custom_vjp``: its forward saves
``(q, k, v, lengths, o, lse)``; its backward computes
``delta = rowsum(do * o)`` as a plain operation, then dq and (dk, dv) with
one kernel each.  The lengths get no gradient.  ``flash_attention``
builds no autograd graph: on the card it raises when grad mode is on and
an operand requires grad, rather than return a result cut off from the
graph.  Nor does it take a DTensor: a sharded model runs the plain
``"torch"`` backend, and ``flash_attention`` raises rather than run on a
DTensor's shards.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...obs.profiling import named_scope
from .. import refuse_dtensors
from . import kernel
from .ref import flash_attention_ref, mha_bwd_ref, mha_fwd_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Softmax attention of q (B, Sq, H, dh) over k and v (B, Sk, KV, dh)
    -> (B, Sq, H, dh) in q's dtype (B7).  KV must divide H: query head h
    reads KV head h // (H // KV), with no repeat.  With ``causal`` query i
    sees keys j <= i, top-left aligned when Sq != Sk.  float32 or bfloat16,
    contiguous; no padding (the JAX wrapper pads to the TPU block).  On the
    card dh must be one of ``kernel.FLASH_HEAD_DIMS``, and the dtype picks
    one of two kernels (``kernel.flash_plan``): float32 runs on the CUDA
    cores, bfloat16 on ``wgmma``; both count in ``launches``, and each in
    ``kernel_launches`` under its kernel's name.  A CPU tensor
    takes the plain version."""
    named = {"q": q, "k": k, "v": v}
    refuse_dtensors("flash_attention", "B7", named)
    shapes = {n: tuple(t.shape) for n, t in named.items()}
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: expected q (B, Sq, H, dh), k and "
                         f"v (B, Sk, KV, dh), got {shapes}")
    b, sq, h, dh = q.shape
    kv = k.shape[2]
    if (k.shape[0], k.shape[3]) != (b, dh) or kv < 1 or h % kv:
        raise ValueError(f"flash_attention: shape mismatch {shapes}")
    if min(b, sq, h, dh, k.shape[1]) < 1:
        raise ValueError(f"flash_attention: empty operand {shapes}")
    if q.dtype not in kernel.FLASH_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: operands must share a dtype of "
                        f"{kernel.FLASH_DTYPES}, got "
                        f"{ {n: t.dtype for n, t in named.items()} }")
    if not all(t.is_contiguous() for t in named.values()):
        raise ValueError("flash_attention: operands must be contiguous")
    if any(t.device != q.device for t in named.values()):
        raise ValueError(f"flash_attention: operands on different devices "
                         f"{[str(t.device) for t in named.values()]}")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in named.values()):
        raise RuntimeError(
            "flash_attention: B7 is forward-only, as in the reference, so "
            "an operand that requires grad would get no gradient through "
            "it; train on the \"torch\" backend")
    with named_scope("mrsch.kernel.flash_attention"):
        out = kernel.flash_forward(q, k, v, causal)
    flash_attention.launches += 1
    flash_attention.kernel_launches[kernel.flash_plan(q.dtype, dh)[0]] += 1
    return out


def _check(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           lengths: torch.Tensor, **rows: torch.Tensor) -> None:
    """q (BH, Sq, dh), k and v (BH, Sk, dh), lengths (BH,) and, for the
    backward, do (BH, Sq, dh), lse and delta (BH, Sq): float32, non-empty,
    contiguous, on one device; on the card dh must be one the kernels are
    instantiated for."""
    named = {"q": q, "k": k, "v": v, "lengths": lengths, **rows}
    shapes = {n: tuple(t.shape) for n, t in named.items()}
    if any(t.dtype != torch.float32 for t in named.values()):
        raise TypeError(f"{name}: operands must be float32, got "
                        f"{ {n: t.dtype for n, t in named.items()} }")
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"{name}: expected q (BH, Sq, dh), k and v "
                         f"(BH, Sk, dh), got {shapes}")
    bh, sq, dh = q.shape
    want = {"k": (bh, k.shape[1], dh), "v": tuple(k.shape),
            "lengths": (bh,), "do": (bh, sq, dh), "lse": (bh, sq),
            "delta": (bh, sq)}
    if any(shapes[n] != want[n] for n in shapes if n != "q"):
        raise ValueError(f"{name}: shape mismatch {shapes}")
    if min(bh, sq, dh, k.shape[1]) < 1:
        raise ValueError(f"{name}: empty operand {shapes}")
    if not all(t.is_contiguous() for t in named.values()):
        raise ValueError(f"{name}: operands must be contiguous")
    device = q.device
    if any(t.device != device for t in named.values()):
        raise ValueError(f"{name}: operands on different devices "
                         f"{[str(t.device) for t in named.values()]}")
    if device.type == "cuda":
        if dh not in kernel.HEAD_DIMS:
            raise ValueError(f"{name}: head dim {dh} has no kernel; "
                             f"expected one of {kernel.HEAD_DIMS}")
    elif device.type != "cpu":
        raise ValueError(f"{name}: no kernel for device {device}")


def mha_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            lengths: torch.Tensor) -> tuple:
    """(o (BH, Sq, dh), lse (BH, Sq)) of the attention of q over the keys
    at positions below each row's length (B5)."""
    _check("mha_fwd", q, k, v, lengths)
    if q.device.type == "cpu":
        return mha_fwd_ref(q, k, v, lengths)
    with named_scope("mrsch.kernel.mha_fwd"):
        out = kernel.mha_forward(q, k, v, lengths)
    mha.launches += 1
    return out


def mha_bwd_dq(q, k, v, do, lse, delta, lengths) -> torch.Tensor:
    """dq (BH, Sq, dh) of ``mha_fwd``, given the output gradient do, the
    forward's lse and delta = rowsum(do * o) (B6)."""
    _check("mha_bwd_dq", q, k, v, lengths, do=do, lse=lse, delta=delta)
    if q.device.type == "cpu":
        return mha_bwd_ref(q, k, v, do, lse, delta, lengths)[0]
    dq = kernel.mha_backward_dq(q, k, v, do, lse, delta, lengths)
    mha_bwd_dq.launches += 1
    return dq


def mha_bwd_dkv(q, k, v, do, lse, delta, lengths) -> tuple:
    """(dk, dv), each (BH, Sk, dh), of ``mha_fwd`` (B6); zero at masked
    key positions."""
    _check("mha_bwd_dkv", q, k, v, lengths, do=do, lse=lse, delta=delta)
    if q.device.type == "cpu":
        return mha_bwd_ref(q, k, v, do, lse, delta, lengths)[1:]
    dk_dv = kernel.mha_backward_dkv(q, k, v, do, lse, delta, lengths)
    mha_bwd_dkv.launches += 1
    return dk_dv


class _MHA(torch.autograd.Function):
    """o = mha_fwd(q, k, v, lengths)[0]; gradients through B6."""

    @staticmethod
    def forward(ctx, q, k, v, lengths):
        o, lse = mha_fwd(q, k, v, lengths)
        ctx.save_for_backward(q, k, v, lengths, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, lengths, o, lse = ctx.saved_tensors
        do = do.contiguous()
        with named_scope("mrsch.kernel.mha_bwd"):
            # The softmax-Jacobian correction, once per row for both
            # kernels (the reference's ops.py computes it the same way).
            delta = (do * o).sum(dim=-1)
            dq = mha_bwd_dq(q, k, v, do, lse, delta, lengths)
            dk, dv = mha_bwd_dkv(q, k, v, do, lse, delta, lengths)
        return dq, dk, dv, None


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked non-causal attention, differentiable in q, k and v.

    q (BH, Sq, dh), k and v (BH, Sk, dh), cast to float32; ``lengths``
    (BH,) counts the valid keys of each batch-head row (keys at positions
    >= length are masked, a row with length 0 outputs exactly 0), clamped
    to Sk; ``None`` means every key is valid.
    """
    sk = k.shape[1]
    if lengths is None:
        lens = torch.full((q.shape[0],), float(sk), dtype=torch.float32,
                          device=q.device)
    else:
        lens = torch.clamp_max(lengths.float(), float(sk))
    return _MHA.apply(q.float(), k.float(), v.float(), lens)


#: Kernel launches since the count was last set to 0 (CPU calls excluded):
#: ``flash_attention.launches`` counts B7 (``kernel_launches`` splits it by
#: the kernel ``kernel.flash_plan`` chose), ``mha.launches`` B5, the other
#: two B6's kernels.
flash_attention.launches = 0
flash_attention.kernel_launches = {"flash_fwd": 0, "flash_fwd_sm90": 0}
mha.launches = 0
mha_bwd_dq.launches = 0
mha_bwd_dkv.launches = 0
