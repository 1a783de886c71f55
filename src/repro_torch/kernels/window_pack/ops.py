"""Public wrappers of the window pack.

* ``pack_window(waiting, feats, window=W)``, the counterpart of the JAX
  package's ``kernels/window_pack/ops.py::pack_window``;
* ``pack_decision_rows(spec, ...)``, the front of the device engine's
  deciding round: the queued mask, the free-unit counts, the pack and the
  decision rows in one launch, where the reference's jitted round lets
  XLA fuse the same ops around its Pallas call.

A tensor on the CPU goes through the plain PyTorch version (``ref.py``);
a CUDA tensor launches the hand-written kernel (``kernel.py``) or raises,
never falling back.  Nothing is padded: the JAX wrapper's pad to 128
lanes and 8 sublanes exists only for the TPU's tiles.
"""
from __future__ import annotations

import torch

from ...obs.profiling import named_scope
from . import kernel
from .ref import (DecisionRows, DecisionRowSpec,
                  pack_decision_rows_reference, pack_window_reference)


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
    with named_scope("mrsch.kernel.window_pack"):
        out = kernel.window_pack_forward(waiting, feats, window)
    pack_window.launches += 1
    return out


#: Kernel launches since the count was last set to 0 (CPU calls excluded).
pack_window.launches = 0


def _check_rows(spec: DecisionRowSpec, tensors: dict) -> None:
    """Raise on what the front's kernel does not take."""
    if not isinstance(spec, DecisionRowSpec):
        raise TypeError(f"pack_decision_rows: spec must be a DecisionRowSpec, "
                        f"got {type(spec).__name__}")
    if spec.n_resources > kernel.MAX_RESOURCES:
        raise ValueError(f"pack_decision_rows: at most "
                         f"{kernel.MAX_RESOURCES} resources, got "
                         f"{spec.n_resources}")
    if spec.has_drains != (tensors["owner"] is not None):
        raise ValueError("pack_decision_rows: owner is read exactly when the "
                         "spec has drains")
    ready = tensors["ready"]
    if ready.dim() != 2 or min(ready.shape) < 1:
        raise ValueError(f"pack_decision_rows: expected ready (N, J) with N, "
                         f"J >= 1, got {tuple(ready.shape)}")
    n, j = ready.shape
    R = spec.n_resources
    want = {"ready": ((n, j), torch.float32), "now": ((n,), torch.float32),
            "started": ((n, j), torch.bool), "finished": ((n, j), torch.bool),
            "failed": ((n, j), torch.bool),
            "release": ((n, spec.n_units), torch.float32),
            "est_end": ((n, j), torch.float32),
            "owner": ((n, spec.n_units), torch.int32),
            "feats": ((n, j, R + 2), torch.float32),
            "walltime": ((n, j), torch.float32),
            "demands": ((n, j, R), torch.float32),
            "caps_f": ((R,), torch.float32)}
    device = ready.device
    for name, t in tensors.items():
        if t is None:
            continue
        shape, dtype = want[name]
        if t.dtype != dtype:
            raise TypeError(f"pack_decision_rows: {name} must be {dtype}, "
                            f"got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"pack_decision_rows: {name} must have shape "
                             f"{shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"pack_decision_rows: {name} must be contiguous")
        if t.device != device:
            raise ValueError(f"pack_decision_rows: operands on different "
                             f"devices: {name} on {t.device}, ready on "
                             f"{device}")


def pack_decision_rows(spec: DecisionRowSpec, *, ready, now, started,
                       finished, failed, release, est_end, feats, walltime,
                       demands, caps_f, owner=None) -> DecisionRows:
    """The front of a deciding round: the queued mask (N, J), its count
    (N,), the free units per resource (N, R), the first ``spec.k`` waiting
    jobs' indices and validity (N, K), and the decision rows (N,
    ``spec.row_dim``), every one a fresh tensor.  Operands as
    ``ref.pack_decision_rows_reference`` takes them; ``owner`` is given
    exactly when ``spec.has_drains``."""
    tensors = dict(ready=ready, now=now, started=started, finished=finished,
                   failed=failed, release=release, est_end=est_end,
                   owner=owner, feats=feats, walltime=walltime,
                   demands=demands, caps_f=caps_f)
    _check_rows(spec, tensors)
    if ready.device.type == "cpu":
        return pack_decision_rows_reference(spec, **tensors)
    if ready.device.type != "cuda":
        raise ValueError(f"pack_decision_rows: no kernel for device "
                         f"{ready.device}")
    with named_scope("mrsch.kernel.window_pack"):
        out = kernel.decision_rows_forward(spec, **tensors)
    pack_decision_rows.launches += 1
    return out


#: Kernel launches since the count was last set to 0 (CPU calls excluded).
pack_decision_rows.launches = 0
