"""Build, load and launch the window-pack CUDA kernels
(``csrc/window_pack.cu``, compiled for ``sm_90a``: ``window_pack_kernel``
and ``decision_rows_kernel``) by the shared scheme of
``kernels/_build.py``; nothing here runs when the module is imported."""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from .._build import BuildInfo, build_library, check_launch, load_library
from .ref import PHANTOM_OWNER, TTF_HORIZON, DecisionRows, DecisionRowSpec

SOURCE = Path(__file__).resolve().parent / "csrc" / "window_pack.cu"
MAX_RESOURCES = 8                   # kMaxR in the source
MODE_CODE = {"mask": 0, "mlp": 1, "attention": 2}


class RowParams(ctypes.Structure):
    """``RowParams`` of the source, field for field."""
    _fields_ = ([(name, ctypes.c_int) for name in (
        "N", "J", "R", "U", "W", "K", "mode", "has_drains", "row_dim",
        "unit_off", "meas_off", "goal_off", "valid_off", "phantom_owner")]
        + [(name, ctypes.c_float) for name in (
            "inv_ts", "goal_default", "ttf_horizon")]
        + [(name, ctypes.c_int * MAX_RESOURCES) for name in (
            "seg_off", "seg_cap", "enc_cap", "enc_off")]
        + [("inv_cap", ctypes.c_float * MAX_RESOURCES)])


def build() -> BuildInfo:
    """Compile the kernel library if this source has not been built yet."""
    return build_library("window_pack", SOURCE)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library(build())
    fn = lib.mrsch_window_pack
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.mrsch_decision_rows
    fn.argtypes = [ctypes.POINTER(RowParams)] + [ctypes.c_void_p] * 19
    fn.restype = ctypes.c_int
    return lib


def window_pack_forward(waiting: torch.Tensor, feats: torch.Tensor,
                        window: int):
    """Launch the kernel on CUDA tensors the caller has checked: waiting
    (N, J) and feats (N, J, F), float32, contiguous, on one device."""
    n, j = waiting.shape
    f = feats.shape[2]
    device = waiting.device
    win_feats = torch.empty((n, window, f), dtype=torch.float32, device=device)
    win_idx = torch.empty((n, window), dtype=torch.int32, device=device)
    # torch.bool is one byte holding 0 or 1: the kernel writes it directly.
    win_valid = torch.empty((n, window), dtype=torch.bool, device=device)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.mrsch_window_pack(
            waiting.data_ptr(), feats.data_ptr(), win_feats.data_ptr(),
            win_idx.data_ptr(), win_valid.data_ptr(), n, j, f, window, stream)
    check_launch(lib, "window_pack", err, f"N={n} J={j} F={f} W={window}")
    return win_feats, win_idx, win_valid


def reciprocal(x: float) -> float:
    """1 / x in float32, as aten's CUDA division by a Python number
    computes the factor it multiplies by."""
    return float(np.float32(1.0) / np.float32(x))


@functools.lru_cache(maxsize=64)
def row_params(spec: DecisionRowSpec, n: int, j: int) -> RowParams:
    """The kernel's constants for one spec and (N, J): the offsets of
    every section of the decision row and the float reciprocals."""
    R, W, K = spec.n_resources, spec.window, spec.k
    p = RowParams(N=n, J=j, R=R, U=spec.n_units, W=W, K=K,
                  mode=MODE_CODE[spec.mode], has_drains=int(spec.has_drains),
                  row_dim=spec.row_dim, inv_ts=reciprocal(spec.time_scale),
                  goal_default=float(np.float32(1.0 / R)),
                  phantom_owner=PHANTOM_OWNER,
                  ttf_horizon=float(np.float32(TTF_HORIZON)))
    for r, (seg_off, cap) in enumerate(spec.segments):
        p.seg_off[r], p.seg_cap[r] = seg_off, cap
        p.inv_cap[r] = reciprocal(max(cap, 1))
    if spec.mode == "mlp":          # [tokens | avail, ttf per resource | ...
        off = K * (R + 2)
        for r, enc in enumerate(spec.enc_caps):
            p.enc_off[r], p.enc_cap[r] = off, enc
            off += 2 * enc
        p.meas_off = off
    elif spec.mode == "attention":  # [tokens | qlen | free, ttf per resource
        p.unit_off = K * (R + 2)
        p.meas_off = p.unit_off + 1 + 2 * R
    if spec.mode != "mask":         # ... | meas | goal | valid]; mask: valid
        p.goal_off = p.meas_off + R
        p.valid_off = p.goal_off + R
    return p


def decision_rows_forward(spec: DecisionRowSpec, *, ready, now, started,
                          finished, failed, release, est_end, owner, feats,
                          walltime, demands, caps_f) -> DecisionRows:
    """Launch the front's kernel on CUDA tensors the caller has checked
    (``ops._check_rows``); every output is a fresh tensor."""
    n, j = ready.shape
    R, K = spec.n_resources, spec.k
    device = ready.device

    def empty(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=device)

    out = DecisionRows(waiting=empty((n, j)), n_waiting=empty((n,)),
                       free=empty((n, R)), idx=empty((n, K), torch.int32),
                       valid=empty((n, K), torch.bool),
                       obs=empty((n, spec.row_dim)))
    lib = _library()
    params = row_params(spec, n, j)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.mrsch_decision_rows(
            ctypes.byref(params),
            *(t.data_ptr() for t in (ready, now, started, finished, failed,
                                     release, est_end)),
            0 if owner is None else owner.data_ptr(),
            *(t.data_ptr() for t in (feats, walltime, demands, caps_f)),
            *(t.data_ptr() for t in out), stream)
    check_launch(lib, "decision_rows", err,
                 f"mode={spec.mode} N={n} J={j} R={R} K={K} "
                 f"U={spec.n_units}")
    return out
