"""Build, load and launch the window-pack CUDA kernel
(``csrc/window_pack.cu``, compiled for ``sm_90a``) by the shared scheme of
``kernels/_build.py``; nothing here runs when the module is imported."""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .._build import BuildInfo, build_library, check_launch, load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "window_pack.cu"


def build() -> BuildInfo:
    """Compile the kernel library if this source has not been built yet."""
    return build_library("window_pack", SOURCE)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library(build())
    fn = lib.mrsch_window_pack
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
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
