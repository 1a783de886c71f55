"""Build, load and launch the chunked SSD CUDA kernel (``csrc/ssd.cu``),
compiled for ``sm_90a`` by the shared scheme of ``kernels/_build.py``;
nothing here runs when the module is imported."""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .._build import BuildInfo, build_library, check_launch, load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd.cu"

HEAD_DIMS = (16, 32, 64)        # the P the kernel is instantiated for
MAX_STATE = 128                 # the largest N it takes
MAX_CHUNK = 1024                # the longest chunk it takes
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def build() -> BuildInfo:
    """Compile the library if this source has not been built yet."""
    return build_library("ssd", SOURCE)


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library(build())
    lib.mrsch_ssd_fwd.argtypes = ([_P] * 6 + [_I] * 8 + [_L] * 6
                                  + [_I] * 2 + [_P])
    lib.mrsch_ssd_fwd.restype = ctypes.c_int
    return lib


def ssd_forward(x: torch.Tensor, dt: torch.Tensor, l: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int,
                out_dtype: torch.dtype) -> torch.Tensor:
    """Launch B8 on CUDA tensors the caller has checked: x (b, S, H, P),
    B and C (b, S, G, N), each with unit feature stride and heads (groups)
    packed; dt and l (b, Sp, H) float32, contiguous -> y (b, S, H, P) in
    ``out_dtype``."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    y = torch.empty((b, S, H, P), dtype=out_dtype, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.mrsch_ssd_fwd(
            x.data_ptr(), dt.data_ptr(), l.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), b, S, dt.shape[1], H, G, N, P, chunk,
            x.stride(0), x.stride(1), B.stride(0), B.stride(1), C.stride(0),
            C.stride(1), DTYPES[x.dtype], DTYPES[out_dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(lib, "ssd", err,
                 f"b={b} S={S} H={H} P={P} G={G} N={N} chunk={chunk}")
    return y
