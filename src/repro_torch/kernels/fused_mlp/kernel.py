"""Build, load and launch the fused dense-layer CUDA kernel
(``csrc/fused_mlp.cu``, compiled for ``sm_90a``).

The library is built at first use with ``nvcc`` by the shared scheme of
``kernels/_build.py`` (keyed by a hash of the source and the flags) and
bound with ``ctypes``; nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .._build import BuildInfo, build_library, check_launch, load_library
from .ref import ACTIVATIONS

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_mlp.cu"

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel geometry, as fixed in csrc/fused_mlp.cu.
TILE_N = 128            # output columns per block
MAX_TILE_M = 16         # rows of x per block
MIN_SPLIT_ROWS = 64     # a K split shorter than this costs more than it hides
BLOCKS_PER_SM = 4       # blocks the split aims to put in flight per SM


def build() -> BuildInfo:
    """Compile the kernel library if this source has not been built yet."""
    return build_library("fused_mlp", SOURCE)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library(build())
    fn = lib.mrsch_fused_mlp_forward
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def split_plan(m: int, k: int, n: int, sm_count: int) -> tuple:
    """(splits, chunk): K is cut into ``splits`` ranges of ``chunk`` rows.

    The column tiles times the M tiles give the blocks the layer has
    without a split; K is split until about ``BLOCKS_PER_SM`` blocks per
    SM are in flight, but never into ranges shorter than
    ``MIN_SPLIT_ROWS``.  With one split the kernel applies the epilogue
    itself; otherwise a second pass adds the splits' partial sums.
    """
    tiles = -(-n // TILE_N) * -(-m // MAX_TILE_M)
    want = max(1, -(-BLOCKS_PER_SM * sm_count // tiles))
    splits = max(1, min(want, k // MIN_SPLIT_ROWS, 65535))
    chunk = -(-k // splits)
    return -(-k // chunk), chunk


def fused_mlp_forward(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      activation: str, slope: float) -> torch.Tensor:
    """Launch the kernel on CUDA tensors the caller has checked: x (M, K),
    w (K, N), b (N,), one dtype, contiguous, on one device."""
    m, k = x.shape
    n = w.shape[1]
    device = x.device
    splits, chunk = split_plan(m, k, n, _sm_count(device.index))
    y = torch.empty((m, n), dtype=x.dtype, device=device)
    partial = (torch.empty((splits, m, n), dtype=torch.float32, device=device)
               if splits > 1 else None)
    vec = int(n % 4 == 0 and w.data_ptr() % 16 == 0)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.mrsch_fused_mlp_forward(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
            partial.data_ptr() if partial is not None else None,
            m, k, n, splits, chunk, vec, ACTIVATIONS.index(activation),
            float(slope), DTYPES[x.dtype], stream)
    check_launch(lib, "fused_mlp", err, f"M={m} K={k} N={n} splits={splits}")
    return y
