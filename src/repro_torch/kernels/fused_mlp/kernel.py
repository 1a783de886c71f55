"""Build, load and launch the fused dense-layer CUDA kernels, compiled for
``sm_90a``: the forward (``csrc/fused_mlp.cu``) and the two gradient
kernels, dgrad and wgrad (``csrc/fused_mlp_bwd.cu``), one library each.

The libraries are built at first use with ``nvcc`` by the shared scheme of
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
BWD_SOURCE = SOURCE.with_name("fused_mlp_bwd.cu")

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel geometry, as fixed in csrc/fused_mlp.cu.
TILE_N = 128            # output columns per block
MAX_TILE_M = 16         # rows of x per block of the M <= 16 kernel
M64_TILE_M = 64         # rows of x per block of the M > 16 kernel
M64_STEP_K = 32         # rows of K a ring stage of the M > 16 kernel holds
MIN_SPLIT_ROWS = 64     # a K split shorter than this costs more than it hides
BLOCKS_PER_SM = 4       # blocks the split aims to put in flight per SM
M64_BLOCKS_PER_SM = 2   # blocks of the M > 16 kernel an SM holds at once

# Backward geometry, as fixed in csrc/fused_mlp_bwd.cu.
DGRAD_TILES = ((64, 128), (64, 64), (32, 32))  # (M rows, K columns)
DGRAD_STEP_N = 32       # columns of N staged per step (the shortest split)
DGRAD_MAX_CLUSTER = 8   # splits of one tile: one cluster, portable size
WGRAD_TILES = (128, 64, 32)  # square wgrad tiles of K x N, 8 warps each
WGRAD_STEP_M = 32           # rows of M a wgrad ring stage holds
MIN_WGRAD_SPLIT_ROWS = 64   # shortest M slice a wgrad split covers


def build() -> BuildInfo:
    """Compile the forward library if this source has not been built yet."""
    return build_library("fused_mlp", SOURCE)


def build_backward() -> BuildInfo:
    """Compile the gradient library if this source has not been built yet."""
    return build_library("fused_mlp_bwd", BWD_SOURCE)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library(build())
    fn = lib.mrsch_fused_mlp_forward
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


@functools.cache
def _backward_library() -> ctypes.CDLL:
    lib = load_library(build_backward())
    lib.mrsch_fused_mlp_dgrad.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.mrsch_fused_mlp_wgrad.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.mrsch_fused_mlp_dgrad.restype = ctypes.c_int
    lib.mrsch_fused_mlp_wgrad.restype = ctypes.c_int
    return lib


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def forward_plan(m: int, k: int, n: int, sm_count: int) -> tuple:
    """(kernel, tile_m, splits, chunk) of the forward for x (m, k), W (k, n).

    M <= 16 (the decision service's batches) runs ``fused_mlp_fwd_kernel``,
    which holds all M rows in registers and streams W once; M > 16 runs
    ``fused_mlp_fwd_m64_kernel``, whose blocks take 64 rows of x each, so W
    is read once per 64 rows, not once per 16.  The column tiles times the
    M tiles give the blocks the layer has without a split; K is cut into
    ``splits`` ranges of ``chunk`` rows, never shorter than
    ``MIN_SPLIT_ROWS``.  For M <= 16, until about ``BLOCKS_PER_SM`` blocks
    per SM are in flight.  For M > 16, into as many ranges as one wave of
    ``M64_BLOCKS_PER_SM`` blocks per SM holds (a second, partial wave
    would cost a whole block's time), each a whole number of its 32-row
    ring stages, and not at all where the tiles alone reach half the SMs
    (the encoder's 129 tiles: the pass that adds the partial sums would
    cost more than the split saves).  With one split the kernel applies
    the epilogue itself; otherwise a second pass adds the splits' partial
    sums in a fixed order."""
    if m <= MAX_TILE_M:
        tiles = -(-n // TILE_N)
        want = max(1, -(-BLOCKS_PER_SM * sm_count // tiles))
        splits = max(1, min(want, k // MIN_SPLIT_ROWS, 65535))
        chunk = -(-k // splits)
        return "fused_mlp_fwd", MAX_TILE_M, -(-k // chunk), chunk
    tiles = -(-n // TILE_N) * -(-m // M64_TILE_M)
    want = (1 if 2 * tiles > sm_count
            else min(65535, M64_BLOCKS_PER_SM * sm_count // tiles))
    chunk = max(MIN_SPLIT_ROWS, -(-k // want)) if want > 1 else k
    chunk = -(-chunk // M64_STEP_K) * M64_STEP_K
    return "fused_mlp_fwd_m64", M64_TILE_M, -(-k // chunk), chunk


def fused_mlp_forward(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      activation: str, slope: float) -> torch.Tensor:
    """Launch the kernel ``forward_plan`` picks on CUDA tensors the caller
    has checked: x (M, K), w (K, N), b (N,), one dtype, contiguous, on one
    device."""
    m, k = x.shape
    n = w.shape[1]
    device = x.device
    name, _, splits, chunk = forward_plan(m, k, n, _sm_count(device.index))
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
            m, k, n, splits, chunk, int(name == "fused_mlp_fwd_m64"),
            _copy_bytes(k, x), _copy_bytes(n, w), vec,
            ACTIVATIONS.index(activation), float(slope), DTYPES[x.dtype],
            stream)
    check_launch(lib, name, err, f"M={m} K={k} N={n} splits={splits}")
    return y


def dgrad_plan(m: int, k: int, n: int, sm_count: int) -> tuple:
    """(tile_m, tile_k, splits, chunk) of the dgrad: blocks own ``tile_m``
    rows of M by ``tile_k`` columns of K (one of ``DGRAD_TILES``), and N is
    cut into ``splits`` ranges of ``chunk`` columns (a multiple of
    ``DGRAD_STEP_N``), the splits of one tile being one thread-block
    cluster, of at most ``DGRAD_MAX_CLUSTER`` blocks.  The tile: the widest
    of 64 x 128, 64 x 64 and 32 x 32 (no wider than K needs) whose tiles,
    split as far as the cluster and N allow, reach half the SMs: a wide
    tile stages g and y for fewer K tiles.  N is split only where the tiles
    alone do not reach half the SMs, and then until about one and a half
    blocks per SM are in flight (the 4000 x 1000 layer at M = 64: 32 tiles
    of 64 x 128, 7 splits)."""
    def tiles(tile):
        return -(-m // tile[0]) * -(-k // tile[1])

    most = min(DGRAD_MAX_CLUSTER, -(-n // DGRAD_STEP_N))
    half = -(-sm_count // 2)
    fit = [t for t in DGRAD_TILES
           if t[1] <= max(DGRAD_STEP_N, -(-k // DGRAD_STEP_N) * DGRAD_STEP_N)]
    tile = next((t for t in fit if tiles(t) * most >= half), fit[-1])
    splits = 1 if tiles(tile) >= half else min(
        most, -(-3 * sm_count // (2 * tiles(tile))))
    chunk = -(-n // splits)
    chunk = -(-chunk // DGRAD_STEP_N) * DGRAD_STEP_N
    return tile[0], tile[1], -(-n // chunk), chunk


def fused_mlp_dgrad(g: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                    activation: str, slope: float) -> torch.Tensor:
    """Launch the dgrad on CUDA tensors the caller has checked: g, y (M, N),
    w (K, N), one dtype, contiguous, on one device -> dx (M, K), in one
    launch (the splits of N add up inside their cluster)."""
    m, n = g.shape
    k = w.shape[0]
    device = g.device
    tile_m, tile_k, splits, chunk = dgrad_plan(m, k, n,
                                               _sm_count(device.index))
    dx = torch.empty((m, k), dtype=g.dtype, device=device)
    vec = int(_copy_bytes(n, g) == _copy_bytes(n, y) == _copy_bytes(n, w)
              == 16)
    lib = _backward_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.mrsch_fused_mlp_dgrad(
            g.data_ptr(), y.data_ptr(), w.data_ptr(), dx.data_ptr(),
            m, k, n, tile_m, tile_k, splits, chunk, vec,
            ACTIVATIONS.index(activation), float(slope), DTYPES[g.dtype],
            stream)
    check_launch(lib, "fused_mlp_dgrad", err,
                 f"M={m} K={k} N={n} tile={tile_m}x{tile_k} splits={splits}")
    return dx


def _tiles(k: int, n: int, tile: int) -> int:
    return -(-k // tile) * -(-n // tile)


def wgrad_tile(m: int, k: int, n: int, sm_count: int) -> int:
    """The wgrad's square tile: the largest of ``WGRAD_TILES`` of which the
    layer has at least one tile per SM (the DFP's 11410 x 4000 and 4000 x
    1000: 128); else 64 where M is long enough to be split, and 32 where it
    is not, so that a small layer's product spreads over more SMs."""
    for tile in WGRAD_TILES[:2]:
        if _tiles(k, n, tile) >= sm_count:
            return tile
    return 64 if m >= 2 * MIN_WGRAD_SPLIT_ROWS else 32


def wgrad_split_plan(m: int, k: int, n: int, sm_count: int) -> tuple:
    """(splits, chunk) of the wgrad: M, the contraction, is cut into
    ``splits`` slices of ``chunk`` rows (a multiple of ``WGRAD_STEP_M``)
    until about ``BLOCKS_PER_SM`` blocks per SM are in flight, never into
    slices shorter than ``MIN_WGRAD_SPLIT_ROWS``; a layer whose tiles fill
    the card is not split.  The attention encoder's layers (K, N <= 128:
    one or two tiles) at M = 8,256 get 129 slices of 64 rows; the DFP's
    layers at M = 64 keep one."""
    tiles = _tiles(k, n, wgrad_tile(m, k, n, sm_count))
    want = 1 if tiles >= sm_count else min(
        65535, -(-BLOCKS_PER_SM * sm_count // tiles))
    chunk = max(MIN_WGRAD_SPLIT_ROWS, -(-m // want))
    chunk = -(-chunk // WGRAD_STEP_M) * WGRAD_STEP_M
    return -(-m // chunk), chunk


def _copy_bytes(row: int, t: torch.Tensor) -> int:
    """The widest ``cp.async`` chunk (16, 8 or 4 bytes) that rows of ``row``
    elements of ``t`` are aligned to, or 0 (stage element by element)."""
    row_bytes = row * t.element_size()
    return next((c for c in (16, 8, 4)
                 if row_bytes % c == 0 and t.data_ptr() % c == 0), 0)


def fused_mlp_wgrad(x: torch.Tensor, g: torch.Tensor, y: torch.Tensor,
                    activation: str, slope: float) -> tuple:
    """Launch the wgrad on CUDA tensors the caller has checked: x (M, K),
    g, y (M, N), one dtype, contiguous, on one device -> (dW (K, N),
    db (N,)), both from the one call (with more than one split, the
    kernel and the pass that adds the splits' partial sums)."""
    m, k = x.shape
    n = g.shape[1]
    device = x.device
    sms = _sm_count(device.index)
    tile = wgrad_tile(m, k, n, sms)
    splits, chunk = wgrad_split_plan(m, k, n, sms)
    dw = torch.empty((k, n), dtype=x.dtype, device=device)
    db = torch.empty((n,), dtype=x.dtype, device=device)
    partial = db_partial = None
    if splits > 1:
        partial = torch.empty((splits, k, n), dtype=torch.float32,
                              device=device)
        db_partial = torch.empty((splits, n), dtype=torch.float32,
                                 device=device)
    x_bytes = _copy_bytes(k, x)
    gy_bytes = min(_copy_bytes(n, g), _copy_bytes(n, y))
    lib = _backward_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.mrsch_fused_mlp_wgrad(
            x.data_ptr(), g.data_ptr(), y.data_ptr(), dw.data_ptr(),
            db.data_ptr(), partial.data_ptr() if partial is not None else None,
            db_partial.data_ptr() if db_partial is not None else None,
            m, k, n, tile, splits, chunk, x_bytes, gy_bytes,
            ACTIVATIONS.index(activation), float(slope), DTYPES[x.dtype],
            stream)
    check_launch(lib, "fused_mlp_wgrad", err,
                 f"M={m} K={k} N={n} tile={tile} splits={splits}")
    return dw, db
