"""Build, load and launch the chunked SSD CUDA kernels (``csrc/ssd.cu``),
compiled for ``sm_90a`` by the shared scheme of ``kernels/_build.py``;
nothing here runs when the module is imported.

B8 is three launches on one stream (``PASSES``): the chunks' local states
into a float32 workspace, the pass that turns them into the states
entering each chunk, and the scan that writes y."""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .._build import BuildInfo, build_library, check_launch, load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd.cu"

HEAD_DIMS = (16, 32, 64)        # the P the kernels take (laid out at 64)
MAX_STATE = 128                 # the largest N they take (laid out at 64, 128)
MAX_CHUNK = 1024                # the longest chunk they take
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PASSES = ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_scan")

#: Each pass's launches since the count was last set to 0, added where the
#: pass launches; ``ops.ssd.kernel_launches`` is this dict (set it to 0 in
#: place).
LAUNCHES = dict.fromkeys(PASSES, 0)


def build() -> BuildInfo:
    """Compile the library if this source has not been built yet."""
    return build_library("ssd", SOURCE)


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library(build())
    lib.mrsch_ssd_chunk_state.argtypes = ([_P] * 5 + [_I] * 8 + [_L] * 4
                                          + [_I] * 2 + [_P])
    lib.mrsch_ssd_state_pass.argtypes = [_P] * 2 + [_I] * 6 + [_P]
    lib.mrsch_ssd_chunk_scan.argtypes = ([_P] * 7 + [_I] * 8 + [_L] * 6
                                         + [_I] * 3 + [_P])
    for fn in PASSES:
        getattr(lib, f"mrsch_{fn}").restype = ctypes.c_int
    return lib


def workspace_shape(b: int, s: int, h: int, n: int, p: int,
                    chunk: int) -> tuple:
    """The float32 workspace of per-chunk states for x (b, s, h, p), B and
    C of state width n: (b, h, n_chunks, n, p).  The passes work out their
    own grids (``csrc/ssd.cu``)."""
    return b, h, -(-s // chunk), n, p


def _vec(*operands: torch.Tensor) -> int:
    """1 when every operand's start, batch and token strides and rows of
    its last dimension are 16-byte aligned (the kernels then stage tiles by
    16-byte cp.async copies), else 0."""
    return int(all(t.data_ptr() % 16 == 0 and all(
        (d * t.element_size()) % 16 == 0
        for d in (t.stride(0), t.stride(1), t.shape[-1])) for t in operands))


def chunk_state(x, dt, l, B, chunk: int, states: torch.Tensor) -> None:
    """Pass 1: each chunk's local state (B exp(l_last - l) dt)^T x into
    ``states`` (b, H, n_chunks, N, P) float32."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.mrsch_ssd_chunk_state(
            x.data_ptr(), dt.data_ptr(), l.data_ptr(), B.data_ptr(),
            states.data_ptr(), b, S, dt.shape[1], H, G, N, P, chunk,
            x.stride(0), x.stride(1), B.stride(0), B.stride(1),
            DTYPES[x.dtype], _vec(x, B),
            torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(lib, "ssd_chunk_state", err,
                 f"b={b} S={S} H={H} P={P} G={G} N={N} chunk={chunk}")
    LAUNCHES["ssd_chunk_state"] += 1


def state_pass(states: torch.Tensor, l: torch.Tensor, chunk: int) -> None:
    """Pass 2: in place, the state entering each chunk (zero for the
    first), h_c = exp(l_last_{c-1}) h_{c-1} + S_{c-1}."""
    b, H, _, N, P = states.shape
    lib = _library()
    with torch.cuda.device(states.device):
        err = lib.mrsch_ssd_state_pass(
            states.data_ptr(), l.data_ptr(), b, l.shape[1], H, N, P, chunk,
            torch.cuda.current_stream(states.device).cuda_stream)
    check_launch(lib, "ssd_state_pass", err, f"b={b} H={H} N={N} P={P}")
    LAUNCHES["ssd_state_pass"] += 1


def chunk_scan(x, dt, l, B, C, chunk: int, states: torch.Tensor,
               out_dtype: torch.dtype) -> torch.Tensor:
    """Pass 3: y = intra + inter over each chunk, from the states entering
    the chunks -> y (b, S, H, P) in ``out_dtype``."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    y = torch.empty((b, S, H, P), dtype=out_dtype, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.mrsch_ssd_chunk_scan(
            x.data_ptr(), dt.data_ptr(), l.data_ptr(), B.data_ptr(),
            C.data_ptr(), states.data_ptr(), y.data_ptr(), b, S, dt.shape[1],
            H, G, N, P, chunk, x.stride(0), x.stride(1), B.stride(0),
            B.stride(1), C.stride(0), C.stride(1), DTYPES[x.dtype],
            DTYPES[out_dtype], _vec(x, B, C),
            torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(lib, "ssd_chunk_scan", err,
                 f"b={b} S={S} H={H} P={P} G={G} N={N} chunk={chunk}")
    LAUNCHES["ssd_chunk_scan"] += 1
    return y


def ssd_forward(x: torch.Tensor, dt: torch.Tensor, l: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int,
                out_dtype: torch.dtype) -> torch.Tensor:
    """Launch B8's three passes on CUDA tensors the caller has checked:
    x (b, S, H, P), B and C (b, S, G, N), each with unit feature stride
    and heads (groups) packed; dt and l (b, Sp, H) float32, contiguous ->
    y (b, S, H, P) in ``out_dtype``."""
    b, S, H, P = x.shape
    states = torch.empty(workspace_shape(b, S, H, B.shape[3], P, chunk),
                         dtype=torch.float32, device=x.device)
    chunk_state(x, dt, l, B, chunk, states)
    state_pass(states, l, chunk)
    return chunk_scan(x, dt, l, B, C, chunk, states, out_dtype)
