"""Build, load and launch the attention CUDA kernels, compiled for
``sm_90a``: the masked forward (``csrc/mha.cu``), its two backward kernels,
dq and dkv (``csrc/mha_bwd.cu``), and the causal flash forward of the LM
zoo in two kernels, float32 in 3xTF32 on ``mma.sync`` (``csrc/flash_fwd.cu``)
and bfloat16 on ``wgmma`` with TMA (``csrc/flash_fwd_sm90.cu``), one library
each, by the shared scheme of ``kernels/_build.py``; nothing here runs when
the module is imported."""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .._build import BuildInfo, build_library, check_launch, load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "mha.cu"
BWD_SOURCE = SOURCE.with_name("mha_bwd.cu")
FLASH_SOURCE = SOURCE.with_name("flash_fwd.cu")
FLASH_SM90_SOURCE = SOURCE.with_name("flash_fwd_sm90.cu")

HEAD_DIMS = (8, 16, 32, 64)     # the dh the mha kernels are instantiated for
# The dh the flash kernel is instantiated for: the LM configs' (zamba2-7b's
# shared blocks 112, gemma-2b 256, nemotron 192, most others 64 or 128),
# the reference tests' (32, 64, 128) and the smoke configs' (16).
FLASH_HEAD_DIMS = (16, 32, 64, 112, 128, 192, 256)
FLASH_DTYPES = (torch.float32, torch.bfloat16)


def build() -> BuildInfo:
    """Compile the forward library if this source has not been built yet."""
    return build_library("mha", SOURCE)


def build_backward() -> BuildInfo:
    """Compile the backward library if this source has not been built yet."""
    return build_library("mha_bwd", BWD_SOURCE)


def build_flash() -> BuildInfo:
    """Compile the float32 flash forward library if this source has not
    been built yet."""
    return build_library("flash_fwd", FLASH_SOURCE)


def build_flash_sm90() -> BuildInfo:
    """Compile the bfloat16 (wgmma, TMA) flash forward library if this
    source has not been built yet."""
    return build_library("flash_fwd_sm90", FLASH_SM90_SOURCE)


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library(build())
    lib.mrsch_mha_fwd.argtypes = [_P] * 6 + [_I] * 4 + [ctypes.c_float, _P]
    lib.mrsch_mha_fwd.restype = ctypes.c_int
    return lib


@functools.cache
def _backward_library() -> ctypes.CDLL:
    lib = load_library(build_backward())
    lib.mrsch_mha_bwd_dq.argtypes = ([_P] * 8 + [_I] * 4
                                     + [ctypes.c_float, _P])
    lib.mrsch_mha_bwd_dkv.argtypes = ([_P] * 9 + [_I] * 4
                                      + [ctypes.c_float, _P])
    lib.mrsch_mha_bwd_dq.restype = ctypes.c_int
    lib.mrsch_mha_bwd_dkv.restype = ctypes.c_int
    return lib


@functools.cache
def _flash_library() -> ctypes.CDLL:
    lib = load_library(build_flash())
    lib.mrsch_flash_fwd.argtypes = [_P] * 4 + [_I] * 8 + [ctypes.c_float, _P]
    lib.mrsch_flash_fwd.restype = ctypes.c_int
    return lib


@functools.cache
def _flash_sm90_library() -> ctypes.CDLL:
    lib = load_library(build_flash_sm90())
    lib.mrsch_flash_fwd_sm90.argtypes = ([_P] * 4 + [_I] * 9
                                         + [ctypes.c_float, _P])
    lib.mrsch_flash_fwd_sm90.restype = ctypes.c_int
    return lib


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _dims(q: torch.Tensor, k: torch.Tensor) -> tuple:
    bh, sq, dh = q.shape
    return bh, sq, k.shape[1], dh, dh ** -0.5


def mha_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                lengths: torch.Tensor) -> tuple:
    """Launch B5 on CUDA tensors the caller has checked: q (BH, Sq, dh),
    k, v (BH, Sk, dh), lengths (BH,), float32, contiguous, on one device
    -> (o (BH, Sq, dh), lse (BH, Sq))."""
    bh, sq, sk, dh, scale = _dims(q, k)
    o = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.mrsch_mha_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                lengths.data_ptr(), o.data_ptr(),
                                lse.data_ptr(), bh, sq, sk, dh, scale,
                                _stream(q.device))
    check_launch(lib, "mha_fwd", err, f"BH={bh} Sq={sq} Sk={sk} dh={dh}")
    return o, lse


def mha_backward_dq(q, k, v, do, lse, delta, lengths) -> torch.Tensor:
    """Launch B6's dq kernel on checked CUDA tensors -> dq (BH, Sq, dh)."""
    bh, sq, sk, dh, scale = _dims(q, k)
    dq = torch.empty_like(q)
    lib = _backward_library()
    with torch.cuda.device(q.device):
        err = lib.mrsch_mha_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), lengths.data_ptr(),
            dq.data_ptr(), bh, sq, sk, dh, scale, _stream(q.device))
    check_launch(lib, "mha_bwd_dq", err, f"BH={bh} Sq={sq} Sk={sk} dh={dh}")
    return dq


def mha_backward_dkv(q, k, v, do, lse, delta, lengths) -> tuple:
    """Launch B6's dkv kernel on checked CUDA tensors -> (dk, dv), each
    (BH, Sk, dh)."""
    bh, sq, sk, dh, scale = _dims(q, k)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _backward_library()
    with torch.cuda.device(q.device):
        err = lib.mrsch_mha_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), lengths.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), bh, sq, sk, dh, scale,
            _stream(q.device))
    check_launch(lib, "mha_bwd_dkv", err, f"BH={bh} Sq={sq} Sk={sk} dh={dh}")
    return dk, dv


def flash_plan(dtype: torch.dtype, dh: int) -> tuple:
    """(kernel, dh_pad, key_tile) of B7 for ``dtype`` and head dim ``dh``.

    float32 goes to ``flash_fwd`` (3xTF32 on ``mma.sync``, which keeps
    float32 accuracy; dh as it is), whose key tile is 64 up to dh 128 and
    32 beyond, to fit the Q tile and two stages of K and V in shared
    memory; bfloat16 to ``flash_fwd_sm90`` (wgmma, TMA), whose tiles
    are boxes of 64 head-dim columns, so dh is padded to ``dh_pad``, a
    multiple of 64, by TMA's zero fill, and whose key tile is 128 up to
    dh_pad 128 and 64 beyond, to fit Q and two stages of K and V in shared
    memory and the output in the consumers' registers.  The choice is fixed
    by dtype, not a fallback: a call that cannot build or launch raises."""
    if dh not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dh} has no kernel; "
                         f"expected one of {FLASH_HEAD_DIMS}")
    if dtype == torch.float32:
        return "flash_fwd", dh, 64 if dh <= 128 else 32
    if dtype == torch.bfloat16:
        dh_pad = -(-dh // 64) * 64
        return "flash_fwd_sm90", dh_pad, 128 if dh_pad <= 128 else 64
    raise TypeError(f"flash_attention: dtype {dtype} has no kernel; "
                    f"expected one of {FLASH_DTYPES}")


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool) -> torch.Tensor:
    """Launch B7 on CUDA tensors the caller has checked: q (B, Sq, H, dh),
    k and v (B, Sk, KV, dh), one dtype, contiguous, on one device ->
    o (B, Sq, H, dh).  Two named kernels, chosen by dtype
    (``flash_plan``): float32 to ``flash_fwd``, bfloat16 to
    ``flash_fwd_sm90``; both load 16-byte chunks (cp.async, TMA), so the
    operands must be 16-byte aligned."""
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    name, dh_pad, key_tile = flash_plan(q.dtype, dh)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: operands must be 16-byte aligned")
    o = torch.empty_like(q)
    where = f"B={b} Sq={sq} Sk={sk} H={h} KV={kv} dh={dh}"
    with torch.cuda.device(q.device):
        if name == "flash_fwd":
            lib = _flash_library()
            err = lib.mrsch_flash_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b,
                sq, sk, h, kv, dh, key_tile, int(causal), dh ** -0.5,
                _stream(q.device))
        else:
            lib = _flash_sm90_library()
            err = lib.mrsch_flash_fwd_sm90(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b,
                sq, sk, h, kv, dh, dh_pad, key_tile, int(causal), dh ** -0.5,
                _stream(q.device))
    check_launch(lib, name, err, where)
    return o
