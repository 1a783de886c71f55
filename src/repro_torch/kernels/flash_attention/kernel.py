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
from dataclasses import dataclass
from pathlib import Path

import torch

from .._build import BuildInfo, build_library, check_launch, load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "mha.cu"
BWD_SOURCE = SOURCE.with_name("mha_bwd.cu")
FLASH_SOURCE = SOURCE.with_name("flash_fwd.cu")
FLASH_SM90_SOURCE = SOURCE.with_name("flash_fwd_sm90.cu")

HEAD_DIMS = (8, 16, 32, 64)     # the dh the mha kernels are instantiated for
MHA_KINDS = ("mha_fwd", "mha_bwd_dq", "mha_bwd_dkv")
# Per dh: the most warps (16 rows each) a block of the mha kernels runs, as
# csrc/mha_common.cuh's Geom (registers bound it: at dh <= 16 two blocks of
# 9 warps share an SM), and the most rows a shared stage holds (a ring of
# two stages beyond it).
MHA_MAX_WARPS = {8: 9, 16: 9, 32: 8, 64: 4}
MHA_MAX_STAGE = {8: 256, 16: 160, 32: 64, 64: 32}
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
    lib.mrsch_mha_fwd.argtypes = [_P] * 6 + [_I] * 8 + [ctypes.c_float, _P]
    lib.mrsch_mha_fwd.restype = ctypes.c_int
    return lib


@functools.cache
def _backward_library() -> ctypes.CDLL:
    lib = load_library(build_backward())
    lib.mrsch_mha_bwd_dq.argtypes = ([_P] * 8 + [_I] * 8
                                     + [ctypes.c_float, _P])
    lib.mrsch_mha_bwd_dkv.argtypes = ([_P] * 9 + [_I] * 8
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


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _pitches(dh: int) -> tuple:
    """(rows read as rows, rows read as columns): Geom's kPR and kPC."""
    return (8 if dh == 8 else dh if dh % 32 == 16 else dh + 16), dh + 4


@dataclass(frozen=True)
class MhaPlan:
    """Launch plan of one masked-attention kernel.  A block owns ``rows``
    rows (16 a warp) of one batch-head: query rows for ``mha_fwd`` and
    ``mha_bwd_dq``, key rows for ``mha_bwd_dkv``; ``tiles`` blocks cover a
    batch-head.  It streams the other side (keys; queries for dkv) through
    ``stages`` shared stages of ``stage`` rows each; ``smem`` bytes hold
    them (for dkv also the warps' partial sums, 32 dh floats a warp)."""
    rows: int
    tiles: int
    stage: int
    stages: int
    smem: int


def mha_plan(kind: str, bh: int, sq: int, sk: int, dh: int,
             sm_count: int) -> MhaPlan:
    """The plan of ``kind`` (one of ``MHA_KINDS``) at these shapes.

    A block holds all of a batch-head's rows (16 ceil(n / 16), n = Sq, or
    Sk for dkv) while that is at most 16 ``MHA_MAX_WARPS[dh]`` (144 at dh
    <= 16: the main path's 129 rows), else the fewest tiles of whole warps
    that fit.  The forward and dq split the query rows over more tiles, of
    at least 3 warps each, while the blocks would not fill the SMs once
    (the service's BH = 4); dkv keeps one block per batch-head or key
    tile, and splits the query rows among the warps its kept keys leave
    idle.  A stage holds the other side's rows rounded up to 16, at most
    ``MHA_MAX_STAGE[dh]``: one stage when that holds them all, else a ring
    of two.  Fixed by the shapes and the card's SM count, never a
    fallback."""
    if kind not in MHA_KINDS:
        raise ValueError(f"mha_plan: unknown kernel {kind!r}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"mha_plan: head dim {dh} has no kernel; "
                         f"expected one of {HEAD_DIMS}")
    own, other = (sk, sq) if kind == "mha_bwd_dkv" else (sq, sk)
    n16 = -(-own // 16)
    tiles = -(-n16 // MHA_MAX_WARPS[dh])
    if kind != "mha_bwd_dkv":
        while bh * tiles < sm_count and -(-n16 // (tiles + 1)) >= 3:
            tiles += 1
    warps = -(-n16 // tiles)
    tiles = -(-n16 // warps)
    stage = min(-(-other // 16) * 16, MHA_MAX_STAGE[dh])
    stages = 1 if stage >= other else 2
    p_rows, p_cols = _pitches(dh)
    # Floats a staged row takes: hi and lo planes of k and v, or, for dkv,
    # of q and do with lse and delta, after the block's own k and v rows
    # (hi and lo planes); dkv's warps' partial sums then reuse it all.
    if kind == "mha_bwd_dkv":
        smem = 4 * (stages * stage * (4 * p_cols + 2)
                    + 4 * 16 * warps * p_rows)
        smem = max(smem, 128 * dh * warps)
    else:
        smem = 4 * stages * stage * 2 * (p_rows + p_cols)
    return MhaPlan(16 * warps, tiles, stage, stages, smem)


def _check_aligned(name: str, *tensors: torch.Tensor) -> None:
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: operands must be 16-byte aligned")


def _plan(kind: str, q: torch.Tensor, k: torch.Tensor) -> tuple:
    bh, sq, dh = q.shape
    sk = k.shape[1]
    plan = mha_plan(kind, bh, sq, sk, dh, _sm_count(q.device))
    return (bh, sq, sk, dh, plan.rows, plan.tiles, plan.stage, plan.smem,
            dh ** -0.5)


def mha_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                lengths: torch.Tensor) -> tuple:
    """Launch B5 on CUDA tensors the caller has checked: q (BH, Sq, dh),
    k, v (BH, Sk, dh), lengths (BH,), float32, contiguous, on one device
    -> (o (BH, Sq, dh), lse (BH, Sq)).  The kernel stages and reads 16
    bytes at a time: q, k and v must be 16-byte aligned."""
    _check_aligned("mha_fwd", q, k, v)
    dims = _plan("mha_fwd", q, k)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.mrsch_mha_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                lengths.data_ptr(), o.data_ptr(),
                                lse.data_ptr(), *dims, _stream(q.device))
    check_launch(lib, "mha_fwd", err, "BH={} Sq={} Sk={} dh={}".format(*dims))
    return o, lse


def mha_backward_dq(q, k, v, do, lse, delta, lengths) -> torch.Tensor:
    """Launch B6's dq kernel on checked CUDA tensors -> dq (BH, Sq, dh);
    q, k, v and do 16-byte aligned."""
    _check_aligned("mha_bwd_dq", q, k, v, do)
    dims = _plan("mha_bwd_dq", q, k)
    dq = torch.empty_like(q)
    lib = _backward_library()
    with torch.cuda.device(q.device):
        err = lib.mrsch_mha_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), lengths.data_ptr(),
            dq.data_ptr(), *dims, _stream(q.device))
    check_launch(lib, "mha_bwd_dq", err,
                 "BH={} Sq={} Sk={} dh={}".format(*dims))
    return dq


def mha_backward_dkv(q, k, v, do, lse, delta, lengths) -> tuple:
    """Launch B6's dkv kernel on checked CUDA tensors -> (dk, dv), each
    (BH, Sk, dh); q, k, v and do 16-byte aligned."""
    _check_aligned("mha_bwd_dkv", q, k, v, do)
    dims = _plan("mha_bwd_dkv", q, k)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _backward_library()
    with torch.cuda.device(q.device):
        err = lib.mrsch_mha_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), lengths.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), *dims, _stream(q.device))
    check_launch(lib, "mha_bwd_dkv", err,
                 "BH={} Sq={} Sk={} dh={}".format(*dims))
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
