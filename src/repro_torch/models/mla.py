"""Multi-head Latent Attention of DeepSeek V2/V3 (the JAX package's
``models/mla.py``).

Prefill runs the decompressed form: per-head keys and values come out of
the compressed latent ``c`` through ``w_uk`` and ``w_uv``, and attention
takes the path ``attention_apply`` takes (``dense_attention`` up to
``dense_threshold``; beyond it B7 on the ``"kernel"`` backend, the
reference's ``flash_attention_scan`` on the ``"torch"`` backend).  B7 takes
one head dim for q, k and v, and MLA's v (``v_head_dim``, 128) is narrower
than its q and k (nope + rope, 192): v is zero-padded to q's width for the
call and the output sliced back, which leaves the softmax, and so the
scale ``(nope + rope) ** -0.5`` of both reference paths, unchanged.

Decode runs the absorbed form against the compressed cache (rank
``kv_lora_rank`` latent plus the shared rope key per token): ``w_uk`` is
folded into the query and ``w_uv`` applied to the attended latent, so the
cache holds ``kv_lora_rank + qk_rope_head_dim`` numbers a token whatever
the head count.  RoPE rotates the rope dims at theta = 10,000, hard-coded
as in the reference.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import MLAConfig
from ..distributed.collectives import (attend_upto, local_heads,
                                       local_parallel, write_pos)
from ..distributed.sharding import (gather_seq, shard, split_heads,
                                    tp_row_matmul)
from ..kernels.flash_attention import flash_attention
from ..nn.backend import resolve_backend
from ..obs.profiling import annotate
from .attention import NEG_INF, dense_attention, flash_attention_scan
from .layers import RMSNorm, _init_dense, apply_rope, empty_param, rmsnorm

ROPE_THETA = 10_000.0


class MLA(nn.Module):
    """MLA's parameters with the reference's names; weights (in, out)."""

    def __init__(self, d_model: int, n_heads: int, mla: MLAConfig, dtype,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        qk_head = mla.qk_nope_head_dim + mla.qk_rope_head_dim
        if mla.q_lora_rank:
            self.w_dq = empty_param(d_model, mla.q_lora_rank, **kw)
            self.q_norm = RMSNorm(mla.q_lora_rank, dtype, device)
            self.w_uq = empty_param(mla.q_lora_rank, n_heads * qk_head, **kw)
        else:
            self.w_uq = empty_param(d_model, n_heads * qk_head, **kw)
        self.w_dkv = empty_param(d_model,
                                 mla.kv_lora_rank + mla.qk_rope_head_dim, **kw)
        self.kv_norm = RMSNorm(mla.kv_lora_rank, dtype, device)
        self.w_uk = empty_param(mla.kv_lora_rank,
                                n_heads * mla.qk_nope_head_dim, **kw)
        self.w_uv = empty_param(mla.kv_lora_rank, n_heads * mla.v_head_dim,
                                **kw)
        self.wo = empty_param(n_heads * mla.v_head_dim, d_model, **kw)

    def reset_parameters(self, generator=None) -> None:
        """Dense weights normal / sqrt(in) (the norms reset themselves)."""
        for name in ("w_dq", "w_uq", "w_dkv", "w_uk", "w_uv", "wo"):
            if hasattr(self, name):
                _init_dense(getattr(self, name), generator)


def _queries(params: MLA, x, n_heads: int, mla: MLAConfig, positions):
    qk_head = mla.qk_nope_head_dim + mla.qk_rope_head_dim
    w_uq = shard(params.w_uq, None, "heads")
    if mla.q_lora_rank:
        cq = rmsnorm(params.q_norm, x @ shard(params.w_dq, None, None))
        q = split_heads(cq @ w_uq, n_heads, qk_head, "heads")
    else:
        q = split_heads(x @ w_uq, n_heads, qk_head, "heads")
    q_nope = q[..., : mla.qk_nope_head_dim]
    q_rope = apply_rope(q[..., mla.qk_nope_head_dim:], positions, ROPE_THETA)
    return q_nope, q_rope


def _compressed_kv(params: MLA, x, mla: MLAConfig, positions):
    ckv = x @ shard(params.w_dkv, None, None)
    c = rmsnorm(params.kv_norm, ckv[..., : mla.kv_lora_rank])
    k_rope = ckv[..., mla.kv_lora_rank:][:, :, None, :]       # (B, S, 1, rope)
    k_rope = apply_rope(k_rope, positions, ROPE_THETA)[:, :, 0]
    return c, k_rope


def mla_apply(params: MLA, x, positions, *, n_heads: int, mla: MLAConfig,
              dense_threshold: int = 2048,
              backend: str = "kernel") -> torch.Tensor:
    """Decompressed-form MLA for prefill.  x (B, S, D) -> (B, S, D).  The
    attention core runs inside the profiler range ``mrsch.lm.attention``,
    as ``attention_apply``'s does."""
    B, S, _ = x.shape
    x = gather_seq(x)                 # one gather for the down projections
    q_nope, q_rope = _queries(params, x, n_heads, mla, positions)
    c, k_rope = _compressed_kv(params, x, mla, positions)
    k_nope = split_heads(c @ shard(params.w_uk, None, "heads"), n_heads,
                         mla.qk_nope_head_dim, "heads")
    v = split_heads(c @ shard(params.w_uv, None, "heads"), n_heads,
                    mla.v_head_dim, "heads")
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, n_heads, mla.qk_rope_head_dim)], dim=-1)
    with annotate("mrsch.lm.attention"):
        if S <= dense_threshold:
            # Grouped layout with KV == heads (MLA decompresses per head).
            out = local_heads(dense_attention, q[:, :, :, None, :], k, v,
                              causal=True)
        elif resolve_backend(backend) == "kernel":
            pad = q.shape[-1] - mla.v_head_dim
            out = flash_attention(q, k, F.pad(v, (0, pad)),
                                  causal=True)[..., : mla.v_head_dim]
        else:
            out = local_heads(flash_attention_scan, q[:, :, :, None, :], k,
                              v, causal=True)
    out = out.reshape(B, S, n_heads * mla.v_head_dim)
    return shard(tp_row_matmul(out, shard(params.wo, "heads", None)),
                 "batch", "act_seq", None)


def _absorbed_core(q_abs, q_rope, cache_c, cache_rope, pos: int,
                   scale: float, seq_lo: int = 0, seq_group=None):
    """The absorbed decode's attention: scores q_abs c + q_rope k_rope over
    the cached positions <= pos, softmax, and the attended latent
    (B, H, lora).  The caches hold positions ``seq_lo`` on; the ranks of
    ``seq_group`` hold the others, and the softmax and the sum are
    finished across them."""
    s = (torch.einsum("bhl,btl->bht", q_abs, cache_c.to(q_abs.dtype))
         + torch.einsum("bshr,btr->bht", q_rope,
                        cache_rope.to(q_rope.dtype)))
    return attend_upto(s.float() * scale, cache_c.to(q_abs.dtype),
                       "bht,btl->bhl", pos, seq_lo, seq_group)


def mla_decode_apply(params: MLA, x, cache_c, cache_rope, pos: int, *,
                     n_heads: int, mla: MLAConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Absorbed-form decode of the token at ``pos`` (a Python int).
    x (B, 1, D); cache_c (B, Smax, kv_lora) and cache_rope (B, Smax, rope)
    take the token's latent and rope key at ``pos`` in place (the
    reference returns updated copies).  Scores q_nope W_uk^T c +
    q_rope k_rope over positions <= pos.  Returns (out (B, 1, D), cache_c,
    cache_rope)."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
    q_nope, q_rope = _queries(params, x, n_heads, mla, positions)
    c, k_rope = _compressed_kv(params, x, mla, positions)
    write_pos(cache_c, pos, c[:, 0])
    write_pos(cache_rope, pos, k_rope[:, 0])
    # Absorb W_uk into the query: (B,1,H,nope) x (lora,H,nope) -> (B,H,lora).
    w_uk = params.w_uk.reshape(mla.kv_lora_rank, n_heads,
                               mla.qk_nope_head_dim)
    q_abs = torch.einsum("bshn,lhn->bhl", q_nope, w_uk)
    scale = (mla.qk_nope_head_dim + mla.qk_rope_head_dim) ** -0.5
    # Parallel over the batch and the heads, and over the cache's
    # positions where the rules shard them.
    ctx = local_parallel(_absorbed_core, (q_abs, q_rope, cache_c, cache_rope),
                         ((0, 1), (0, 2), (0, None), (0, None)), (0, 1),
                         split=(None, None, 1, 1), pos=pos, scale=scale)
    w_uv = params.w_uv.reshape(mla.kv_lora_rank, n_heads, mla.v_head_dim)
    out = torch.einsum("bhl,lhv->bhv", ctx, w_uv).reshape(B, 1, -1)
    return shard(out @ params.wo, "batch", None, None), cache_c, cache_rope
