"""GQA/MQA self-attention for train and prefill (the JAX package's
``models/attention.py``).

Path selection, as in the reference (``attention_apply``):

* ``S <= dense_threshold``: ``dense_attention``, the full score matrix in
  plain PyTorch (XLA einsums in the reference), on both backends;
* ``S > dense_threshold``: on the ``"kernel"`` backend the causal flash
  kernel B7 (``kernels.flash_attention.flash_attention``: the CUDA kernel
  on the card, its plain version on the CPU); on the ``"torch"`` backend
  ``flash_attention_scan``, the reference's online softmax over blocks of
  1024 keys, as a Python loop.  Both keep the reference's head order:
  query head h reads KV head h // (H // KV).

The one-token decode (``decode_attention_apply``) is the reference's
plain masked softmax over the whole cache, with no kernel.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..distributed.collectives import (attend_upto, local_heads,
                                       local_parallel, write_pos)
from ..distributed.sharding import (gather_seq, mesh_rules, shard,
                                    split_heads, tp_row_matmul)
from ..kernels.flash_attention import flash_attention
from ..nn.backend import resolve_backend
from ..obs.profiling import annotate
from .layers import _init_dense, apply_rope, empty_param

NEG_INF = -1e30


class Attention(nn.Module):
    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int,
                 head_dim: int, dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.wq = empty_param(d_model, n_heads * head_dim, **kw)
        self.wk = empty_param(d_model, n_kv_heads * head_dim, **kw)
        self.wv = empty_param(d_model, n_kv_heads * head_dim, **kw)
        self.wo = empty_param(n_heads * head_dim, d_model, **kw)

    def reset_parameters(self, generator=None) -> None:
        for p in (self.wq, self.wk, self.wv, self.wo):
            _init_dense(p, generator)


def attention_init(d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, dtype, *, generator,
                   device=None) -> Attention:
    m = Attention(d_model, n_heads, n_kv_heads, head_dim, dtype, device)
    m.reset_parameters(generator)
    return m


def _project_qkv(params: Attention, x, n_heads, n_kv_heads, head_dim,
                 positions, rope_theta, rope_fraction):
    x = gather_seq(x)                             # one gather for q, k, v
    wq = shard(params.wq, None, "heads")          # gather fsdp dim on use
    wk = shard(params.wk, None, "kv_heads")
    wv = shard(params.wv, None, "kv_heads")
    q = split_heads(x @ wq, n_heads, head_dim, "heads")
    k = split_heads(x @ wk, n_kv_heads, head_dim, "kv_heads")
    v = split_heads(x @ wv, n_kv_heads, head_dim, "kv_heads")
    if rope_theta:
        q = apply_rope(q, positions, rope_theta, rope_fraction)
        k = apply_rope(k, positions, rope_theta, rope_fraction)
    return q, k, v


def _group_heads(q: torch.Tensor, n_kv_heads: int) -> torch.Tensor:
    """(B, S, H, dh) -> (B, S, KV, G, dh), splitting query heads into KV
    groups."""
    B, S, H, dh = q.shape
    rules = mesh_rules()
    if rules is not None and rules.resolve("kv_heads", n_kv_heads) is None:
        # Heads sharded past the KV groups: a DTensor cannot split them.
        q = shard(q, "batch", None, None, None)
    return q.reshape(B, S, n_kv_heads, H // n_kv_heads, dh)


def dense_attention(q, k, v, causal: bool = True,
                    q_offset: int = 0) -> torch.Tensor:
    """Full-matrix grouped attention.  q (B, S, KV, G, dh), k and v
    (B, T, KV, dh)."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bskgd,btkd->bkgst", q, k).float() * scale
    if causal:
        S, T = scores.shape[-2], scores.shape[-1]
        qpos = torch.arange(S, device=q.device)[:, None] + q_offset
        mask = qpos >= torch.arange(T, device=q.device)[None, :]
        scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgst,btkd->bskgd", w, v)


def flash_attention_scan(q, k, v, block_k: int = 1024,
                         causal: bool = True) -> torch.Tensor:
    """Online softmax over blocks of ``block_k`` keys.  q (B, S, KV, G, dh),
    k and v (B, T, KV, dh).  The reference's ``lax.scan`` over blocks is a
    Python loop here; the arithmetic per block is the same."""
    B, S, KV, G, dh = q.shape
    dv = v.shape[-1]
    T = k.shape[1]
    scale = dh ** -0.5
    qpos = torch.arange(S, device=q.device)[:, None]
    m = torch.full((B, KV, G, S), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KV, G, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, S, dv), dtype=torch.float32,
                      device=q.device)
    for start in range(0, T, block_k):
        kblk = k[:, start:start + block_k]
        vblk = v[:, start:start + block_k]
        n = kblk.shape[1]
        if n < block_k:             # the reference pads the last block
            kblk = torch.nn.functional.pad(kblk, (0, 0, 0, 0, 0, block_k - n))
            vblk = torch.nn.functional.pad(vblk, (0, 0, 0, 0, 0, block_k - n))
        s = torch.einsum("bskgd,btkd->bkgst", q, kblk).float() * scale
        kpos = start + torch.arange(block_k, device=q.device)[None, :]
        valid = kpos < T
        if causal:
            valid = valid & (qpos >= kpos)
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bkgst,btkd->bkgsd", p.to(q.dtype), vblk)
        acc = acc * alpha[..., None] + pv.float()
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)        # (B, S, KV, G, dh)


def attention_apply(params: Attention, x, positions, *, n_heads, n_kv_heads,
                    head_dim, rope_theta=10_000.0, rope_fraction=1.0,
                    causal=True, dense_threshold: int = 2048,
                    backend: str = "kernel") -> torch.Tensor:
    """Self-attention for train and prefill.  x (B, S, D).  The attention
    core (not the projections) runs inside the profiler range
    ``mrsch.lm.attention``."""
    B, S, D = x.shape
    q, k, v = _project_qkv(params, x, n_heads, n_kv_heads, head_dim,
                           positions, rope_theta, rope_fraction)
    with annotate("mrsch.lm.attention"):
        if S <= dense_threshold:
            out = local_heads(dense_attention, _group_heads(q, n_kv_heads),
                              k, v, causal=causal)
        elif resolve_backend(backend) == "kernel":
            out = flash_attention(q, k, v, causal=causal)
        else:
            out = local_heads(flash_attention_scan,
                              _group_heads(q, n_kv_heads), k, v,
                              causal=causal)
    out = out.reshape(B, S, n_heads * head_dim)
    return shard(tp_row_matmul(out, shard(params.wo, "heads", None)),
                 "batch", "act_seq", None)


def _decode_core(qg, cache_k, cache_v, pos: int, seq_lo: int = 0,
                 seq_group=None):
    """One query row (B, 1, KV, G, dh) over the cache's positions <= pos.
    The cache holds positions ``seq_lo`` on; the ranks of ``seq_group``
    hold the others, and the softmax and the weighted sum are finished
    across them."""
    scale = qg.shape[-1] ** -0.5
    s = torch.einsum("bskgd,btkd->bkgst", qg,
                     cache_k.to(qg.dtype)).float() * scale
    return attend_upto(s, cache_v.to(qg.dtype), "bkgst,btkd->bskgd", pos,
                       seq_lo, seq_group)


def decode_attention_apply(params: Attention, x, cache_k, cache_v, pos: int,
                           *, n_heads, n_kv_heads, head_dim,
                           rope_theta=10_000.0, rope_fraction=1.0
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """One-token decode at ``pos`` (a Python int, the current length).
    x (B, 1, D); cache_k and cache_v (B, Smax, KV, dh) take the token's k
    and v at ``pos`` in place (the reference returns updated copies).
    Returns (out (B, 1, D), cache_k, cache_v)."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
    q, k, v = _project_qkv(params, x, n_heads, n_kv_heads, head_dim,
                           positions, rope_theta, rope_fraction)
    write_pos(cache_k, pos, k[:, 0])
    write_pos(cache_v, pos, v[:, 0])
    # Parallel over the batch and the KV heads, and over the cache's
    # positions where the rules shard them.
    out = local_parallel(_decode_core, (_group_heads(q, n_kv_heads), cache_k,
                                        cache_v), ((0, 2),) * 3, (0, 2),
                         split=(None, 1, 1), pos=pos)
    out = out.reshape(B, 1, n_heads * head_dim) @ shard(params.wo, "heads",
                                                        None)
    return shard(out, "batch", None, None), cache_k, cache_v
