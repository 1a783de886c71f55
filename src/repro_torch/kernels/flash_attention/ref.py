"""Plain PyTorch versions of the attention kernels (the JAX package's
``kernels/flash_attention/ref.py`` and the arithmetic of its
``flash_attention_kernel``, ``mha_fwd_kernel`` and ``mha_bwd_kernels``):
the CPU path, and the oracles the CUDA kernels are held against on the
card.

``flash_attention_ref`` is B7's: causal or full attention in the models'
layout, float32 scores and sums, with p rounded to v's dtype before p . v.
The rest is the masked non-causal attention (B5, B6), all in float32.

Keys at positions ``>= length`` of their batch-head row are masked, the
positions compared in float32; queries are never masked.  A row with
length 0 outputs exactly 0, its lse is about -1e30 (finite) and its
gradients are exactly 0.  Masked probabilities are selected away with
``where``, not multiplied by the mask: on a fully masked row the
backward's ``exp(s - lse)`` overflows to inf, and inf * 0 is NaN.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _key_mask(lengths: torch.Tensor, sk: int) -> torch.Tensor:
    """(BH, 1, Sk) bool: key position < the row's length, in float32."""
    kpos = torch.arange(sk, dtype=torch.float32, device=lengths.device)
    return kpos[None, None, :] < lengths.float()[:, None, None]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense softmax attention: q (BH, Sq, dh), k/v (BH, Sk, dh) ->
    (BH, Sq, dh) in q's dtype; ``lengths`` (BH,) masks keys at positions
    >= length, and a row with length 0 outputs exactly 0."""
    scale = q.shape[-1] ** -0.5
    sk = k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    kmask = None
    if lengths is not None:
        kmask = _key_mask(lengths, sk)
        s = torch.where(kmask, s, NEG_INF)
    if causal:
        sq = s.shape[-2]
        cmask = (torch.arange(sq, device=s.device)[:, None]
                 >= torch.arange(sk, device=s.device)[None, :])
        s = torch.where(cmask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    if kmask is not None:
        w = torch.where(kmask, w, 0.0)
    return torch.einsum("bqk,bkd->bqd", w, v.float()).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """B7's function, in one key block: q (B, Sq, H, dh), k and v
    (B, Sk, KV, dh) -> (B, Sq, H, dh) in q's dtype.  Query head h reads KV
    head h // (H // KV); with ``causal`` query i sees keys j <= i (top-left
    aligned when Sq != Sk).  Scores and sums are float32; m is the row's
    max, p = exp(s - m), l = sum p, and o = (p in v's dtype) . v / max(l,
    1e-30), as the kernel finalises its online softmax."""
    b, sq, h, dh = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, sq, kv, g, dh)
    s = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * dh ** -0.5
    if causal:
        sk = k.shape[1]
        cmask = (torch.arange(sq, device=s.device)[:, None]
                 >= torch.arange(sk, device=s.device)[None, :])
        s = torch.where(cmask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgst,btkd->bkgsd", p.to(v.dtype).float(), v.float())
    o = (o / l).to(q.dtype)                                  # (b,kv,g,sq,dh)
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh)


def mha_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                lengths: torch.Tensor) -> tuple:
    """(o (BH, Sq, dh), lse (BH, Sq)) of the masked non-causal attention,
    with the flash finalisation of ``mha_fwd_kernel`` over one key block:
    m = the row's max masked score, p = exp(s - m) on valid keys,
    l = sum p, o = (p @ v) / max(l, 1e-30), lse = m + log(max(l, 1e-30)).
    A fully masked row has m = -1e30 and l = 0: o = 0 and a finite lse."""
    scale = q.shape[-1] ** -0.5
    kmask = _key_mask(lengths, k.shape[1])
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    s = torch.where(kmask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(kmask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bqk,bkd->bqd", p, v.float()) / l
    return o, (m + torch.log(l))[..., 0]


def mha_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                lengths: torch.Tensor) -> tuple:
    """(dq, dk, dv) by ``mha_bwd_kernels``' formula, recomputing
    p = exp(s - lse) on valid keys: ds = p * (do @ v.T - delta) * scale,
    dq = ds @ k, dk = ds.T @ q, dv = p.T @ do.  ``delta`` (BH, Sq) is
    rowsum(do * o).  Not autograd: it checks the kernels' own arithmetic."""
    scale = q.shape[-1] ** -0.5
    q, k, v, do = q.float(), k.float(), v.float(), do.float()
    kmask = _key_mask(lengths, k.shape[1])
    s = torch.einsum("bqd,bkd->bqk", q, k) * scale
    p = torch.where(kmask, torch.exp(s - lse.float()[..., None]), 0.0)
    dp = torch.einsum("bqd,bkd->bqk", do, v)
    ds = p * (dp - delta.float()[..., None]) * scale
    dq = torch.einsum("bqk,bkd->bqd", ds, k)
    dk = torch.einsum("bqk,bqd->bkd", ds, q)
    dv = torch.einsum("bqk,bqd->bkd", p, do)
    return dq, dk, dv
