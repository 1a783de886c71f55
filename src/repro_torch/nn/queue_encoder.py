"""Queue-as-tokens attention state encoder (the JAX package's
``repro/nn/queue_encoder.py``).

The paper's state vector observes only the first W queued jobs.  This
module observes up to ``queue_cap`` of them: every waiting job becomes one
token of per-job features, the cluster context (free fraction and mean
time-to-free per resource) is an always-valid token 0, and a small
pre-norm transformer runs non-causal attention masked to the true queue
length.  On the ``"kernel"`` backend the attention runs the hand-written
masked-attention kernels (``repro_torch.kernels.flash_attention.mha``,
whose gradient runs their backward) and every dense layer the fused-MLP
kernels; on ``"torch"`` both run as plain PyTorch ops.

Pooling into the DFP state features: [context-token output | masked mean
over the job tokens | the first W job-token embeddings, zeroed where
invalid] -> dense -> leaky_relu.  The mean sees the whole queue; the W
positional read-outs tell the action stream which job sits in which
window slot.  The flat state layout is ``repro_torch.core.encoding``'s
(``state_module="attention"``).

Parameters are named as the JAX package's tree names them (``tok``,
``ctx``, ``blocks.<i>.{ln1, wq, wk, wv, wo, ln2, mlp}``, ``ln_f``,
``out``; a layer norm's ``scale`` and ``bias``), so ``convert`` carries
them across in flatten order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..kernels.flash_attention.ops import mha
from ..kernels.flash_attention.ref import attention_ref
from .backend import dense_forward, resolve_backend
from .modules import MLP, Dense

LN_EPS = 1e-5


@dataclass(frozen=True)
class QueueEncoderConfig:
    """Static architecture of the queue encoder.

    ``queue_cap`` (Q) is the token-buffer size; no parameter depends on it.
    ``window`` (W) is how many leading job tokens are read out
    positionally for the action slots.
    """
    queue_cap: int               # Q: job-token buffer size
    job_dim: int                 # per-job feature width (R + 2)
    ctx_dim: int                 # context-token feature width (2R)
    window: int                  # W: positional read-out slots
    d_model: int = 64
    n_heads: int = 4
    n_layers: int = 2
    mlp_mult: int = 2
    out_dim: int = 512           # DFP state-feature width

    def __post_init__(self):
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} not divisible by "
                             f"n_heads {self.n_heads}")
        if self.queue_cap < self.window:
            raise ValueError(f"queue_cap {self.queue_cap} < window "
                             f"{self.window}: the window slots are the "
                             "leading queue tokens")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


class LayerNorm(nn.Module):
    """(x - mean) * rsqrt(biased variance + 1e-5) * scale + bias over the
    last axis.  Not ``nn.LayerNorm``: its parameter is named ``weight``,
    and the reference's ``scale`` keeps the leaf order of ``convert``."""

    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mu = x.mean(dim=-1, keepdim=True)
        var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + LN_EPS) * self.scale + self.bias


class EncoderBlock(nn.Module):
    """One pre-norm layer: attention (``wq``, ``wk``, ``wv``, ``wo``) after
    ``ln1``, a two-layer MLP after ``ln2``, each added to the residual."""

    def __init__(self, d: int, mlp_mult: int, **kw):
        super().__init__()
        self.ln1 = LayerNorm(d, device=kw.get("device"))
        self.wq = Dense(d, d, **kw)
        self.wk = Dense(d, d, **kw)
        self.wv = Dense(d, d, **kw)
        self.wo = Dense(d, d, **kw)
        self.ln2 = LayerNorm(d, device=kw.get("device"))
        self.mlp = MLP([d, mlp_mult * d, d], **kw)


class QueueEncoder(nn.Module):
    """The encoder's weights, as the JAX package's ``queue_encoder_init``
    lays them out; the forward is ``queue_state_features``."""

    def __init__(self, cfg: QueueEncoderConfig, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        d = cfg.d_model
        self.tok = Dense(cfg.job_dim, d, **kw)
        self.ctx = Dense(cfg.ctx_dim, d, **kw)
        self.blocks = nn.ModuleList(EncoderBlock(d, cfg.mlp_mult, **kw)
                                    for _ in range(cfg.n_layers))
        self.ln_f = LayerNorm(d, device=device)
        self.out = Dense(d * (2 + cfg.window), cfg.out_dim, **kw)


def _dense(layer: Dense, x: torch.Tensor, activation: Optional[str] = None,
           *, backend: str) -> torch.Tensor:
    """``dense_forward`` over any leading dims: the fused kernel is 2-D and
    takes contiguous rows only."""
    flat = x.reshape(-1, x.shape[-1]).contiguous()
    y = dense_forward(layer, flat, activation, backend=backend)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            lengths: torch.Tensor, *, backend: str) -> torch.Tensor:
    """(B, S, H, hd) self-attention, keys masked to per-batch lengths."""
    B, S, H, hd = q.shape

    def heads(t: torch.Tensor) -> torch.Tensor:       # -> (B * H, S, hd)
        return t.transpose(1, 2).reshape(B * H, S, hd).contiguous()

    lens = lengths.repeat_interleave(H)               # b-major, h-minor
    if backend == "kernel":
        out = mha(heads(q), heads(k), heads(v), lens)
    else:
        out = attention_ref(heads(q), heads(k), heads(v), causal=False,
                            lengths=lens)
    return out.reshape(B, H, S, hd).transpose(1, 2)


def encode_queue_tokens(enc: QueueEncoder, cfg: QueueEncoderConfig,
                        tokens: torch.Tensor, qlen: torch.Tensor,
                        ctx: torch.Tensor, *,
                        backend: str = "kernel") -> torch.Tensor:
    """Per-token embeddings (B, 1 + Q, d_model); token 0 is the context.

    ``tokens`` (B, Q, job_dim) zero-padded past the queue, ``qlen`` (B,)
    true queue lengths, ``ctx`` (B, ctx_dim).  Keys are masked to
    ``1 + qlen`` (the context token is always valid); every query slot
    gets an output, so a padded slot's embedding depends on the valid
    tokens only.
    """
    resolve_backend(backend)
    B, Q, _ = tokens.shape
    tok = _dense(enc.tok, tokens, backend=backend)
    ctx_t = _dense(enc.ctx, ctx, backend=backend)[:, None]
    x = torch.cat([ctx_t, tok], dim=1)                # (B, S = 1 + Q, d)
    S, H, hd = 1 + Q, cfg.n_heads, cfg.head_dim
    lengths = qlen.float() + 1.0
    for blk in enc.blocks:
        h = blk.ln1(x)
        qh, kh, vh = (_dense(w, h, backend=backend).reshape(B, S, H, hd)
                      for w in (blk.wq, blk.wk, blk.wv))
        a = _attend(qh, kh, vh, lengths, backend=backend)
        x = x + _dense(blk.wo, a.reshape(B, S, cfg.d_model), backend=backend)
        m = _dense(blk.mlp.layers[0], blk.ln2(x), "leaky_relu",
                   backend=backend)
        x = x + _dense(blk.mlp.layers[1], m, backend=backend)
    return enc.ln_f(x)


def queue_state_features(enc: QueueEncoder, cfg: QueueEncoderConfig,
                         state: torch.Tensor, *,
                         backend: str = "kernel") -> torch.Tensor:
    """Flat attention-layout state (..., state_dim) -> (..., out_dim).

    Layout: ``[Q * job_dim tokens | queue_len | ctx (ctx_dim)]``.
    """
    Q, jd, W = cfg.queue_cap, cfg.job_dim, cfg.window
    lead = state.shape[:-1]
    flat = state.reshape(-1, state.shape[-1])
    B = flat.shape[0]
    tokens = flat[:, :Q * jd].reshape(B, Q, jd)
    qlen = flat[:, Q * jd]
    ctx = flat[:, Q * jd + 1:Q * jd + 1 + cfg.ctx_dim]
    h = encode_queue_tokens(enc, cfg, tokens, qlen, ctx, backend=backend)
    hc, jobs = h[:, 0], h[:, 1:]                      # (B, d), (B, Q, d)
    valid = (torch.arange(Q, dtype=torch.float32, device=h.device)[None, :]
             < qlen[:, None]).to(h.dtype)             # (B, Q)
    mean = ((jobs * valid[..., None]).sum(dim=1)
            / valid.sum(dim=1, keepdim=True).clamp_min(1.0))
    win = jobs[:, :W] * valid[:, :W, None]
    feat = torch.cat([hc, mean, win.reshape(B, W * cfg.d_model)], dim=-1)
    y = _dense(enc.out, feat, "leaky_relu", backend=backend)
    return y.reshape(*lead, cfg.out_dim)
