"""Shared building blocks of the LM zoo (the JAX package's
``models/layers.py``).

Parameters live in small ``nn.Module``s whose tensors carry the reference's
names and layouts (a dense weight is ``(in, out)``), so a JAX parameter
tree converts leaf for leaf (``repro_torch.convert.lm_params_from_jax``).
A module is made empty; its ``reset_parameters(generator)`` draws its
weights with the reference's distributions from a ``torch.Generator``
(the numbers differ from ``jax.random``'s), and each ``*_init`` does
both.  The ``*_apply`` functions mirror the reference's:
compute in the parameters' dtype, norms and softmax in float32.
Parameters are made without gradients; the training entry points turn
them on (``launch.steps.make_train_step``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..distributed.sharding import shard as _shard
from ..distributed.collectives import embed_rows as _embed_rows
from ..distributed.collectives import mean_last as _mean_last
from ..distributed.collectives import replicated_on as _replicated_on
from ..distributed.collectives import take_last as _take_last
from ..distributed.sharding import gather_seq as _gather_seq
from ..distributed.sharding import seq_matmul as _seq_matmul
from ..distributed.sharding import tp_row_matmul as _tp_row


def empty_param(*shape: int, dtype, device) -> nn.Parameter:
    """An uninitialised parameter that takes no gradient."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def _normal(shape, generator, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32)


def _init_dense(p: nn.Parameter, generator, scale: float = 1.0) -> None:
    """Fill an (in, out) weight from normal(0, 1) * scale / sqrt(in)."""
    std = scale / math.sqrt(p.shape[0])
    p.copy_(_normal(p.shape, generator, p.device) * std)


# ----------------------------------------------------------------- norms
class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype, device=None):
        super().__init__()
        self.scale = empty_param(d, dtype=dtype, device=device)

    def reset_parameters(self, generator=None) -> None:
        nn.init.ones_(self.scale)


def rmsnorm_init(d: int, dtype, device=None) -> RMSNorm:
    m = RMSNorm(d, dtype, device)
    m.reset_parameters()
    return m


def rmsnorm(params: RMSNorm, x: torch.Tensor, eps: float = 1e-5):
    xf = x.float()
    var = _mean_last(xf * xf)
    y = xf * torch.rsqrt(var + eps)
    return (y * params.scale.float()).to(x.dtype)


# ----------------------------------------------------------------- rope
def rope_frequencies(head_dim: int, theta: float, fraction: float = 1.0,
                     device=None):
    rot = int(head_dim * fraction) // 2 * 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** exps), rot


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """x (..., S, H, dh); positions (..., S).  Rotates interleaved pairs
    (``0::2``, ``1::2``) over the leading ``fraction`` of the head dim
    (partial rotary for stablelm and chatglm)."""
    dh = x.shape[-1]
    inv, rot = rope_frequencies(dh, theta, fraction, x.device)
    if rot == 0:
        return x
    ang = positions[..., :, None].float() * inv             # (..., S, rot/2)
    # On a sharded x the angles join its mesh as replicated DTensors, so
    # the backward needs no implicit replication.
    cos = _replicated_on(torch.cos(ang)[..., :, None, :], x)
    sin = _replicated_on(torch.sin(ang)[..., :, None, :], x)
    xr = x[..., :rot].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(*x1.shape[:-1], rot)
    return torch.cat([yr.to(x.dtype), x[..., rot:]], dim=-1)


# ----------------------------------------------------------------- embed
class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, dtype, device=None):
        super().__init__()
        self.table = empty_param(vocab, d, dtype=dtype, device=device)

    def reset_parameters(self, generator=None) -> None:
        self.table.copy_(_normal(self.table.shape, generator,
                                 self.table.device))


def embedding_init(vocab: int, d: int, dtype, *, generator,
                   device=None) -> Embedding:
    m = Embedding(vocab, d, dtype, device)
    m.reset_parameters(generator)
    return m


def embedding_lookup(params: Embedding, tokens: torch.Tensor):
    table = _shard(params.table, "vocab", None)       # gather fsdp dim
    return _shard(_embed_rows(table, tokens), "batch", None, None)


def _softcap(logits: torch.Tensor, softcap: float) -> torch.Tensor:
    return torch.tanh(logits / softcap) * softcap if softcap else logits


def unembed(params: Embedding, x: torch.Tensor, softcap: float = 0.0):
    """Logits through the tied embedding table, float32."""
    table = _shard(params.table, "vocab", None)
    return _shard(_softcap(_seq_matmul(x, table.t()).float(), softcap),
                  "batch", "act_seq", "vocab")


class LMHead(nn.Module):
    def __init__(self, d: int, vocab: int, dtype, device=None):
        super().__init__()
        self.w = empty_param(d, vocab, dtype=dtype, device=device)

    def reset_parameters(self, generator=None) -> None:
        _init_dense(self.w, generator)


def lm_head_init(d: int, vocab: int, dtype, *, generator,
                 device=None) -> LMHead:
    m = LMHead(d, vocab, dtype, device)
    m.reset_parameters(generator)
    return m


def lm_head_apply(params: LMHead, x: torch.Tensor, softcap: float = 0.0):
    logits = _softcap(_seq_matmul(x, _shard(params.w, None, "vocab")).float(),
                      softcap)
    return _shard(logits, "batch", "act_seq", "vocab")


# ----------------------------------------------------------------- ffn
class FFN(nn.Module):
    def __init__(self, d: int, f: int, glu: bool, dtype, device=None):
        super().__init__()
        self.w_up = empty_param(d, f, dtype=dtype, device=device)
        self.w_down = empty_param(f, d, dtype=dtype, device=device)
        self.w_gate: Optional[nn.Parameter] = (
            empty_param(d, f, dtype=dtype, device=device) if glu else None)

    def reset_parameters(self, generator=None) -> None:
        for p in (self.w_up, self.w_down, self.w_gate):
            if p is not None:
                _init_dense(p, generator)


def ffn_init(d: int, f: int, glu: bool, dtype, *, generator,
             device=None) -> FFN:
    m = FFN(d, f, glu, dtype, device)
    m.reset_parameters(generator)
    return m


def _act(name: str):
    if name == "silu":
        return torch.nn.functional.silu
    if name == "gelu":        # jax.nn.gelu's default is the tanh form
        return lambda x: torch.nn.functional.gelu(x, approximate="tanh")
    if name == "relu2":
        return lambda x: torch.square(torch.relu(x))
    raise ValueError(name)


def ffn_apply(params: FFN, x: torch.Tensor, act: str, glu: bool):
    # ZeRO-3 "gather-on-use": weights are stored fsdp-sharded over data;
    # the use-site layout (None, mlp) gathers the weight instead of
    # partial-sum reducing the (B, S, F) activation.
    x = _gather_seq(x)
    up = _shard(x @ _shard(params.w_up, None, "mlp"), "batch", None, "mlp")
    if glu:
        gate = _shard(x @ _shard(params.w_gate, None, "mlp"),
                      "batch", None, "mlp")
        h = _act(act)(gate) * up
    else:
        h = _act(act)(up)
    out = _tp_row(h, _shard(params.w_down, "mlp", None))
    return _shard(out, "batch", "act_seq", None)


# ----------------------------------------------------------------- losses
def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None):
    """logits (B, S, V), labels (B, S) -> scalar mean nll, float32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = _take_last(logits, labels.long())
    nll = logz - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()
