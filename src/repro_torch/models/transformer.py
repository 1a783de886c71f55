"""Config-driven decoder stack of the LM zoo, forward only (the JAX
package's ``models/transformer.py``).

One generic implementation; blocks compose by ``ModelConfig``:

* dense GQA/MQA -> attention + (GLU or squared-ReLU) FFN;
* ssm (mamba2)  -> SSD blocks, attention-free;
* hybrid (zamba2) -> SSD backbone + shared attention/MLP blocks cycled in;
* vlm / audio   -> the dense stack with an embeddings input stub (musicgen
  adds parallel codebook heads).

The reference stacks the parameters of homogeneous layers (a leading L dim)
for one ``lax.scan``; here the layers are an ``nn.ModuleList`` run in a
Python loop.  ``backend`` picks the long-sequence kernels: ``"kernel"``
runs B7 (causal flash attention, past ``dense_threshold``) and B8 (the
chunked SSD), ``"torch"`` the reference's plain PyTorch counterparts.

Not here yet, each an item of the roadmap's module queue: MLA and MoE
(the ``moe`` family: ``forward`` raises ``NotImplementedError``), the
loss with rematerialisation and training, and decode (``decode_step``,
``init_cache``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..distributed.sharding import shard
from . import attention as attn
from . import mamba2 as ssd
from .layers import (FFN, Embedding, LMHead, RMSNorm, embedding_lookup,
                     ffn_apply, lm_head_apply, rmsnorm, unembed)

NOT_PORTED = ("MLA and MoE are not ported yet (ROADMAP.md, queue A, "
              "'MLA and MoE')")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a configuration this slice cannot
    run (MLA attention or MoE FFNs)."""
    if cfg.mla is not None or cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: {NOT_PORTED}")


# ------------------------------------------------------------------ blocks
class Block(nn.Module):
    """One layer: an SSD block (``kind="ssm"``) or attention + FFN
    (``kind="attn"``), pre-norm, with the reference's parameter names."""

    def __init__(self, cfg: ModelConfig, kind: str, dtype, device=None):
        super().__init__()
        D = cfg.d_model
        self.norm1 = RMSNorm(D, dtype, device)
        if kind == "ssm":
            self.ssm = ssd.Mamba2(D, cfg.ssm, dtype, device)
            return
        self.attn = attn.Attention(D, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.resolved_head_dim, dtype, device)
        self.norm2 = RMSNorm(D, dtype, device)
        self.mlp = FFN(D, cfg.d_ff, cfg.glu, dtype, device)


class SharedBlock(nn.Module):
    """Zamba2's shared attention + MLP block."""

    def __init__(self, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        h = cfg.hybrid
        D = cfg.d_model
        self.norm1 = RMSNorm(D, dtype, device)
        self.attn = attn.Attention(D, h.shared_n_heads, h.shared_n_kv_heads,
                                   D // h.shared_n_heads, dtype, device)
        self.norm2 = RMSNorm(D, dtype, device)
        self.shared = FFN(D, h.shared_d_ff, cfg.glu, dtype, device)


def _block_apply(params: Block, cfg: ModelConfig, kind: str, x, positions,
                 backend: str):
    if kind == "ssm":
        return x + ssd.mamba2_apply(
            params.ssm, rmsnorm(params.norm1, x, cfg.norm_eps), cfg.ssm,
            backend=backend)
    h = rmsnorm(params.norm1, x, cfg.norm_eps)
    a = attn.attention_apply(params.attn, h, positions,
                             n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                             head_dim=cfg.resolved_head_dim,
                             rope_theta=cfg.rope_theta,
                             rope_fraction=cfg.rope_fraction,
                             backend=backend)
    x = x + a
    h = rmsnorm(params.norm2, x, cfg.norm_eps)
    return x + ffn_apply(params.mlp, h, cfg.act, cfg.glu)


def _shared_block_apply(params: SharedBlock, cfg: ModelConfig, x, positions,
                        backend: str):
    h = rmsnorm(params.norm1, x, cfg.norm_eps)
    hcfg = cfg.hybrid
    a = attn.attention_apply(params.attn, h, positions,
                             n_heads=hcfg.shared_n_heads,
                             n_kv_heads=hcfg.shared_n_kv_heads,
                             head_dim=cfg.d_model // hcfg.shared_n_heads,
                             rope_theta=cfg.rope_theta, backend=backend)
    x = x + a
    h = rmsnorm(params.norm2, x, cfg.norm_eps)
    return x + ffn_apply(params.shared, h, cfg.act, cfg.glu)


# ------------------------------------------------------------------ stacks
def _layer_plan(cfg: ModelConfig) -> Tuple[int, str, int, str]:
    """(prefix_n, prefix_kind, main_n, main_kind)."""
    if cfg.family in ("ssm", "hybrid"):
        return 0, "", cfg.n_layers, "ssm"
    if cfg.moe is not None:
        p = cfg.moe.first_dense_layers
        return p, "attn", cfg.n_layers - p, "attn_moe"
    return 0, "", cfg.n_layers, "attn"


class LM(nn.Module):
    """The parameters of one configuration, named as the reference's tree:
    ``embed``, ``final_norm``, ``stack`` (one module per layer where the
    reference stacks them), ``shared_blocks`` (hybrid) and ``lm_head``
    (untied).  Made empty; ``init_params`` fills it."""

    def __init__(self, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        check_supported(cfg)
        _, _, main_n, main_kind = _layer_plan(cfg)
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, dtype, device)
        self.final_norm = RMSNorm(cfg.d_model, dtype, device)
        self.stack = nn.ModuleList(Block(cfg, main_kind, dtype, device)
                                   for _ in range(main_n))
        if cfg.hybrid is not None:
            self.shared_blocks = nn.ModuleList(
                SharedBlock(cfg, dtype, device)
                for _ in range(cfg.hybrid.n_shared_blocks))
        if not cfg.tie_embeddings:
            self.lm_head = LMHead(cfg.d_model,
                                  cfg.vocab_size * cfg.n_codebooks, dtype,
                                  device)


@torch.no_grad()
def init_params(cfg: ModelConfig, *, generator=None, device=None,
                dtype=torch.bfloat16) -> LM:
    """Parameters for ``cfg`` with the reference's shapes and
    distributions, drawn from ``generator`` (a fresh one seeded 0 when
    None; it must live on ``device``), on the card unless ``device`` says
    otherwise.  Not bit-equal to the reference's ``jax.random`` draws."""
    from ..core.agent import resolve_device
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    lm = LM(cfg, dtype, device)
    for m in lm.modules():
        if m is not lm and hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)
    return lm


def _run_stack(layers, cfg: ModelConfig, kind: str, x, positions,
               backend: str):
    for p in layers:
        x = _block_apply(p, cfg, kind, x, positions, backend)
    return x


def _hybrid_run(params: LM, cfg: ModelConfig, x, positions, backend: str):
    """SSD backbone with a shared attention block after every
    ``attn_period`` layers (and after a last, shorter run only if it is
    full), cycling through the shared blocks."""
    h = cfg.hybrid
    L = cfg.n_layers
    period = h.attn_period
    i = seg = 0
    while i < L:
        n = min(period, L - i)
        x = _run_stack(params.stack[i:i + n], cfg, "ssm", x, positions,
                       backend)
        i += n
        if i < L or n == period:
            blk = params.shared_blocks[seg % h.n_shared_blocks]
            x = _shared_block_apply(blk, cfg, x, positions, backend)
            seg += 1
    return x


def _inputs_to_h(params: LM, cfg: ModelConfig,
                 batch: Dict[str, torch.Tensor]):
    if cfg.input_mode == "embeddings":
        x = batch["embeddings"].to(params.embed.table.dtype)
        return shard(x, "batch", None, None)
    tokens = batch["tokens"]
    if cfg.n_codebooks > 1 and tokens.dim() == 3:
        return sum(embedding_lookup(params.embed, tokens[..., c])
                   for c in range(cfg.n_codebooks))
    return embedding_lookup(params.embed, tokens)


def _logits(params: LM, cfg: ModelConfig, x):
    if cfg.tie_embeddings:
        return unembed(params.embed, x, cfg.logit_softcap)
    logits = lm_head_apply(params.lm_head, x, cfg.logit_softcap)
    if cfg.n_codebooks > 1:
        B, S, _ = logits.shape
        logits = logits.reshape(B, S, cfg.n_codebooks, cfg.vocab_size)
    return logits


@torch.no_grad()
def forward(params: LM, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            backend: str = "kernel") -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, V[, K]), float32."""
    check_supported(cfg)
    x = _inputs_to_h(params, cfg, batch)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    _, _, _, main_kind = _layer_plan(cfg)
    if cfg.family == "hybrid":
        x = _hybrid_run(params, cfg, x, positions, backend)
    else:
        x = _run_stack(params.stack, cfg, main_kind, x, positions, backend)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    return _logits(params, cfg, x)
