"""Config-driven decoder stack of the LM zoo (the JAX package's
``models/transformer.py``): the full-sequence forward (prefill and
training), the loss, and the one-token decode step against a cache.

One generic implementation; blocks compose by ``ModelConfig``:

* dense GQA/MQA -> attention + (GLU or squared-ReLU) FFN;
* moe (deepseek) -> MLA attention + a dense-FFN prefix, then MoE layers;
* ssm (mamba2)  -> SSD blocks, attention-free;
* hybrid (zamba2) -> SSD backbone + shared attention/MLP blocks cycled in;
* vlm / audio   -> the dense stack with an embeddings input stub (musicgen
  adds parallel codebook heads).

The reference stacks the parameters of homogeneous layers (a leading L dim)
for one ``lax.scan``; here the layers are an ``nn.ModuleList`` run in a
Python loop.  ``backend`` picks the long-sequence kernels: ``"kernel"``
runs B7 (causal flash attention, past ``dense_threshold``) and B8 (the
chunked SSD), ``"torch"`` the reference's plain PyTorch counterparts.

Decode (``init_cache``, ``decode_step``) runs no kernel, as in the
reference: attention reads the whole cache with a mask, MLA its
compressed cache in the absorbed form, Mamba2 its recurrent state.  The
reference returns a new cache each step (and ``generate`` donates the old
one); here each step writes its token's slice into the cache in place and
returns the same tree.

``forward`` and ``loss`` build an autograd graph when a parameter requires
a gradient (the training entry points turn them on; ``init_params`` makes
them frozen), on the ``"torch"`` backend only: B7 and B8 are forward-only,
as in the reference, and refuse a graph on the card.  ``remat`` recomputes
each block's activations in the backward (``torch.utils.checkpoint``), as
the reference's ``jax.checkpoint`` does.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..distributed.sharding import (current_rules, shard, split_heads,
                                    use_rules)
from ..obs.profiling import annotate
from . import attention as attn
from . import mamba2 as ssd
from . import mla as mla_mod
from . import moe as moe_mod
from .layers import (FFN, Embedding, LMHead, RMSNorm, embedding_lookup,
                     ffn_apply, lm_head_apply, rmsnorm,
                     softmax_cross_entropy, unembed)

# ------------------------------------------------------------------ blocks
class Block(nn.Module):
    """One layer, pre-norm, with the reference's parameter names: an SSD
    block (``kind="ssm"``), or attention (MLA when the config has it) and
    then a dense FFN (``kind="attn"``) or MoE (``kind="attn_moe"``)."""

    def __init__(self, cfg: ModelConfig, kind: str, dtype, device=None):
        super().__init__()
        D = cfg.d_model
        self.norm1 = RMSNorm(D, dtype, device)
        if kind == "ssm":
            self.ssm = ssd.Mamba2(D, cfg.ssm, dtype, device)
            return
        if cfg.mla is not None:
            self.mla = mla_mod.MLA(D, cfg.n_heads, cfg.mla, dtype, device)
        else:
            self.attn = attn.Attention(D, cfg.n_heads, cfg.n_kv_heads,
                                       cfg.resolved_head_dim, dtype, device)
        self.norm2 = RMSNorm(D, dtype, device)
        if kind == "attn_moe":
            self.moe = moe_mod.MoE(D, cfg.moe, cfg.glu, dtype, device)
        else:
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
    """One layer, inside its profiler range (``mrsch.lm.block``; under
    remat the range opens again for the backward's recompute)."""
    with annotate("mrsch.lm.block"):
        # Sequence-parallel residual stream under "opt" rules (S over
        # model); no-op under baseline rules or when S doesn't divide.
        x = shard(x, "batch", "act_seq", None)
        if kind == "ssm":
            return shard(x + ssd.mamba2_apply(
                params.ssm, rmsnorm(params.norm1, x, cfg.norm_eps), cfg.ssm,
                backend=backend), "batch", "act_seq", None)
        h = rmsnorm(params.norm1, x, cfg.norm_eps)
        if cfg.mla is not None:
            a = mla_mod.mla_apply(params.mla, h, positions,
                                  n_heads=cfg.n_heads, mla=cfg.mla,
                                  backend=backend)
        else:
            a = attn.attention_apply(params.attn, h, positions,
                                     n_heads=cfg.n_heads,
                                     n_kv_heads=cfg.n_kv_heads,
                                     head_dim=cfg.resolved_head_dim,
                                     rope_theta=cfg.rope_theta,
                                     rope_fraction=cfg.rope_fraction,
                                     backend=backend)
        x = shard(x + a, "batch", "act_seq", None)
        return shard(x + _ffn(params, cfg, kind,
                              rmsnorm(params.norm2, x, cfg.norm_eps)),
                     "batch", "act_seq", None)


def _ffn(params: Block, cfg: ModelConfig, kind: str, h):
    if kind == "attn_moe":
        return moe_mod.moe_apply(params.moe, h, cfg.moe, cfg.act, cfg.glu)
    return ffn_apply(params.mlp, h, cfg.act, cfg.glu)


def _shared_block_apply(params: SharedBlock, cfg: ModelConfig, x, positions,
                        backend: str):
    h = rmsnorm(params.norm1, x, cfg.norm_eps)
    hcfg = cfg.hybrid
    a = attn.attention_apply(params.attn, h, positions,
                             n_heads=hcfg.shared_n_heads,
                             n_kv_heads=hcfg.shared_n_kv_heads,
                             head_dim=cfg.d_model // hcfg.shared_n_heads,
                             rope_theta=cfg.rope_theta, backend=backend)
    x = shard(x + a, "batch", "act_seq", None)
    h = rmsnorm(params.norm2, x, cfg.norm_eps)
    return shard(x + ffn_apply(params.shared, h, cfg.act, cfg.glu),
                 "batch", "act_seq", None)


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
    ``embed``, ``final_norm``, ``prefix`` (the MoE family's leading dense
    layers) and ``stack`` (one module per layer where the reference stacks
    them), ``shared_blocks`` (hybrid) and ``lm_head`` (untied).  Made
    empty; ``init_params`` fills it."""

    def __init__(self, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        prefix_n, prefix_kind, main_n, main_kind = _layer_plan(cfg)
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, dtype, device)
        self.final_norm = RMSNorm(cfg.d_model, dtype, device)
        if prefix_n:
            self.prefix = nn.ModuleList(Block(cfg, prefix_kind, dtype, device)
                                        for _ in range(prefix_n))
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


def _block_under(rules, *args):
    """``_block_apply`` under ``rules``: remat recomputes the block in the
    backward, which on the card runs in autograd's device thread, where
    the forward's thread-local rules are not installed."""
    with use_rules(rules):
        return _block_apply(*args)


def _run_stack(layers, cfg: ModelConfig, kind: str, x, positions,
               backend: str, remat: bool = False):
    """The layers in order; with ``remat`` each block keeps only its input
    for the backward and recomputes the rest there, under the same
    rules."""
    rules = current_rules()
    for p in layers:
        if remat:
            x = checkpoint(_block_under, rules, p, cfg, kind, x, positions,
                           backend, use_reentrant=False)
        else:
            x = _block_apply(p, cfg, kind, x, positions, backend)
    return x


def _hybrid_plan(cfg: ModelConfig):
    """The hybrid's schedule, shared by the forward and the decode step: an
    SSD backbone with a shared attention block after every ``attn_period``
    layers (and after a last, shorter run only if it is full), cycling
    through the shared blocks.  Yields (layers, seg, block) for each run of
    SSM layers: ``seg`` numbers the shared-block use that follows the run
    (its slot in the decode cache) and ``block`` the shared block it uses,
    both None where no shared block follows."""
    L, period = cfg.n_layers, cfg.hybrid.attn_period
    seg = 0
    for i in range(0, L, period):
        n = min(period, L - i)
        if i + n < L or n == period:
            yield range(i, i + n), seg, seg % cfg.hybrid.n_shared_blocks
            seg += 1
        else:
            yield range(i, i + n), None, None


def _hybrid_run(params: LM, cfg: ModelConfig, x, positions, backend: str,
                remat: bool = False):
    """The hybrid's backbone over the whole sequence (``_hybrid_plan``);
    ``remat`` reaches the SSM layers, not the shared blocks, as in the
    reference."""
    for layers, seg, block in _hybrid_plan(cfg):
        x = _run_stack(params.stack[layers.start:layers.stop], cfg, "ssm", x,
                       positions, backend, remat)
        if seg is not None:
            x = _shared_block_apply(params.shared_blocks[block], cfg, x,
                                    positions, backend)
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
        logits = split_heads(logits, cfg.n_codebooks, cfg.vocab_size,
                             "vocab", seq_axis="act_seq")
    return logits


def _hidden(params: LM, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            backend: str, remat: bool) -> torch.Tensor:
    """The stack's output after the final norm, (B, S, D)."""
    x = _inputs_to_h(params, cfg, batch)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    prefix_n, prefix_kind, _, main_kind = _layer_plan(cfg)
    if prefix_n:
        x = _run_stack(params.prefix, cfg, prefix_kind, x, positions,
                       backend, remat)
    if cfg.family == "hybrid":
        x = _hybrid_run(params, cfg, x, positions, backend, remat)
    else:
        x = _run_stack(params.stack, cfg, main_kind, x, positions, backend,
                       remat)
    return rmsnorm(params.final_norm, x, cfg.norm_eps)


def forward(params: LM, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            backend: str = "kernel", remat: bool = False) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, V[, K]), float32.  With
    ``remat`` every block (the MoE prefix's too) recomputes its
    activations in the backward; the hybrid's shared blocks keep theirs."""
    return _logits(params, cfg, _hidden(params, cfg, batch, backend, remat))


def loss(params: LM, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
         remat: bool = True) -> torch.Tensor:
    """Mean softmax cross-entropy of ``batch["labels"]`` (B, S[, K]) in
    float32; musicgen's is the mean over its codebooks.  A 0-d tensor.
    It runs the ``"torch"`` backend: the loss is for training, and B7 and
    B8 are forward-only.  The logits and the cross-entropy run inside the
    profiler range ``mrsch.lm.logits_ce``."""
    x = _hidden(params, cfg, batch, "torch", remat)
    labels = batch["labels"]
    with annotate("mrsch.lm.logits_ce"):
        logits = _logits(params, cfg, x)
        if cfg.n_codebooks > 1:
            total = 0.0
            for c in range(cfg.n_codebooks):
                total = total + softmax_cross_entropy(logits[..., c, :],
                                                      labels[..., c])
            return total / cfg.n_codebooks
        return softmax_cross_entropy(logits, labels)


# ------------------------------------------------------------------ decode
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, device=None) -> dict:
    """The decode cache, zeros, in the reference's tree: ``stack`` (and
    ``prefix``) of {``k``, ``v``} (B, max_len, KV, dh), MLA's {``c``,
    ``rope``} (B, max_len, rank) or Mamba2's {``state`` (float32),
    ``conv``}, each stacked along a leading layer dim; the hybrid's
    ``shared`` {``k``, ``v``} has one slot per use of a shared block,
    ceil(L / attn_period) of them.  On the card unless ``device`` says
    otherwise."""
    from ..core.agent import resolve_device
    device = resolve_device(device)
    prefix_n, _, main_n, _ = _layer_plan(cfg)
    D = cfg.d_model
    kw = dict(dtype=dtype, device=device)

    def attn_cache(n_layers, kv_heads, head_dim):
        shape = (n_layers, batch, max_len, kv_heads, head_dim)
        return {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)}

    def mla_cache(n_layers):
        m = cfg.mla
        return {"c": torch.zeros(n_layers, batch, max_len, m.kv_lora_rank,
                                 **kw),
                "rope": torch.zeros(n_layers, batch, max_len,
                                    m.qk_rope_head_dim, **kw)}

    cache: Dict[str, dict] = {}
    if cfg.family in ("ssm", "hybrid"):
        one = ssd.mamba2_decode_init_cache(batch, D, cfg.ssm, dtype,
                                           device=device)
        cache["stack"] = {k: t[None].repeat(main_n, *(1,) * t.dim())
                          for k, t in one.items()}
        if cfg.hybrid is not None:
            h = cfg.hybrid
            n_inv = -(-cfg.n_layers // h.attn_period)
            cache["shared"] = attn_cache(n_inv, h.shared_n_kv_heads,
                                         D // h.shared_n_heads)
        return cache
    if cfg.mla is not None:
        cache["stack"] = mla_cache(main_n)
        if prefix_n:
            cache["prefix"] = mla_cache(prefix_n)
        return cache
    cache["stack"] = attn_cache(main_n, cfg.n_kv_heads, cfg.resolved_head_dim)
    return cache


def _layer(tree: dict, i: int) -> dict:
    """Layer i's cache leaves: views, so writes land in ``tree``."""
    return {k: t[i] for k, t in tree.items()}


def _decode_block(params: Block, cfg: ModelConfig, kind: str, x,
                  layer_cache: dict, pos: int):
    h = rmsnorm(params.norm1, x, cfg.norm_eps)
    if kind == "ssm":
        out, _ = ssd.mamba2_decode_apply(params.ssm, h, layer_cache, cfg.ssm)
        return x + out
    if cfg.mla is not None:
        a, _, _ = mla_mod.mla_decode_apply(
            params.mla, h, layer_cache["c"], layer_cache["rope"], pos,
            n_heads=cfg.n_heads, mla=cfg.mla)
    else:
        a, _, _ = attn.decode_attention_apply(
            params.attn, h, layer_cache["k"], layer_cache["v"], pos,
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
            rope_fraction=cfg.rope_fraction)
    x = x + a
    return x + _ffn(params, cfg, kind, rmsnorm(params.norm2, x, cfg.norm_eps))


def _decode_shared_block(params: SharedBlock, cfg: ModelConfig, x, kcache,
                         vcache, pos: int):
    h = rmsnorm(params.norm1, x, cfg.norm_eps)
    hcfg = cfg.hybrid
    a, _, _ = attn.decode_attention_apply(
        params.attn, h, kcache, vcache, pos, n_heads=hcfg.shared_n_heads,
        n_kv_heads=hcfg.shared_n_kv_heads,
        head_dim=cfg.d_model // hcfg.shared_n_heads,
        rope_theta=cfg.rope_theta)
    x = shard(x + a, "batch", "act_seq", None)
    h = rmsnorm(params.norm2, x, cfg.norm_eps)
    return shard(x + ffn_apply(params.shared, h, cfg.act, cfg.glu),
                 "batch", "act_seq", None)


@torch.no_grad()
def decode_step(params: LM, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                cache: dict, pos: int) -> Tuple[torch.Tensor, dict]:
    """One-token decode.  ``batch``: tokens (B, 1)[, K] or embeddings
    (B, 1, D); ``pos`` the current cache length (the new token's index), a
    Python int, so no step waits on the card to read it.  Writes the
    token's keys, latents or states into ``cache`` in place and returns
    (logits (B, 1, V[, K]) float32, ``cache``)."""
    x = _inputs_to_h(params, cfg, batch)
    prefix_n, prefix_kind, _, main_kind = _layer_plan(cfg)
    for i in range(prefix_n):
        x = _decode_block(params.prefix[i], cfg, prefix_kind, x,
                          _layer(cache["prefix"], i), pos)
    if cfg.family == "hybrid":
        for layers, seg, block in _hybrid_plan(cfg):
            for j in layers:
                x = _decode_block(params.stack[j], cfg, "ssm", x,
                                  _layer(cache["stack"], j), pos)
            if seg is not None:
                x = _decode_shared_block(params.shared_blocks[block], cfg, x,
                                         cache["shared"]["k"][seg],
                                         cache["shared"]["v"][seg], pos)
    else:
        for i, p in enumerate(params.stack):
            x = _decode_block(p, cfg, main_kind, x, _layer(cache["stack"], i),
                              pos)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    return _logits(params, cfg, x), cache
