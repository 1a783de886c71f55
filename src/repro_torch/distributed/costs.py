"""Analytic cost model per (arch x shape) cell (the JAX package's
``distributed/costs.py``, pure Python, reading the port's own ``configs/``).

Two uses:
  1. ``model_flops_global``, the useful flops of a step (6*N*D dense /
     6*N_active*D MoE for training; 2*N_active per generated token for
     inference) plus exact attention/SSD terms: the dry run's usefulness
     ratio, and the fleet scheduler's demand vectors (``param_bytes`` sets
     a job's chips and burst buffer).
  2. ``flash_correction``: the (n_blocks - 1) x body flops/bytes that a
     count taking the blockwise attention scan's body once would miss.
     The port's dry run counts every op it dispatches, each block of the
     scan included, so it does not add this term; it is kept so the two
     packages' cost tables stay equal.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from ..configs.base import ModelConfig
from ..configs.shapes import InputShape

FLASH_BLOCK_K = 1024
DENSE_ATTN_THRESHOLD = 2048


@dataclass(frozen=True)
class CellCosts:
    model_flops_global: float        # useful flops, whole step, all chips
    attn_flops_global: float         # quadratic/SSD part included above
    param_bytes: float               # bf16 params
    notes: str = ""


def _attn_flops_per_layer(cfg: ModelConfig, B: int, S: int, causal=True):
    """QK^T + PV flops for one full-attention layer (causal halves it)."""
    if cfg.mla is not None:
        dh_qk = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
        dh_v = cfg.mla.v_head_dim
        H = cfg.n_heads
    else:
        dh_qk = dh_v = cfg.resolved_head_dim
        H = cfg.n_heads
    full = 2 * B * H * S * S * (dh_qk + dh_v)
    return full / 2 if causal else full


def _ssd_flops_per_layer(cfg: ModelConfig, B: int, S: int):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    P, N, Q = s.head_dim, s.d_state, s.chunk
    nc = S // Q
    intra = 2 * B * nc * Q * Q * H * (N + P) / 2        # causal-ish half
    states = 2 * B * nc * Q * H * N * P                 # chunk states
    inter = 2 * B * nc * Q * H * N * P                  # C . H_prev
    return intra + states + inter


def cell_costs(cfg: ModelConfig, shape: InputShape) -> CellCosts:
    B, S = shape.global_batch, shape.seq_len
    total, active = cfg.param_count()
    if shape.kind == "train":
        tokens = B * S
        base = 6.0 * active * tokens
        mult = 3.0                                      # fwd+bwd on attn too
        S_eff = S
    elif shape.kind == "prefill":
        tokens = B * S
        base = 2.0 * active * tokens
        mult = 1.0
        S_eff = S
    else:  # decode: one token against an S-long cache
        tokens = B * 1
        base = 2.0 * active * tokens
        mult = 1.0
        S_eff = S
    attn = 0.0
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        if kind == "ssm":
            if shape.kind == "decode":
                s = cfg.ssm
                d_in = s.expand * cfg.d_model
                H = d_in // s.head_dim
                attn += 4.0 * B * H * s.head_dim * s.d_state
            else:
                attn += _ssd_flops_per_layer(cfg, B, S_eff) * mult
        else:
            if shape.kind == "decode":
                # one query row against the cache
                if cfg.mla is not None:
                    d_eff = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
                    attn += 2.0 * B * cfg.n_heads * S_eff * (
                        d_eff + cfg.mla.kv_lora_rank)
                else:
                    attn += 2.0 * B * cfg.n_heads * S_eff * \
                        2 * cfg.resolved_head_dim
            else:
                attn += _attn_flops_per_layer(cfg, B, S_eff) * mult
    if cfg.hybrid is not None:
        n_inv = cfg.n_layers // cfg.hybrid.attn_period
        for _ in range(n_inv):
            if shape.kind == "decode":
                dh = cfg.d_model // cfg.hybrid.shared_n_heads
                attn += 2.0 * B * cfg.hybrid.shared_n_heads * S_eff * 2 * dh
            else:
                attn += _attn_flops_per_layer(cfg, B, S_eff) * mult
    return CellCosts(
        model_flops_global=base + attn,
        attn_flops_global=attn,
        param_bytes=2.0 * total,
    )


def flash_correction(cfg: ModelConfig, shape: InputShape,
                     block_k: int = FLASH_BLOCK_K) -> Dict[str, float]:
    """Missing (global) flops/bytes of a count that takes the blockwise
    attention scan's body once.

    Applies only to full-attention layers with S > DENSE_ATTN_THRESHOLD in
    train/prefill cells.  The scan body does attention of all S queries
    against one KV block; the true count is n_blocks bodies.  Bytes are
    modeled kernel-ideally (q, k, v, o single pass), as a fused flash
    kernel moves them.
    """
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode" or S <= DENSE_ATTN_THRESHOLD:
        return {"flops": 0.0, "bytes": 0.0}
    n_layers_attn = sum(
        1 for i in range(cfg.n_layers) if cfg.layer_kind(i) != "ssm")
    if cfg.hybrid is not None:
        n_layers_attn += cfg.n_layers // cfg.hybrid.attn_period
    if n_layers_attn == 0:
        return {"flops": 0.0, "bytes": 0.0}
    mult = 3.0 if shape.kind == "train" else 1.0
    n_blocks = -(-S // block_k)
    per_layer_full = _attn_flops_per_layer(cfg, B, S, causal=False)
    body = per_layer_full / n_blocks
    missing_flops = (n_blocks - 1) * body * n_layers_attn * mult
    if cfg.mla is not None:
        H, dh = cfg.n_heads, (cfg.mla.qk_nope_head_dim
                              + cfg.mla.qk_rope_head_dim + cfg.mla.v_head_dim)
    else:
        H, dh = cfg.n_heads, 3 * cfg.resolved_head_dim
    qkvo_bytes = 2.0 * B * S * H * dh * (2 if shape.kind == "prefill" else 4)
    return {"flops": missing_flops,
            "bytes": qkvo_bytes * n_layers_attn}
