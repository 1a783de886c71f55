"""Architecture registry: ``get_config(name)`` / ``--arch <id>``.  A copy
of the JAX package's ``configs/`` (pure Python), so the two packages read
the same configurations."""
from __future__ import annotations

import importlib
from typing import Dict

from .base import HybridConfig, MLAConfig, ModelConfig, MoEConfig, SSMConfig
from .shapes import SHAPE_ORDER, SHAPES, InputShape, all_cells, cell_supported

_MODULES = {
    "deepseek-v2-lite-16b": ".deepseek_v2_lite_16b",
    "deepseek-v3-671b": ".deepseek_v3_671b",
    "internvl2-26b": ".internvl2_26b",
    "zamba2-7b": ".zamba2_7b",
    "stablelm-1.6b": ".stablelm_1_6b",
    "chatglm3-6b": ".chatglm3_6b",
    "nemotron-4-340b": ".nemotron_4_340b",
    "gemma-2b": ".gemma_2b",
    "musicgen-medium": ".musicgen_medium",
    "mamba2-1.3b": ".mamba2_1_3b",
}

ARCH_NAMES = list(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    mod = importlib.import_module(_MODULES[name], __package__)
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {n: get_config(n) for n in ARCH_NAMES}


# Reduced same-family configs for CPU smoke tests (small widths, few layers,
# tiny vocab) — full configs are only exercised via the AOT dry-run.
def smoke_config(name: str) -> ModelConfig:
    from dataclasses import replace
    cfg = get_config(name)
    kw = dict(n_layers=min(cfg.n_layers, 4), d_model=64,
              vocab_size=512, max_seq_len=512)
    if cfg.n_heads:
        kw.update(n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 4) or 1,
                  head_dim=16, d_ff=128)
    if cfg.mla is not None:
        kw["mla"] = replace(cfg.mla, kv_lora_rank=32,
                            q_lora_rank=(48 if cfg.mla.q_lora_rank else None),
                            qk_nope_head_dim=16, qk_rope_head_dim=8,
                            v_head_dim=16)
    if cfg.moe is not None:
        kw["moe"] = replace(cfg.moe, n_routed=8, top_k=2, d_expert=32,
                            first_dense_layers=min(cfg.moe.first_dense_layers, 1))
        kw["d_ff"] = 128
    if cfg.ssm is not None:
        kw["ssm"] = replace(cfg.ssm, d_state=16, head_dim=16, chunk=32)
    if cfg.hybrid is not None:
        kw["hybrid"] = replace(cfg.hybrid, attn_period=2, shared_d_ff=128,
                               shared_n_heads=4, shared_n_kv_heads=4)
        kw["n_layers"] = 4
    return cfg.scaled(**kw)


__all__ = [
    "ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig", "HybridConfig",
    "InputShape", "SHAPES", "SHAPE_ORDER", "all_cells", "cell_supported",
    "ARCH_NAMES", "get_config", "all_configs", "smoke_config",
]
