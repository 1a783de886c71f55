"""Zamba2-7B: Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; unverified]"""
from .base import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab_size=32_000,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_width=4, chunk=256),
    hybrid=HybridConfig(attn_period=6, n_shared_blocks=2, shared_d_ff=14336,
                        shared_n_heads=32, shared_n_kv_heads=32),
    act="silu", glu=True,
    notes="81 Mamba2 layers; 2 alternating shared attn+MLP blocks every 6",
)
