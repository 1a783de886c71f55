"""Mamba2-1.3B: pure SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50_280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4, chunk=256),
    tie_embeddings=True,
)
