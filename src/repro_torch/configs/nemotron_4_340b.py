"""Nemotron-4-340B: dense, GQA kv=8, squared-ReLU MLP (no GLU).
[arXiv:2402.16819; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8,
    d_ff=73728, vocab_size=256_000,
    head_dim=192,
    act="relu2", glu=False, rope_theta=10_000.0,
)
