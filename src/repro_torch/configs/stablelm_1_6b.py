"""StableLM-2 1.6B: dense, MHA (kv=32), partial rotary.
[hf:stabilityai/stablelm-2-1_6b; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=5632, vocab_size=100_352,
    act="silu", glu=True, rope_fraction=0.25, rope_theta=10_000.0,
)
