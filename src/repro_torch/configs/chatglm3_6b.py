"""ChatGLM3-6B: dense, GQA kv=2, 2d (half-rotary) RoPE.
[arXiv:2406.12793; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab_size=65_024,
    act="silu", glu=True, rope_fraction=0.5, rope_theta=10_000.0,
)
