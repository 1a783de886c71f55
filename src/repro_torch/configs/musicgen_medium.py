"""MusicGen-medium: decoder-only over EnCodec tokens (4 codebooks,
delay pattern at the data layer).  EnCodec frontend is a stub —
input_specs() supplies frame embeddings.  [arXiv:2306.05284; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab_size=2048,
    act="gelu", glu=False,
    input_mode="embeddings", n_codebooks=4,
    notes="4 parallel codebook heads (vocab 2048 each)",
)
