"""InternVL2-26B backbone (InternLM2-20B): 48L GQA kv=8.  ViT frontend is a
stub — input_specs() supplies precomputed patch embeddings.
[arXiv:2404.16821; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=92_553,
    act="silu", glu=True, rope_theta=1_000_000.0,
    input_mode="embeddings",
    notes="InternViT frontend stubbed; backbone-only per assignment",
)
