"""DeepSeek-V2-Lite 16B: MLA + MoE (2 shared + 64 routed, top-6).
[arXiv:2405.04434; hf].  The assignment line lists both "64e" and
"160 routed"; the published V2-Lite config is 64 routed (160 is V2-full) —
we follow the leading "64e" spec (see DESIGN.md)."""
from .base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10944,                      # dense FFN width of layer 0
    vocab_size=102_400,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=None,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_routed=64, n_shared=2, top_k=6, d_expert=1408,
                  first_dense_layers=1),
    act="silu", glu=True, rope_theta=10_000.0,
    notes="MLA kv_lora=512; first layer dense FFN",
)
