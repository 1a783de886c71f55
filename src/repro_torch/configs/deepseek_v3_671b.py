"""DeepSeek-V3 671B: MLA + MoE (1 shared + 256 routed, top-8), MTP.
[arXiv:2412.19437; hf]"""
from .base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=18432,                      # dense FFN width of the 3 leading layers
    vocab_size=129_280,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_routed=256, n_shared=1, top_k=8, d_expert=2048,
                  first_dense_layers=3),
    act="silu", glu=True, rope_theta=10_000.0,
    mtp_depth=1,
    notes="MTP auxiliary head (mtp_depth=1) available; off in dry-run cells",
)
