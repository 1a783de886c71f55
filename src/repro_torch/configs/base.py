"""Model configuration schema for the architecture zoo.

Every assigned architecture is a frozen :class:`ModelConfig`; the generic
decoder stack in ``repro_torch.models.transformer`` is driven entirely by
these fields — there is no per-architecture model code.  A copy of the JAX
package's ``configs/base.py``: the port imports nothing of that package.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_routed: int
    n_shared: int
    top_k: int
    d_expert: int                     # per-expert FFN width
    first_dense_layers: int = 1       # leading layers use a dense FFN
    capacity_factor: float = 1.25
    router_softmax_after_topk: bool = False
    d_shared_expert: Optional[int] = None  # defaults to d_expert * n_shared


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None     # None -> direct q projection
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256
    n_groups: int = 1


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style: shared attention/MLP blocks cycled between SSM spans."""
    attn_period: int = 6              # one shared block per this many SSM layers
    n_shared_blocks: int = 2          # alternating shared transformer blocks
    shared_d_ff: int = 14336
    shared_n_heads: int = 32
    shared_n_kv_heads: int = 32


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // n_heads
    act: str = "silu"                  # silu | gelu | relu2
    glu: bool = True                   # gated FFN (SwiGLU / GeGLU)
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0         # fraction of head_dim that rotates
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    input_mode: str = "tokens"         # tokens | embeddings (vlm/audio stub)
    n_codebooks: int = 1               # musicgen parallel codebook heads
    max_seq_len: int = 524_288
    mtp_depth: int = 0                 # DeepSeek-V3 multi-token prediction
    notes: str = ""

    # ------------------------------------------------------------- helpers
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can this config decode at 500k context without quadratic cost
        growth / a dense per-layer KV cache?  (SSM state or hybrid.)"""
        return self.family in ("ssm", "hybrid")

    def layer_kind(self, i: int) -> str:
        """'attn' | 'attn_moe' | 'ssm' for layer i."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid":
            return "ssm"               # shared attn blocks are interleaved
        if self.moe is not None and i >= self.moe.first_dense_layers:
            return "attn_moe"
        return "attn"

    def scaled(self, **kw) -> "ModelConfig":
        """Reduced config of the same family (smoke tests)."""
        return replace(self, **kw)

    # Rough parameter counts (for roofline MODEL_FLOPS and memory planning).
    def param_count(self) -> Tuple[int, int]:
        """Returns (total_params, active_params_per_token)."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        H, KV, dh = self.n_heads, self.n_kv_heads, self.resolved_head_dim
        total = V * D * (1 if self.tie_embeddings else 2)
        active = total
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            if kind == "ssm":
                s = self.ssm
                d_in = s.expand * D
                nheads = d_in // s.head_dim
                in_proj = D * (2 * d_in + 2 * s.n_groups * s.d_state + nheads)
                blk = in_proj + d_in * D + d_in * 2  # out_proj + norms
                total += blk
                active += blk
            else:
                if self.mla is not None:
                    m = self.mla
                    qdim = H * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                    if m.q_lora_rank:
                        q = D * m.q_lora_rank + m.q_lora_rank * qdim
                    else:
                        q = D * qdim
                    kv = D * (m.kv_lora_rank + m.qk_rope_head_dim) \
                        + m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
                    attn = q + kv + H * m.v_head_dim * D
                else:
                    attn = D * H * dh + 2 * D * KV * dh + H * dh * D
                total += attn
                active += attn
                if kind == "attn_moe":
                    e = self.moe
                    per_exp = D * e.d_expert * (3 if self.glu else 2)
                    shared_w = e.d_shared_expert or (e.d_expert * e.n_shared)
                    shared = D * shared_w * (3 if self.glu else 2)
                    router = D * e.n_routed
                    total += e.n_routed * per_exp + shared + router
                    active += e.top_k * per_exp + shared + router
                else:
                    ffn = D * F * (3 if self.glu else 2)
                    total += ffn
                    active += ffn
        if self.hybrid is not None:
            h = self.hybrid
            dh_s = D // h.shared_n_heads
            blk = (D * h.shared_n_heads * dh_s * 2
                   + 2 * D * h.shared_n_kv_heads * dh_s
                   + D * h.shared_d_ff * (3 if self.glu else 2))
            total += h.n_shared_blocks * blk
            n_uses = self.n_layers // h.attn_period
            active += n_uses * blk
        return int(total), int(active)
