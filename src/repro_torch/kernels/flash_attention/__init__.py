"""Attention kernels: the LM zoo's causal flash forward (B7), and the
masked non-causal attention with its backward (B5, B6): CUDA kernels,
wrappers, plain versions."""
from .ops import flash_attention, mha, mha_bwd_dkv, mha_bwd_dq, mha_fwd
from .ref import (attention_ref, flash_attention_ref, mha_bwd_ref,
                  mha_fwd_ref)

__all__ = ["flash_attention", "mha", "mha_fwd", "mha_bwd_dq", "mha_bwd_dkv",
           "attention_ref", "flash_attention_ref", "mha_fwd_ref",
           "mha_bwd_ref"]
