"""Masked non-causal attention and its backward: CUDA kernels, wrappers,
plain versions."""
from .ops import mha, mha_bwd_dkv, mha_bwd_dq, mha_fwd
from .ref import attention_ref, mha_bwd_ref, mha_fwd_ref

__all__ = ["mha", "mha_fwd", "mha_bwd_dq", "mha_bwd_dkv", "attention_ref",
           "mha_fwd_ref", "mha_bwd_ref"]
