"""Fused dense layer y = act(x @ W + b) and its two gradient kernels: CUDA
kernels, wrappers, plain versions."""
from .ops import fused_mlp, fused_mlp_dgrad, fused_mlp_wgrad
from .ref import (ACTIVATIONS, fused_mlp_dgrad_ref, fused_mlp_layer_ref,
                  fused_mlp_wgrad_ref)

__all__ = ["fused_mlp", "fused_mlp_dgrad", "fused_mlp_wgrad",
           "fused_mlp_layer_ref", "fused_mlp_dgrad_ref", "fused_mlp_wgrad_ref",
           "ACTIVATIONS"]
