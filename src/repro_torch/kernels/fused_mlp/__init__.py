"""Fused dense layer y = act(x @ W + b): CUDA kernel, wrapper, plain version."""
from .ops import fused_mlp
from .ref import ACTIVATIONS, fused_mlp_layer_ref

__all__ = ["fused_mlp", "fused_mlp_layer_ref", "ACTIVATIONS"]
