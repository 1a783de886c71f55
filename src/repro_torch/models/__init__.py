"""The LM zoo's models for serving: layers, attention, MLA, MoE, Mamba2
and the config-driven decoder stack (forward and decode)."""
from . import attention, layers, mamba2, mla, moe
from .transformer import LM, decode_step, forward, init_cache, init_params

__all__ = ["LM", "attention", "decode_step", "forward", "init_cache",
           "init_params", "layers", "mamba2", "mla", "moe"]
