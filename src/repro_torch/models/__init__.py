"""The LM zoo's models: layers, attention, MLA, MoE, Mamba2 and the
config-driven decoder stack (forward, loss and decode)."""
from . import attention, layers, mamba2, mla, moe
from .transformer import (LM, decode_step, forward, init_cache, init_params,
                          loss)

__all__ = ["LM", "attention", "decode_step", "forward", "init_cache",
           "init_params", "layers", "loss", "mamba2", "mla", "moe"]
