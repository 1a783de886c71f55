"""The LM zoo's models, forward only: layers, attention, Mamba2 and the
config-driven decoder stack."""
from . import attention, layers, mamba2
from .transformer import LM, forward, init_params

__all__ = ["LM", "attention", "forward", "init_params", "layers", "mamba2"]
