"""Window pack: the first W waiting jobs per environment (CUDA kernel,
wrapper, plain version)."""
from .ops import pack_window
from .ref import pack_window_reference

__all__ = ["pack_window", "pack_window_reference"]
