"""Mamba2 chunked SSD (B8): the CUDA kernel, its wrapper and its plain
versions."""
from .ops import ssd
from .ref import ssd_chunk_ref, ssd_plain, ssd_ref

__all__ = ["ssd", "ssd_chunk_ref", "ssd_plain", "ssd_ref"]
