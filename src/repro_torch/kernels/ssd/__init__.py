"""Mamba2 chunked SSD (B8): the CUDA kernel, its wrapper and its plain
versions."""
from .ops import ssd
from .ref import (ssd_chunk_ref, ssd_chunk_scan_ref, ssd_chunk_state_ref,
                  ssd_plain, ssd_ref, ssd_state_pass_ref)

__all__ = ["ssd", "ssd_chunk_ref", "ssd_chunk_scan_ref",
           "ssd_chunk_state_ref", "ssd_plain", "ssd_ref",
           "ssd_state_pass_ref"]
