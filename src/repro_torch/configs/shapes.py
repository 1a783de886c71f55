"""Assigned input shapes and the (arch x shape) cell matrix.

  train_4k     seq 4096,    global_batch 256   -> train_step
  prefill_32k  seq 32768,   global_batch 32    -> prefill (serve)
  decode_32k   1 new token, KV len 32768, global_batch 128 -> serve_step
  long_500k    1 new token, KV len 524288, global_batch 1  -> serve_step

``long_500k`` needs sub-quadratic sequence mixing: it runs for SSM/hybrid
archs and is skipped (recorded, not silently dropped) for pure
full-attention archs — see DESIGN.md §Arch-applicability.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .base import ModelConfig


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def cell_supported(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """(supported, reason-if-not)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("pure full-attention arch: 500k dense KV cache is "
                       "out of spec; see DESIGN.md §Arch-applicability")
    return True, ""


def all_cells(configs: Dict[str, ModelConfig]):
    """Yield (arch, shape, supported, reason) for the full matrix."""
    for arch, cfg in configs.items():
        for sname in SHAPE_ORDER:
            ok, reason = cell_supported(cfg, SHAPES[sname])
            yield arch, sname, ok, reason
