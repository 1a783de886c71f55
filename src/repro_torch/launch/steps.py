"""Step builders of the LM zoo (the JAX package's ``launch/steps.py``).

``make_prefill_step`` is the serving path's prefill: one full-sequence
forward that returns the last token's logits; ``make_decode_step`` one
token against the cache.  PyTorch runs eagerly, so a step is a plain
function (the reference's is ``jit``-able and carries sharding plumbing,
which one card does not need).  The train step waits for its item of the
roadmap.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..configs.base import ModelConfig
from ..models import transformer
from ..nn.backend import resolve_backend


def make_prefill_step(cfg: ModelConfig, backend: str = "kernel"
                      ) -> Callable[..., torch.Tensor]:
    """``prefill_step(params, batch)`` -> logits of the last position,
    (B, V[, K]) float32, on the device of ``params``."""
    resolve_backend(backend)

    def prefill_step(params: transformer.LM,
                     batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        logits = transformer.forward(params, cfg, batch, backend=backend)
        return logits[:, -1]

    return prefill_step


def make_decode_step(cfg: ModelConfig
                     ) -> Callable[..., Tuple[torch.Tensor, dict]]:
    """``serve_step(params, batch, cache, pos)`` -> (logits of the new
    token (B, V[, K]) float32, ``cache``), the cache written in place
    (``transformer.decode_step``).  Decode runs no kernel, so it takes no
    backend."""

    def serve_step(params: transformer.LM, batch: Dict[str, torch.Tensor],
                   cache: dict, pos: int) -> Tuple[torch.Tensor, dict]:
        logits, cache = transformer.decode_step(params, cfg, batch, cache,
                                                pos)
        return logits[:, -1], cache

    return serve_step
