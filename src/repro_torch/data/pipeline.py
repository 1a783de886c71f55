"""Deterministic synthetic batches for the LM zoo (the JAX package's
``data/pipeline.py``).

``make_batch`` draws from ``np.random.default_rng(seed * 100_003 + step)``
in the same order as the reference, so both packages get identical tokens
(and embeddings) for one seed and step.  For the embeddings-input families
(vlm, audio) the modality frontend is a stub, as in the reference: the
batch holds precomputed embeddings of the backbone's width.
``input_specs`` returns the same structure as meta-device tensors: shapes
and dtypes without storage, the dry run's stand-ins.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..configs.shapes import InputShape


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    pad_id: int = 0


def _token_shape(cfg: ModelConfig, batch: int, seq: int):
    if cfg.n_codebooks > 1:
        return (batch, seq, cfg.n_codebooks)
    return (batch, seq)


def input_specs(cfg: ModelConfig, shape: InputShape,
                dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Meta-device stand-ins for every model input of one (arch x shape)
    cell: ``make_batch``'s names, shapes and dtypes (tokens int64)."""
    B, S = shape.global_batch, shape.seq_len
    B_, S_ = (B, 1) if shape.kind == "decode" else (B, S)
    specs: Dict[str, torch.Tensor] = {}
    if cfg.input_mode == "embeddings":
        specs["embeddings"] = torch.empty((B_, S_, cfg.d_model), dtype=dtype,
                                          device="meta")
    else:
        specs["tokens"] = torch.empty(_token_shape(cfg, B_, S_),
                                      dtype=torch.int64, device="meta")
    if shape.kind == "train":
        specs["labels"] = torch.empty(_token_shape(cfg, B, S),
                                      dtype=torch.int64, device="meta")
    return specs


def make_batch(cfg: ModelConfig, shape: InputShape, step: int = 0,
               data: DataConfig = DataConfig(), dtype=torch.float32,
               device=None) -> Dict[str, torch.Tensor]:
    """One batch for ``shape``: ``tokens`` (int64) or ``embeddings``
    (``dtype``), plus ``labels`` for a train shape; on the card unless
    ``device`` says otherwise."""
    from ..core.agent import resolve_device
    device = resolve_device(device)
    rng = np.random.default_rng(data.seed * 100_003 + step)
    B, S = shape.global_batch, shape.seq_len
    B_, S_ = (B, 1) if shape.kind == "decode" else (B, S)
    out: Dict[str, torch.Tensor] = {}
    if cfg.input_mode == "embeddings":
        emb = rng.standard_normal((B_, S_, cfg.d_model), np.float32)
        out["embeddings"] = torch.from_numpy(emb).to(device, dtype)
    else:
        tok = rng.integers(0, cfg.vocab_size, _token_shape(cfg, B_, S_))
        out["tokens"] = torch.from_numpy(tok).to(device, torch.int64)
    if shape.kind == "train":
        lab = rng.integers(0, cfg.vocab_size, _token_shape(cfg, B, S))
        out["labels"] = torch.from_numpy(lab).to(device, torch.int64)
    return out


def synthetic_batch_iter(cfg: ModelConfig, shape: InputShape,
                         data: DataConfig = DataConfig(),
                         dtype=torch.float32,
                         device=None) -> Iterator[Dict[str, torch.Tensor]]:
    step = 0
    while True:
        yield make_batch(cfg, shape, step, data, dtype, device)
        step += 1
