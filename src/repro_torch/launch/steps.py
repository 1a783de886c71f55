"""Step builders of the LM zoo (the JAX package's ``launch/steps.py``).

``make_train_step`` is one training step: the loss and its gradients,
then AdamW; ``make_prefill_step`` is the serving path's prefill: one
full-sequence forward that returns the last token's logits;
``make_decode_step`` one token against the cache.  PyTorch runs eagerly,
so a step is a plain function (the reference's is ``jit``-able and
carries sharding plumbing, which one card does not need: ``build_cell``,
``batch_pspec`` and ``cache_pspecs`` come with the multi-card item of the
roadmap).  The reference's ``unroll`` has no counterpart: the port's
stack is always a Python loop.  Serving builds no autograd graph, even
on parameters that train: the prefill step runs under
``torch.inference_mode()`` and the decode step under ``torch.no_grad()``.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..configs.base import ModelConfig
from ..models import transformer
from ..nn.backend import resolve_backend
from ..obs.profiling import annotate
from ..optim import OptConfig, opt_update


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig, remat: bool = True,
                    lr_schedule=None, microbatches: int = 1
                    ) -> Callable[..., tuple]:
    """``train_step(params, opt_state, batch)`` -> (params, opt_state,
    {"loss", "grad_norm"}): the mean loss of ``batch`` and its gradients
    (``transformer.loss`` with ``remat``), then one ``opt_update`` in place
    at ``lr_schedule(opt_state["step"])``, read before the update (so
    ``cfg.lr`` when no schedule is given).  It turns on the gradients of
    ``params`` (an ``LM``; they stay on).

    It always runs the ``"torch"`` backend and takes none: the reference
    differentiates its plain paths (dense attention, the blockwise scan,
    the chunked SSD), and the kernels B7 and B8 are forward-only in both
    packages.  ``microbatches > 1`` splits the batch (the split must
    divide B) and runs one backward per slice, adding each slice's
    gradient / ``microbatches`` into float32 buffers and its loss likewise,
    as the reference's loop does.  A parameter the loss does not reach
    gets a zero gradient, as ``jax.grad`` gives it.  The update runs
    inside the profiler range ``mrsch.lm.adamw`` (``transformer.loss``
    and the blocks open the step's other ``mrsch.lm.*`` ranges)."""

    def grads_of(params, named, batch) -> Tuple[torch.Tensor, list]:
        loss = transformer.loss(params, cfg, batch, remat=remat)
        grads = torch.autograd.grad(loss, [p for _, p in named],
                                    allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for (_, p), g in zip(named, grads)]

    def train_step(params: transformer.LM, opt_state: dict,
                   batch: Dict[str, torch.Tensor]) -> tuple:
        params.requires_grad_(True)
        named = list(params.named_parameters())
        if microbatches > 1:
            B = next(iter(batch.values())).shape[0]
            assert B % microbatches == 0, (B, microbatches)
            mb = B // microbatches
            loss, grads = 0.0, None
            for i in range(microbatches):
                sub = {k: t[i * mb:(i + 1) * mb] for k, t in batch.items()}
                l, g = grads_of(params, named, sub)
                g = [x.float() / microbatches for x in g]
                grads = g if grads is None else [
                    a.add_(b) for a, b in zip(grads, g)]
                loss = loss + l / microbatches
        else:
            loss, grads = grads_of(params, named, batch)
        lr = lr_schedule(opt_state["step"]) if lr_schedule else None
        with annotate("mrsch.lm.adamw"):
            opt_state, gnorm = opt_update(
                {n: g for (n, _), g in zip(named, grads)}, opt_state, params,
                opt_cfg, lr=lr)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_prefill_step(cfg: ModelConfig, backend: str = "kernel"
                      ) -> Callable[..., torch.Tensor]:
    """``prefill_step(params, batch)`` -> logits of the last position,
    (B, V[, K]) float32, on the device of ``params``."""
    resolve_backend(backend)

    def prefill_step(params: transformer.LM,
                     batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.inference_mode():
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
