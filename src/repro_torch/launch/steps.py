"""Step builders of the LM zoo and their sharding plumbing (the JAX
package's ``launch/steps.py``).

``make_train_step`` is one training step: the loss and its gradients,
then AdamW; ``make_prefill_step`` is the serving path's prefill: one
full-sequence forward that returns the last token's logits;
``make_decode_step`` one token against the cache.  PyTorch runs eagerly,
so a step is a plain function; the reference's ``unroll`` has no
counterpart (the port's stack is always a Python loop).  Serving builds
no autograd graph, even on parameters that train: the prefill step runs
under ``torch.inference_mode()`` (``torch.no_grad()`` on DTensor
parameters) and the decode step under ``torch.no_grad()``.

The sharding plumbing: ``batch_pspec``, ``cache_pspecs`` and
``param_pspecs_for_opt`` give the specs of a cell's inputs, cache and
optimizer state under a ``Rules``; ``_bind_rules`` makes the rules (and
their ``shard()`` constraints) active while a step runs; ``build_cell``
returns one cell's step and its example arguments, DTensors of fake
tensors (no storage) placed by the rules on the rules' mesh.  The same
steps run on DTensor parameters: the AdamW state is then the stacked
tree of DTensors (replicated along the layer dim), and each layer's
update reads views of it.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..configs.shapes import InputShape
from ..convert import is_stacked, nest
from ..data.pipeline import input_specs
from ..distributed.collectives import last_row
from ..distributed.sharding import (P, PartitionSpec, Rules,
                                    distribute_params, distribute_tree,
                                    param_pspecs, use_rules)
from ..models import transformer
from ..nn.backend import resolve_backend
from ..obs.profiling import annotate
from ..optim import OptConfig, opt_init, opt_update

CACHE_AXES = {
    "k": (None, "batch", "kv_seq", "kv_heads", None),
    "v": (None, "batch", "kv_seq", "kv_heads", None),
    "c": (None, "batch", "kv_seq", None),
    "rope": (None, "batch", "kv_seq", None),
    "state": (None, "batch", "heads", None, None),
    "conv": (None, "batch", None, None),
}


def batch_pspec(rules: Rules, specs: Dict[str, torch.Tensor]
                ) -> Dict[str, PartitionSpec]:
    """Each input's spec: its leading dim over "batch"."""
    out = {}
    for k, v in specs.items():
        axes = ["batch"] + [None] * (v.dim() - 1)
        out[k] = rules.spec(axes, tuple(v.shape))
    return out


def cache_pspecs(cache_tree, rules: Rules):
    """The decode cache's tree of specs, by each leaf's name
    (``CACHE_AXES``; a leaf of another name is replicated)."""
    if isinstance(cache_tree, dict):
        return {k: (_cache_leaf_spec(k, v, rules)
                    if isinstance(v, torch.Tensor)
                    else cache_pspecs(v, rules))
                for k, v in cache_tree.items()}
    return [cache_pspecs(v, rules) for v in cache_tree]


def _cache_leaf_spec(name: str, leaf: torch.Tensor, rules: Rules):
    axes = tuple(CACHE_AXES.get(name, (None,) * leaf.dim()))[: leaf.dim()]
    axes = axes + (None,) * (leaf.dim() - len(axes))
    return rules.spec(axes, tuple(leaf.shape))


def _bind_rules(fn, rules: Optional[Rules]):
    """Make the logical-axis ``shard()`` constraints (and, on a
    ``DeviceMesh``, DTensor's implicit replication) active while ``fn``
    runs, wherever it is called from."""
    if rules is None:
        return fn

    @functools.wraps(fn)
    def inner(*a, **k):
        with use_rules(rules):
            return fn(*a, **k)

    return inner


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
        with _no_graph(params):
            logits = transformer.forward(params, cfg, batch, backend=backend)
            return last_row(logits)

    return prefill_step


def _no_graph(params: transformer.LM):
    """``torch.inference_mode()``, or ``torch.no_grad()`` for DTensor
    parameters: DTensor fails to view a tensor made outside inference
    mode inside it (a parameter's slice, say)."""
    from torch.distributed.tensor import DTensor
    if isinstance(next(params.parameters()), DTensor):
        return torch.no_grad()
    return torch.inference_mode()


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


# ------------------------------------------------------------ cell builder
def build_cell(cfg: ModelConfig, shape: InputShape, rules: Rules,
               opt_cfg: Optional[OptConfig] = None, remat: bool = True,
               dtype=torch.bfloat16, microbatches: int = 1):
    """Return (step, example_args) for one cell at full width and depth.
    The arguments are DTensors of fake tensors (``FakeTensorMode``: shapes,
    dtypes and devices, no storage) on ``rules.mesh``, placed by the
    rules: the parameters (``param_pspecs``), the AdamW state
    (``param_pspecs_for_opt``; ``factored`` with a bfloat16 first moment
    past 50B parameters, as the reference picks), the batch
    (``batch_pspec``) and the decode cache (``cache_pspecs``; the decode
    step writes the cache's last slot, so it reads the whole cache).
    ``step(*args)`` runs the cell's step under the rules and the fake
    mode.  Serving runs the ``"torch"`` backend: B7 and B8 take no
    DTensor."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mesh = rules.mesh
    device = mesh.device_type
    if opt_cfg is None:
        big = cfg.param_count()[0] > 50e9
        opt_cfg = OptConfig(factored=big,
                            m_dtype=torch.bfloat16 if big else torch.float32)
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        lm = transformer.LM(cfg, dtype, device)
        pspecs = param_pspecs(lm, rules)
        distribute_params(lm, rules, pspecs)
        specs = input_specs(cfg, shape, dtype)
        batch = distribute_tree(
            {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
             for k, v in specs.items()}, batch_pspec(rules, specs), mesh)
        if shape.kind == "train":
            opt = opt_init(lm, opt_cfg)
            opt = distribute_tree(opt, param_pspecs_for_opt(opt, pspecs),
                                  mesh)
            fn = make_train_step(cfg, opt_cfg, remat=remat,
                                 microbatches=microbatches)
            args = (lm, opt, batch)
        elif shape.kind == "prefill":
            fn = make_prefill_step(cfg, backend="torch")
            args = (lm, batch)
        else:  # decode
            cache = transformer.init_cache(cfg, shape.global_batch,
                                           shape.seq_len, dtype,
                                           device=device)
            cache = distribute_tree(cache, cache_pspecs(cache, rules), mesh)
            fn = make_decode_step(cfg)
            args = (lm, batch, cache, shape.seq_len - 1)
    bound = _bind_rules(fn, rules)

    @functools.wraps(fn)
    def step(*a, **k):
        with mode:
            return bound(*a, **k)

    return step, args


def param_tree_pspecs(params: transformer.LM,
                      pspecs: Dict[str, PartitionSpec]) -> dict:
    """The specs of the reference's parameter tree
    (``convert.lm_params_to_tree``): a stacked leaf (L, ...) takes its
    layers' spec after a None on the layer dim."""
    from ..convert import lm_tree_groups
    return nest({path: P(None, *pspecs[names[0]]) if is_stacked(path)
                 else pspecs[names[0]]
                 for path, names in lm_tree_groups(params).items()})


def init_sharded_params(cfg: ModelConfig, rules: Rules, *, generator,
                        dtype=torch.bfloat16) -> transformer.LM:
    """``transformer.init_params`` onto ``rules.mesh``: the same draws from
    ``generator`` in the same order, on its device, module by module, each
    module's parameters laid out by ``param_pspecs`` as soon as they are
    drawn.  A rank then holds its shards and one module whole, never the
    whole model, and a one-rank mesh holds ``init_params``'s numbers.
    Every rank draws alike; each keeps its shard."""
    from torch import nn
    from torch.distributed.tensor import DTensor, distribute_tensor

    from ..distributed.sharding import placements
    mesh = rules.mesh
    lm = transformer.LM(cfg, dtype, "meta")
    specs = param_pspecs(lm, rules)
    with torch.no_grad():
        for prefix, m in lm.named_modules():
            if m is lm or not hasattr(m, "reset_parameters"):
                continue
            m.to_empty(device=generator.device, recurse=False)
            m.reset_parameters(generator)
            for leaf, p in list(m.named_parameters(recurse=False)):
                name = f"{prefix}.{leaf}" if prefix else leaf
                dt = distribute_tensor(p.detach(), mesh,
                                       placements(specs[name], mesh))
                setattr(m, leaf, nn.Parameter(dt,
                                              requires_grad=p.requires_grad))
    left = [n for n, p in lm.named_parameters()
            if not isinstance(p, DTensor)]
    if left:
        raise RuntimeError(f"init_sharded_params: no module draws {left[:3]}")
    return lm


def param_pspecs_for_opt(opt_state: dict, pspecs: Dict[str, PartitionSpec]
                         ) -> dict:
    """The AdamW state's tree of specs (the state's layout, module
    ``optim.adamw``): a moment inherits its parameter's spec when their
    ranks match (m, v), with a leading None on the layer dim of a stacked
    leaf; factored vr/vc, which drop a dim, and the step replicate."""
    def flat(tree, prefix=""):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for k, v in items:
            path = f"{prefix}{k}"
            if isinstance(v, dict) and all(isinstance(x, torch.Tensor)
                                           for x in v.values()):
                yield path, v
            else:
                yield from flat(v, path + ".")

    out = {}
    for path, state in flat(opt_state["leaves"]):
        if is_stacked(path):
            head, _, rest = path.partition(".")
            spec = P(None, *pspecs[f"{head}.0.{rest}"])
        else:
            spec = pspecs[path]
        for k, s in state.items():
            out[f"{path}.{k}"] = spec if s.dim() == len(spec) \
                else P(*([None] * s.dim()))
    return {"step": P(), "leaves": nest(out)}
