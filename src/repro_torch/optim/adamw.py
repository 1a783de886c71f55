"""AdamW for the LM zoo (the JAX package's ``optim/adamw.py``): a clip to
the global gradient norm, Adam with bias corrections, decoupled weight
decay, and optionally an Adafactor-style factored second moment and a
first moment stored in a narrower dtype.

As in the reference:

* the clip scale is ``min(1, clip / (gnorm + 1e-9))``, and ``opt_update``
  returns the norm before the clip;
* the bias corrections are ``1 - b ** t`` with the step ``t`` in float32;
* ``m`` is computed in float32 and stored in ``m_dtype``;
* weight decay is decoupled (``u += wd * p``) and reaches every leaf,
  norms and embeddings included;
* the new parameter is ``(p32 - lr * u)`` cast back to the parameter's
  dtype;
* with ``factored``, a leaf whose last two dims are both at least 2 keeps
  a row and a column mean of ``g ** 2 + 1e-30`` (``vr`` drops the row
  dim, ``vc`` the column dim) and rebuilds ``v`` as their outer product
  over ``mean(vr)``; other leaves keep a full ``v``.

The state is the reference's tree, ``{"step": int32 0-d, "leaves":
{<path>: {"m", "v"} | {"m", "vr", "vc"}}}``, with the paths and shapes of
the reference's stacked parameters (``convert.lm_tree_groups``): a leaf
that the reference stacks by layer, ``stack.<name>`` or
``prefix.<name>``, has one (L, ...) state for the L layers' parameters.
So a ``{"params", "opt"}`` checkpoint is the reference's, and whether a
leaf is factored is decided on the stacked shape, by the reference's
rule: a stacked 1-D parameter (a norm's scale, Mamba2's ``A_log``) is an
(L, D) leaf, factored across its layers.

How the per-layer gradients meet the stacked state: the update is
elementwise except for the factored means, so each layer's parameter is
updated against its slice of the stacked state (views, in place), and a
factored leaf whose means run within a layer (a stacked parameter of two
or more dims) is updated the same way.  Only a factored leaf whose means
run across the layers, a stacked 1-D parameter, is stacked: its
gradients and parameters (L x D numbers) are stacked, updated together,
and the new parameters copied back.

``opt_update`` updates the parameters and the state's tensors in place
under ``torch.no_grad()`` and returns ``(state, gnorm)``, the state a new
dict holding the same moment tensors and the next step, as
``repro_torch.nn.optim`` does.  Nothing is read back to the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional, Tuple

import torch
from torch import nn

from ..convert import is_stacked, lm_tree_groups, nest


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4                  # used when no schedule is passed
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    factored: bool = False            # Adafactor-style second moment
    m_dtype: torch.dtype = torch.float32   # bfloat16 for giant configs


def _factored_dims(shape) -> Optional[Tuple[int, int]]:
    """The last two dims if both are at least 2 (Adafactor convention)."""
    if len(shape) < 2 or shape[-1] < 2 or shape[-2] < 2:
        return None
    return len(shape) - 2, len(shape) - 1


def opt_init(params: nn.Module, cfg: OptConfig, device=None) -> dict:
    """Zero state for ``params`` (an ``LM``) on its device, or on
    ``device`` when given (``"meta"`` for the shapes alone), in the
    reference's tree (module docstring)."""
    named = dict(params.named_parameters())
    if device is None:
        device = next(iter(named.values())).device
    flat = {}
    for path, names in lm_tree_groups(params).items():
        shape = tuple(named[names[0]].shape)
        if is_stacked(path):                    # the reference's (L, ...)
            shape = (len(names), *shape)
        flat[f"{path}.m"] = torch.zeros(shape, dtype=cfg.m_dtype,
                                        device=device)
        dims = _factored_dims(shape) if cfg.factored else None
        if dims is None:
            flat[f"{path}.v"] = torch.zeros(shape, dtype=torch.float32,
                                            device=device)
            continue
        r, c = dims
        flat[f"{path}.vr"] = torch.zeros(shape[:r] + shape[r + 1:],
                                         dtype=torch.float32, device=device)
        flat[f"{path}.vc"] = torch.zeros(shape[:c] + shape[c + 1:],
                                         dtype=torch.float32, device=device)
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "leaves": nest(flat)}


def _subtree(tree, path: str):
    for k in path.split("."):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def _update(p: torch.Tensor, g: torch.Tensor, s: dict, cfg: OptConfig, lr,
            bc1: torch.Tensor, bc2: torch.Tensor,
            scale: torch.Tensor) -> None:
    """One leaf's step, in place on ``p`` and ``s``'s tensors (which may be
    views into the stacked state).  A factored leaf's means run over the
    last two dims of ``p``.  Each product and sum rounds as the
    reference's expression does."""
    g = g.float() * scale
    # ``.float()`` of a float32 tensor is the tensor itself: a float32
    # moment is updated in place and the copy back is a no-op.
    m = s["m"].float().mul_(cfg.b1).add_(g * (1 - cfg.b1))
    s["m"].copy_(m)
    if "v" in s:
        v = s["v"].mul_(cfg.b2).add_(g.square().mul_(1 - cfg.b2))
    else:
        r, c = p.dim() - 2, p.dim() - 1
        g2 = g.square().add_(1e-30)
        vr = s["vr"].mul_(cfg.b2).add_(g2.mean(dim=r).mul_(1 - cfg.b2))
        vc = s["vc"].mul_(cfg.b2).add_(g2.mean(dim=c).mul_(1 - cfg.b2))
        del g2
        # v ~= vr (x) vc / mean(vr): the rank-1 reconstruction.
        mean_vr = vr.mean(dim=-1, keepdim=True).unsqueeze(r)
        v = vr.unsqueeze(r) * vc.unsqueeze(c) / torch.clamp_min(mean_vr,
                                                                1e-30)
    denom = (v / bc2).sqrt_().add_(cfg.eps)
    u = (m / bc1).div_(denom)
    del denom, m, v
    if cfg.weight_decay:
        u.add_(p.float() * cfg.weight_decay)
    p.copy_(p.float() - u.mul_(lr))


@torch.no_grad()
def opt_update(grads: Mapping[str, torch.Tensor], opt_state: dict,
               params: nn.Module, cfg: OptConfig,
               lr=None) -> Tuple[dict, torch.Tensor]:
    """One AdamW step on ``params`` (an ``LM``), in place.  ``grads`` maps
    each of its parameter names (``named_parameters``) to a gradient of
    the parameter's shape (zeros for a parameter the loss does not reach,
    as ``jax.grad`` gives); ``lr`` is a float or a 0-d tensor, ``cfg.lr``
    when None.  Returns (state, the global gradient norm before the
    clip)."""
    named = dict(params.named_parameters())
    gnorm = torch.sqrt(torch.stack([torch.sum(torch.square(grads[n].float()))
                                    for n in named]).sum())
    scale = torch.clamp(torch.full_like(gnorm, cfg.grad_clip)
                        / (gnorm + 1e-9), max=1.0)
    step = opt_state["step"] + 1
    t = step.float()
    bc1 = 1.0 - torch.pow(cfg.b1, t)
    bc2 = 1.0 - torch.pow(cfg.b2, t)
    lr = cfg.lr if lr is None else lr
    for path, names in lm_tree_groups(params).items():
        s = _subtree(opt_state["leaves"], path)
        if not is_stacked(path):
            _update(named[names[0]], grads[names[0]], s, cfg, lr, bc1, bc2,
                    scale)
        elif "v" in s or s["m"].dim() > 2:
            for i, n in enumerate(names):
                _update(named[n], grads[n], {k: x[i] for k, x in s.items()},
                        cfg, lr, bc1, bc2, scale)
        else:       # factored across the layers: stack, update, copy back
            p = torch.stack([named[n] for n in names])
            _update(p, torch.stack([grads[n] for n in names]), s, cfg, lr,
                    bc1, bc2, scale)
            for i, n in enumerate(names):
                named[n].copy_(p[i])
    return {"step": step, "leaves": opt_state["leaves"]}, gnorm
