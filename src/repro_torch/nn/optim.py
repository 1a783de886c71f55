"""Adam for the agent network, ported as written from the JAX package's
``repro/nn/optim.py``: a clip to a global gradient norm, then Adam with
bias corrections.

It is not ``torch.optim.Adam`` with ``clip_grad_norm_``: the clip scale is
``min(1, clip / (gnorm + 1e-9))`` (torch adds 1e-6), the bias corrections
are ``1 / (1 - b ** t)`` with the step ``t`` in float32 on the device, and
the update is ``u = (m * s1) / (sqrt(v * s2) + eps)``, ``p -= lr * u``.

The JAX version is pure and returns new trees.  Here ``adam_update``
updates the parameters and both moments in place, under
``torch.no_grad()``, so no second copy of the parameters is made; the
returned state holds the same moment tensors and a new step.  Leaves are
lists in ``convert.leaves`` order.  Each step's arithmetic runs as a few
multi-tensor ``torch._foreach_*`` operations over all the leaves, and
nothing is read back to the host.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


class AdamState(NamedTuple):
    step: torch.Tensor          # () int32, on the parameters' device
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def adam_init(params: Sequence[torch.Tensor]) -> AdamState:
    return AdamState(
        step=torch.zeros((), dtype=torch.int32, device=params[0].device),
        mu=[torch.zeros_like(p) for p in params],
        nu=[torch.zeros_like(p) for p in params])


@torch.no_grad()
def adam_update(grads: Sequence[torch.Tensor], state: AdamState,
                params: Sequence[torch.Tensor], *, lr: float,
                grad_clip: float) -> Tuple[AdamState, torch.Tensor]:
    """One clipped Adam step, in place on ``params`` and the moments.

    Returns the new state and the pre-clip global gradient norm, computed
    once: it sets the clip scale and is what the agent reports as
    ``last_grad_norm``.
    """
    gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
        [g.float() for g in grads])))
    scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
    grads = torch._foreach_mul(list(grads), scale)
    step = state.step + 1
    torch._foreach_mul_(state.mu, B1)
    torch._foreach_add_(state.mu, grads, alpha=1 - B1)
    torch._foreach_mul_(state.nu, B2)
    torch._foreach_addcmul_(state.nu, grads, grads, value=1 - B2)
    t = step.float()
    mu_hat_scale = 1.0 / (1 - torch.pow(B1, t))
    nu_hat_scale = 1.0 / (1 - torch.pow(B2, t))
    denom = torch._foreach_mul(state.nu, nu_hat_scale)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, EPS)
    u = torch._foreach_mul(state.mu, mu_hat_scale)
    torch._foreach_div_(u, denom)
    torch._foreach_add_(list(params), u, alpha=-lr)
    return AdamState(step=step, mu=state.mu, nu=state.nu), gnorm
