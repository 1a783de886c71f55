"""One-card stand-in for the JAX package's ``distributed/sharding.py``.

The models call two helpers of that module: ``shard``, which constrains an
activation's sharding by logical axes and is a no-op when no mesh rules are
installed, and ``tp_row_matmul``, the row-parallel matmul whose epilogue is
a reduce-scatter over the model axis.  On one card neither has anything to
distribute, so ``shard`` returns its input and ``tp_row_matmul`` is the
plain product.  Sharding over several cards (``DeviceMesh``/``DTensor``
rules, the logical-axis table) comes with the distributed item of the
roadmap's module queue.
"""
from __future__ import annotations

import torch


def shard(x: torch.Tensor, *logical_axes) -> torch.Tensor:
    """``x`` unchanged: one card holds every shard."""
    del logical_axes
    return x


def tp_row_matmul(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h @ w``: the row-parallel product with nothing to reduce."""
    return h @ w
