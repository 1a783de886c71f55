"""Plain PyTorch version of the window pack (the JAX package's
``kernels/window_pack/ref.py::pack_window_reference``): the CPU path, and
the oracle the CUDA kernel is held against on the card.

Given per-environment waiting masks over the job axis, gather the first
``W`` waiting jobs (queue order == ascending job index; the device engine
keeps traces sorted by submit time) into a dense window: their feature
rows, their job indices, and a validity mask.  Written as the reference
writes it: an (N, W, J) one-hot selection contracted with ``einsum``.
"""
from __future__ import annotations

import torch


def pack_window_reference(waiting: torch.Tensor, feats: torch.Tensor, *,
                          window: int):
    """waiting (N, J) 0/1, feats (N, J, F) ->
    (win_feats (N, W, F), win_idx (N, W) int32, win_valid (N, W) bool).

    Slot ``w`` holds the (w+1)-th waiting job in index order; slots past
    the number of waiting jobs are invalid with zero features and index 0.
    """
    J = waiting.shape[1]
    is_wait = waiting > 0.5
    csum = torch.cumsum(is_wait.to(torch.int32), dim=1)           # (N, J)
    slots = torch.arange(window, dtype=torch.int32,
                         device=waiting.device)[None, :, None]    # (1, W, 1)
    sel = is_wait[:, None, :] & (csum[:, None, :] == slots + 1)   # (N, W, J)
    win_feats = torch.einsum("nwj,njf->nwf", sel.to(feats.dtype), feats)
    jidx = torch.arange(J, dtype=torch.int32,
                        device=waiting.device)[None, None, :]
    win_idx = (sel * jidx).sum(dim=-1).to(torch.int32)
    win_valid = sel.any(dim=-1)
    return win_feats, win_idx, win_valid
