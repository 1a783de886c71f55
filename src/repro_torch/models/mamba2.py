"""Mamba2 block via SSD (state-space duality) for the full sequence (the
JAX package's ``models/mamba2.py``).

``mamba2_apply`` projects, convolves and gates as the reference does; its
SSD core runs on the ``"kernel"`` backend through B8
(``kernels.ssd.ssd``: the CUDA kernel on the card, its plain version on
the CPU), which reads B and C by group, and on the ``"torch"`` backend
through ``_ssd_chunked``, the reference's vectorised chunked algorithm.
The one-token decode (``mamba2_decode_apply``) is the reference's
recurrent update with no kernel: the conv over a window of the last
``conv_width`` inputs, the float32 state, the ``D`` skip, gate and norm.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import SSMConfig
from ..distributed.collectives import local_parallel
from ..distributed.sharding import gather_seq, shard
from ..kernels.ssd import ssd
from ..nn.backend import resolve_backend
from .layers import RMSNorm, _init_dense, _normal, empty_param, rmsnorm


class Mamba2(nn.Module):
    def __init__(self, d_model: int, cfg: SSMConfig, dtype, device=None):
        super().__init__()
        d_in = cfg.expand * d_model
        n_heads = d_in // cfg.head_dim
        gn = cfg.n_groups * cfg.d_state
        kw = dict(dtype=dtype, device=device)
        self.w_z = empty_param(d_model, d_in, **kw)
        self.w_x = empty_param(d_model, d_in, **kw)
        self.w_B = empty_param(d_model, gn, **kw)
        self.w_C = empty_param(d_model, gn, **kw)
        self.w_dt = empty_param(d_model, n_heads, **kw)
        self.dt_bias = empty_param(n_heads, **kw)
        self.A_log = empty_param(n_heads, dtype=torch.float32, device=device)
        self.D = empty_param(n_heads, dtype=torch.float32, device=device)
        self.conv = empty_param(cfg.conv_width, d_in + 2 * gn, **kw)
        self.norm = RMSNorm(d_in, dtype, device)
        self.out_proj = empty_param(d_in, d_model, **kw)

    def reset_parameters(self, generator=None) -> None:
        """The reference's distributions: dense weights normal / sqrt(in),
        dt_bias and A_log 0, D 1, the conv normal / width (the norm
        resets itself)."""
        for p in (self.w_z, self.w_x, self.w_B, self.w_C, self.w_dt):
            _init_dense(p, generator)
        nn.init.zeros_(self.dt_bias)
        nn.init.zeros_(self.A_log)
        nn.init.ones_(self.D)
        width = self.conv.shape[0]
        self.conv.copy_(_normal(self.conv.shape, generator, self.conv.device)
                        / width)
        _init_dense(self.out_proj, generator)


def mamba2_init(d_model: int, cfg: SSMConfig, dtype, *, generator,
                device=None) -> Mamba2:
    m = Mamba2(d_model, cfg, dtype, device)
    m.reset_parameters(generator)
    m.norm.reset_parameters()
    return m


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv by explicit shifts, as the reference computes
    it (no ``conv1d``, so no cuDNN and no TF32).  x (B, S, C), w (W, C)."""
    W = w.shape[0]
    out = x * w[W - 1]
    for i in range(1, W):
        shifted = F.pad(x, (0, 0, i, 0))[:, : x.shape[1]]
        out = out + shifted * w[W - 1 - i]
    return out


def _ssd_chunked(xh, dt, dA, B_, C_, chunk: int) -> torch.Tensor:
    """Chunked SSD core, vectorised over chunks (the reference's).

    xh (B, S, H, P) inputs per head; dt (B, S, H) step sizes; dA (B, S, H)
    = dt * A; B_ and C_ (B, S, G, N), G groups broadcast over H; S a
    multiple of ``chunk`` -> y (B, S, H, P) float32.

    The reference combines the chunk states with ``jax.lax.associative_scan``
    (log depth); here a loop over chunks runs the same recurrence
    H_c = exp(l_last_c) H_{c-1} + S_c in order.  The two differ only in the
    order of the sums.
    """
    B, S, H, P = xh.shape
    G = B_.shape[-2]
    nc = S // chunk
    rep = H // G

    def chunks(t):
        return t.reshape(t.shape[0], nc, chunk, *t.shape[2:])

    xc = chunks(xh)                                         # (B,nc,Q,H,P)
    dtc = chunks(dt)                                        # (B,nc,Q,H)
    dAc = chunks(dA)
    Bc = torch.repeat_interleave(chunks(B_), rep, dim=-2)   # (B,nc,Q,H,N)
    Cc = torch.repeat_interleave(chunks(C_), rep, dim=-2)

    l = torch.cumsum(dAc, dim=2)                            # (B,nc,Q,H)
    l_last = l[:, :, -1]                                    # (B,nc,H)

    # intra-chunk: decay(i, j) = exp(l_i - l_j) for i >= j.  The reference
    # masks exp(diff) after the exp; masking diff to -inf before it gives
    # the same values, and a finite gradient where exp(l_i - l_j) for
    # i < j overflows (inf * 0 in the backward of the masked entries: at
    # full width a chunk's decay reaches exp(200)).
    diff = l[:, :, :, None, :] - l[:, :, None, :, :]        # (B,nc,Qi,Qj,H)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xh.device))
    decay = torch.exp(torch.where(mask[None, None, :, :, None], diff,
                                  float("-inf")))
    scores = torch.einsum("bcihn,bcjhn->bcijh", Cc, Bc)
    w = scores * decay * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w.to(xc.dtype), xc)

    # chunk summary states: S_c = sum_j exp(l_last - l_j) dt_j B_j x_j^T
    sdec = torch.exp(l_last[:, :, None] - l)                # (B,nc,Q,H)
    states = torch.einsum("bcjh,bcjhn,bcjhp->bchnp",
                          (sdec * dtc).to(xc.dtype), Bc, xc).float()

    # inter-chunk recurrence, in order: H_c = exp(l_last_c) H_{c-1} + S_c,
    # and the state entering chunk c is H_{c-1} (zeros for chunk 0).
    a = torch.exp(l_last).float()                           # (B,nc,H)
    h = torch.zeros_like(states[:, 0])
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * a[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                     # (B,nc,H,N,P)

    y_inter = torch.einsum("bcihn,bchnp->bcihp", Cc.float(),
                           h_prev) * torch.exp(l)[..., None]
    y = y_intra.float() + y_inter
    return y.reshape(B, S, H, P)


def _ssd_padded(xh, dt, dA, B_, C_, chunk: int) -> torch.Tensor:
    """``_ssd_chunked`` of a sequence padded to a chunk multiple (appended
    steps are causal-safe), as the reference pads it."""
    S = xh.shape[1]
    pad = (-S) % chunk
    return _ssd_chunked(*(F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                          for t in (xh, dt, dA, B_, C_)), chunk)[:, :S]


def mamba2_apply(params: Mamba2, u: torch.Tensor, cfg: SSMConfig, *,
                 backend: str = "kernel") -> torch.Tensor:
    """Full-sequence SSD block.  u (B, S, D) -> (B, S, D)."""
    B, S, D = u.shape
    d_in = cfg.expand * D
    H = d_in // cfg.head_dim
    gn = cfg.n_groups * cfg.d_state
    u = gather_seq(u)                  # one gather for the five projections
    z = u @ shard(params.w_z, None, "heads")
    xBC = torch.cat([u @ shard(params.w_x, None, "heads"),
                     u @ shard(params.w_B, None, None),
                     u @ shard(params.w_C, None, None)], dim=-1)
    # The conv is parallel over the batch and the channels.
    xBC = F.silu(local_parallel(_causal_conv, (xBC, params.conv),
                                ((0, 2), (None, 1)), (0, 2)))
    x = shard(xBC[..., :d_in], "batch", None, "heads")
    B_ = xBC[..., d_in: d_in + gn].reshape(B, S, cfg.n_groups, cfg.d_state)
    C_ = xBC[..., d_in + gn:].reshape(B, S, cfg.n_groups, cfg.d_state)
    dt = F.softplus((u @ params.w_dt).float() + params.dt_bias.float())
    A = -torch.exp(params.A_log)                            # (H,) negative
    dA = dt * A
    xh = x.reshape(B, S, H, cfg.head_dim)
    if resolve_backend(backend) == "kernel":
        # B8 takes the sequence unpadded and B_, C_ by group.
        y = ssd(xh, dt, dA, B_, C_, chunk=cfg.chunk, out_dtype=torch.float32)
    else:
        # Parallel over the batch and, when one group serves every head,
        # the heads: on each rank's shards under mesh rules.
        heads = 2 if cfg.n_groups == 1 else None
        y = local_parallel(_ssd_padded, (xh, dt, dA, B_, C_),
                           ((0, heads),) * 3 + ((0, None),) * 2, (0, heads),
                           chunk=cfg.chunk)
    y = y + params.D[None, None, :, None] * xh.float()
    y = y.reshape(B, S, d_in).to(u.dtype)
    y = y * F.silu(z)
    y = rmsnorm(params.norm, y)
    return shard(y @ shard(params.out_proj, "heads", None),
                 "batch", "act_seq", None)


def mamba2_decode_init_cache(batch: int, d_model: int, cfg: SSMConfig, dtype,
                             *, device=None) -> dict:
    """Zeros: ``state`` (B, H, P, N) float32 and ``conv`` (B, W - 1, C), the
    last W - 1 inputs of the conv."""
    d_in = cfg.expand * d_model
    H = d_in // cfg.head_dim
    gn = cfg.n_groups * cfg.d_state
    return {
        "state": torch.zeros(batch, H, cfg.head_dim, cfg.d_state,
                             dtype=torch.float32, device=device),
        "conv": torch.zeros(batch, cfg.conv_width - 1, d_in + 2 * gn,
                            dtype=dtype, device=device),
    }


def _recurrent_step(state, dt, dA, Bh, Ch, x):
    """One step of the SSM recurrence per head: state (B, H, P, N) decays
    by exp(dA) and takes dt B x^T; y (B, H, P) reads it with C."""
    state = state * torch.exp(dA)[..., None, None] + torch.einsum(
        "bh,bhn,bhp->bhpn", dt, Bh.float(), x.float())
    return state, torch.einsum("bhpn,bhn->bhp", state, Ch.float())


def mamba2_decode_apply(params: Mamba2, u: torch.Tensor, cache: dict,
                        cfg: SSMConfig) -> Tuple[torch.Tensor, dict]:
    """One-token recurrent update.  u (B, 1, D); ``cache`` {``state``,
    ``conv``} is updated in place (the reference returns a new one).
    Returns (out (B, 1, D), cache)."""
    B, _, D = u.shape
    d_in = cfg.expand * D
    H = d_in // cfg.head_dim
    gn = cfg.n_groups * cfg.d_state
    z = u @ params.w_z
    xBC_t = torch.cat([u @ params.w_x, u @ params.w_B, u @ params.w_C],
                      dim=-1)
    window = torch.cat([cache["conv"], xBC_t], dim=1)       # (B, W, C)
    conv_out = (window * params.conv[None]).sum(dim=1, keepdim=True)
    xBC = F.silu(conv_out)
    x = xBC[..., :d_in].reshape(B, H, cfg.head_dim)
    B_ = xBC[..., d_in: d_in + gn].reshape(B, cfg.n_groups, cfg.d_state)
    C_ = xBC[..., d_in + gn:].reshape(B, cfg.n_groups, cfg.d_state)
    # Each group's B and C for its H / G heads (a repeat without the
    # host: ``repeat_interleave`` may read its output size back).
    shape = (B, cfg.n_groups, H // cfg.n_groups, cfg.d_state)
    Bh = B_[:, :, None].expand(shape).reshape(B, H, cfg.d_state)
    Ch = C_[:, :, None].expand(shape).reshape(B, H, cfg.d_state)
    dt = F.softplus((u[:, 0] @ params.w_dt).float()
                    + params.dt_bias.float())
    A = -torch.exp(params.A_log)
    # Parallel over the batch (dim 0) and the heads (dim 1).
    state, y = local_parallel(
        _recurrent_step, (cache["state"], dt, dt * A, Bh, Ch, x),
        ((0, 1),) * 6, ((0, 1), (0, 1)))
    y = y + params.D[None, :, None] * x.float()
    y = y.reshape(B, 1, d_in).to(u.dtype) * F.silu(z)
    y = rmsnorm(params.norm, y)
    cache["state"].copy_(state)
    cache["conv"].copy_(window[:, 1:])
    return shard(y @ params.out_proj, "batch", None, None), cache
