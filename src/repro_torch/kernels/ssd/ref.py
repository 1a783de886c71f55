"""Plain PyTorch versions of the Mamba2 SSD (the JAX package's
``kernels/ssd/ref.py`` and the arithmetic of its ``ssd_kernel``): the CPU
path, and the oracles the CUDA kernel is held against on the card.

* ``ssd_ref``: the exact sequential recurrence, the reference's oracle,
  ``h_t = exp(dA_t) h_{t-1} + dt_t B_t x_t^T``, ``y_t = C_t . h_t``.
* ``ssd_chunk_ref``: what the kernel computes, chunk by chunk, in float32
  (the Pallas kernel's body batched over batch-heads).
* ``ssd_plain``: ``ssd_chunk_ref`` behind the wrapper's preparation, in the
  models' layout: the plain version of ``ops.ssd``.
* ``ssd_chunk_state_ref``, ``ssd_state_pass_ref``, ``ssd_chunk_scan_ref``:
  the three passes the CUDA kernels compute, parallel over chunks (the
  decomposition of the JAX package's ``_ssd_chunked``); composed, they
  give ``ssd_chunk_ref``'s function.
"""
from __future__ import annotations

import torch


def ssd_ref(x, dt, dA, B, C):
    """x (BH, S, P); dt and dA (BH, S, 1); B and C (BH, S, N) -> y
    (BH, S, P) in x's dtype, by the sequential recurrence in float32."""
    xf, dtf, dAf, Bf, Cf = (t.float() for t in (x, dt, dA, B, C))
    bh, S, P = x.shape
    h = torch.zeros((bh, B.shape[-1], P), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(S):
        h = (torch.exp(dAf[:, t])[:, :, None] * h
             + (dtf[:, t] * Bf[:, t])[:, :, None] * xf[:, t, None, :])
        ys.append(torch.einsum("bn,bnp->bp", Cf[:, t], h))
    return torch.stack(ys, dim=1).to(x.dtype)


def ssd_chunk_ref(x, dt, l, B, C, chunk: int) -> torch.Tensor:
    """The Pallas ``ssd_kernel``'s function: x (BH, S, P), dt and l (BH, S,
    1) with l the within-chunk cumulative sum of dA, B and C (BH, S, N),
    S % chunk == 0 -> y (BH, S, P) float32.  Per chunk, with the (N, P)
    state h carried from the last: y = tril(C B^T * exp(l_i - l_j)) * dt^T
    @ x + exp(l) * (C @ h); h <- exp(l_last) h + (B exp(l_last - l) dt)^T
    @ x."""
    xf, dtf, lf, Bf, Cf = (t.float() for t in (x, dt, l, B, C))
    bh, S, P = x.shape
    assert S % chunk == 0, (S, chunk)
    h = torch.zeros((bh, B.shape[-1], P), dtype=torch.float32,
                    device=x.device)
    tril = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        xc, dtc, lc, Bc, Cc = (t[:, sl] for t in (xf, dtf, lf, Bf, Cf))
        scores = Cc @ Bc.transpose(1, 2)                     # (BH, Q, Q)
        decay = torch.exp(lc - lc.transpose(1, 2))
        w = torch.where(tril, scores * decay * dtc.transpose(1, 2), 0.0)
        y = w @ xc + torch.exp(lc) * (Cc @ h)
        l_last = lc[:, -1:]                                  # (BH, 1, 1)
        sdec = torch.exp(l_last - lc)
        h = torch.exp(l_last) * h + (Bc * sdec * dtc).transpose(1, 2) @ xc
        ys.append(y)
    return torch.cat(ys, dim=1)


def _chunks(t, chunk: int):
    """(BH, S, d) -> (BH, n_chunks, chunk, d) float32."""
    bh, S, d = t.shape
    return t.float().reshape(bh, S // chunk, chunk, d)


def ssd_chunk_state_ref(x, dt, l, B, chunk: int) -> torch.Tensor:
    """Pass 1: each chunk's local state S_c = (B exp(l_last - l) dt)^T x,
    for x (BH, S, P), dt and l (BH, S, 1), B (BH, S, N), S % chunk == 0 ->
    (BH, n_chunks, N, P) float32."""
    xc, dtc, lc, Bc = (_chunks(t, chunk) for t in (x, dt, l, B))
    scale = torch.exp(lc[:, :, -1:] - lc) * dtc             # (BH, nc, Q, 1)
    return (Bc * scale).transpose(2, 3) @ xc


def ssd_state_pass_ref(states, l, chunk: int) -> torch.Tensor:
    """Pass 2: the state entering each chunk from the chunks' local states
    (BH, n_chunks, N, P) and l (BH, S, 1): h_0 = 0, h_c = exp(l_last_{c-1})
    h_{c-1} + S_{c-1} -> (BH, n_chunks, N, P) float32."""
    decay = torch.exp(_chunks(l, chunk)[:, :, -1, 0])        # (BH, nc)
    h = torch.zeros_like(states[:, 0])
    entering = []
    for c in range(states.shape[1]):
        entering.append(h)
        h = decay[:, c, None, None] * h + states[:, c]
    return torch.stack(entering, dim=1)


def ssd_chunk_scan_ref(x, dt, l, B, C, h, chunk: int) -> torch.Tensor:
    """Pass 3: per chunk, y = tril(C B^T * exp(l_i - l_j)) * dt^T @ x +
    exp(l) * (C @ h_c), from the states entering the chunks h (BH,
    n_chunks, N, P) -> y (BH, S, P) float32.  The decay is the masked
    difference exp(l_i - l_j), never exp(l_i) exp(-l_j)."""
    xc, dtc, lc, Bc, Cc = (_chunks(t, chunk) for t in (x, dt, l, B, C))
    tril = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    diff = torch.where(tril, lc - lc.transpose(2, 3), -torch.inf)
    w = (Cc @ Bc.transpose(2, 3)) * torch.exp(diff) * dtc.transpose(2, 3)
    y = w @ xc + torch.exp(lc) * (Cc @ h)
    return y.reshape(x.shape[0], -1, x.shape[2])


def prepare(dt, dA, S: int, chunk: int) -> tuple:
    """The wrapper's preparation of the step sizes, as the reference's
    ``ssd/ops.py`` makes it: dt and dA (b, S, H) padded with zeros to Sp, a
    multiple of the chunk, and l = the within-chunk cumulative sum of dA,
    both (b, Sp, H) float32 and contiguous."""
    b, _, H = dt.shape
    pad = (-S) % chunk
    dtp = torch.nn.functional.pad(dt.float(), (0, 0, 0, pad))
    dAp = torch.nn.functional.pad(dA.float(), (0, 0, 0, pad))
    Sp = S + pad
    l = dAp.reshape(b, Sp // chunk, chunk, H).cumsum(dim=2)
    return dtp.contiguous(), l.reshape(b, Sp, H).contiguous()


def ssd_plain(x, dt, dA, B, C, *, chunk: int, out_dtype=None):
    """``ops.ssd``'s function on any device: x (b, S, H, P), dt and dA
    (b, S, H), B and C (b, S, G, N) with head h reading group h // (H // G)
    -> y (b, S, H, P) in ``out_dtype`` (default x's dtype)."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    dtp, l = prepare(dt, dA, S, chunk)
    Sp = dtp.shape[1]
    pad = Sp - S
    group = torch.arange(H, device=x.device) // (H // G)

    def flat(t, d):                     # (b, S, H, d) -> (b*H, Sp, d)
        t = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
        return t.transpose(1, 2).reshape(b * H, Sp, d)

    def col(t):                         # (b, Sp, H) -> (b*H, Sp, 1)
        return t.transpose(1, 2).reshape(b * H, Sp, 1)

    y = ssd_chunk_ref(flat(x, P), col(dtp), col(l),
                      flat(B[:, :, group], N), flat(C[:, :, group], N), chunk)
    y = y.reshape(b, H, Sp, P).transpose(1, 2)[:, :S]
    return y.to(out_dtype or x.dtype)
