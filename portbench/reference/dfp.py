"""Plain DFP network (Dosovitskiy & Koltun 2017, as MRSch adapts it in
arXiv:2403.16298 §II-B, §III): its weight layout, the evaluated policy's
weights laid out by a seed, and action scores for packed decision rows,
in plain PyTorch.

State module ``"mlp"``: state_dim -> hidden... -> state_out, leaky ReLU
(slope 0.2) after every layer.  ``"attention"``: the queue-as-tokens
encoder (each of the first Q waiting jobs one token, a cluster-context
token first, pre-norm layers of multi-head attention masked to the queue
length and a two-layer MLP, a final layer norm), pooled as [context |
masked mean of the job tokens | the first W job tokens, zeroed where
empty] -> dense -> leaky ReLU.  Measurement and goal modules: three
layers of ``module_hidden``, leaky ReLU.  The joint vector feeds an
expectation stream (T*M) and an action stream (A*T*M) normalised to zero
mean over actions; the score of action a is sum_t w_t sum_m g_m p[a,t,m].

``precision="float32"`` multiplies in float32 (TF32 off).  ``"tf32"``
rounds both operands of every product to TF32's 10-bit mantissa first,
as the card's TF32 path does: the control one step below the
configuration's float32.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

LN_EPS = 1e-5
SLOPE = 0.2


def layout(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every weight leaf of the configuration's
    network; kind is "w" (He normal), "b" (bias), "ln_scale", "ln_bias"."""
    a = cfg["agent"]
    R = len(cfg["cluster"]["capacities"])
    W = a["window"]
    T = len(a["offsets"])
    h, out, sh = a["module_hidden"], a["state_out"], a["stream_hidden"]
    leaves: List[Tuple[str, tuple, str]] = []

    def dense(name, k, n):
        leaves.append((f"{name}.w", (k, n), "w"))
        leaves.append((f"{name}.b", (n,), "b"))

    def mlp(name, sizes):
        for i in range(len(sizes) - 1):
            dense(f"{name}.layers.{i}", sizes[i], sizes[i + 1])

    def norm(name, d):
        leaves.append((f"{name}.scale", (d,), "ln_scale"))
        leaves.append((f"{name}.bias", (d,), "ln_bias"))

    if a["state_module"] == "attention":
        d = a["attn_dim"]
        dense("state.tok", R + 2, d)
        dense("state.ctx", 2 * R, d)
        for i in range(a["attn_layers"]):
            p = f"state.blocks.{i}"
            norm(f"{p}.ln1", d)
            for w in ("wq", "wk", "wv", "wo"):
                dense(f"{p}.{w}", d, d)
            norm(f"{p}.ln2", d)
            mlp(f"{p}.mlp", [d, a["attn_mlp_mult"] * d, d])
        norm("state.ln_f", d)
        dense("state.out", d * (2 + W), out)
    else:
        state_dim = W * (R + 2) + 2 * sum(cfg["cluster"]["capacities"])
        mlp("state", [state_dim, *a["state_hidden"], out])
    mlp("measurement", [R, h, h, h])
    mlp("goal", [R, h, h, h])
    mlp("expectation", [out + 2 * h, sh, T * R])
    mlp("action", [out + 2 * h, sh, W * T * R])
    return leaves


def _sites(cfg: dict) -> List[Tuple[int, List[tuple]]]:
    """Every hidden width that a permutation may reorder without changing
    the network's function: (size, [(leaf, axis, start, stop), ...]), the
    producing layer's columns and bias and the consuming rows."""
    a = cfg["agent"]
    h, out = a["module_hidden"], a["state_out"]
    names = {n for n, _, _ in layout(cfg)}
    sites = []

    def chain(name):
        n = sum(1 for k in names if k.startswith(f"{name}.layers.")
                and k.endswith(".w"))
        return [f"{name}.layers.{i}" for i in range(n)]

    def link(src, dst_rows, size):
        sites.append((size, [(f"{src}.w", 1, 0, size), (f"{src}.b", 0, 0, size),
                             *dst_rows]))

    chains = ["measurement", "goal", "expectation", "action"]
    if a["state_module"] == "attention":
        chains += [f"state.blocks.{i}.mlp" for i in range(a["attn_layers"])]
        state_out = "state.out"
    else:
        chains.append("state")
        state_out = chain("state")[-1]
    shapes = {n: s for n, s, _ in layout(cfg)}
    for c in chains:
        layers = chain(c)
        for i in range(len(layers) - 1):
            size = shapes[f"{layers[i]}.w"][1]
            link(layers[i], [(f"{layers[i + 1]}.w", 0, 0, size)], size)
    off = 0
    for src, size in ((state_out, out), (chain("measurement")[-1], h),
                      (chain("goal")[-1], h)):
        link(src, [(f"{s}.layers.0.w", 0, off, off + size)
                   for s in ("expectation", "action")], size)
        off += size
    return sites


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The evaluated policy's weights, laid out by ``seed``.

    The policy is fixed: every leaf comes from one normal draw of a
    generator on ``device`` seeded with the configuration's
    ``weights_seed`` (weights He normal, std sqrt(2 / fan_in); biases
    N(0, 0.05^2); layer-norm scales 1 + N(0, 0.1^2), biases N(0, 0.1^2)).
    ``seed`` then reorders every hidden width that a permutation can
    reorder without changing what the network computes (``_sites``), so
    each run's weights differ in layout while every run does the same
    work."""
    leaves = layout(cfg)
    sizes = [math.prod(shape) for _, shape, _ in leaves]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(cfg["weights_seed"]))
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    out, off = {}, 0
    for (name, shape, kind), n in zip(leaves, sizes):
        x = flat[off:off + n].view(shape)
        off += n
        if kind == "w":
            x = x * math.sqrt(2.0 / shape[0])
        elif kind == "b":
            x = x * 0.05
        elif kind == "ln_scale":
            x = 1.0 + 0.1 * x
        else:
            x = 0.1 * x
        out[name] = x
    gen.manual_seed(int(seed) % 2**63)
    for size, uses in _sites(cfg):
        perm = torch.randperm(size, generator=gen, device=device)
        for leaf, axis, start, stop in uses:
            part = out[leaf].narrow(axis, start, stop - start)
            part.copy_(part.index_select(axis, perm))
    return out


def parameter_count(cfg: dict) -> int:
    return sum(math.prod(shape) for _, shape, _ in layout(cfg))


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits), to nearest, ties to even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class Net:
    """The scorer: ``scores(rows)`` -> (B, W) for packed decision rows."""

    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor],
                 precision: str = "float32"):
        if precision not in ("float32", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.cfg, self.w, self.tf32 = cfg, weights, precision == "tf32"
        a = cfg["agent"]
        self.R = len(cfg["cluster"]["capacities"])
        self.W, self.T = a["window"], len(a["offsets"])
        self.temporal = torch.tensor(a["temporal_weights"],
                                     dtype=torch.float32)

    def _mm(self, x, w):
        if self.tf32:
            x, w = _tf32(x), _tf32(w)
        return x @ w

    def _bmm(self, x, y):
        if self.tf32:
            x, y = _tf32(x), _tf32(y)
        return torch.matmul(x, y)

    def _dense(self, name, x, act=False):
        y = self._mm(x, self.w[f"{name}.w"]) + self.w[f"{name}.b"]
        return torch.where(y >= 0, y, SLOPE * y) if act else y

    def _mlp(self, name, x, final_act):
        n = sum(1 for k in self.w if k.startswith(f"{name}.layers.")
                and k.endswith(".w"))
        for i in range(n):
            x = self._dense(f"{name}.layers.{i}", x,
                            act=i < n - 1 or final_act)
        return x

    def _norm(self, name, x):
        mu = x.mean(dim=-1, keepdim=True)
        var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
        return ((x - mu) * torch.rsqrt(var + LN_EPS) * self.w[f"{name}.scale"]
                + self.w[f"{name}.bias"])

    def _encoder(self, state):
        a = self.cfg["agent"]
        Q, R, W = a["queue_cap"], self.R, self.W
        d, H = a["attn_dim"], a["attn_heads"]
        hd = d // H
        B = state.shape[0]
        tokens = state[:, :Q * (R + 2)].reshape(B, Q, R + 2)
        qlen = state[:, Q * (R + 2)]
        ctx = state[:, Q * (R + 2) + 1:Q * (R + 2) + 1 + 2 * R]
        x = torch.cat([self._dense("state.ctx", ctx)[:, None],
                       self._dense("state.tok", tokens)], dim=1)
        S = Q + 1
        keep = (torch.arange(S, dtype=torch.float32, device=state.device)
                [None, :] < (qlen + 1.0)[:, None])            # (B, S) keys
        for i in range(a["attn_layers"]):
            p = f"state.blocks.{i}"
            h = self._norm(f"{p}.ln1", x)
            q, k, v = (self._dense(f"{p}.{w}", h).reshape(B, S, H, hd)
                       .transpose(1, 2) for w in ("wq", "wk", "wv"))
            s = self._bmm(q, k.transpose(-1, -2)) * hd ** -0.5
            s = torch.where(keep[:, None, None, :], s, -torch.inf)
            att = self._bmm(torch.softmax(s, dim=-1), v)
            x = x + self._dense(f"{p}.wo", att.transpose(1, 2)
                                .reshape(B, S, d))
            m = self._dense(f"{p}.mlp.layers.0", self._norm(f"{p}.ln2", x),
                            act=True)
            x = x + self._dense(f"{p}.mlp.layers.1", m)
        h = self._norm("state.ln_f", x)
        jobs = h[:, 1:]
        valid = (torch.arange(Q, dtype=torch.float32, device=state.device)
                 [None, :] < qlen[:, None]).float()
        mean = ((jobs * valid[..., None]).sum(dim=1)
                / valid.sum(dim=1, keepdim=True).clamp_min(1.0))
        win = (jobs[:, :W] * valid[:, :W, None]).reshape(B, W * d)
        return self._dense("state.out", torch.cat([h[:, 0], mean, win], -1),
                           act=True)

    def scores(self, rows: torch.Tensor) -> torch.Tensor:
        a = self.cfg["agent"]
        R, W, T = self.R, self.W, self.T
        sd = rows.shape[1] - 2 * R - W
        state, meas = rows[:, :sd], rows[:, sd:sd + R]
        goal = rows[:, sd + R:sd + 2 * R]
        if a["state_module"] == "attention":
            s = self._encoder(state)
        else:
            s = self._mlp("state", state, final_act=True)
        j = torch.cat([s, self._mlp("measurement", meas, True),
                       self._mlp("goal", goal, True)], dim=-1)
        e = self._mlp("expectation", j, False)                   # (B, T*R)
        act = self._mlp("action", j, False).reshape(-1, W, T * R)
        p = (e[:, None, :] + act - act.mean(dim=1, keepdim=True))
        p = p.reshape(-1, W, T, R)
        wt = self.temporal.to(rows.device)
        return (p * wt[None, None, :, None] * goal[:, None, None, :]
                ).sum(dim=(2, 3))
