"""Mixture-of-Experts on one card (the JAX package's ``models/moe.py``).

``moe_apply`` is the reference's path without a mesh: every token picks
its ``top_k`` experts by a float32 router, each expert takes at most
``capacity`` tokens (``_default_capacity``), and the choices past it are
dropped; the kept rows are scattered into an (E, C, D) buffer, the
experts' FFNs run as batched products over it (plain ``torch.bmm``, as
the reference computes them in plain XLA outside any Pallas kernel), and
each token's rows are gathered back and summed with their gates.  Shared
experts run densely on every token.

Which choices are dropped follows the reference exactly: a choice's
position within its expert is its rank in the stable sort of the flat
(token * k + j) choice list (``_positions_in_expert``).  The scatter and
the gather go through one spare row past the buffer, where dropped
choices land and which reads back as 0, so neither needs the host.

Under rules on a ``DeviceMesh`` (``distributed.sharding.use_rules``) with
a "model" axis that divides the experts, the reference's two
expert-parallel paths run on each rank's local shards (``to_local``),
their ``shard_map`` collectives as ``torch.distributed`` ones over the
mesh dims' groups (``distributed.collectives``):

* small T (B * S <= ``SMALL_T_THRESHOLD``, decode and small batches,
  ``_moe_small_t``): the tokens are replicated and the expert weights
  stay sharded in place, over "model" or, under the serve rules, over
  ("model", "data"); rank (m, d)'s experts are block ``m * n_data + d``,
  the reference's index, which is the block its ``_StridedShard`` weights
  hold.  With d_model fsdp-sharded over "data" (and experts not over
  "data"), the up/gate products run on each data rank's D slice of the
  buffer and are summed over "data", the down product's D slices
  gathered.  The routed output is summed over the expert axes;
* big T: the tokens stay batch-sharded over ("pod", "data"); each data
  shard routes its own T_loc tokens at the capacity of T_loc (so it
  equals the no-mesh result only when nothing is dropped), its model
  rank runs its E / n_model experts with the weights' D dim all-gathered
  over "data", and the output is summed over "model".

The collectives carry their gradients (``psum``'s ``grad`` argument says
which way), so the paths also train.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..configs.base import MoEConfig
from ..distributed import collectives, sharding
from ..distributed.sharding import P, shard
from .layers import FFN, _act, _normal, empty_param, ffn_apply


class MoE(nn.Module):
    """The reference's leaves: ``router`` (D, E) in float32 whatever the
    model's dtype; ``w_up``, ``w_down`` and, with GLU, ``w_gate`` stacked
    (E, in, out); ``shared``, an FFN of width ``d_shared_expert`` or
    ``d_expert * n_shared``."""

    def __init__(self, d_model: int, cfg: MoEConfig, glu: bool, dtype,
                 device=None):
        super().__init__()
        E, Fe = cfg.n_routed, cfg.d_expert
        kw = dict(dtype=dtype, device=device)
        self.router = empty_param(d_model, E, dtype=torch.float32,
                                  device=device)
        self.w_up = empty_param(E, d_model, Fe, **kw)
        self.w_down = empty_param(E, Fe, d_model, **kw)
        self.w_gate: Optional[nn.Parameter] = (
            empty_param(E, d_model, Fe, **kw) if glu else None)
        if cfg.n_shared:
            shared_f = cfg.d_shared_expert or cfg.d_expert * cfg.n_shared
            self.shared = FFN(d_model, shared_f, glu, dtype, device)

    def reset_parameters(self, generator=None) -> None:
        """Each matrix normal / sqrt(its in dim): the router's (D, E) and
        every expert's (the FFN resets itself)."""
        for p in (self.router, self.w_up, self.w_down, self.w_gate):
            if p is not None:
                std = 1.0 / math.sqrt(p.shape[-2])
                p.copy_(_normal(p.shape, generator, p.device) * std)


def moe_init(d_model: int, cfg: MoEConfig, glu: bool, dtype, *, generator,
             device=None) -> MoE:
    m = MoE(d_model, cfg, glu, dtype, device)
    for sub in m.modules():
        sub.reset_parameters(generator)
    return m


def _positions_in_expert(idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """idx (T, k) -> each choice's position within its expert (T, k): its
    rank among the choices of that expert in flat (t * k + j) order, by a
    stable sort."""
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    sorted_e = flat[order]
    starts = torch.searchsorted(
        sorted_e, torch.arange(n_experts, device=idx.device,
                               dtype=sorted_e.dtype), side="left")
    pos_sorted = torch.arange(flat.numel(), device=idx.device) \
        - starts[sorted_e]
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    return pos.reshape(idx.shape)


def route(router_w: torch.Tensor, x: torch.Tensor, cfg: MoEConfig
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, D) -> (gates (T, k) float32, experts (T, k) int64): softmax
    of the float32 logits, its top k (largest first), the gates
    renormalised to sum 1 (floored at 1e-9)."""
    probs = torch.softmax(x.float() @ router_w, dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return gates, idx


def _expert_ffn(buf, w_gate, w_up, w_down, act: str, glu: bool):
    """buf (E, C, D) through each expert's FFN -> (E, C, D)."""
    up = torch.bmm(buf, w_up)
    h = _act(act)(torch.bmm(buf, w_gate)) * up if glu else _act(act)(up)
    return torch.bmm(h, w_down)


def _expert_ffn_local(buf, w_gate, w_up, w_down, act: str, glu: bool,
                      data_group=None):
    """buf (E_loc, C, D); with ``data_group`` the expert weights arrive
    d_model-sharded over the data axis (ZeRO-3 storage) and are
    all-gathered for use — tokens differ across data shards, so the
    contraction itself must be local (the gathers' backward
    reduce-scatters the weights' gradients)."""
    if data_group is not None:
        gather = functools.partial(collectives.all_gather, group=data_group,
                                   grad="reduce_scatter")
        w_up = gather(w_up, dim=1)
        w_down = gather(w_down, dim=2)
        if glu:
            w_gate = gather(w_gate, dim=1)
    return _expert_ffn(buf, w_gate, w_up, w_down, act, glu)


def _dispatch(x, idx, pos, mine, capacity: int, n_local: int):
    """Scatter x (T, D)'s choices ``mine`` (of local experts ``idx``) into
    an (n_local, C, D) buffer -> (buffer, dest): row idx * C + pos; the
    other choices go to one spare row past it."""
    T, D = x.shape
    K = idx.shape[1]
    dest = torch.where(mine, idx * capacity + pos,
                       n_local * capacity).reshape(-1)
    buf = torch.zeros(n_local * capacity + 1, D, dtype=x.dtype,
                      device=x.device)
    buf.index_copy_(0, dest, x[:, None].expand(T, K, D).reshape(T * K, D))
    return buf[:-1].view(n_local, capacity, D), dest


def _combine(out, dest, mine, gates):
    """Gather each choice's row of out (n_local, C, D) back (the spare
    row reads 0) and sum them with their gates -> (T, D)."""
    n_local, C, D = out.shape
    T, K = gates.shape
    out = torch.cat([out.reshape(n_local * C, D), out.new_zeros(1, D)])
    y = out[dest].reshape(T, K, D)
    w = (gates * mine)[..., None].to(y.dtype)
    return (y * w).sum(dim=1)


def _route_and_dispatch(x, router_w, cfg: MoEConfig, capacity: int,
                        e_first: int, n_local: int):
    """Route x (T, D) and scatter the kept choices of experts [e_first,
    e_first + n_local) -> (gates, buffer, dest, mine)."""
    gates, idx = route(router_w, x, cfg)
    pos = _positions_in_expert(idx, cfg.n_routed)
    mine = pos < capacity
    if n_local != cfg.n_routed:              # a shard of the experts
        mine = mine & (idx >= e_first) & (idx < e_first + n_local)
        idx = idx - e_first
    buf, dest = _dispatch(x, idx, pos, mine, capacity, n_local)
    return gates, buf, dest, mine


def _moe_local(x, router_w, w_gate, w_up, w_down, cfg: MoEConfig, act: str,
               glu: bool, capacity: int, e_first: int = 0,
               n_local: Optional[int] = None, model_group=None,
               data_group=None) -> torch.Tensor:
    """Routed experts over x (T, D) for the experts [e_first, e_first +
    n_local) held here (all of them by default); the per-shard body of
    the big-T path, which passes the mesh's "model" group (the partial
    outputs are summed over it) and "data" group (the weights' D dim is
    gathered over it)."""
    n_local = cfg.n_routed if n_local is None else n_local
    gates, buf, dest, mine = _route_and_dispatch(x, router_w, cfg, capacity,
                                                 e_first, n_local)
    out = _expert_ffn_local(buf, w_gate, w_up, w_down, act, glu, data_group)
    y = _combine(out, dest, mine, gates)
    if model_group is not None:
        y = collectives.psum(y, model_group)
    return y


SMALL_T_THRESHOLD = 4096     # decode/small-batch: replicate tokens, not weights


def _local(t, mesh, spec):
    """A DTensor's local shard laid out as ``spec``; a plain tensor counts
    as replicated."""
    return collectives.to_local(t, sharding.placements(spec, mesh))


def _as_dtensor(y, mesh, spec):
    return collectives.from_local(y, mesh, sharding.placements(spec, mesh))


def _moe_small_t(params: MoE, x, cfg: MoEConfig, act: str, glu: bool, rules):
    """Decode-path MoE: tokens are tiny (B tokens of D), so replicating
    them and keeping expert weights sharded in place beats fsdp weight
    gathers by orders of magnitude.

    Expert placement follows the rules' "experts" mapping: over "model"
    (training rules; d_model fsdp slices finished with a sum over "data",
    valid because every data shard sees the SAME tokens here) or over
    ("model", "data") (serve rules; weights fully resident, zero
    per-layer weight traffic).  Returns the routed output, a DTensor
    replicated on the mesh."""
    mesh = rules.mesh
    sizes = rules.axis_sizes
    B, S, D = x.shape
    T = B * S
    e_axes = rules.resolve("experts", cfg.n_routed)
    e_axes = (e_axes,) if isinstance(e_axes, str) else tuple(e_axes or ())
    if not e_axes:
        e_axes = ("model",)
    n_shards = 1
    for a in e_axes:
        n_shards *= sizes[a]
    n_local = cfg.n_routed // n_shards
    C = max(int(math.ceil(T * cfg.top_k / cfg.n_routed
                          * cfg.capacity_factor)), cfg.top_k)
    d_axes = rules.resolve("fsdp", D)
    has_data = d_axes is not None and "data" not in e_axes

    e_spec = e_axes if len(e_axes) > 1 else e_axes[0]
    d_spec = "data" if has_data else None
    wspec, wdspec = P(e_spec, d_spec, None), P(e_spec, None, d_spec)
    wu = _local(params.w_up, mesh, wspec)
    wd = _local(params.w_down, mesh, wdspec)
    wg = _local(params.w_gate, mesh, wspec) if glu else None
    # Each expert shard does part of the work on the replicated tokens and
    # router: their gradients add up over the expert axes.
    e_group = collectives.mesh_group(mesh, e_axes)
    router_w = collectives.grad_psum(_local(params.router, mesh, P(None, None)),
                                  e_group)
    xt = collectives.grad_psum(_local(x, mesh, P(None, None, None))
                            .reshape(T, D), e_group)
    shard_idx = 0
    for a in e_axes:
        shard_idx = shard_idx * sizes[a] + mesh.get_local_rank(a)
    e_first = shard_idx * n_local
    gates, buf, dest, mine = _route_and_dispatch(xt, router_w, cfg, C,
                                                 e_first, n_local)
    if has_data:
        data_group = mesh.get_group("data")
        d_loc = wu.shape[1]
        d_lo = mesh.get_local_rank("data") * d_loc
        # Each data rank reads its own D columns of the buffer.
        buf_d = collectives.grad_psum(buf, data_group)[:, :, d_lo:d_lo + d_loc]
        up = torch.bmm(buf_d, wu)
        # The sum is read by each data rank's own D slice of the output:
        # its gradient is summed too.
        if glu:
            gate = torch.bmm(buf_d, wg)
            up = collectives.psum(up, data_group, grad="psum")
            gate = collectives.psum(gate, data_group, grad="psum")
            h = _act(act)(gate) * up
        else:
            h = _act(act)(collectives.psum(up, data_group, grad="psum"))
        out_part = torch.bmm(h, wd)                      # local D slice
        out = collectives.all_gather(out_part, data_group, dim=2)
    else:
        out = _expert_ffn_local(buf, wg, wu, wd, act, glu, None)
    y = _combine(out, dest, mine, gates)
    y = collectives.psum(y, e_group)
    return _as_dtensor(y.reshape(B, S, D), mesh, P(None, None, None))


def moe_apply(params: MoE, x: torch.Tensor, cfg: MoEConfig, act: str,
              glu: bool) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D): routed experts plus the shared experts.
    Without mesh rules every expert runs here at the default capacity of
    B * S tokens; under them, the expert-parallel paths (module
    docstring)."""
    B, S, D = x.shape
    x = sharding.gather_seq(x)        # one gather for routing and shared
    rules = sharding.mesh_rules()
    sizes = rules.axis_sizes if rules is not None else {}
    mesh_ok = "model" in sizes and cfg.n_routed % sizes["model"] == 0

    if mesh_ok and B * S <= SMALL_T_THRESHOLD:
        y = _moe_small_t(params, x, cfg, act, glu, rules)
        if cfg.n_shared:
            y = y + ffn_apply(params.shared, x, act, glu)
        return shard(y, "batch", None, None)

    batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
    n_batch = 1
    for a in batch_axes:
        n_batch *= sizes[a]
    if mesh_ok and B * S % n_batch == 0 and n_batch > 1:
        mesh = rules.mesh
        T_loc = B * S // n_batch
        C = max(int(math.ceil(T_loc * cfg.top_k / cfg.n_routed
                              * cfg.capacity_factor)), cfg.top_k)
        n_model = sizes["model"]
        n_local = cfg.n_routed // n_model
        d_shard = "data" if ("data" in sizes
                             and D % sizes["data"] == 0) else None
        wspec, wdspec = P("model", d_shard, None), P("model", None, d_shard)
        b_spec = batch_axes if len(batch_axes) > 1 else batch_axes[0]
        x_loc = _local(x, mesh, P(b_spec, None, None))
        model_group = mesh.get_group("model")
        # The tokens differ over the batch axes and each model rank runs
        # its own experts: the router's gradient adds up over the whole
        # mesh, the tokens' over "model", the expert weights' (replicated
        # over "pod") over "pod".
        router_w = collectives.grad_psum(
            _local(params.router, mesh, P(None, None)),
            collectives.mesh_group(mesh, tuple(sizes)))

        def weight(w, spec):
            w = _local(w, mesh, spec)
            return collectives.grad_psum(w, mesh.get_group("pod")) \
                if "pod" in sizes else w

        y = _moe_local(
            collectives.grad_psum(x_loc.reshape(-1, D), model_group), router_w,
            weight(params.w_gate, wspec) if glu else None,
            weight(params.w_up, wspec), weight(params.w_down, wdspec), cfg,
            act, glu, C, mesh.get_local_rank("model") * n_local, n_local,
            model_group, mesh.get_group("data") if d_shard else None)
        y = _as_dtensor(y.reshape(x_loc.shape), mesh, P(b_spec, None, None))
        y = shard(y, "batch", "act_seq", None)
    else:
        y = _moe_local(x.reshape(-1, D), params.router, params.w_gate,
                       params.w_up, params.w_down, cfg, act, glu,
                       _default_capacity(B * S, cfg)).reshape(B, S, D)
    if cfg.n_shared:
        y = y + ffn_apply(params.shared, x, act, glu)
    return y


def _default_capacity(T: int, cfg: MoEConfig) -> int:
    return max(int(math.ceil(T * cfg.top_k / cfg.n_routed
                             * cfg.capacity_factor)), cfg.top_k)


def load_balance_loss(router_w: torch.Tensor, x_flat: torch.Tensor,
                      cfg: MoEConfig) -> torch.Tensor:
    """Switch-style auxiliary loss: n_routed * sum(f * P), f the share of
    top-k choices and P the mean router probability of each expert."""
    probs = torch.softmax(x_flat.float() @ router_w, dim=-1)
    _, idx = torch.topk(probs, cfg.top_k, dim=-1)
    onehot = torch.nn.functional.one_hot(idx, cfg.n_routed).sum(-2).float()
    f = onehot.reshape(-1, cfg.n_routed).mean(dim=0)
    p = probs.reshape(-1, cfg.n_routed).mean(dim=0)
    return cfg.n_routed * torch.sum(f * p)
