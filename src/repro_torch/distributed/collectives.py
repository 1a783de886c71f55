"""Collectives and vocab- and head-parallel ops on a ``DeviceMesh``: what
the JAX package writes inside its ``shard_map`` bodies (``psum``,
``all_gather``) and what GSPMD does for its gathers and attention, as
``torch.distributed`` functional collectives on local shards with
explicit gradients.

* ``psum``, ``grad_psum``, ``all_gather`` over a mesh dim's group
  (``mesh_group``), each saying how its gradient flows (a sum read alike
  on every rank has the identity as its backward; one read in parts sums
  its gradient too);
* ``embed_rows`` and ``take_last``: an embedding lookup and the
  cross-entropy's label gather over a vocabulary sharded across a mesh
  dim, each rank taking the rows it holds and the ranks summing them
  (DTensor's own strategies for these fail on this layout in the torch
  releases at hand);
* ``local_parallel`` (``local_heads``): a computation that is parallel
  over the batch and the heads, the attention cores and the chunked SSD,
  on each rank's shards with no collective;
* ``write_pos`` and ``attend_upto``: a decode step's token into its
  cache, and the attention over the cached positions, where the ranks
  may split those positions.
"""
from __future__ import annotations

from typing import Sequence

import torch

def mesh_group(mesh, axes: Sequence[str]):
    """The process group over the named mesh ``axes`` (one axis: its
    group; several: their flattened sub-mesh's, made outside any fake
    tensor mode, since the mesh's rank tensor must be real)."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    ordered = tuple(a for a in mesh.mesh_dim_names if a in axes)
    with unset_fake_temporarily():
        return mesh[ordered]._flatten().get_group()


class _AllReduce(torch.autograd.Function):
    """A sum over ``group`` in the forward, the backward, or both: the
    forward sum of partial results read by a replicated computation has
    the identity as its backward; the entry of a computation whose ranks
    each take part of the work sums the gradient in the backward."""

    @staticmethod
    def forward(ctx, t, group, fwd: bool, bwd: bool):
        from torch.distributed import _functional_collectives as funcol
        ctx.group, ctx.bwd = group, bwd
        return funcol.wait_tensor(funcol.all_reduce(t, "sum", group)) \
            if fwd else t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed import _functional_collectives as funcol
        if ctx.bwd:
            g = funcol.wait_tensor(funcol.all_reduce(g.contiguous(), "sum",
                                                     ctx.group))
        return g, None, None, None


def psum(t: torch.Tensor, group, *, grad: str = "identity") -> torch.Tensor:
    """Sum a local tensor over ``group`` (``jax.lax.psum``).  ``grad``:
    ``"identity"`` when what reads the sum is the same on every rank of
    the group, ``"psum"`` when each rank reads a different part of it."""
    return _AllReduce.apply(t, group, True, grad == "psum")


def grad_psum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` unchanged; its gradient summed over ``group`` (where each
    rank of the group uses the replicated ``t`` for part of the work)."""
    return _AllReduce.apply(t, group, False, True)


class _AllGather(torch.autograd.Function):
    """Tiled all-gather along ``dim``; the backward keeps the rank's own
    slice of the gradient (the gathered tensor is read alike on every
    rank) or reduce-scatters it (each rank reads it differently)."""

    @staticmethod
    def forward(ctx, t, group, dim: int, reduce: bool):
        import torch.distributed as dist
        from torch.distributed import _functional_collectives as funcol
        ctx.group, ctx.dim, ctx.reduce = group, dim, reduce
        ctx.n, ctx.rank = dist.get_world_size(group), dist.get_rank(group)
        return funcol.wait_tensor(funcol.all_gather_tensor(
            t.contiguous(), gather_dim=dim, group=group))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed import _functional_collectives as funcol
        if ctx.reduce:
            g = funcol.wait_tensor(funcol.reduce_scatter_tensor(
                g.contiguous(), "sum", scatter_dim=ctx.dim, group=ctx.group))
        else:
            g = g.chunk(ctx.n, dim=ctx.dim)[ctx.rank]
        return g, None, None, None


def all_gather(t: torch.Tensor, group, dim: int, *,
               grad: str = "slice") -> torch.Tensor:
    """Tiled all-gather of a local tensor along ``dim`` over ``group``
    (``jax.lax.all_gather(..., tiled=True)``); ``grad`` ``"slice"`` or
    ``"reduce_scatter"`` (see ``_AllGather``)."""
    return _AllGather.apply(t, group, dim, grad == "reduce_scatter")


def _shard_offset(x, dim: int, mesh_dims) -> int:
    """Where this rank's shard of DTensor ``x`` starts along ``dim``,
    which ``Shard`` splits evenly over ``mesh_dims`` (in mesh order)."""
    mesh = x.device_mesh
    idx, n = 0, 1
    for i in mesh_dims:
        idx = idx * mesh.shape[i] + mesh.get_local_rank(i)
        n *= mesh.shape[i]
    return idx * (x.shape[dim] // n)


def embed_rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``: the rows of an embedding table.  On a DTensor
    table whose rows (the vocabulary) are sharded over a mesh dim, each
    rank looks up the rows it holds (0 elsewhere) and the ranks of that
    dim sum them, the vocab-parallel embedding; the tokens keep their
    batch sharding and the result (tokens' dims, D) is laid out alike.
    DTensor's own indexing does not train on this layout in every
    release (its backward's ``index_put`` fails to propagate)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(table, DTensor):
        return table[tokens]
    mesh = table.device_mesh
    vocab = [i for i, p in enumerate(table.placements)
             if isinstance(p, Shard) and p.dim == 0]
    table = shard_placed(table, [Shard(0) if i in vocab else Replicate()
                                 for i in range(mesh.ndim)])
    tokens = replicated_on(tokens, table)
    out_pl = tuple(Shard(0) if isinstance(p, Shard) and p.dim == 0
                   and i not in vocab else Replicate()
                   for i, p in enumerate(tokens.placements))
    tok = to_local(tokens, out_pl)
    # The table is read alike on the ranks of the tokens' sharded dims, each
    # for its own tokens: its gradient sums over them.
    split = [mesh.mesh_dim_names[i] for i, p in enumerate(out_pl)
             if isinstance(p, Shard)]
    t_loc = table.to_local()
    if split:
        t_loc = grad_psum(t_loc, mesh_group(mesh, split))
    if vocab:
        lo, n = _shard_offset(table, 0, vocab), t_loc.shape[0]
        mine = (tok >= lo) & (tok < lo + n)
        rows = torch.nn.functional.embedding(
            (tok - lo).clamp(0, max(n - 1, 0)), t_loc)
        rows = rows * mine[..., None].to(rows.dtype)
        rows = psum(rows, mesh_group(mesh, [mesh.mesh_dim_names[i]
                                            for i in vocab]))
    else:
        rows = torch.nn.functional.embedding(tok, t_loc)
    return from_local(rows, mesh, out_pl)


def take_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``torch.gather(x, -1, idx[..., None])[..., 0]``: the entry of x's
    last dim (the vocabulary) that ``idx`` names.  On a DTensor each rank
    gathers from its own shard, the indices laid out as x's other dims;
    where the last dim is sharded over one mesh dim, a rank gathers the
    entries it holds (0 elsewhere) and the ranks of that dim sum them,
    the vocab-parallel gather.  (DTensor's own strategy fails on the
    vocab-parallel layout, and its backward on the sequence-parallel one
    builds a zero tensor of x's global shape on every rank.)"""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    last = x.dim() - 1
    if not isinstance(x, DTensor):
        return torch.gather(x, -1, idx[..., None])[..., 0]
    vocab = [i for i, p in enumerate(x.placements)
             if isinstance(p, Shard) and p.dim == last]
    if len(vocab) > 1 or any(type(p) not in (Shard, Replicate)
                             for p in x.placements):
        return torch.gather(shard_placed(x, [
            Replicate() if i in vocab else p
            for i, p in enumerate(x.placements)]), -1, idx[..., None])[..., 0]
    mesh = x.device_mesh
    out_pl = tuple(Replicate() if i in vocab else p
                   for i, p in enumerate(x.placements))
    idx = replicated_on(idx, x)
    idx_loc = to_local(idx, out_pl)
    x_loc = x.to_local()
    if not vocab:
        return from_local(torch.gather(x_loc, -1, idx_loc[..., None])[..., 0],
                          mesh, out_pl)
    lo, n = _shard_offset(x, last, vocab), x_loc.shape[-1]
    mine = (idx_loc >= lo) & (idx_loc < lo + n)
    local = torch.gather(x_loc, -1, (idx_loc - lo).clamp(0, max(n - 1, 0))
                         [..., None])[..., 0]
    local = torch.where(mine, local, torch.zeros_like(local))
    total = psum(local, mesh.get_group(vocab[0]))
    return from_local(total, mesh, out_pl)


def last_row(x: torch.Tensor) -> torch.Tensor:
    """``x[:, -1]``, the last position of x (B, S, ...).  On a DTensor
    whose dim 1 is sharded over mesh dims (the prefill's logits under
    sequence parallelism) the rank that holds the last position takes it,
    the others 0, and the ranks of those dims sum it, where DTensor's
    select would gather the whole of x first."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    seq = [] if not isinstance(x, DTensor) else [
        i for i, p in enumerate(x.placements)
        if type(p) is Shard and p.dim == 1]
    if not seq:
        return x[:, -1]
    mesh = x.device_mesh
    out_pl = tuple(Replicate() if i in seq else
                   (Shard(p.dim - 1) if type(p) is Shard and p.dim > 1 else p)
                   for i, p in enumerate(x.placements))
    x_loc = x.to_local()
    mine = _shard_offset(x, 1, seq) + x_loc.shape[1] == x.shape[1]
    row = x_loc[:, -1] if mine else torch.zeros_like(x_loc[:, -1])
    names = [mesh.mesh_dim_names[i] for i in seq]
    return from_local(psum(row, mesh_group(mesh, names)), mesh, out_pl)


def mean_last(x: torch.Tensor) -> torch.Tensor:
    """``x.mean(-1, keepdim=True)``.  On a DTensor whose last dim is split
    over mesh dims (Mamba2's gated norm over its head-sharded inner
    width), each rank sums its slice and the ranks of those dims add the
    sums, the mean replicated on them.  DTensor's own reduction leaves a
    partial sum, and in the backward its propagation answers that by
    moving the split onto the sequence, which the input projections'
    weight gradients then meet flattened with the batch (a
    ``_StridedShard`` on their contraction dim)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    last = x.dim() - 1
    split = [] if not isinstance(x, DTensor) else [
        i for i, p in enumerate(x.placements)
        if type(p) is Shard and p.dim == last]
    if not split:
        return x.mean(dim=-1, keepdim=True)
    mesh = x.device_mesh
    out_pl = tuple(Replicate() if i in split else p
                   for i, p in enumerate(x.placements))
    total = psum(x.to_local().sum(dim=-1, keepdim=True),
                 mesh_group(mesh, [mesh.mesh_dim_names[i] for i in split]))
    return from_local(total / x.shape[-1], mesh, out_pl)


def local_parallel(fn, args, dims, out_dims, split=None, **kw):
    """``fn(*args, **kw)`` on each rank's shards, for a computation that
    is parallel over a few of its operands' dims (the batch, the heads):
    ``dims[i]`` names, for each such role, the dim of ``args[i]`` that
    carries it (None where the operand lacks the role), ``out_dims`` the
    same for each output.  A mesh dim that shards the first operand along
    one of its roles keeps doing so for every operand that has the role;
    every other mesh dim is replicated first.  So ``fn`` runs on plain
    local tensors and needs no collective; plain operands pass through,
    and with no DTensor operand this is ``fn(*args, **kw)``.

    ``split`` names, for each operand, the dim that ``fn`` reduces over
    (a decode core's cache positions, which the serve rules shard:
    ``kv_seq``), or None.  Mesh dims of more than one rank that shard the
    first such operand along that dim keep it sharded for every operand
    that has it; ``fn`` then gets ``seq_lo``, where the rank's part
    starts, and ``seq_group``, those dims' group (None when there are
    none), to finish its reduction across them (``attend_upto``), and its outputs are whole there."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    lead = args[0]
    if split is not None:
        kw.update(seq_lo=0, seq_group=None)
    if not isinstance(lead, DTensor):
        return fn(*args, **kw)
    mesh = lead.device_mesh
    roles = []                      # per mesh dim: the role it shards
    for p in lead.placements:
        hit = [r for r, d in enumerate(dims[0])
               if d is not None and type(p) is Shard and p.dim == d]
        roles.append(hit[0] if hit else None)
    if split is not None:           # one more role, the reduced dim
        k = next(i for i, d in enumerate(split) if d is not None)
        held = args[k].placements if isinstance(args[k], DTensor) else ()
        seq = [i for i, p in enumerate(held) if type(p) is Shard
               and p.dim == split[k] and mesh.size(i) > 1]
        for i in seq:
            roles[i] = len(dims[0])
        dims = [tuple(ds) + (s,) for ds, s in zip(dims, split)]
        if seq:
            kw.update(seq_lo=_shard_offset(args[k], split[k], seq),
                      seq_group=mesh_group(mesh, [mesh.mesh_dim_names[i]
                                                  for i in seq]))

    def layout(ds):
        return [Shard(ds[r]) if r is not None and r < len(ds)
                and ds[r] is not None else Replicate() for r in roles]

    shards = []
    for a, ds in zip(args, dims):
        if isinstance(a, DTensor):
            a = to_local(a, layout(ds))
            # An operand that lacks a role which a mesh dim shards is read
            # alike on that dim's ranks, each for its own part of the work:
            # its gradient sums over them.
            split = [mesh.mesh_dim_names[i] for i, r in enumerate(roles)
                     if r is not None and ds[r] is None]
            if split:
                a = grad_psum(a, mesh_group(mesh, split))
        shards.append(a)
    out = fn(*shards, **kw)
    if isinstance(out, tuple):
        return tuple(from_local(o, mesh, layout(ds))
                     for o, ds in zip(out, out_dims))
    return from_local(out, mesh, layout(out_dims))


def attend_upto(s: torch.Tensor, values: torch.Tensor, eq: str, pos: int,
                seq_lo: int = 0, seq_group=None) -> torch.Tensor:
    """The end of a decode core: float32 scores ``s`` over cached
    positions (their last dim) masked after ``pos``, their softmax, and
    the weighted sum ``torch.einsum(eq, w, values)``.  The positions here
    start at ``seq_lo``; where the ranks of ``seq_group`` hold the others
    (the serve rules' ``kv_seq``, a split-K), the softmax's max and sum
    and the weighted sum are reduced over them, and a masked position
    weighs 0 whichever rank holds it."""
    tpos = torch.arange(seq_lo, seq_lo + s.shape[-1], device=s.device)
    s = torch.where(tpos <= pos, s, -1e30)
    if seq_group is None:
        w = torch.softmax(s, dim=-1)
    else:
        from torch.distributed import _functional_collectives as funcol
        m = funcol.wait_tensor(funcol.all_reduce(
            s.amax(dim=-1, keepdim=True), "max", seq_group))
        p = torch.exp(s - m)
        w = p / psum(p.sum(dim=-1, keepdim=True), seq_group)
    out = torch.einsum(eq, w.to(values.dtype), values)
    return out if seq_group is None else psum(out, seq_group)


def write_pos(cache: torch.Tensor, pos: int, value: torch.Tensor
              ) -> torch.Tensor:
    """``cache[:, pos] = value`` in place: a decode step's token into its
    cache (B, T, ...).  On a DTensor cache each rank writes its own shard:
    ``value`` is laid out as the cache is without its dim 1, and where
    mesh dims shard the positions (the serve rules' ``kv_seq``) only the
    ranks whose part holds ``pos`` write.  (DTensor's own indexing of a
    sharded dim would write into a gathered copy.)"""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(cache, DTensor):
        cache[:, pos] = value.to(cache.dtype)
        return cache
    seq = [i for i, p in enumerate(cache.placements)
           if type(p) is Shard and p.dim == 1]
    # The value's dims are the cache's without dim 1.
    target = [Shard(p.dim - (p.dim > 1)) if type(p) is Shard and p.dim != 1
              else Replicate() for p in cache.placements]
    value = replicated_on(value, cache)
    row = to_local(value, target)      # on every rank: it may gather
    local = cache.to_local()
    lo = _shard_offset(cache, 1, seq) if seq else 0
    if lo <= pos < lo + local.shape[1]:
        local[:, pos - lo] = row.to(cache.dtype)
    return cache


def local_heads(fn, q, k, v, **kw):
    """``fn(q, k, v, **kw)``, an attention core, on each rank's shards:
    attention is parallel over the batch (dim 0) and the KV heads (dim 2
    of q (B, S, KV, G, dh) and of k and v (B, T, KV, dh)), and so is its
    output, laid out as q (``local_parallel``)."""
    return local_parallel(fn, (q, k, v), ((0, 2),) * 3, (0, 2), **kw)


def to_local(t, placements=None) -> torch.Tensor:
    """A DTensor's local shard, laid out as ``placements`` first when
    given; a plain tensor passes as it is (it counts as replicated)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return t
    return (t if placements is None else shard_placed(t, placements)
            ).to_local()


def from_local(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """The DTensor whose local shards are ``t``, laid out as
    ``placements`` on ``mesh`` (not checked across ranks)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, mesh, tuple(placements), run_check=False)


def replicated_on(t: torch.Tensor, like) -> torch.Tensor:
    """``t``, a plain tensor whole on every rank, as a DTensor replicated
    on the mesh of ``like`` where ``like`` is a DTensor; otherwise (or
    when ``t`` is a DTensor already) ``t`` as it is.  An op that mixes the
    two then needs no implicit replication, which is per thread in some
    torch releases and so off in a backward that runs in autograd's
    device thread."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor) or not isinstance(like, DTensor):
        return t
    return from_local(t, like.device_mesh,
                      [Replicate()] * like.device_mesh.ndim)


def shard_placed(x, target) -> torch.Tensor:
    """A DTensor redistributed to ``target`` placements (itself when it
    has them)."""
    target = tuple(target)
    return x if tuple(x.placements) == target else \
        x.redistribute(x.device_mesh, target)
