"""Logical-axis sharding rules on ``DeviceMesh``/DTensor (the JAX package's
``distributed/sharding.py``).

Models annotate activations with *logical* axes (``shard(x, "batch", None,
"heads", None)``); parameters get partition specs from
:func:`param_pspecs`.  The mapping logical axis -> mesh axes lives in one
place (:class:`Rules`) and is installed with :func:`use_rules`, so swapping
a sharding strategy is a one-object change.

Divisibility is respected automatically: a logical axis only maps to a mesh
axis when the dimension divides the mesh-axis size (e.g. gemma-2b's 8 query
heads stay unsharded on a model=16 mesh).

A spec is the reference's per-dim structure (:class:`PartitionSpec`: for
each tensor dim ``None``, a mesh axis name, or a tuple of names, major
first).  ``Rules`` resolves it from the mesh's axis names and sizes alone,
so an :class:`AbstractMesh` (no process group) serves to compute the
tables.  Only when a ``DeviceMesh`` is attached does a spec become DTensor
placements (:func:`placements`): a dim sharded over several mesh axes in
mesh order is ``Shard`` on each; over axes against mesh order (the serve
rules' experts over ``("model", "data")`` on a ``("data", "model")`` mesh)
the earlier mesh dim is a ``_StridedShard``, so each rank holds the
reference's block (index ``model_idx * n_data + data_idx``).

Where the reference constrains a sharding with ``with_sharding_constraint``
and lets GSPMD insert the collectives, :func:`shard` redistributes the
DTensor (DTensor inserts them); a plain tensor passes through.  The
collectives the reference writes by hand (``shard_map`` bodies) are in
``collectives``.  The
models run their plain PyTorch code on DTensors under
``implicit_replication`` (a plain tensor they make, a mask or positions,
counts as replicated), which :func:`use_rules` turns on with the rules.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from .collectives import (from_local, grad_psum, local_parallel, mesh_group,
                          to_local)

MeshAxes = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """Per tensor dim: ``None``, a mesh axis name, or a tuple of names
    (major first); compares equal to the reference's ``PartitionSpec``
    element for element (``tuple(spec)``)."""

    def __new__(cls, *parts: MeshAxes):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes without devices or a process group (the
    reference's ``jax.sharding.AbstractMesh``): enough to resolve specs."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of an ``AbstractMesh`` or a named ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_device(mesh) -> torch.device:
    """The device this rank's shards of a ``DeviceMesh`` live on (its
    card, or the CPU)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _is_device_mesh(mesh) -> bool:
    return mesh is not None and not isinstance(mesh, AbstractMesh)


@dataclass(frozen=True)
class Rules:
    """Logical axis -> mesh axis (or tuple for combined axes)."""
    mapping: Dict[str, MeshAxes] = field(default_factory=dict)
    mesh: object = None              # DeviceMesh | AbstractMesh | None

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return mesh_axis_sizes(self.mesh)

    def resolve(self, logical: Optional[str],
                dim: Optional[int] = None) -> MeshAxes:
        if logical is None or self.mesh is None:
            return None
        axes = self.mapping.get(logical)
        if axes is None:
            return None
        if isinstance(axes, str):
            axes = (axes,)
        sizes = self.axis_sizes
        # Keep the largest prefix of mesh axes that divides the dim.
        if dim is not None:
            total = 1
            kept = []
            for a in axes:
                n = sizes[a]
                if dim % (total * n) == 0:
                    kept.append(a)
                    total *= n
                else:
                    break
            axes = tuple(kept)
        if not axes:
            return None
        return axes if len(axes) > 1 else axes[0]

    def spec(self, logical_axes: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None) -> PartitionSpec:
        """Resolve logical axes to a spec.  A mesh axis may appear on at
        most one dim; when two logical axes resolve to the same mesh axis
        (e.g. act_seq and vocab both -> model), the leftmost wins."""
        dims = shape if shape is not None else [None] * len(logical_axes)
        used = set()
        out = []
        for ax, d in zip(logical_axes, dims):
            r = self.resolve(ax, d)
            axes = (r,) if isinstance(r, str) else (r or ())
            kept = tuple(a for a in axes if a not in used)
            used.update(kept)
            out.append(kept if len(kept) > 1 else (kept[0] if kept else None))
        return P(*out)


def default_rules(mesh) -> Rules:
    """Baseline strategy: batch over (pod, data); fsdp param shard over
    data; tensor parallel (heads / mlp / experts / vocab) over model."""
    names = mesh_axis_sizes(mesh)
    axes = dict(
        batch=("pod", "data") if "pod" in names else ("data",),
        fsdp=("data",),
        heads=("model",),
        kv_heads=("model",),
        mlp=("model",),
        experts=("model",),
        vocab=("model",),
        seq=None,
        embed=None,
        act_seq=None,       # residual-stream S stays unsharded (baseline)
        kv_seq=None,        # decode caches replicated over model (baseline)
    )
    return Rules(mapping=axes, mesh=mesh)


def optimized_rules(mesh) -> Rules:
    """Baseline + sequence parallelism (residual stream S sharded over
    model, which turns the per-layer all-reduce into reduce-scatter +
    all-gather) + decode KV caches sharded over model along the sequence
    axis."""
    base = default_rules(mesh)
    mapping = dict(base.mapping)
    mapping.update(act_seq=("model",), kv_seq=("model",))
    return Rules(mapping=mapping, mesh=mesh)


def serve_rules(mesh) -> Rules:
    """Inference strategy: weights are *resident*, never fsdp-gathered —
    experts shard over (model x data), dense/attention weights over model
    only; decode caches shard their sequence axis over model."""
    base = default_rules(mesh)
    mapping = dict(base.mapping)
    mapping.update(fsdp=None, experts=("model", "data"),
                   act_seq=("model",), kv_seq=("model",))
    return Rules(mapping=mapping, mesh=mesh)


RULE_SETS = {"baseline": default_rules, "opt": optimized_rules,
             "serve": serve_rules}


# ------------------------------------------------------------ placements
def placements(spec: Sequence[MeshAxes], mesh) -> tuple:
    """DTensor placements (one per mesh dim) that lay a tensor out as
    ``spec`` does on ``mesh`` (a named ``DeviceMesh``).  A dim over
    several axes is split major-first, as the reference's spec is: a mesh
    dim whose axis comes after a later mesh dim's in the spec is a
    ``_StridedShard`` with the split already made by those axes."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    names = list(mesh.mesh_dim_names)
    sizes = mesh_axis_sizes(mesh)
    out: List = [Replicate()] * len(names)
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for j, a in enumerate(axes):
            i = names.index(a)
            split = 1
            for b in axes[:j]:                  # more major in the spec
                if names.index(b) > i:          # but later in the mesh
                    split *= sizes[b]
            out[i] = Shard(d) if split == 1 else _StridedShard(
                d, split_factor=split)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a ``DeviceMesh`` (the reference's ``NamedSharding``)."""
    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def mesh_rules() -> Optional[Rules]:
    """The installed rules when they are on a ``DeviceMesh``, else None."""
    rules = current_rules()
    return rules if rules is not None and _is_device_mesh(rules.mesh) \
        else None


def tp_row_matmul(h, w, out_shard_axes=("batch", "act_seq", None)):
    """Row-parallel TP matmul with an explicit reduce-scatter epilogue.

    h (B, S, F) with F sharded over "model"; w (F, D) with rows sharded
    over "model".  Computes the local partial product on the shards
    (``to_local``) and finishes with a reduce-scatter over the sequence on
    the "model" dim's process group — the Megatron-SP schedule, pinned as
    the reference's ``shard_map`` pins it.

    Falls back to a plain matmul when no suitable rules/mesh are active:
    no rules on a ``DeviceMesh``, no "model" axis, act_seq not mapped to
    ("model",) alone, S or F not divisible by the model size, or w's rows
    not F (the reference's conditions); and when h or w is a plain tensor.
    """
    rules = mesh_rules()
    if rules is None:
        return h @ w
    sizes = rules.axis_sizes
    if "model" not in sizes:
        return h @ w
    n_model = sizes["model"]
    B, S, F = h.shape
    D = w.shape[-1]
    seq_axes = rules.mapping.get("act_seq")
    if (seq_axes != ("model",) or S % n_model or F % n_model
            or w.shape[0] != F):
        return h @ w
    from torch.distributed.tensor import DTensor
    if not (isinstance(h, DTensor) and isinstance(w, DTensor)):
        return h @ w
    mesh = rules.mesh
    batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
    n_batch = 1
    for a in batch_axes:
        n_batch *= sizes[a]
    if B % n_batch:
        batch_axes, n_batch = (), 1
    b_spec = (batch_axes if len(batch_axes) > 1 else batch_axes[0]) \
        if batch_axes else None
    h_loc = to_local(h, placements(P(b_spec, None, "model"), mesh))
    w_loc = to_local(w, placements(P("model", None), mesh))
    if batch_axes:        # each batch shard adds its part of w's gradient
        w_loc = grad_psum(w_loc, mesh_group(mesh, batch_axes))
    out_pl = placements(P(b_spec, "model", None), mesh)
    from torch.distributed import _functional_collectives as funcol
    partial = h_loc @ w_loc                              # (B_loc, S, D)
    # The autograd reduce-scatter (its backward all-gathers); newer
    # releases name it ``reduce_scatter_single_autograd``.
    rs = getattr(funcol, "reduce_scatter_single_autograd",
                 funcol.reduce_scatter_tensor_autograd)
    out = rs(partial, "sum", scatter_dim=1, group=mesh.get_group("model"))
    out = funcol.wait_tensor(out)                         # (B_loc, S/n, D)
    return from_local(out, mesh, out_pl)


def gather_seq(x):
    """x (B, S, D) from the residual stream's layout ("batch", "act_seq",
    None) to ("batch", None, None), the layout the column-parallel
    products that read it take (q/k/v, MLA's down projections, the MLP's
    gate and up, the MoE, Mamba2's input projections, the logits).

    Under sequence parallelism (act_seq over mesh axes that divide S) this
    is the Megatron-SP entry that GSPMD inserts for the reference: an
    all-gather of the sequence over those axes, whose backward
    reduce-scatters the gradient, which the column-parallel products
    return partial over "model" (DTensor's redistribute does both).
    Without it DTensor's ``mm`` meets the (B·S) dim flattened from a
    batch and a sequence split on different mesh dims, a
    ``_StridedShard`` that its strategy cannot take on a row or
    contraction dim.  The identity when act_seq does not shard S (the
    baseline rules, a one-token decode), on a plain tensor, and with no
    rules on a ``DeviceMesh``."""
    rules = mesh_rules()
    if rules is None or rules.resolve("act_seq", x.shape[1]) is None:
        return x
    return shard(x, "batch", None, None)


def seq_matmul(x, w):
    """``x @ w`` for x (B, S, D) in the residual stream's layout and a
    weight w (D, N) whose output keeps x's layout: the logits, which the
    reference constrains to ("batch", "act_seq", "vocab").  Under
    sequence parallelism "model" then lands on the sequence, not the
    vocabulary, so each rank multiplies its slice of the sequence by the
    whole weight (gathered; its gradient summed over the ranks that split
    the tokens), which moves V·D numbers where gathering x and moving
    the (B, S, V) logits onto the sequence would move B·S·V.  Otherwise
    (act_seq not sharding S, a plain tensor, no rules) ``x @ w``."""
    rules = mesh_rules()
    if rules is None or rules.resolve("act_seq", x.shape[1]) is None:
        return x @ w
    return local_parallel(torch.matmul, (x, w), ((0, 1), (None, None)),
                          (0, 1))


_state = threading.local()


def current_rules() -> Optional[Rules]:
    return getattr(_state, "rules", None)


@contextmanager
def use_rules(rules: Optional[Rules]) -> Iterator[Optional[Rules]]:
    """Install ``rules`` for the block (and, on a ``DeviceMesh``, DTensor's
    implicit replication: plain tensors that the models make count as
    replicated).  Both are restored to what they were, so a block nested
    in another, as remat's recompute inside the backward, leaves its
    caller's on: the replication flag is process-wide in some torch
    releases, and ``implicit_replication()`` turns it off on exit."""
    prev = current_rules()
    _state.rules = rules
    replicate = rules is not None and _is_device_mesh(rules.mesh)
    if replicate:
        from torch.distributed.tensor import DTensor
        dispatcher = DTensor._op_dispatcher
        was = dispatcher._allow_implicit_replication
        dispatcher._allow_implicit_replication = True
    try:
        yield rules
    finally:
        _state.rules = prev
        if replicate:
            dispatcher._allow_implicit_replication = was


def shard(x, *logical_axes):
    """Constrain an activation's sharding by logical axes: a DTensor is
    redistributed to the rules' layout; no-op when no rules on a
    ``DeviceMesh`` are installed or ``x`` is a plain tensor."""
    rules = mesh_rules()
    if rules is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    target = placements(rules.spec(logical_axes, x.shape), rules.mesh)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(rules.mesh, target)


def split_heads(x, n_heads: int, head_dim: int, axis: str,
                seq_axis: Optional[str] = None):
    """x (B, S, n_heads * head_dim) -> (B, S, n_heads, head_dim),
    constrained to ("batch", ``seq_axis``, ``axis``, None).  Where
    ``axis`` cannot shard the heads (it does not divide them) but sharded
    the flat dim, the flat dim is gathered first: a DTensor cannot view a
    dim that is split inside a head."""
    rules = mesh_rules()
    if rules is not None and rules.resolve(axis, n_heads) is None:
        x = shard(x, "batch", seq_axis, None)
    B, S = x.shape[:2]
    return shard(x.reshape(B, S, n_heads, head_dim), "batch", seq_axis,
                 axis, None)


def named_sharding(logical_axes: Sequence[Optional[str]],
                   shape: Optional[Sequence[int]] = None
                   ) -> Optional[NamedSharding]:
    rules = mesh_rules()
    if rules is None:
        return None
    return NamedSharding(rules.mesh, rules.spec(logical_axes, shape))


# ---------------------------------------------------------------- params
# Parameter logical axes are declared per path fragment of the reference's
# tree; ``param_pspecs`` maps each parameter of an ``LM`` to its path.
PARAM_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    # name fragment -> logical axes per dim (excluding a stacked L prefix)
    "embed/table": ("vocab", "fsdp"),
    "lm_head/w": ("fsdp", "vocab"),
    "attn/wq": ("fsdp", "heads"),
    "attn/wk": ("fsdp", "kv_heads"),
    "attn/wv": ("fsdp", "kv_heads"),
    "attn/wo": ("heads", "fsdp"),
    "mla/w_dq": ("fsdp", None),
    "mla/w_uq": (None, "heads"),
    "mla/w_dkv": ("fsdp", None),
    "mla/w_uk": (None, "heads"),
    "mla/w_uv": (None, "heads"),
    "mla/wo": ("heads", "fsdp"),
    "mlp/w_gate": ("fsdp", "mlp"),
    "mlp/w_up": ("fsdp", "mlp"),
    "mlp/w_down": ("mlp", "fsdp"),
    "moe/router": ("fsdp", None),
    "moe/w_gate": ("experts", "fsdp", None),
    "moe/w_up": ("experts", "fsdp", None),
    "moe/w_down": ("experts", None, "fsdp"),
    "shared/w_gate": ("fsdp", "mlp"),
    "shared/w_up": ("fsdp", "mlp"),
    "shared/w_down": ("mlp", "fsdp"),
    "ssm/w_x": ("fsdp", "heads"),
    "ssm/w_z": ("fsdp", "heads"),
    "ssm/w_B": ("fsdp", None),
    "ssm/w_C": ("fsdp", None),
    "ssm/w_dt": ("fsdp", None),
    "ssm/conv": (None, "heads"),
    "ssm/out_proj": ("heads", "fsdp"),
    "ssm/A_log": (None,),
    "ssm/D": (None,),
    "ssm/dt_bias": (None,),
    "norm/scale": (None,),
    "scale": (None,),
}


def _match_axes(path: str, ndim: int) -> Tuple[Optional[str], ...]:
    best = None
    for frag, axes in PARAM_AXES.items():
        if path.endswith(frag) or f"/{frag}" in path or frag in path:
            if best is None or len(frag) > len(best[0]):
                best = (frag, axes)
    if best is None:
        return (None,) * ndim
    axes = best[1]
    if len(axes) < ndim:                       # stacked layer prefix dims
        axes = (None,) * (ndim - len(axes)) + tuple(axes)
    return axes[:ndim]


def param_pspecs(params: nn.Module, rules: Rules, prefix: str = ""
                 ) -> Dict[str, PartitionSpec]:
    """Parameter name -> spec under ``rules``, for the parameters of an
    ``LM`` (real, meta or fake tensors), each matched by its leaf's path
    in the reference's tree (``stack.3.attn.wq`` -> ``stack/attn/wq``: a
    parameter that the reference stacks by layer has its per-layer spec,
    the reference's without the leading None).  ``prefix`` places a
    module of the model alone (``"stack/moe/"`` for one layer's MoE)."""
    from ..convert import lm_tree_groups
    shapes = {n: p.shape for n, p in params.named_parameters()}
    specs = {}
    for path, names in lm_tree_groups(params).items():
        for n in names:
            axes = _match_axes(prefix + path.replace(".", "/"),
                               len(shapes[n]))
            specs[n] = rules.spec(axes, tuple(shapes[n]))
    return specs


def param_shardings(params: nn.Module, rules: Rules
                    ) -> Dict[str, NamedSharding]:
    return {n: NamedSharding(rules.mesh, s)
            for n, s in param_pspecs(params, rules).items()}


def distribute_params(params: nn.Module, rules: Rules,
                      specs: Mapping[str, PartitionSpec]) -> nn.Module:
    """Replace each parameter of ``params`` by a DTensor laid out by its
    spec (``param_pspecs``) on ``rules.mesh``, in place: the reference's
    ``device_put`` of the tree onto ``param_shardings``.  Every rank
    passes the same full tensors; each keeps its shard.  Returns
    ``params``."""
    from torch.distributed.tensor import distribute_tensor
    mesh = rules.mesh
    for name, p in list(params.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = params.get_submodule(mod_name) if mod_name else params
        dt = distribute_tensor(p.detach(), mesh,
                               placements(specs[name], mesh))
        setattr(mod, leaf, nn.Parameter(dt, requires_grad=p.requires_grad))
    return params


def _map_tree(fn, tree, specs):
    """``fn(leaf, spec)`` over a nested dict/list of leaves and the
    matching tree of specs (a ``PartitionSpec`` is a leaf, not a list)."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree,
                                                          PartitionSpec):
        return type(tree)(_map_tree(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def named_shardings(specs, mesh):
    """A tree of specs as the matching tree of ``NamedSharding`` on
    ``mesh`` (what ``checkpoint.restore_pytree`` takes)."""
    return _map_tree(lambda spec, _: NamedSharding(mesh, spec), specs, specs)


def zeros_tree(tree, specs, mesh):
    """DTensor zeros of each leaf's shape and dtype (its device is not
    read: meta tensors serve), laid out by the matching tree of specs on
    ``mesh``.  Each rank makes its own shard; no rank holds a whole
    leaf."""
    from torch.distributed.tensor import zeros
    return _map_tree(lambda t, spec: zeros(
        tuple(t.shape), dtype=t.dtype, device_mesh=mesh,
        placements=placements(spec, mesh)), tree, specs)


def distribute_tree(tree, specs, mesh):
    """A nested dict (or list) of tensors as DTensors laid out by the
    matching tree of specs on ``mesh`` (every rank passes the same full
    tensors; each keeps its shard)."""
    from torch.distributed.tensor import distribute_tensor
    return _map_tree(lambda t, spec: distribute_tensor(
        t, mesh, placements(spec, mesh)), tree, specs)
