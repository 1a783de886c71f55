"""Carry weights between the JAX package and this one: the DFP network's
(below), the comparison policies' (``load_policy_params``) and the LM
zoo's (``lm_params_from_jax``).

The JAX package keeps the weights as a tree of nested dicts and lists,
``{"state" | "measurement" | "goal" | "expectation" | "action":
{"layers": [{"w": (in, out), "b": (out,)}, ...]}}``; this package keeps
the same arrays, same layout, as ``DFPNetwork`` parameters named by their
path in that tree (``state.layers.0.w``).  So conversion is a copy.

The ``.npz`` checkpoint format is the JAX ``MRSchAgent.save`` one: leaves
``p0 .. p{n-1}`` in ``jax.tree_util`` flatten order (dict keys sorted at
every level, lists in order), plus ``n`` and ``epsilon``.

The LM zoo's reference tree stacks the parameters of homogeneous layers
along a leading L dim (``stack.<name>``, and the MoE family's
``prefix.<name>``, of shape (L, ...)); an ``LM`` keeps one module per
layer (``stack.<i>.<name>``).  ``lm_tree_groups`` maps one layout onto
the other, ``lm_params_to_tree`` and ``load_lm_tree`` carry the weights
across it both ways, and the LM optimizer's state and training
checkpoints live in the reference's layout.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping

import numpy as np
import torch
from torch import nn


def _tree_key(name: str) -> tuple:
    # Dict keys sort as strings, list positions as integers.
    return tuple(int(p) if p.isdigit() else p for p in name.split("."))


def leaves(net: nn.Module) -> List[tuple]:
    """(name, parameter) pairs in ``jax.tree_util`` flatten order."""
    return sorted(net.named_parameters(), key=lambda kv: _tree_key(kv[0]))


def _flatten(tree, prefix: str, out: Dict[str, Any],
             leaf: Callable = np.asarray) -> None:
    """Dotted paths (``stack.attn.wq``, ``shared_blocks.0.attn.wq``) of a
    tree of nested dicts and lists -> ``leaf(x)`` into ``out``."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out, leaf)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}.", out, leaf)
    else:
        out[prefix[:-1]] = leaf(tree)


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """The JAX parameter tree (nested dicts/lists of arrays) as a state
    dict for ``DFPNetwork.load_state_dict``."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    return {k: torch.from_numpy(np.array(v)) for k, v in flat.items()}


def load_policy_params(policy, tree) -> None:
    """Copy a JAX policy's parameter tree into the port's counterpart, in
    place, on the device its network lives on: ScalarRL's and CoSchedRL's
    ``{"layers": [...]}``, DRAS's ``{"select": ..., "gate": ...}``, or the
    MRSch agent's DFP tree (any state module).  Raises unless every leaf
    matches by path and shape.  A policy that keeps Adam moments (ScalarRL,
    the agent) starts them afresh, as the JAX policy's start."""
    from .nn.optim import adam_init
    net = policy.init_state()
    net.load_state_dict(params_from_jax(tree), strict=True)
    if hasattr(policy, "opt_state"):
        policy.opt_state = adam_init([p for _, p in leaves(net)])


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A numpy leaf as a tensor; bfloat16 (an ml_dtypes type numpy cannot
    hand to torch) goes through float32, which holds it exactly."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


# Top-level keys whose leaves the reference stacks along a leading L dim.
_STACKED = ("stack", "prefix")


def _unstacked(flat: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's dotted leaf names -> the LM's parameter names: a
    stacked leaf ``stack.<name>`` (L, ...) becomes ``stack.<i>.<name>``,
    its i-th slice, for i < L; other leaves keep their names."""
    out: Dict[str, Any] = {}
    for name, a in flat.items():
        head, _, rest = name.partition(".")
        if head in _STACKED:
            for i in range(a.shape[0]):
                out[f"{head}.{i}.{rest}"] = a[i]
        else:
            out[name] = a
    return out


def lm_tree_groups(lm: nn.Module) -> Dict[str, List[str]]:
    """The reference tree's leaf paths (dotted) -> the names of the LM's
    parameters that make each leaf: the L layers' in order for a stacked
    leaf (``stack.attn.wq`` -> ``stack.0.attn.wq``, ``stack.1.attn.wq``,
    ...), the parameter of the same name for any other."""
    groups: Dict[str, List[str]] = {}
    for name, _ in lm.named_parameters():
        head, _, rest = name.partition(".")
        if head in _STACKED:
            _, _, leaf = rest.partition(".")
            groups.setdefault(f"{head}.{leaf}", []).append(name)
        else:
            groups[name] = [name]
    return groups


def is_stacked(path: str) -> bool:
    """Whether the reference stacks the leaf at ``path`` (dotted) by layer."""
    return path.partition(".")[0] in _STACKED


def nest(flat: Mapping[str, Any]) -> dict:
    """Dotted paths -> a tree of nested dicts, a level whose keys are all
    positions (``shared_blocks.0``) a list, as the reference keeps it."""
    tree: dict = {}
    for path, x in flat.items():
        *parents, last = path.split(".")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = x

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[k]) for k in sorted(node, key=int)]
        return {k: lists(v) for k, v in node.items()}
    return lists(tree)


def lm_params_to_tree(lm: nn.Module) -> dict:
    """An ``LM``'s weights as the reference's parameter tree
    (``transformer.init_params``): stacked leaves are new (L, ...) tensors,
    the others the parameters themselves, detached, on the LM's device."""
    params = dict(lm.named_parameters())
    flat = {}
    for path, names in lm_tree_groups(lm).items():
        ts = [params[n].detach() for n in names]
        flat[path] = torch.stack(ts) if is_stacked(path) else ts[0]
    return nest(flat)


def load_lm_tree(lm: nn.Module, tree) -> None:
    """Copy the reference's parameter tree (tensors, in the layout
    ``lm_params_to_tree`` gives) into ``lm`` in place, each leaf cast to
    its parameter's dtype.  Raises unless every leaf matches a parameter
    by path and shape."""
    flat: Dict[str, torch.Tensor] = {}
    _flatten(tree, "", flat, leaf=lambda t: t)
    state = _unstacked(flat)
    params = dict(lm.named_parameters())
    if set(state) != set(params):
        raise KeyError(f"load_lm_tree: the tree lacks "
                       f"{sorted(set(params) - set(state))[:3]} and has "
                       f"unknown {sorted(set(state) - set(params))[:3]}")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(state[name].shape) != tuple(p.shape):
                raise ValueError(f"load_lm_tree: {name} has shape "
                                 f"{tuple(state[name].shape)}, the model "
                                 f"{tuple(p.shape)}")
            p.copy_(state[name])


def lm_params_from_jax(tree, cfg, *, device=None):
    """The JAX package's LM parameter tree (``models.transformer.
    init_params``) for ``cfg`` as this package's ``models.LM``, same dtype,
    on ``device`` (``None`` means the card, as ``init_params`` resolves it).
    The reference stacks the layers along a leading L dim; here leaf
    ``stack.<name>`` (and the MoE family's ``prefix.<name>``) of shape
    (L, ...) becomes ``stack.<i>.<name>`` for i < L.  ``shared_blocks``
    keep their list order; weights stay (in, out).  Every leaf keeps its
    dtype: the model's is the one leaf dtype other than float32, and the
    leaves the reference keeps in float32 in any model (MoE's ``router``,
    Mamba2's ``A_log`` and ``D``) are made float32 by the port's modules
    too, which ``load_state_dict`` would otherwise cast into."""
    from .core.agent import resolve_device
    from .models.transformer import LM
    device = resolve_device(device)
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    state = {k: _tensor(a) for k, a in _unstacked(flat).items()}
    dtypes = {t.dtype for t in state.values()} - {torch.float32}
    lm = LM(cfg, dtypes.pop() if dtypes else torch.float32, device)
    lm.load_state_dict(state, strict=True)
    return lm


def _assign(net: nn.Module, arrays: List[np.ndarray], context: str) -> None:
    """Copy ``arrays`` (flatten order) into ``net``'s parameters, raising
    ``ValueError`` unless they match leaf for leaf in count, shape and
    dtype (``checkpoint.check_leaves_compat``)."""
    from .checkpoint.store import check_leaves_compat  # (it imports us)
    expected = leaves(net)
    check_leaves_compat([p for _, p in expected], arrays, context=context)
    with torch.no_grad():
        for (_, p), a in zip(expected, arrays):
            p.copy_(torch.from_numpy(np.array(a)))


def save_npz(path: str, net: nn.Module, epsilon: float = 0.0) -> None:
    flat = [p.detach().cpu().numpy() for _, p in leaves(net)]
    np.savez(path, n=len(flat), epsilon=epsilon,
             **{f"p{i}": x for i, x in enumerate(flat)})


def load_npz(path: str, net: nn.Module) -> float:
    """Load a ``save_npz`` (or JAX ``MRSchAgent.save``) file into ``net``;
    returns the stored epsilon."""
    with np.load(path) as data:
        n = int(data["n"])
        missing = [f"p{i}" for i in range(n) if f"p{i}" not in data.files]
        if missing:
            raise ValueError(
                f"load({path}): checkpoint claims {n} leaves but arrays "
                f"{missing[:3]}{'...' if len(missing) > 3 else ''} are absent")
        _assign(net, [data[f"p{i}"] for i in range(n)], context=f"load({path})")
        return float(data["epsilon"])
