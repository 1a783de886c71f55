"""Carry DFP weights between the JAX package and this one.

The JAX package keeps the weights as a tree of nested dicts and lists,
``{"state" | "measurement" | "goal" | "expectation" | "action":
{"layers": [{"w": (in, out), "b": (out,)}, ...]}}``; this package keeps
the same arrays, same layout, as ``DFPNetwork`` parameters named by their
path in that tree (``state.layers.0.w``).  So conversion is a copy.

The ``.npz`` checkpoint format is the JAX ``MRSchAgent.save`` one: leaves
``p0 .. p{n-1}`` in ``jax.tree_util`` flatten order (dict keys sorted at
every level, lists in order), plus ``n`` and ``epsilon``.
"""
from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch
from torch import nn


def _tree_key(name: str) -> tuple:
    # Dict keys sort as strings, list positions as integers.
    return tuple(int(p) if p.isdigit() else p for p in name.split("."))


def leaves(net: nn.Module) -> List[tuple]:
    """(name, parameter) pairs in ``jax.tree_util`` flatten order."""
    return sorted(net.named_parameters(), key=lambda kv: _tree_key(kv[0]))


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """The JAX parameter tree (nested dicts/lists of arrays) as a state
    dict for ``DFPNetwork.load_state_dict``."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    return {k: torch.from_numpy(np.array(v)) for k, v in flat.items()}


def _assign(net: nn.Module, arrays: List[np.ndarray], context: str) -> None:
    """Copy ``arrays`` (flatten order) into ``net``'s parameters, raising
    ``ValueError`` unless they match leaf for leaf in count, shape and
    dtype."""
    expected = leaves(net)
    if len(arrays) != len(expected):
        raise ValueError(
            f"{context}: incompatible parameter tree — {len(arrays)} leaves, "
            f"expected {len(expected)} (was it saved from a different "
            "architecture?)")
    for i, ((name, p), a) in enumerate(zip(expected, arrays)):
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(
                f"{context}: leaf {i} ({name}) shape mismatch — checkpoint "
                f"{tuple(a.shape)}, expected {tuple(p.shape)}")
        if a.dtype != torch.empty(0, dtype=p.dtype).numpy().dtype:
            raise ValueError(f"{context}: leaf {i} ({name}) dtype mismatch — "
                             f"checkpoint {a.dtype}, expected {p.dtype}")
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
