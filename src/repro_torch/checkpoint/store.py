"""Checkpoint directories: atomic save, restore by path, async save,
retention — the JAX package's ``repro/checkpoint/store.py`` layout.

Layout:  <dir>/step_<n>/
            manifest.json        leaf paths, logical shapes, dtypes, extra
            shard_000.npz        leaf arrays ``a0 .. a{n-1}``

Either package reads the other's checkpoints.  A leaf's path is its keys
joined by ``/`` in ``jax.tree_util`` order (dict keys sorted, lists in
order); a module's parameter ``state.layers.0.w`` is the path
``state/layers/0/w``, the JAX DFP tree's leaf of the same array.  Leaves
are restored *by path*.  Dtypes that ``.npz`` cannot hold are stored as
bytes, as the JAX package stores them: 2-byte dtypes (bfloat16) as
``uint16`` of the same shape, others (float8, complex64) as ``uint8``
with a trailing itemsize axis; the manifest keeps the logical dtype under
its numpy/ml_dtypes name (``"bfloat16"``).  This package reads them back
through torch's own dtypes, without ``ml_dtypes``.

* atomic commit (write ``step_<n>.tmp``, then rename): a killed save
  never leaves a half-written step for ``latest_step`` to find;
* ``CheckpointManager.save_async`` copies the leaves to the host on the
  caller's thread and writes them from a background thread;
* restore lands each leaf on the template leaf's device unless told
  otherwise; restoring into a module returns a new module;
* keeps the newest ``keep`` checkpoints.
"""
from __future__ import annotations

import copy
import json
import os
import shutil
import threading
from typing import Any, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..convert import leaves as module_leaves

_NPZ_NATIVE = (np.float32, np.float64, np.int32, np.int64,
               np.uint8, np.int8, np.uint16, np.int16,
               np.float16, np.bool_, np.uint32, np.uint64)


def _dtype_name(x) -> str:
    """A leaf's dtype under its numpy/ml_dtypes name (``"bfloat16"``,
    ``"float32"``), for a tensor or an array."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(np.asarray(x).dtype if not hasattr(x, "dtype") else x.dtype)


class _Flat:
    """A tree already flattened: paths and host copies of its leaves (what
    ``save_async`` hands its background thread)."""

    def __init__(self, paths: List[str], leaves: List[Any]):
        self.paths, self.leaves = paths, leaves


def _walk(tree, prefix: Tuple[str, ...], out: list) -> None:
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            _walk(tree[k], prefix + (str(k),), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _walk(v, prefix + (str(i),), out)
    elif tree is not None:
        out.append(("/".join(prefix), tree))


def _flatten(tree) -> Tuple[List[str], List[Any]]:
    """(paths, leaves) in ``jax.tree_util`` order.  A module's leaves are
    its parameters; a nested dict/list/tuple's are its tensors (``None``
    is an empty subtree, as in jax)."""
    if isinstance(tree, _Flat):
        return tree.paths, tree.leaves
    if isinstance(tree, nn.Module):
        pairs = [(n.replace(".", "/"), p) for n, p in module_leaves(tree)]
    else:
        pairs = []
        _walk(tree, (), pairs)
    return [p for p, _ in pairs], [x for _, x in pairs]


def _unflatten(template, by_path: dict):
    """``template``'s structure with each leaf replaced by ``by_path``'s.
    A module comes back as a new module (a deep copy whose parameters are
    the given tensors, never the template's)."""
    if isinstance(template, nn.Module):
        memo = {}
        for name, p in template.named_parameters():
            memo[id(p)] = nn.Parameter(by_path[name.replace(".", "/")],
                                       requires_grad=p.requires_grad)
        return copy.deepcopy(template, memo)

    def build(tree, prefix):
        if isinstance(tree, Mapping):
            return type(tree)((k, build(v, prefix + (str(k),)))
                              for k, v in tree.items())
        if isinstance(tree, (list, tuple)):
            return type(tree)(build(v, prefix + (str(i),))
                              for i, v in enumerate(tree))
        return None if tree is None else by_path["/".join(prefix)]
    return build(template, ())


def _to_numpy(leaf: torch.Tensor) -> Tuple[np.ndarray, str, list]:
    """(array ``.npz`` stores, logical dtype name, logical shape)."""
    name = _dtype_name(leaf)
    t = leaf.detach().cpu().contiguous()
    shape = list(t.shape)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), name, shape
    if t.is_floating_point() and t.dtype.itemsize == 1:       # float8
        return t.view(torch.uint8).numpy().reshape(*shape, 1), name, shape
    arr = t.numpy()
    if arr.dtype not in _NPZ_NATIVE:                          # complex64
        arr = arr.view(np.uint8).reshape(*arr.shape, arr.itemsize)
    return arr, name, shape


def _from_numpy(arr: np.ndarray, meta: dict) -> torch.Tensor:
    """Invert ``_to_numpy``'s byte view: a tensor of the logical dtype,
    viewed through torch's dtype of that name (numpy may not know it)."""
    name, shape = meta["dtype"], meta["shape"]
    if str(arr.dtype) == name:
        return torch.from_numpy(arr)
    tdt = getattr(torch, name, None)
    if not isinstance(tdt, torch.dtype):
        raise ValueError(f"checkpoint leaf {meta['path']}: dtype {name!r} "
                         "has no torch counterpart")
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint8:                      # (*shape, itemsize) bytes
        return torch.from_numpy(arr.reshape(-1)).view(tdt).reshape(shape)
    return torch.from_numpy(arr.view(np.int16)).view(tdt)   # 2-byte view


def check_leaves_compat(expected, got, context: str = "checkpoint") -> None:
    """Raise ``ValueError`` unless ``got`` matches ``expected`` leaf for leaf.

    Both are flat leaf sequences (tensors or arrays, ``jax.tree_util``
    flatten order).  Guards every path that puts foreign arrays into a
    live network — ``MRSchAgent.load`` (through ``convert``) and the
    service's ``update_params`` — so an incompatible checkpoint (other
    window, hidden widths, resource count) fails loudly instead of
    producing a corrupt network.
    """
    expected = list(expected)
    got = list(got)
    if len(got) != len(expected):
        raise ValueError(
            f"{context}: incompatible parameter tree — {len(got)} leaves, "
            f"expected {len(expected)} (was it saved from a different "
            "architecture?)")
    for i, (e, g) in enumerate(zip(expected, got)):
        e_shape, g_shape = tuple(np.shape(e)), tuple(np.shape(g))
        if e_shape != g_shape:
            raise ValueError(
                f"{context}: leaf {i} shape mismatch — checkpoint "
                f"{g_shape}, expected {e_shape} (different window / hidden "
                "sizes / resource count?)")
        e_dtype, g_dtype = _dtype_name(e), _dtype_name(g)
        if g_dtype != e_dtype:
            raise ValueError(
                f"{context}: leaf {i} dtype mismatch — checkpoint "
                f"{g_dtype}, expected {e_dtype}")


def save_pytree(tree, directory: str, step: int, extra: Optional[dict] = None
                ) -> str:
    """Atomic synchronous save of a module's parameters or a nested
    dict/list of tensors (layout: module docstring)."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    paths, leaves = _flatten(tree)
    arrays = {}
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for i, (p, leaf) in enumerate(zip(paths, leaves)):
        arr, true_dtype, shape = _to_numpy(leaf)
        key = f"a{i}"
        arrays[key] = arr
        manifest["leaves"].append(
            {"path": p, "key": key, "shape": shape, "dtype": true_dtype})
    np.savez(os.path.join(tmp, "shard_000.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def restore_pytree(template, directory: str, step: Optional[int] = None,
                   device=None):
    """Restore into the structure of ``template`` (a module, or a nested
    dict/list of tensors) -> (tree, manifest).

    Each leaf is read by its path (``KeyError`` when the checkpoint lacks
    it), must have the template leaf's shape (``ValueError``), and is cast
    to the template leaf's dtype.  It lands on ``device``; ``None`` means
    the template leaf's own device.  A module template gives a new module
    holding the loaded weights; the template is never written to.
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    paths, leaves = _flatten(template)
    meta_by_path = {leaf["path"]: leaf for leaf in manifest["leaves"]}
    out = {}
    with np.load(os.path.join(d, "shard_000.npz")) as data:
        by_path = {leaf["path"]: leaf["key"] for leaf in manifest["leaves"]}
        for p, leaf in zip(paths, leaves):
            if not isinstance(leaf, torch.Tensor):
                raise TypeError(f"restore template leaf {p}: expected a "
                                f"tensor, got {type(leaf).__name__}")
            t = _from_numpy(data[by_path[p]], meta_by_path[p])
            if list(t.shape) != list(leaf.shape):
                raise ValueError(f"shape mismatch for {p}: ckpt "
                                 f"{tuple(t.shape)} vs template "
                                 f"{tuple(leaf.shape)}")
            out[p] = t.to(leaf.device if device is None else device,
                          dtype=leaf.dtype)
    return _unflatten(template, out), manifest


def _step_numbers(directory: str) -> list:
    """Committed checkpoint steps in ``directory``, ascending.  Entries
    that merely look step-like (``step_backup/`` left by an operator, an
    in-flight ``.tmp``) are skipped, not fatal — the hot-reload watcher
    polls this on a loop and must keep finding real checkpoints."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for n in os.listdir(directory):
        parts = n.split("_")
        if len(parts) == 2 and parts[0] == "step" and parts[1].isdigit():
            steps.append(int(parts[1]))
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = _step_numbers(directory)
    return max(steps) if steps else None


class CheckpointManager:
    """Async save + retention policy.

    A failed background save (full disk, bad dtype, ...) is never
    silent: the worker exception is captured and re-raised from
    ``wait()`` — and therefore from the next ``save_async``/``save``/
    ``restore_latest``, which all flush first.
    """

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._async_exc: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    def save_async(self, tree, step: int, extra: Optional[dict] = None):
        self.wait()
        # Copy to the host *before* backgrounding, so an optimizer step
        # that updates the parameters in place cannot tear the snapshot.
        paths, leaves = _flatten(tree)
        # (On the CPU, ``.cpu()`` and ``.numpy()`` share the leaf's memory.)
        host = _Flat(paths, [x.detach().to("cpu", copy=True)
                             for x in leaves])

        def work():
            try:
                save_pytree(host, self.directory, step, extra)
                self._gc()
            except BaseException as e:          # surfaced by wait()
                self._async_exc = e

        self._thread = threading.Thread(target=work, daemon=True,
                                        name="mrsch-ckpt-save")
        self._thread.start()

    def save(self, tree, step: int, extra: Optional[dict] = None):
        self.wait()
        save_pytree(tree, self.directory, step, extra)
        self._gc()

    def wait(self):
        """Join any in-flight async save; re-raise its failure, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._async_exc is not None:
            exc, self._async_exc = self._async_exc, None
            raise exc

    def restore_latest(self, template, device=None):
        self.wait()
        return restore_pytree(template, self.directory, None, device)

    def _gc(self):
        steps = _step_numbers(self.directory)
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
