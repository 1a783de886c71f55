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

Across a world of ranks (DTensor leaves, the reference's sharded arrays):
a save gathers each DTensor leaf whole, one leaf at a time, on every rank
of its mesh and on the caller's thread (never in the background, where
its collectives would meet the next step's); the mesh's first rank alone
writes, the same full arrays in ``shard_000.npz``, and every rank waits
until the step is committed.  A restore with ``shardings`` reads each
leaf whole and lays it out on the target mesh, which may hold another
number of ranks than the one that saved (the elastic restart).
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


def _dtensor_mesh(leaves: List[Any]):
    """The mesh of the tree's DTensor leaves (None when it has none).  It
    must span the world: the ranks agree over the default group."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    meshes = []
    for x in leaves:
        if isinstance(x, DTensor) and x.device_mesh not in meshes:
            meshes.append(x.device_mesh)
    if not meshes:
        return None
    if len(meshes) > 1:
        raise ValueError(f"checkpoint: the tree's DTensors lie on meshes "
                         f"{meshes}; one is supported")
    mesh = meshes[0]
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"checkpoint: the leaves' mesh holds {mesh.size()} "
                         f"of the world's {dist.get_world_size()} ranks")
    return mesh


def _writes(mesh) -> bool:
    """Whether this rank writes the checkpoint: the mesh's first rank."""
    import torch.distributed as dist
    return dist.get_rank() == int(mesh.mesh.flatten()[0])


def _host_copies(leaves: List[Any], mesh) -> Optional[List[torch.Tensor]]:
    """Each leaf whole on the host, on the writing rank (None elsewhere).
    A DTensor is gathered (``full_tensor``) by every rank, one leaf at a
    time, so no card holds more than one whole leaf; the writer copies
    each to the host before the next."""
    from torch.distributed.tensor import DTensor
    writer = _writes(mesh)
    out = []
    for x in leaves:
        x = x.detach()
        if isinstance(x, DTensor):
            x = x.full_tensor()
        out.append(x.to("cpu", copy=True) if writer else None)
    return out if writer else None


def _agree(mesh, failed: bool) -> bool:
    """A barrier over the world that also tells every rank whether any
    rank's part of a save failed."""
    import torch.distributed as dist
    from ..distributed.sharding import mesh_device
    flag = torch.tensor([int(failed)], dtype=torch.int32,
                        device=mesh_device(mesh))
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())


def save_pytree(tree, directory: str, step: int, extra: Optional[dict] = None
                ) -> str:
    """Atomic synchronous save of a module's parameters or a nested
    dict/list of tensors (layout: module docstring).  A tree of DTensors
    is saved by every rank of its mesh together: each leaf gathered
    whole, the mesh's first rank writing, all returning once the step is
    committed; a failure on the writer raises on every rank."""
    final = os.path.join(directory, f"step_{step:08d}")
    paths, leaves = _flatten(tree)
    mesh = _dtensor_mesh(leaves)
    if mesh is None:
        return _write(paths, leaves, final, step, extra)
    host = _host_copies(leaves, mesh)
    err = None
    if host is not None:
        try:
            _write(paths, host, final, step, extra)
        except BaseException as e:          # raised after the barrier
            err = e
    if _agree(mesh, err is not None):
        raise err or RuntimeError(f"checkpoint: the writing rank failed to "
                                  f"save step {step}")
    return final


def _write(paths: List[str], leaves: List[Any], final: str, step: int,
           extra: Optional[dict]) -> str:
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
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


def _shardings_by_path(shardings, paths: List[str]) -> dict:
    """Path -> ``NamedSharding`` of the leaves a tree of shardings places
    (``ValueError`` for a path the template lacks)."""
    pairs = []
    _walk(shardings, (), pairs)
    unknown = sorted(set(p for p, _ in pairs) - set(paths))
    if unknown:
        raise ValueError(f"restore: shardings for leaves the template "
                         f"lacks: {unknown[:3]}")
    return dict(pairs)


def _place(t: torch.Tensor, leaf, sharding, device) -> torch.Tensor:
    """A restored array (on the host, the template leaf's dtype) where it
    goes: laid out by ``sharding`` on its mesh, else like a DTensor
    template leaf, else on ``device`` or the template leaf's device."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if sharding is None and isinstance(leaf, DTensor):
        mesh, pl = leaf.device_mesh, leaf.placements
    elif sharding is not None:
        mesh, pl = sharding.mesh, sharding.placements
    else:
        return t.to(leaf.device if device is None else device)
    from ..distributed.sharding import mesh_device
    return distribute_tensor(t.to(mesh_device(mesh)), mesh, pl)


def restore_pytree(template, directory: str, step: Optional[int] = None,
                   device=None, shardings=None):
    """Restore into the structure of ``template`` (a module, or a nested
    dict/list of tensors) -> (tree, manifest).

    Each leaf is read by its path (``KeyError`` when the checkpoint lacks
    it), must have the template leaf's shape (``ValueError``), and is cast
    to the template leaf's dtype.  It lands on ``device``; ``None`` means
    the template leaf's own device.  ``shardings`` (the reference's
    elastic restart), a tree of ``sharding.NamedSharding`` matching a
    nested template (None for a leaf it leaves alone), lays each leaf it
    names out on that
    mesh, whatever mesh saved it: every rank reads the leaf whole and
    keeps its shard.  A DTensor template leaf it does not name keeps the
    template's layout.  The template's leaves may then be meta tensors.
    A module template gives a new module holding the loaded weights; the
    template is never written to.
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    paths, leaves = _flatten(template)
    placed = _shardings_by_path(shardings, paths)
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
            out[p] = _place(t.to(dtype=leaf.dtype), leaf, placed.get(p),
                            device)
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

    With DTensor leaves every rank of their mesh (the whole world) calls
    the same methods in the same order: each save gathers the leaves on
    every rank, on the caller's thread; the mesh's first rank alone writes
    (``save_async`` from its background thread) and prunes old steps;
    ``wait()`` on every rank returns only once that write is committed
    (a barrier), so any rank's ``latest_step`` then finds it, and raises on
    every rank when the write failed.
    """

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._async_exc: Optional[BaseException] = None
        self._mesh = None             # the mesh of an uncommitted save
        os.makedirs(directory, exist_ok=True)

    def save_async(self, tree, step: int, extra: Optional[dict] = None):
        self.wait()
        # Copy to the host *before* backgrounding, so an optimizer step
        # that updates the parameters in place cannot tear the snapshot.
        paths, leaves = _flatten(tree)
        mesh = _dtensor_mesh(leaves)
        if mesh is None:
            # (On the CPU, ``.cpu()`` and ``.numpy()`` share the leaf's
            # memory.)
            copies = [x.detach().to("cpu", copy=True) for x in leaves]
        else:
            copies = _host_copies(leaves, mesh)
            self._mesh = mesh
            if copies is None:                  # not the writing rank
                return
        host = _Flat(paths, copies)

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
        mesh = _dtensor_mesh(_flatten(tree)[1])
        if mesh is None or _writes(mesh):
            self._gc()

    def wait(self):
        """Join any in-flight async save; re-raise its failure, if any.
        After a save of DTensors, every rank waits here for the writer's
        commit, and raises when it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        exc, self._async_exc = self._async_exc, None
        if self._mesh is not None:
            mesh, self._mesh = self._mesh, None
            if _agree(mesh, exc is not None) and exc is None:
                raise RuntimeError("checkpoint: the writing rank failed to "
                                   "save")
        if exc is not None:
            raise exc

    def restore_latest(self, template, device=None, shardings=None):
        self.wait()
        return restore_pytree(template, self.directory, None, device,
                              shardings)

    def _gc(self):
        steps = _step_numbers(self.directory)
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
