"""Production mesh construction (the JAX package's ``launch/mesh.py``).

FUNCTIONS, not module-level constants: importing this module touches no
process group.  Both build a named ``DeviceMesh`` over the initialised
world (``torch.distributed.init_process_group``), on the card when the
world's backend is NCCL and on the CPU otherwise (gloo, or the dry run's
fake backend of 256 or 512 ranks in one process).  ``join_world`` forms
that world for the command lines when ``torchrun`` launched them.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16x16 = 256 ranks ("data", "model"); two of them -> (2, 16, 16)
    with a leading "pod" axis for cross-pod data parallelism.  The world
    must hold exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_host_mesh(model_parallel: int = 1) -> DeviceMesh:
    """("data", "model") mesh over the whole world (the host's cards, the
    tests' gloo ranks)."""
    n = dist.get_world_size()
    dp = max(n // model_parallel, 1)
    return init_device_mesh(_device_type(), (dp, model_parallel),
                            mesh_dim_names=("data", "model"))


def join_world(device=None) -> Optional[DeviceMesh]:
    """The host mesh of the world ``torchrun`` launched this process into
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK`` and the rendezvous address in
    the environment), joining it first; None in a process that no
    launcher started, which then runs alone.  The group is NCCL on card
    ``LOCAL_RANK`` unless ``device`` is ``"cpu"`` (gloo).  Nothing falls
    back: without a card, or when NCCL cannot form the group, it
    raises."""
    if "WORLD_SIZE" not in os.environ:
        return None
    if not dist.is_initialized():
        if device is not None and torch.device(device).type == "cpu":
            dist.init_process_group("gloo")
        else:
            from ..core.agent import resolve_device
            resolve_device(device)                  # raises without a card
            card = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            torch.cuda.set_device(card)
            # ``device_id`` forms the NCCL communicator now, so a failure
            # shows here and not at the first collective.
            dist.init_process_group("nccl", device_id=card)
    return make_host_mesh()
